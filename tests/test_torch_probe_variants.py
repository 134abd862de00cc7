"""P3's loop variants B and C (tools/archive/pallas_probe3.py::kernel_BC:
unrolled offsets accumulating into the output refs, or in registers)
against the port's one window kernel's plain version, EAM and LJ, at one
chunk in interpret mode.  Variant A and P1/P2 are in
test_torch_probe_window.py; the tolerance is the same (max|a - b| / max|b|
<= 1e-5 per output)."""
import pytest
import torch

from probe_archive import check_plain_against_archive

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["B", "C"])
@pytest.mark.parametrize("lj", [False, True])
def test_plain_matches_archive_variant(variant, lj):
    check_plain_against_archive(3, variant, lj, 1)
