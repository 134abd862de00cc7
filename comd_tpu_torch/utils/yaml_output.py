"""YAML run report (src-mpi/yamlOutput.c, CoMD.c:498-552).

Copy of comd_tpu.utils.yaml_output (the port imports nothing of comd_tpu):
writes ``<variant>.<timestamp>.yaml`` mirroring the reference's sections:
run metadata, command-line parameters, simulation/decomposition/memory data,
potential description, per-print-rate energies, validation, and timings.
"""
from __future__ import annotations

import datetime
import getpass
import os
import platform
import socket


class YamlReport:
    def __init__(self, variant: str = "comd-tpu", out_dir: str = "."):
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.path = os.path.join(out_dir, f"{variant}.{ts}.yaml")
        self._fh = None

    def open(self):
        self._fh = open(self.path, "w")
        self.comment("Mitosis-free YAML (mostly compliant), one doc per run")
        return self

    def comment(self, text: str):
        self._fh.write(f"# {text}\n")

    def header(self, version: str):
        now = datetime.datetime.now().strftime("%Y-%m-%d, %H:%M:%S")
        self.section("Run Date & Time", now)
        self.section("Host", socket.gethostname())
        self.section("User", getpass.getuser() if hasattr(os, "getuid") else "?")
        self.section("Platform", platform.platform())
        self.section("Version", version)

    def section(self, key: str, value=None):
        if value is None:
            self._fh.write(f"{key}:\n")
        else:
            self._fh.write(f"{key}: {value}\n")

    def kv(self, key: str, value, indent: int = 2):
        self._fh.write(f"{' ' * indent}{key}: {value}\n")

    def raw(self, text: str):
        self._fh.write(text if text.endswith("\n") else text + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
