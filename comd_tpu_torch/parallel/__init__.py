"""Domain decomposition over a mesh of shards (comd_tpu.parallel's port)."""
