"""Data parallelism over tracks on ``torch.distributed``: ``mesh`` (the
shards and their kernels) and ``multihost`` (each process's slice)."""
from extrack_tpu_torch.parallel import mesh  # noqa: F401
