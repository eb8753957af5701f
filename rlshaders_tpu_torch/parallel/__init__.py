"""Multi-GPU tile sharding over torch.distributed (parallel/mesh.py)."""
from . import mesh  # noqa: F401
