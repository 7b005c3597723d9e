"""The multi-device layer: the mesh, the sharded compress and decompress,
the z-slab segments and their merge, and the multi-process compress on
torch.distributed (`cvxcompress_tpu/parallel/`)."""

from . import compress, mesh, multihost, sharded  # noqa: F401
