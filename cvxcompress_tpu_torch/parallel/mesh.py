"""The device mesh of the block-data-parallel codec.

The PyTorch counterpart of `cvxcompress_tpu/parallel/mesh.py`.  The codec's
only distribution axis is the block grid: blocks are independent once the
scalar mulfac is known (the reference's OpenMP dynamic schedule over
blocks, CvxCompress.cpp:318).  Here a mesh is a tuple of `torch.device`,
one per shard, z-slab shard k on device k.  A device may appear more than
once: several shards on one card, each on a CUDA stream of its own (the
counterpart of the JAX suite's 8 virtual CPU devices, and how one card
runs the shard code).

The JAX module's `is_tpu_mesh`, `block_sharding` and `replicated` have no
counterpart: they pick Pallas kernels on TPU meshes and name XLA shardings
of a block batch, while the port runs its own kernels on every CUDA device
and moves each shard's slab itself.
"""

from __future__ import annotations

import torch

from ..ops import codec


def make_mesh(devices=None):
    """A tuple of torch devices, one per shard: `devices` (names or
    devices, repeats allowed), else every visible CUDA card.  There is no
    CPU fallback: with no card and no `devices` given it raises, and a CUDA
    device on a machine without a card raises; pass ["cpu"] * n to run the
    plain versions on the CPU.  A bare "cuda" becomes the current card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a CUDA card and there is none; "
                               "pass devices=['cpu'] * n to shard on the CPU")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    mesh = []
    for d in devices:
        d = codec._target(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return tuple(mesh)


def pad_to_shards(n, n_shards):
    """Blocks to add so the batch divides evenly across shards."""
    return (-n) % n_shards
