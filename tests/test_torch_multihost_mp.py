"""The port's multihost module in two real processes (torch.distributed,
gloo over TCP on 127.0.0.1, device="cpu"): each process compresses its
z-slab, and the gathered container ("allgather") or the merged segment
files ("files") are byte-equal to the port's single compress of the whole
volume, the JAX test's case (tests/test_multihost_mp.py).  A process that
fails or outlives its 120 s fails the test; it is killed first."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPE, BLOCK = (32, 24, 48), (16, 8, 8)
TIMEOUT = 120  # seconds a process

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method={addr!r}, world_size=2, rank={rank})
from cvxcompress_tpu_torch.parallel import multihost, sharded
from cvxcompress_tpu_torch.utils import volumes

shape, block = {shape!r}, {block!r}
vol = volumes.radial_volume(*shape)
z0, z1 = sharded.plan_shards(shape, block, 2)[{rank}]
slab = vol[z0:z1]
if {mode!r} == "allgather":
    data = multihost.compress(slab, 1e-2, block, vol_shape=shape, device={device!r})
    assert (data is None) == ({rank} != 0)
    if {rank} == 0:
        data.tofile({out!r})
else:
    path = multihost.compress(slab, 1e-2, block, vol_shape=shape, gather="files",
                              file_prefix={out!r} + ".part", device={device!r})
    assert path == {out!r} + ".part.seg{rank}"
    dist.barrier()
    if {rank} == 0:
        multihost.merge_segment_files([{out!r} + ".part.seg0", {out!r} + ".part.seg1"],
                                      shape, block).tofile({out!r})
dist.destroy_process_group()
print("worker", {rank}, "done", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(tmp_path, mode, device="cpu"):
    """Run the two workers, compressing on `device`; returns rank 0's
    container, or fails with both logs when a worker fails or times out."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    out = str(tmp_path / f"mp_{mode}.bin")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(repo=REPO, addr=addr, rank=r, mode=mode,
                                             out=out, shape=SHAPE, block=BLOCK,
                                             device=device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    logs, ok = [], True
    for p in procs:
        try:
            log, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            ok = False
        logs.append(log.decode(errors="replace"))
        ok = ok and p.returncode == 0
    for p in procs:  # nothing outlives the test
        if p.poll() is None:
            p.kill()
            p.wait()
    assert ok, "a worker failed:\n" + "\n---\n".join(lg[-1500:] for lg in logs)
    return np.fromfile(out, dtype=np.uint8)


@pytest.mark.parametrize("mode", ["allgather", "files"])
def test_two_process_container_byte_identity(tmp_path, mode):
    from cvxcompress_tpu_torch.ops import codec
    from cvxcompress_tpu_torch.utils import volumes

    got = run_pair(tmp_path, mode)
    vol = volumes.radial_volume(*SHAPE)
    want, _ = codec.compress(vol, 1e-2, BLOCK, device="cpu")
    np.testing.assert_array_equal(got, want)
    out = codec.decompress(got, device="cpu").numpy()
    assert np.abs(out - vol).max() < 1e-1
