"""The comparison that decides `correct`.

Once the window has closed, the reference (reference/codec.py, plain
PyTorch) is run on the inputs of the sampled calls, made again from the
seed, and the program's outputs are judged against it:

- `container_bytes_differing`: over the checked compress calls, the bytes
  of the program's container that differ from the reference's, plus the
  difference of their lengths;
- `volume_cells_differing`: over the checked decompress calls, the cells
  of the program's volume whose float32 bits differ from the volume the
  reference decodes from its own container (two NaNs count as equal).

Both limits are 0: the program runs the reference library's order of
operations, so every byte and bit is determined.  The limits live in
limits/<workload>.json, with the readings they were set from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import codec as ref_codec
from .generator import Generator

NAMES = ("container_bytes_differing", "volume_cells_differing")


def container_diff(got, want):
    got = np.asarray(got, dtype=np.uint8).ravel()
    want = np.asarray(want, dtype=np.uint8).ravel()
    n = min(got.size, want.size)
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(got.size - want.size)


def volume_diff(got, want):
    got = torch.as_tensor(got).to(want.device, torch.float32)
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    return int((~same).sum())


def compare(config, traffic, seed, kept, device):
    """Readings of the checked calls: `kept` is a list of (snapshot index,
    the port's container, the port's volume).  Returns {name: value, ...,
    "containers": n, "volumes": n}."""
    codec = ref_codec.Codec(config["shape"], config["block"], config["scale"],
                            config.get("use_local_rms", False), device)
    gen = Generator(traffic, config["shape"], seed, device)
    out = dict.fromkeys(NAMES, 0)
    for i, data, vol in kept:
        want, want_vol = codec.compress(gen.snapshot(i))
        out["container_bytes_differing"] += container_diff(data, want)
        out["volume_cells_differing"] += volume_diff(vol, want_vol)
        del want_vol
    out.update(containers=len(kept), volumes=len(kept))
    return out


def judge(readings, limits):
    """True when every reading is within its limit and something was
    checked in both directions."""
    return (readings["containers"] > 0 and readings["volumes"] > 0
            and all(readings[n] <= limits[n] for n in NAMES))
