"""The one traffic generator: wavefield snapshots made on the device.

A traffic mix is a JSON file of parameters (traffic/<name>.json):

    {"snapshots": 4,                 snapshot buffers a round (P)
     "trace_rounds": 2,              rounds in the traced window
     "terms": [ ... ],               fields summed into each snapshot
     "noise_uniform": 0.01}          amplitude of U(0, 1) noise added (0: none)

Terms (rewritten in torch from `cvxcompress_tpu_torch/utils/volumes.py`,
which copies the reference library's inputs):

- {"kind": "z_sinusoid", "periods": p}: sin((z + phi) * pi * p / nz),
  constant over each z-slice (Test_With_Generated_Input.cpp:45-51); phi is
  uniform over one period;
- {"kind": "radial_sinusoid", "radius_divisor": d, "centre_shift": s}:
  sin(r / d), r the distance from a centre ((n - 1) // 2 on each axis,
  Read_Raw_Volume.cpp:28-42) moved by a uniform share of each dimension in
  [-s, s].

Snapshot i of a run is a function of (seed, i) alone: its phase, centre and
noise come from generators seeded by a hash of both.  Snapshot 0 has phase
0 and the centre unmoved (the reference's own input, plus the noise);
negative i are the warm-up round's.  Every value is computed in float32.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

SLAB_CELLS = 1 << 24  # noise is drawn in z-slabs of about this many cells


def seed_of(seed, i, tag):
    """A 63-bit seed for snapshot i's `tag` draws of run `seed` (any int)."""
    h = hashlib.sha256(f"{int(seed)}/{int(i)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


class Generator:
    """Makes snapshot i of a run into a (nz, ny, nx) float32 buffer on the
    device, in a few large operations."""

    def __init__(self, traffic, shape, seed, device):
        self.terms = list(traffic["terms"])
        self.noise = float(traffic.get("noise_uniform", 0.0))
        self.shape = tuple(int(n) for n in shape)
        self.seed = int(seed)
        self.device = torch.device(device)
        for t in self.terms:
            if t["kind"] not in ("z_sinusoid", "radial_sinusoid"):
                raise ValueError(f"unknown term kind {t['kind']!r}")

    def snapshot(self, i):
        buf = torch.empty(self.shape, dtype=torch.float32, device=self.device)
        self.fill(buf, i)
        return buf

    def fill(self, buf, i):
        """Write snapshot i into `buf`."""
        for k, term in enumerate(self.terms):
            rng = np.random.default_rng(seed_of(self.seed, i, f"term{k}"))
            if k == 0:
                self._term(buf, term, i, rng)
            else:
                tmp = torch.empty_like(buf)
                self._term(tmp, term, i, rng)
                buf.add_(tmp)
        if self.noise:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed_of(self.seed, i, "noise"))
            nz = self.shape[0]
            step = max(1, SLAB_CELLS // (self.shape[1] * self.shape[2]))
            for z0 in range(0, nz, step):
                sl = buf[z0:z0 + step]
                u = torch.rand(sl.shape, generator=g, device=self.device)
                sl.add_(u.mul_(self.noise))
        return buf

    def _term(self, out, term, i, rng):
        nz, ny, nx = self.shape
        dev = self.device
        if term["kind"] == "z_sinusoid":
            p = float(term["periods"])
            phi = 0.0 if i == 0 else rng.uniform(0.0, 2.0 * nz / p)
            z = torch.arange(nz, dtype=torch.float32, device=dev) + np.float32(phi)
            col = torch.sin(z * np.float32(math.pi * p / nz))
            out.copy_(col.view(nz, 1, 1).expand(nz, ny, nx))
            return
        s = float(term["centre_shift"])
        axes = []
        for n in (nz, ny, nx):
            c = (n - 1) // 2 + (0.0 if i == 0 else rng.uniform(-s * n, s * n))
            d = torch.arange(n, dtype=torch.float32, device=dev) - np.float32(c)
            axes.append(d * d)
        out.copy_(axes[0].view(nz, 1, 1).expand(nz, ny, nx))
        out.add_(axes[1].view(1, ny, 1))
        out.add_(axes[2].view(1, 1, nx))
        out.sqrt_()
        out.div_(float(term["radius_divisor"]))
        out.sin_()
