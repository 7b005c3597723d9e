"""The payload emitter: tokens -> block-ordered byte stream (K2 + K3 port).

`emit_payload` launches csrc/emit_payload.cu on CUDA tensors and runs
`emit_payload_plain` on CPU tensors.  Inputs are fused_encode's outputs for
the (nnn) blocks plus the byte base of each block in the stream (the
exclusive cumsum of the non-raw blocks' sizes); the output is the dense
(total,) uint8 payload of the non-raw blocks in container block order —
what `cvxcompress_tpu/ops/rle_device.py:547-575` `pack_active_stripe_seg`
returns on its default path.  Raw-fallback blocks are absent; the host
splices their coefficients in (`rle_device.assemble_payload_blockorder`).

TPU counterparts: `pack_pallas.pack_staging_seg` (:479) and
`pack_pallas.tile_compact` (:605).
"""

from __future__ import annotations

import torch

from . import _kernels, quant, rle_device
from .tokenize import scaled


def _byte(v, k):
    return (v >> (8 * k)) & 0xFF


def token_bytes(coeffs, mulfac, desc):
    """The five byte planes of every cell's (<= 5-byte) token, and its cost.

    Byte values follow the grammar of oracle/rle.py; a packed group splits
    per lane (VLESC2_8x = lane 0 [code, i16] + lanes 1..7 [i16]).  Mirrors
    `cvxcompress_tpu/ops/rle_device.py:_planes`.
    """
    fv = scaled(coeffs, mulfac)
    iv = quant.quantize(fv)
    izero, is_byte, is_short, is_i3 = rle_device.classify(iv)
    mode = rle_device.group_modes(izero, is_byte, is_short, is_i3)
    cost = desc & 7
    rl = desc >> 4  # non-negative: run_len < 2^24
    lane0 = (torch.arange(iv.shape[-1], device=iv.device) % 8 == 0)[None, :]
    pb, ps, p3 = mode == 1, mode == 2, mode == 3
    cb = is_byte & ~izero
    cs = is_short & ~is_byte
    c3 = is_i3 & ~is_short
    fvb = fv.view(torch.int32)
    b0, b1, b2 = _byte(iv, 0), _byte(iv, 1), _byte(iv, 2)

    def sel(*pairs):
        out = pairs[-1]
        for i in range(len(pairs) - 3, -1, -2):
            out = torch.where(pairs[i], pairs[i + 1], out)
        return out

    run_code = torch.where(cost == 1, 0, torch.where(cost == 2, 127, 125))
    plane0 = sel(
        pb, b0,
        ps, torch.where(lane0, 0x82, b0),
        p3, torch.where(lane0, 0x7E, b0),
        izero, run_code,
        cb, b0,
        cs, 0x83,
        c3, 0x81,
        torch.full_like(iv, 0x80),
    )
    plane1 = sel(
        ps, torch.where(lane0, b0, b1),
        p3, torch.where(lane0, b0, b1),
        izero, _byte(rl, 0),
        cs | c3, b0,
        _byte(fvb, 0),
    )
    plane2 = sel(
        ps, b1,  # read only for lane 0 (cost 3)
        p3, torch.where(lane0, b1, b2),
        izero, _byte(rl, 1),
        cs | c3, b1,
        _byte(fvb, 1),
    )
    plane3 = sel(p3, b2, izero, _byte(rl, 2), c3, b2, _byte(fvb, 2))
    plane4 = torch.where(izero, 0, _byte(fvb, 3))  # split run: trailing [0]
    return (plane0, plane1, plane2, plane3, plane4), cost


def emit_payload_plain(coeffs, mulfac, desc, base, raw, total):
    """Plain PyTorch version of the kernel (same stream)."""
    planes, cost = token_bytes(coeffs, mulfac, desc)
    cost = torch.where(raw[:, None], 0, cost)
    pos = base[:, None] + (torch.cumsum(cost, dim=1) - cost)
    out = torch.zeros(total, dtype=torch.uint8, device=coeffs.device)
    for k, plane in enumerate(planes):
        m = cost > k
        out[pos[m] + k] = plane[m].to(torch.uint8)
    return out


def emit_payload(coeffs, mulfac, desc, base, raw, total):
    """Block-ordered payload stream (total,) uint8 of the non-raw blocks.

    coeffs (nnn, 32768) f32, desc (nnn, 32768) int32, base (nnn,) int64,
    raw (nnn,) bool; `total` is the sum of the non-raw blocks' sizes.
    """
    if coeffs.device.type == "cpu":
        return emit_payload_plain(coeffs, mulfac, desc, base, raw, total)
    _kernels.check_cuda(
        coeffs, desc, base, raw,
        dtypes=(torch.float32, torch.int32, torch.int64, torch.bool),
    )
    nnn = coeffs.shape[0]
    out = torch.empty(total, dtype=torch.uint8, device=coeffs.device)
    _kernels.launch(
        "emit_payload", coeffs.data_ptr(), float(mulfac), desc.data_ptr(),
        base.data_ptr(), raw.data_ptr(), nnn, out.data_ptr(),
    )
    return out
