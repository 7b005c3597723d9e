"""NumPy oracle for the quantize + run-length/escape-code entropy stage.

Byte-exact re-statement of the reference's vectorized encoder grammar
(reference: Run_Length_Encode_Slow.cpp:189-294, the TMJ_AVX_RLE path, with
escape codes from Run_Length_Escape_Codes.hxx:8-14).  A numpy copy of
`cvxcompress_tpu/oracle/rle.py`: the format authority.

Token grammar (all little-endian):
  plain byte   b in (-125,125)       1 B   quantized value (0 = single zero)
  RLESC1  127  code + u8 run         2 B   run of 1..255 zeros
  RLESC3  125  code + u24 run        4 B   run of >=256 zeros
  VLESC2 -125  code + i16            3 B   16-bit quantized value
  VLESC3 -127  code + i24            4 B   24-bit quantized value
  VLESC4 -128  code + f32            5 B   raw scaled float (out of i24 range)
  VLESC2_8x -126  code + 8 x i16    17 B   group fast path: 8 shorts
  VLESC3_8x  126  code + 8 x i24    25 B   group fast path: 8 int24s

Quantization contract: i = trunc(mulfac * c) toward zero with AVX
_mm256_cvttps_epi32 semantics (out-of-range / NaN -> INT32_MIN,
Run_Length_Encode_Slow.cpp:203-204); a coefficient is "zero" iff i == 0.
Dequantization: c' = float(i) * (1.0f / mulfac) (:392,408-409).

Deliberate deviation from the reference: zero runs >= 2^24 are split into
multiple RLESC3 tokens.  The reference truncates the run count to 24 bits
(Run_Length_Encode_Slow.cpp:59), silently corrupting the stream for an
all-zero 256^3 block (run == 2^24); we refuse to replicate that bug.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
INT32_MIN = -2147483648

RLESC1 = 127
VLESC3_8X = 126
RLESC3 = 125
VLESC2 = -125
VLESC2_8X = -126
VLESC3 = -127
VLESC4 = -128

_B_RLESC1 = RLESC1 & 0xFF
_B_RLESC3 = RLESC3 & 0xFF
_B_VLESC2 = VLESC2 & 0xFF
_B_VLESC3 = VLESC3 & 0xFF
_B_VLESC4 = VLESC4 & 0xFF
_B_VLESC2_8X = VLESC2_8X & 0xFF
_B_VLESC3_8X = VLESC3_8X & 0xFF

MAX_RUN24 = (1 << 24) - 1


def quantize(mulfac, vals):
    """fvals = float32(mulfac) * vals; ivals = cvttps(fvals).

    Returns (fvals f32, ivals i32) with AVX truncation semantics
    (Run_Length_Encode_Slow.cpp:203-204): truncate toward zero; NaN and
    values outside int32 range map to INT32_MIN.
    """
    vals = np.asarray(vals, dtype=F32)
    fvals = (F32(mulfac) * vals).astype(F32)
    with np.errstate(invalid="ignore"):
        in_range = (fvals >= F32(-2147483648.0)) & (fvals < F32(2147483648.0))
    tr = np.trunc(np.where(in_range, fvals, 0.0)).astype(np.int64)
    ivals = np.where(in_range, tr, INT32_MIN).astype(np.int32)
    return fvals, ivals


def _flush_rle(out, rle):
    """Emit the pending zero run. Reference: EncodeRLE_Slow (:21-71)."""
    rle = int(rle)
    while rle > MAX_RUN24:
        out += bytes((_B_RLESC3,)) + MAX_RUN24.to_bytes(3, "little")
        rle -= MAX_RUN24
    if rle == 0:
        return
    if rle == 1:
        out.append(0)
    elif rle < 256:
        out += bytes((_B_RLESC1, rle))
    else:
        out += bytes((_B_RLESC3,)) + rle.to_bytes(3, "little")


def encode(mulfac, vals):
    """Encode a flat float32 coefficient array (length multiple of 8).

    Byte-exact vs the reference's TMJ_AVX_RLE encoder
    (Run_Length_Encode_Slow.cpp:193-294), except runs >= 2^24 (see module
    docstring). Returns a `bytes` payload.
    """
    vals = np.asarray(vals, dtype=F32).ravel()
    if vals.size % 8:
        raise ValueError("the encoder operates on groups of 8 values")
    fvals, ivals = quantize(mulfac, vals)
    fivals = ivals.astype(F32)

    g_fi = fivals.reshape(-1, 8)
    g_iv = ivals.reshape(-1, 8)
    g_fv = fvals.reshape(-1, 8)

    is_zero = g_fi == 0
    # byte class is exclusive range (-125, 125): Run_Length_Encode_Slow.cpp:215
    is_byte = (g_fi > F32(VLESC2)) & (g_fi < F32(RLESC3))
    is_short = (g_fi >= F32(-32768)) & (g_fi <= F32(32767))
    is_i3 = (g_fi >= F32(-8388608)) & (g_fi <= F32(8388607))

    nzeros = is_zero.sum(axis=1)
    allzero = nzeros == 8
    num_bytes = is_byte.sum(axis=1)
    num_shorts = is_short.sum(axis=1)
    nozero = nzeros == 0

    allbyte = nozero & (num_bytes == 8)
    # pack-beats-per-lane guards: :231 and :246
    allshort = (
        nozero & ~allbyte & is_short.all(axis=1)
        & (num_bytes + (8 - num_bytes) * 3 > 17)
    )
    alli3 = (
        nozero & ~allbyte & ~allshort & is_i3.all(axis=1)
        & (num_bytes + (num_shorts - num_bytes) * 3 + (8 - num_shorts) * 4 > 25)
    )

    active = np.flatnonzero(~allzero)
    out = bytearray()
    rle = 0
    prev = -1
    for g in active:
        rle += 8 * (g - prev - 1)
        prev = g
        iv = g_iv[g]
        if allbyte[g]:
            _flush_rle(out, rle)
            rle = 0
            out += (iv & 0xFF).astype(np.uint8).tobytes()
        elif allshort[g]:
            _flush_rle(out, rle)
            rle = 0
            out += bytes((_B_VLESC2_8X,)) + iv.astype("<i2").tobytes()
        elif alli3[g]:
            _flush_rle(out, rle)
            rle = 0
            out.append(_B_VLESC3_8X)
            for v in iv:
                out += (int(v) & 0xFFFFFF).to_bytes(3, "little")
        else:
            # mixed per-lane path with the andnot class chain (:259-261)
            zz = is_zero[g]
            by = is_byte[g] & ~zz
            sh = is_short[g] & ~is_byte[g]
            i3 = is_i3[g] & ~is_short[g]
            for lane in range(8):
                if zz[lane]:
                    rle += 1
                    continue
                _flush_rle(out, rle)
                rle = 0
                v = int(iv[lane])
                if by[lane]:
                    out.append(v & 0xFF)
                elif sh[lane]:
                    out += bytes((_B_VLESC2,)) + (v & 0xFFFF).to_bytes(2, "little")
                elif i3[lane]:
                    out += bytes((_B_VLESC3,)) + (v & 0xFFFFFF).to_bytes(3, "little")
                else:
                    out += bytes((_B_VLESC4,)) + g_fv[g, lane].tobytes()
    rle += 8 * (g_fi.shape[0] - 1 - prev)
    _flush_rle(out, rle)
    return bytes(out)


def decode(mulfac, payload, num_expected):
    """Decode a payload back to float32 values.

    Sequential token walk matching Run_Length_Decode_Slow
    (Run_Length_Encode_Slow.cpp:388-527).  `payload` may extend past the last
    token (the container carries slack bytes); decoding stops after
    `num_expected` values.
    """
    scalefac = F32(1.0) / F32(mulfac)
    vals = np.zeros(num_expected, dtype=F32)
    p = 0
    num = 0
    buf = memoryview(payload)
    while num < num_expected:
        code = buf[p]
        sval = code - 256 if code >= 128 else code
        if -125 < sval < 125:
            vals[num] = F32(np.int32(sval)) * scalefac
            num += 1
            p += 1
        elif sval == RLESC1:
            run = buf[p + 1]
            num += run  # vals already zero
            p += 2
        elif sval == RLESC3:
            run = int.from_bytes(buf[p + 1 : p + 4], "little")
            num += run
            p += 4
        elif sval == VLESC2:
            q = int.from_bytes(buf[p + 1 : p + 3], "little", signed=True)
            vals[num] = F32(np.int32(q)) * scalefac
            num += 1
            p += 3
        elif sval == VLESC3:
            q = int.from_bytes(buf[p + 1 : p + 4], "little")
            if q >= 1 << 23:
                q -= 1 << 24
            vals[num] = F32(np.int32(q)) * scalefac
            num += 1
            p += 4
        elif sval == VLESC2_8X:
            q = np.frombuffer(buf[p + 1 : p + 17], dtype="<i2").astype(np.int32)
            vals[num : num + 8] = q.astype(F32) * scalefac
            num += 8
            p += 17
        elif sval == VLESC3_8X:
            raw = np.frombuffer(buf[p + 1 : p + 25], dtype=np.uint8)
            b = raw.reshape(8, 3).astype(np.int32)
            q = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            q = np.where(q >= 1 << 23, q - (1 << 24), q)
            vals[num : num + 8] = q.astype(F32) * scalefac
            num += 8
            p += 25
        elif sval == VLESC4:
            f = np.frombuffer(buf[p + 1 : p + 5], dtype="<f4")[0]
            vals[num] = F32(f) * scalefac
            num += 1
            p += 5
        else:  # pragma: no cover - grammar is total over byte values
            raise ValueError(f"invalid escape code {sval} at byte {p}")
    return vals, p
