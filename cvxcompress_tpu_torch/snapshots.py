"""Device-resident snapshot store: compressed wavefields that never leave the card.

The PyTorch counterpart of `cvxcompress_tpu/snapshots.py`.  The codec's
production use is RTM: the forward pass compresses a wavefield snapshot
per time step, the backward pass decompresses them in reverse order.  The
wavefield already lives in device memory, so the stack keeps the
compressed snapshots there:

    store = DeviceSnapshotStack(vol_shape, scale, block=(32, 32, 32))
    for step in range(T):
        u = propagate(u)
        store.append(u)            # on the card: encode, quantize, sparsify
    ...
    for step in reversed(range(T)):
        u_hat = store.pop()        # on the card: dequantize, inverse

Representation per snapshot: the SCALED INTEGERS fiv = float(trunc(mulfac
* c)) of the codec's wavelet coefficients c (c * mulfac itself where that
lies outside the int32 range, as the VLESC4 token carries it), in rows of
`rle_device.chunk_cells(cells)` cells; only the chunks holding a value
other than 0 are kept, as (capacity, chunk) f32 rows, with what the
port's inverse kernels read (the TPU stack stored volume-order plane rows
for its lane layout instead):
  * at 32^3 an (nchunks,) int32 map from every chunk to its row (the
    capacity for an all-zero chunk): `fused_inverse.fused_inverse(rows,
    invmap, shape)` takes them directly, as the host engine's decode does;
  * at every other block the (capacity,) int32 ids of the rows' chunks
    (nchunks past the live ones): `get` densifies them with one
    `index_copy_` and runs the codec's inverse (ops/codec.py `_inverse`).
`dense_fiv` is block-major whatever the representation.

The coefficients come from the route's own encode (ops/codec.py `route`:
the kernels `fused_encode` at 32^3, `block_encode` at aligned 128^3,
`stripe_fused_encode` at the fused stripe blocks, which return them beside
the tokens; the stripe route's transform), so the stack's transform is the
codec's.  The mulfac is `quant.global_mulfac` of the volume where it lies
(on the card the f64 sum, one read-back an append), the port codec's own
reduction, where the JAX stack sums in f32 (a deliberate difference,
ROADMAP.md §3).  So `dense_fiv(i)` equals the quantized values of the
port's `compress` of the same tensor exactly; `get(i)` dequantizes as the
decoders do (fiv * (1/mulfac), one f32 rounding, 1/mulfac on the host) and
runs the same inverse, so it equals `decompress(to_container(i),
engine="device")` bit for bit.  What is traded away is the entropy stage's
byte packing, for no host traffic but the mulfac and the live count.

`to_container(i)` / `from_container(data)` convert to and from the byte
container through the host.  The stored values are the exact scaled
integers, so `to_container` re-encodes losslessly: its tokens are those of
`compress` of the same volume (raw-fallback blocks store the dequantized
values), and its header carries the snapshot's mulfac.

Capacity: the rows of a snapshot are a power-of-two bucket of live chunks.
An append compacts against the last known capacity without waiting for
its live count, which comes back by a non-blocking copy into page-locked
memory and an event; it is checked within `max_pending` appends (an
overflow compacts again, at a larger bucket, from the scaled integers kept
until then), so the stack holds at most `max_pending` dense volumes beside
the compressed ones.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from . import container as ctn
from .ops import (
    blocks, codec, fused_compress, fused_inverse, geometry, quant, rle_device,
    rle_host, tokenize, wavelet,
)
from .utils import io

F32 = np.float32


def _bucket(n):
    """The capacity for n live chunks: the next power of two, at least 1."""
    return 1 << max(0, int(n) - 1).bit_length()


def scaled_integers(coeffs, mulfac):
    """fiv of the module doc: float(trunc(c * mulfac)) in f32 (+0.0 for
    every value that quantizes to 0), or c * mulfac where that lies
    outside the int32 range (NaN included)."""
    fv = tokenize.scaled(coeffs, mulfac)
    in_range = (fv >= -2147483648.0) & (fv < 2147483648.0)
    return torch.where(in_range, quant.quantize(fv).to(torch.float32), fv)


class DeviceSnapshotStack:
    """Compressed snapshot sequence held on the card (see the module doc).

    `device` ("cuda" unless the caller names another; "cpu" runs the plain
    versions) is where the snapshots live; any valid block; the global RMS.
    """

    def __init__(self, vol_shape, scale, block=(32, 32, 32), max_pending=2,
                 device=None):
        self.block = geometry.check_block(block)
        self.vol_shape = tuple(int(n) for n in vol_shape)
        self.scale = float(scale)
        self.device = codec._target(device)
        self.cells = math.prod(self.block)
        self.chunk = rle_device.chunk_cells(self.cells)
        self.nnn = math.prod(blocks.grid_shape(self.vol_shape, self.block))
        self.nchunks = self.nnn * (self.cells // self.chunk)
        self._route = codec.route(self.vol_shape, self.block)
        self._invmap = self._route == "fused32"
        self._snaps = []  # [rows, index, mulfac, live count (None until checked)]
        self._cap = None
        self._pending = collections.deque()
        self._max_pending = max(1, int(max_pending))

    def _coefficients(self, t, mulfac):
        """Block-major (nnn, cells) unscaled coefficients of the route."""
        if self._route == "fused32":
            return tokenize.fused_encode(t, mulfac)[0]
        if self._route == "block128":
            return fused_compress.block_encode(t, mulfac)[0]
        if self._route == "stripe_fused":
            return tokenize.stripe_fused_encode(t, self.block, mulfac)[0]
        plane = wavelet.forward_3d_volume(t, self.block)
        return blocks.to_blocks(plane, self.block).view(self.nnn, self.cells)

    def _compact(self, rows, mask, cap):
        """The first `cap` live rows of `rows` (zero past the live count) and
        the representation's index (module doc); no host sync."""
        cs = torch.cumsum(mask, 0)
        want = torch.arange(1, cap + 1, dtype=cs.dtype, device=cs.device)
        ids = torch.searchsorted(cs, want)  # chunk of live row k; nchunks past them
        live = ids < self.nchunks
        packed = rows.index_select(0, ids.clamp(max=self.nchunks - 1))
        packed.masked_fill_(~live[:, None], 0.0)
        if self._invmap:
            index = torch.where(mask, cs - 1, cap)
        else:
            index = ids
        return packed, index.to(torch.int32)

    def append(self, vol):
        """Compress a volume (a tensor, moved to the stack's device if it lies
        elsewhere, or a numpy array) into the stack; returns its index."""
        if isinstance(vol, torch.Tensor):
            t = vol.to(self.device, torch.float32).contiguous()
        else:
            t = torch.from_numpy(np.ascontiguousarray(vol, dtype=F32)).to(self.device)
        if tuple(t.shape) != self.vol_shape:
            raise ValueError(f"volume {tuple(t.shape)} != the stack's {self.vol_shape}")
        with codec.device_guard(self.device):
            mulfac = quant.global_mulfac(t, self.scale)
            rows = scaled_integers(self._coefficients(t, mulfac), mulfac)
            rows = rows.view(self.nchunks, self.chunk)
            mask = (rows != 0).any(1)
            count, ev = codec.fetch(mask.sum().view(1))
            if self._cap is None:
                codec.wait(ev)
                self._cap = _bucket(int(count[0]))
            packed, index = self._compact(rows, mask, self._cap)
        self._snaps.append([packed, index, mulfac, None])
        self._pending.append((len(self._snaps) - 1, count, ev, rows, mask))
        while len(self._pending) > self._max_pending:
            self._validate_one()
        return len(self._snaps) - 1

    def _validate_one(self):
        idx, count, ev, rows, mask = self._pending.popleft()
        codec.wait(ev)
        n = int(count[0])
        snap = self._snaps[idx]
        if n > snap[0].shape[0]:  # capacity overflow: compact again
            self._cap = _bucket(n)
            with codec.device_guard(self.device):
                snap[0], snap[1] = self._compact(rows, mask, self._cap)
        snap[3] = n

    def flush(self):
        """Resolve all pending capacity checks (frees their dense volumes)."""
        while self._pending:
            self._validate_one()

    def __len__(self):
        return len(self._snaps)

    def _dense(self, rows, index):
        """(nchunks, chunk) dense block-major rows from a snapshot's rows."""
        if self._invmap:
            pad = torch.cat([rows, rows.new_zeros((1, self.chunk))])
            return pad[index.to(torch.int64).clamp(max=rows.shape[0])]
        dense = rows.new_zeros((self.nchunks + 1, self.chunk))
        dense.index_copy_(0, index.to(torch.int64), rows)
        return dense[:self.nchunks]

    def get(self, i):
        """Reconstruct snapshot i as a tensor on the stack's device."""
        self.flush()
        rows, index, mulfac, _ = self._snaps[i]
        with codec.device_guard(self.device):
            scalefac = torch.tensor(F32(1.0) / mulfac, device=self.device)
            deq = rows * scalefac
            if self._invmap:
                return fused_inverse.fused_inverse(deq, index, self.vol_shape)
            nz, ny, nx = self.vol_shape
            hdr = ctn.Header(nx, ny, nz, *self.block, mulfac, False)
            return codec._inverse(self._dense(deq, index).view(self.nnn, self.cells),
                                  hdr)

    def pop(self):
        """Reconstruct and release the most recent snapshot (backward pass)."""
        vol = self.get(len(self._snaps) - 1)
        self._snaps.pop()
        return vol

    def nbytes(self):
        """Device memory held by the compressed snapshots."""
        self.flush()
        return sum(4 * (rows.numel() + index.numel()) for rows, index, _, _ in self._snaps)

    def ratio(self):
        """Aggregate compression ratio against raw f32 snapshots."""
        raw = len(self._snaps) * math.prod(self.vol_shape) * 4
        held = self.nbytes()
        return raw / held if held else float("inf")

    # ---------------------------------------------- container conversion

    def dense_fiv(self, i):
        """Snapshot i's scaled integers as a dense BLOCK-MAJOR (nnn, cells)
        f32 host array: the view that does not depend on the
        representation, used by container conversion and tests."""
        self.flush()
        rows, index, _, _ = self._snaps[i]
        with codec.device_guard(self.device):
            dense = self._dense(rows, index)
        return dense.cpu().numpy().reshape(self.nnn, self.cells)

    def to_container(self, i):
        """Snapshot i -> the portable byte container (through the host).

        Lossless: the entropy stage re-encodes the stored scaled integers
        verbatim, so decoding the container on the device engine gives
        `get(i)` bit for bit.  The header carries the snapshot's mulfac.
        """
        nz, ny, nx = self.vol_shape
        return _encode_fiv_container(self.dense_fiv(i), self._snaps[i][2],
                                     (nx, ny, nz), self.block)

    def from_container(self, data):
        """Append a snapshot decoded from a byte container; returns its index.

        The container must be global-RMS with this stack's volume shape and
        block.  Exact for token-coded blocks: the scaled integers come from
        the tokens directly (decoded at mulfac 1.0), so `get` on the new
        snapshot equals `decompress(data, engine="device")` bit for bit.
        Raw-fallback blocks store DEQUANTIZED coefficients that bypass the
        decoder's scalefac (CvxCompress.cpp:552-555); they are multiplied
        back by the header mulfac into scaled integers here, so their
        reconstruction matches `decompress(data)` to one f32 rounding.
        """
        io.validate(data)
        hdr, blkoffs, _, pbase = ctn.unpack(data)
        if hdr.use_local_rms:
            raise ValueError("the snapshot stack holds global-RMS snapshots only")
        if (hdr.nz, hdr.ny, hdr.nx) != self.vol_shape or (
                hdr.bx, hdr.by, hdr.bz) != self.block:
            raise ValueError(f"container {(hdr.nz, hdr.ny, hdr.nx)} in "
                             f"{(hdr.bx, hdr.by, hdr.bz)} blocks, the stack "
                             f"{self.vol_shape} in {self.block}")
        payload = np.frombuffer(memoryview(data), dtype=np.uint8)[pbase:]
        fiv = rle_host.decode_payloads(payload, blkoffs, F32(1.0), self.cells)
        is_raw = np.asarray(blkoffs) < 0
        if is_raw.any():
            fiv[is_raw] = (fiv[is_raw] * F32(hdr.glob_mulfac)).astype(F32)
        rows = fiv.reshape(self.nchunks, self.chunk)
        ids = np.flatnonzero(rows.any(axis=1))
        cap = _bucket(ids.size)
        packed = np.zeros((cap, self.chunk), dtype=F32)
        packed[:ids.size] = rows[ids]
        if self._invmap:
            index = np.full(self.nchunks, cap, dtype=np.int32)
            index[ids] = np.arange(ids.size, dtype=np.int32)
        else:
            index = np.full(cap, self.nchunks, dtype=np.int32)
            index[:ids.size] = ids
        self._snaps.append([torch.from_numpy(packed).to(self.device),
                            torch.from_numpy(index).to(self.device),
                            F32(hdr.glob_mulfac), ids.size])
        return len(self._snaps) - 1


def _encode_fiv_container(fiv, mulfac, dims_xyz, block):
    """Entropy-encode scaled integers (nnn, cells) into a container.

    Encoding runs at mulfac 1.0 (trunc(1.0 * fiv) == fiv exactly) while the
    header records the true mulfac, so decoders reconstruct fiv * (1 /
    mulfac), the snapshot's own dequantization.  Raw-fallback blocks
    (encoded size > 4*cells) store the DEQUANTIZED values, since raw
    payloads bypass the decoder's scalefac (CvxCompress.cpp:552).  The
    native encoder runs where its library builds, else the oracle's.
    """
    nnn, cells = fiv.shape
    try:
        streams, _, raw = rle_host.encode_payloads(fiv, F32(1.0))
    except (RuntimeError, OSError):  # no native library: the oracle's encoder
        from .oracle import rle as orle

        streams = [orle.encode(F32(1.0), row) for row in fiv]
        raw = [len(p) > 4 * cells for p in streams]
    scalefac = F32(1.0) / F32(mulfac)
    payloads = [(fiv[b] * scalefac).astype(F32).tobytes() if raw[b] else streams[b]
                for b in range(nnn)]
    nx, ny, nz = dims_xyz
    hdr = ctn.Header(nx, ny, nz, *block, F32(mulfac), False)
    return ctn.pack(hdr, payloads, raw)
