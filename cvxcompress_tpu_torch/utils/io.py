"""Container file IO: the compressed container IS the persistence format.

A numpy copy of `cvxcompress_tpu/utils/io.py`.  The reference has no
in-library checkpointing: its benchmark CLIs fwrite the container to disk
(Test_Compression.cpp:201-207).  These helpers make that a first-class
operation, plus validated loading.
"""

from __future__ import annotations

import numpy as np

from .. import container as ctn


def save(path, data):
    """Write a compressed container to disk."""
    np.asarray(data, dtype=np.uint8).tofile(path)


def validate(data):
    """Structural validation of a container; returns the parsed Header.

    Raises ValueError for corrupt headers, truncated offset tables, payload
    areas too short for the recorded block offsets, or raw-block payloads
    whose full 4*cells extent does not fit.  (RLE payload extents are only
    knowable by decoding; the native decoder is buffer-bounded and rejects
    overruns — this pre-check catches structural damage early.)

    Offsets are NOT required to be monotone: the reference emits payloads
    in thread-completion order (CvxCompress.cpp:370-374).
    """
    data = np.asarray(data, dtype=np.uint8)
    hdr, blkoffs, _, payload_base = ctn.unpack(data)
    avail = int(data.size) - payload_base - ctn.SLACK_BYTES
    blkoffs = np.asarray(blkoffs)
    is_raw = blkoffs < 0
    plain = blkoffs & ~ctn.RAW_FLAG
    cells = hdr.bx * hdr.by * hdr.bz
    # every block needs at least 1 payload byte; raw blocks exactly 4*cells
    reach = np.where(is_raw, plain + 4 * cells, plain + 1)
    if avail < 0 or (reach.size and int(reach.max()) > max(avail, 0)):
        raise ValueError(
            f"truncated container: {data.size} bytes, block extents reach "
            f"{int(reach.max()) if reach.size else 0} of {avail}"
        )
    return hdr


def load(path):
    """Read and validate a compressed container; returns the uint8 array.

    Raises ValueError on a corrupt or truncated container.
    """
    data = np.fromfile(path, dtype=np.uint8)
    validate(data)
    return data


def probe(data_or_path):
    """Header summary of a container (or of the file at a path): dims,
    block, mode, sizes, as a dict for CLIs and debugging."""
    if isinstance(data_or_path, (str, bytes)):
        data = np.fromfile(data_or_path, dtype=np.uint8)
    else:
        data = np.asarray(data_or_path, dtype=np.uint8)
    hdr, blkoffs, _, payload_base = ctn.unpack(data)
    ncells = hdr.nx * hdr.ny * hdr.nz
    return {
        "shape_zyx": (hdr.nz, hdr.ny, hdr.nx),
        "block_xyz": (hdr.bx, hdr.by, hdr.bz),
        "blocks": hdr.grid[3],
        "glob_mulfac": float(hdr.glob_mulfac),
        "use_local_rms": hdr.use_local_rms,
        "raw_blocks": int((blkoffs < 0).sum()),
        "container_bytes": int(data.size),
        "payload_bytes": int(data.size - payload_base - ctn.SLACK_BYTES),
        "ratio": ncells * 4 / data.size,
    }
