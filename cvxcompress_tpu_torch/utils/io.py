"""Structural validation of a container before any decode work.

A numpy copy of `cvxcompress_tpu/utils/io.py:validate`.
"""

from __future__ import annotations

import numpy as np

from .. import container as ctn


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
