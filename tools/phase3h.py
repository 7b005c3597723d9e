#!/usr/bin/env python3
"""Phase 3h of chip_smoke.py alone: the multi-device layer at A, A-local,
B and the unaligned 128^3 volume over four shards on cuda:0 and the
default mesh, the two-process multihost run, `module_tests --quick`, the
integration test at k = 1 and the sharded calls' times, every check of the
phase (about 70 s with the build).

    python3 tools/phase3h.py

Prints the card's name and power limit, the phase's lines, and its
results as one JSON line; exits with another code than 0 on a failed
check or where there is no CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.ops import _kernels, codec, rle_host

    import ab_common  # tools/, the script's own directory

    card = ab_common.card()
    print(card, f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    _kernels.lib()
    rle_host.lib()
    print(f"  built in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    res = cs.phase_3h(torch, cvt, codec, _kernels, torch.device("cuda"), card)
    print(f"  phase 3h {time.perf_counter() - t:.1f} s on {card}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
