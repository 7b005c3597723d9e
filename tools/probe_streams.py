#!/usr/bin/env python3
"""Where the thread streams' time goes: `pipeline.compress_stream` and
`decompress_stream` over 8 volumes of A's shape born on the card, with 1,
2 and 4 worker threads, beside single calls on the default stream and on
one pooled stream from the main thread (host ms a volume, medians of 3).

    python3 tools/probe_streams.py

Prints the card's name and power limit first; exits with another code
than 0 where there is no CUDA card.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch import pipeline
    from cvxcompress_tpu_torch.ops import _kernels

    import ab_common  # tools/, the script's own directory

    card = ab_common.card()
    print(card, flush=True)
    _kernels.lib()
    dev = torch.device("cuda")
    vols = [cs.card_sinusoid(torch, dev, cs.SHAPE, 0.7 * j) for j in range(8)]
    datas = [cvt.compress(v, cs.SCALE)[0] for v in vols]
    pooled = pipeline._streams(dev, 1)[0]

    def on_pooled(fn):
        def run():
            with torch.cuda.stream(pooled):
                out = fn()
            torch.cuda.current_stream().wait_stream(pooled)
            return out
        return run

    runs = {
        "compress single, default stream": lambda: [cvt.compress(v, cs.SCALE) for v in vols],
        "compress single, a pooled stream": on_pooled(
            lambda: [cvt.compress(v, cs.SCALE) for v in vols]),
        "decompress single, default stream": lambda: [cvt.decompress(d) for d in datas],
        "decompress single, a pooled stream": on_pooled(
            lambda: [cvt.decompress(d) for d in datas]),
    }
    for w in (1, 2, 4):
        runs[f"compress_stream workers={w}"] = (
            lambda w=w: list(pipeline.compress_stream(iter(vols), cs.SCALE, workers=w)))
        runs[f"decompress_stream workers={w}"] = (
            lambda w=w: list(pipeline.decompress_stream(iter(datas), workers=w)))
    for tag, fn in runs.items():
        fn()  # warm: the pooled streams' buffers
        torch.cuda.synchronize()
        med, times = cs.wall_ms(lambda: (fn(), torch.cuda.synchronize()), 3)
        print(f"  {tag}: {med / 8:.3f} ms a volume (runs of 8: "
              f"{[round(x, 2) for x in times]} ms) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
