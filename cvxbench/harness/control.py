"""The control: the reference put in the program's place, its transforms
computed in bfloat16, the precision below the configuration's float32.

The check has to find it not correct.  It compresses with the reference
codec at `dtype` and decompresses its own containers to the volume that
codec decoded from the same quantized coefficients (the inverse also in
`dtype`), so it needs no token parser.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import torch

from ..reference.codec import Codec


class Control:
    KEEP = 8  # decoded volumes held: two rounds of P = 4

    def __init__(self, config, device, dtype=torch.bfloat16):
        self.codec = Codec(config["shape"], config["block"], config["scale"],
                           config.get("use_local_rms", False), device, dtype)
        self.decoded = OrderedDict()

    @staticmethod
    def _key(data):
        return hashlib.sha1(data.tobytes()).hexdigest()

    def compress(self, vol):
        data, vol_out = self.codec.compress(vol, decode=True)
        self.decoded[self._key(data)] = vol_out
        while len(self.decoded) > self.KEEP:
            self.decoded.popitem(last=False)
        return data

    def decompress(self, data):
        return self.decoded[self._key(data)]
