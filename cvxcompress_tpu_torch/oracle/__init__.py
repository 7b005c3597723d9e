"""NumPy oracle codec: the correctness and format authority.

A numpy copy of `cvxcompress_tpu/oracle/` (codec, rle, wavelet), built on
this package's `container.py`: the JAX package cannot be imported where
there is no jax.  `api.compress(..., backend="oracle")` runs it, and
tests/test_torch_api.py holds its containers byte-equal to the original's.
Slow, obvious, and byte-exact against the grammar.
"""

from . import codec, rle, wavelet  # noqa: F401
from .codec import compress, decompress  # noqa: F401
