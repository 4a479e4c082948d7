"""sprintz_jax: lossless time-series compression on JAX accelerators.

A from-scratch JAX/XLA re-design of the Sprintz codec family
(predict -> zigzag -> bitpack -> run-length -> entropy-code) for
multivariate u8/u16 integer streams, with a byte-compatible stream format,
data-parallel multi-chip encode/decode, query pushdown, and an entropy
stage.

Layers:
- ``sprintz_jax.golden``   bit-exact scalar reference codec (executable spec)
- ``sprintz_jax.ops``      vectorized JAX/XLA kernels
- ``sprintz_jax.models``   forecaster state machines (delta family, FIRE, ...)
- ``sprintz_jax.parallel`` mesh/shard_map distributed encode/decode
- ``sprintz_jax.entropy``  Huffman entropy stage
- ``sprintz_jax.query``    fused decode+reduce query pushdown
- ``sprintz_jax.data``     corpus loaders and quantizers
"""

from . import config as config  # noqa: F401  (validates SPRINTZ_* env at import)
from .api import CorruptStreamError, SprintzCodec, compress, decompress  # noqa: F401
from .constants import CodecConfig, DEFAULT_CONFIG  # noqa: F401

__version__ = "0.1.0"
