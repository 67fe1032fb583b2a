"""srla_tpu — JAX lossless audio codec, bit-compatible with SRLA .srl.

Layers:
  - constants/format/bitio/huffman/rice/fletcher: stream format
  - dsp/: analysis & filter math (host-exact f64 reference + batched int paths)
  - encoder/decoder: block pipelines (batched over blocks)
  - kernels/: JAX/Pallas device paths
  - cli: `srla`-compatible command line tool
"""

# NOTE: importing this package must NOT import jax.  The persistent XLA
# compilation cache is configured in srla_tpu/kernels/__init__.py, which
# every device code path imports before tracing; pure-host usage
# (backend="exact"/"native") stays jax-free and never starts the jax
# runtime.

from .decoder import decode
from .encoder import encode

__all__ = ["encode", "decode"]
__version__ = "0.1.0"
