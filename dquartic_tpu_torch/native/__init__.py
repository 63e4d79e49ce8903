"""Native (C++) host-side components, loaded via ctypes: a copy of
:mod:`dquartic_tpu.native` (the port imports nothing of the JAX package).

The shared library is built on first use with the system toolchain (g++,
zlib); everything degrades gracefully to pure-Python fallbacks when no
compiler is available. See decode.cpp for the decoder itself.
"""

from .loader import get_library, native_available
from .decode import decode_batch, decode_one

__all__ = ["get_library", "native_available", "decode_batch", "decode_one"]
