"""Build + load the native library (a copy of
:mod:`dquartic_tpu.native.loader` that builds elsewhere).

Compiles ``decode.cpp`` into ``dquartic_tpu_torch/_build/libdqnative.so``
on first use (cached thereafter; the source tree stays as it is); returns
None when no toolchain exists so callers can fall back to the Python
decoder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libdqnative.so")
_SRC = os.path.join(_HERE, "decode.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # Compile to a per-pid temp path, then atomically rename: concurrent
    # processes may race to build and must never load a half-written .so.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        _SRC, "-o", tmp, "-lz", "-lpthread",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            # retry without -march=native (portability)
            cmd.remove("-march=native")
            res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dq_decoded_size.restype = ctypes.c_long
    lib.dq_decoded_size.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
    ]
    lib.dq_decode_one.restype = ctypes.c_long
    lib.dq_decode_one.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    lib.dq_decode_batch.restype = ctypes.c_long
    lib.dq_decode_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
    ]
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if necessary; None when
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH) or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            _lib = _bind(ctypes.CDLL(_SO_PATH))
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return get_library() is not None
