"""Python surface over the native decoder, with pure-Python fallback.

``decode_batch(blobs, compressions)`` decodes a list of sqMass DATA
blobs (zlib-compressed little-endian float64) into numpy arrays — in
parallel C++ threads when the native library is available, else via
zlib/numpy per blob.
"""

from __future__ import annotations

import ctypes
import os
import zlib
from typing import List, Optional, Sequence

import numpy as np

from .loader import get_library


def _py_decode_one(blob: bytes, compression: int) -> Optional[np.ndarray]:
    try:
        raw = zlib.decompress(blob) if compression in (1, 3) else bytes(blob)
        n = len(raw) // 8
        return np.frombuffer(raw[: n * 8], dtype="<f8").copy()
    except Exception:
        return None


def decode_one(blob: bytes, compression: int) -> Optional[np.ndarray]:
    lib = get_library()
    if lib is None:
        return _py_decode_one(blob, compression)
    size = lib.dq_decoded_size(blob, len(blob), compression)
    if size < 0:
        return None
    out = np.empty(size, dtype=np.float64)
    got = lib.dq_decode_one(
        blob, len(blob), compression,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), size,
    )
    if got != size:
        return None
    return out


def decode_batch(
    blobs: Sequence[bytes],
    compressions: Sequence[int],
    num_threads: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """Decode many blobs; returns per-blob float64 arrays (None = corrupt).

    The native path packs all blobs into one buffer, decodes with C++
    threads, and slices the result; any single corrupt blob falls the
    whole batch back to per-blob Python decoding so valid spectra still
    load (matching the reference's skip-on-error behavior,
    raw_data_parser.py:53-55).
    """
    n = len(blobs)
    if n == 0:
        return []
    lib = get_library()
    if lib is None:
        return [_py_decode_one(b, c) for b, c in zip(blobs, compressions)]

    packed = b"".join(bytes(b) for b in blobs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    comps = np.asarray(compressions, dtype=np.int32)

    # capacity guess: zlib on doubles rarely beats 20x; retry on overflow
    cap = max(1024, len(packed) * 24 // 8)
    threads = num_threads or min(8, os.cpu_count() or 1)
    for _ in range(3):
        out = np.empty(cap, dtype=np.float64)
        out_offsets = np.zeros(n + 1, dtype=np.int64)
        total = lib.dq_decode_batch(
            packed,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            comps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
            out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            threads,
        )
        if total >= 0:
            return [
                out[out_offsets[i] : out_offsets[i + 1]].copy() for i in range(n)
            ]
        cap *= 4
    # a corrupt blob (or pathological ratio): per-blob fallback
    return [_py_decode_one(b, c) for b, c in zip(blobs, compressions)]
