"""Single-file checkpointing with auto-resume (port of
:mod:`dquartic_tpu.train.checkpoint`).

The same file names as the JAX package: a "latest" checkpoint named
``dquartic_latest_checkpoint.ckpt`` next to the configured best-model path,
written every epoch, plus the best-loss file; training auto-resumes from
the latest file. The format is ``torch.save`` of ``{epoch, best_loss,
step, params, opt_state, ema_params}`` (``params`` the model's
state_dict, ``ema_params`` keyed by parameter name), written atomically
through a ``.tmp`` file and ``os.replace``: the port's files are
``torch.save`` files under the JAX names, whatever the JAX package would
write there. This is the backend of ``tpu.checkpoint_backend =
"msgpack"`` (the default); ``"orbax"`` selects the async sharded one,
:mod:`~dquartic_tpu_torch.train.async_ckpt`, which only the trainer's
resume reads.

:func:`load_checkpoint` also reads the JAX package's files, flax msgpack
of ``{epoch, best_loss, state: {step, params, opt_state, ema_params}}``,
telling the two apart by their first bytes (a ``torch.save`` file is a zip
archive). The port needs no ``msgpack`` package (a CUDA host may lack
it): :func:`read_msgpack` is a decoder of its own for maps, arrays, str, bin, ext,
ints, floats, nil and bool, with flax's extensions 1 (an ndarray: the
msgpack of (shape, dtype name, bytes)) and 3 (a numpy scalar), and flax's
chunked arrays (``{"__msgpack_chunked_array__": True, "shape", "chunks"}``,
its form of an array over 2^30 bytes). Arrays are views of the file's
bytes, read once; a ``bfloat16`` array, which numpy has no dtype for, is a
``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

LATEST_NAME = "dquartic_latest_checkpoint.ckpt"


def latest_path_for(checkpoint_path: str) -> str:
    """``<dirname(checkpoint_path)>/dquartic_latest_checkpoint.ckpt``."""
    d = os.path.dirname(checkpoint_path)
    return os.path.join(d, LATEST_NAME) if d else LATEST_NAME


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomically write a checkpoint file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# flax's msgpack extension types (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_ZIP_MAGIC = b"PK\x03\x04"


class _MsgpackReader:
    """Decodes msgpack from a buffer; bin and ext payloads are memoryviews
    of it, never copies."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self._take(self._unpack((">B", ">H", ">I")[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self._unpack((">H", ">I")[b - 0xDC]))
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack((">H", ">I")[b - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is never written")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension {code} is not read (flax writes 1 and 3 for "
                             "arrays and numpy scalars; 2, a complex number, has no use here)")
        shape, dtype, payload = _MsgpackReader(data).read()
        dtype = str(dtype, "utf-8") if isinstance(dtype, memoryview) else dtype
        if dtype == "bfloat16":  # no numpy dtype: the bits as uint16, viewed as bf16
            bits = np.require(np.frombuffer(payload, np.uint16), requirements=["A"])
            arr = torch.from_numpy(bits.reshape(shape))
            arr = arr.view(torch.bfloat16)
            return arr.reshape(()) if code == _EXT_NPSCALAR else arr
        arr = np.frombuffer(payload, np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """flax ``_unchunk_array_leaves_in_place``: a chunked array back into
    one array of its shape."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(data) -> Any:
    """Decode flax msgpack bytes (``flax.serialization.msgpack_restore``):
    dicts, lists, numbers, strings, numpy arrays and scalars, and
    ``torch.bfloat16`` tensors for bfloat16 arrays."""
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


def read_jax_checkpoint(path: str) -> Any:
    """The raw tree of a JAX package checkpoint file. The file is read
    once into a writable buffer that the arrays view."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return read_msgpack(buf)


def _is_torch_checkpoint(path: str) -> bool:
    """A ``torch.save`` file (a zip archive), not a JAX msgpack one."""
    with open(path, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def load_checkpoint(path: str, map_location=None) -> Optional[Dict[str, Any]]:
    """Load a checkpoint in the port's form (tensors, numbers and dicts
    only), or None when the file does not exist. A JAX package file is
    mapped onto the port's names and layouts by
    :func:`~dquartic_tpu_torch.compat.jax_params.jax_checkpoint_to_port`
    and its tensors moved to ``map_location``."""
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, not a checkpoint file: the async sharded checkpoints of "
            "tpu.checkpoint_backend 'orbax' (and the JAX package's Orbax trees) are read only "
            "by the trainer's resume; serve from a msgpack-backend checkpoint file")
    if _is_torch_checkpoint(path):
        return torch.load(path, map_location=map_location, weights_only=True)
    from ..compat.jax_params import jax_checkpoint_to_port

    payload = jax_checkpoint_to_port(read_jax_checkpoint(path))
    return _to_device(payload, map_location)


def _to_device(tree, device):
    if device is None:
        return tree
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def restore_or_init(
    checkpoint_path: str, map_location=None
) -> Tuple[Optional[Dict[str, Any]], int, float, bool]:
    """Auto-resume: ``(payload, epoch, best_loss, resumed)`` from the latest
    checkpoint beside ``checkpoint_path``, or ``(None, 0, inf, False)``.
    ``epoch`` is the last completed epoch of the file."""
    latest = latest_path_for(checkpoint_path)
    ckpt = load_checkpoint(latest, map_location)
    if ckpt is None:
        print(f"No checkpoint ({latest}) found. Starting from scratch.")
        return None, 0, float("inf"), False
    epoch, best_loss = int(ckpt["epoch"]), float(ckpt["best_loss"])
    print(f"Resumed from ({latest}) epoch {epoch}, best loss {best_loss:.6f}")
    return ckpt, epoch, best_loss, True


def checkpoint_params(ckpt: Dict[str, Any], use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The float weights a serving model loads from a checkpoint (the JAX
    ``predict``'s choice): the EMA in place of the trained weights where
    ``use_ema`` is set and the file holds one, else the trained weights.
    An EMA stored as a positional list (the port's files before the EMA was
    keyed by name) follows the order of ``params``: a trainable model has
    no buffers, so its state_dict lists its parameters in their order."""
    params = dict(ckpt["params"])
    ema = ckpt.get("ema_params")
    if not (use_ema and ema):
        return params
    if not isinstance(ema, dict):
        ema = dict(zip(params, ema))
    return {**params, **ema}
