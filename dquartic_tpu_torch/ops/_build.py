"""Build, load and call the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The build happens at
the first kernel launch, never at import, into
``dquartic_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises with the compiler's output.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # device code optimized in parallel threads within a source: halves the
    # build (163.4 s -> 78.9 s on 8 cores, the same library size), whose end
    # waits on the largest sources (linear_attention_bwd.cu, fused_resnet_bwd.cu)
    "--split-compile=0",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# w_qkv, w_out (a pointer and two strides each), b_out, g, g_pre (a pointer
# and a stride each): the five weights, or their gradients
_WEIGHTS = ([_P] + [_L] * 2) * 2 + [_P, _L] * 3
# C signatures of the entry points in csrc/ (argtypes, restype int).
_SIGNATURES = {
    # x, y, w_qkv, its (c, h) strides, w_out, its (h, c) strides, b_out,
    # stride, g, stride, g_pre, stride, B, C, N, heads, w_bf16, x_bf16,
    # device, stream
    "dq_linear_attention": ([_P] * 3 + [_L] * 2 + [_P] + [_L] * 2 + [_P, _L] * 3
                            + [_I] * 7 + [_P]),
    # C, N, heads, bf16, out (3 ints: CTAs per cluster, staged, smem bytes)
    "dq_linear_attention_plan": [_I] * 4 + [_P],
    # x, out, then w1, b1, g1, scale, shift, w2, b2, g2, w_res, b_res, each
    # a pointer and its strides (3, 1, 1, 2, 2, 3, 1, 1, 2, 1 of them),
    # B, C_in, C_out, N, flags, dtype bits, x_bf16, device, stream
    "dq_fused_resnet": ([_P] * 2 + sum(([_P] + [_L] * n for n in (3, 1, 1, 2, 2, 3, 1, 1, 2, 1)), [])
                        + [_I] * 8 + [_P]),
    # x, w_q, scale, part, out, M, K, N, ksplit, kchunk, bf16, device, stream
    "dq_int8_matmul": [_P] * 5 + [_I] * 7 + [_P],
    # x, dy, dx, then w_qkv, w_out, b_out, g, g_pre and their gradients, each
    # a pointer and its strides (2, 2, 1, 1, 1), rowpart, ctapart, B, C, N,
    # heads, w_bf16, g_bf16, x_bf16, device, stream
    "dq_linear_attention_bwd": ([_P] * 3 + ([_P] + [_L] * 2) * 2 + [_P, _L] * 3
                                + ([_P] + [_L] * 2) * 2 + [_P, _L] * 3 + [_P] * 2
                                + [_I] * 8 + [_P]),
    # B, C, N, heads, bf16, device, out (3 ints: CTAs per cluster, staged, smem bytes)
    "dq_linear_attention_bwd_plan": [_I] * 6 + [_P],
    # x, dy, dx, then the ten operands of dq_fused_resnet and their
    # gradients, each a pointer and its strides, part, B, C_in, C_out, N,
    # flags, dtype bits, gradient dtype bits, x_bf16, device, stream
    "dq_fused_resnet_bwd": ([_P] * 3 + sum(([_P] + [_L] * n for n in (3, 1, 1, 2, 2, 3, 1, 1, 2, 1)), []) * 2
                            + [_P] + [_I] * 9 + [_P]),
    # q, k, v, out, out32, stats, BH, n, m, scale, bf16, device, stream
    "dq_flash_attention": [_P] * 6 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
    # q, k, v, o (float32), stats ((m, l) float32 pairs), dO, dq, dk, dv, BH,
    # n, m, scale, bf16, cluster (CTAs of the one cluster launch, 0: two
    # launches), device, stream
    "dq_flash_attention_bwd": [_P] * 9 + [_I] * 3 + [_F] + [_I] * 3 + [_P],
    # x, y, x's and y's (b, n, c) strides, then w_qkv, w_out, b_out, g as
    # dq_linear_attention takes them, B, C, N, heads, w_bf16, x_bf16,
    # device, stream
    "dq_linear_attention_rows_fused": ([_P] * 2 + [_L] * 6 + ([_P] + [_L] * 2) * 2 + [_P, _L] * 2
                                       + [_I] * 7 + [_P]),
    # the arguments of dq_linear_attention_rows_fused with m, the rows' M
    # between K9's two launches, after the weights
    "dq_linear_attention_rows": ([_P] * 2 + [_L] * 6 + ([_P] + [_L] * 2) * 2 + [_P, _L] * 2
                                 + [_P] + [_I] * 7 + [_P]),
    # x, w_qkv, its (c, h) strides, g_pre, its stride, stats, B, C, N, heads,
    # w_bf16, round, x_bf16, device, stream
    "dq_linear_attention_sp_stats": [_P] * 2 + [_L] * 2 + [_P, _L, _P] + [_I] * 8 + [_P],
    # x, y, stats, the five weights as dq_linear_attention takes them, B, C,
    # N, heads, w_bf16, x_bf16, device, stream
    "dq_linear_attention_sp_apply": [_P] * 3 + _WEIGHTS + [_I] * 7 + [_P],
    # x, dy, the five weights as dq_linear_attention takes them, stats, z,
    # rowpart, B, C, N, heads, w_bf16, x_bf16, device, stream
    "dq_linear_attention_sp_bwd_z": [_P] * 2 + _WEIGHTS + [_P] * 3 + [_I] * 7 + [_P],
    # x, dy, dx, the five weights and their gradients, stats, stats_local, z,
    # rowpart, ctapart, B, C, N, heads, w_bf16, g_bf16, x_bf16, device, stream
    "dq_linear_attention_sp_bwd_x": [_P] * 3 + _WEIGHTS * 2 + [_P] * 5 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of dquartic_tpu_torch are built from csrc/ at first use"
        )
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_DIR / f"libdquartic_kernels_{_source_hash()}.so"


def _check_proc(proc: subprocess.Popen, cmd) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    return err


def _compile(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"obj_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    objs = [objdir / f"{src.stem}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, sources())]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        logs = [_check_proc(proc, cmd) for proc, cmd in zip(procs, cmds)]
    finally:
        for proc in procs:  # stop the other compiles when one fails
            proc.kill()
            proc.wait()
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    _check_proc(subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True), link)
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    shutil.rmtree(objdir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_of(t) -> int:
    """The raw handle of the current stream of ``t``'s device (PyTorch's own
    accessor, without building a ``torch.cuda.Stream`` on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_no_grad(op: str, *tensors) -> None:
    """Refuse a call autograd would track, for a kernel that is inference
    only and has no backward (K3, as in JAX)."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward only (no backward kernel); run it under "
            "torch.no_grad() or torch.inference_mode()"
        )
