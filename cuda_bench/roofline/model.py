"""The UNet1d's kernel calls and FLOPs, from the configuration alone.

Per forward of ``b`` windows of ``rt`` rows (``rows = b * rt`` for the
per-row kernels):

* K1 (linear attention, ``linear_attn_impl`` "pallas_t") at the 14 mixers
  of the down/up path, and with ``simple: false`` the MS1 tower's mixer
  over its ``attn_cond_channels`` columns: :func:`mixers`;
* K2 (the fused ResnetBlock, ``fused_resnet``) at the 29 row blocks:
  :func:`row_blocks`;
* K3 (int8 weights, ``quantize_mid``) at the four mid convs, an im2col
  product of (rows, 3 C) by (3 C, C): :func:`mid_convs`;
* K7a (flash attention over RT) at the bottleneck's attention: one cross
  attention with ``simple: true``; with ``simple: false`` the tower's
  ``tfer_depth // 2`` self attentions and the mid transformer's
  ``tfer_depth`` layers, the second half hybrid (two attentions):
  :func:`attentions`.

A training step runs each backward once: K4 for each K1 call, K5 for each
K2 call, K7b for each K7a call.

:func:`forward_flops` counts every product of the forward (conv, linear,
matmul, einsum, attention) as ``torch.utils.flop_counter`` counts the
plain reference's; elementwise math, norms and softmax are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

from . import PEAK_INT8, bound_s

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD


def _dims(u: dict):
    dim = u["dim"]
    ds = [dim] + [dim * m for m in u["dim_mults"]]
    in_out = list(zip(ds[:-1], ds[1:]))
    stride = 2 ** (len(in_out) - 1)
    mid_ch = ds[-1] * (u["downsample_dim"] // stride)
    return dim, in_out, mid_ch


def _lengths(u: dict) -> List[int]:
    mz = u["downsample_dim"]
    return [mz // 2 ** i for i in range(len(u["dim_mults"]))]


def mixers(u: dict) -> List[Tuple[int, int]]:
    """(C, N) of each K1 call of a forward."""
    _, in_out, _ = _dims(u)
    ns = _lengths(u)
    out = [(d_in, ns[i]) for i, (d_in, _) in enumerate(in_out)]
    out += [(d_out, ns[len(in_out) - 1 - j]) for j, (_, d_out) in enumerate(reversed(in_out))]
    if not u.get("simple", True):
        out.append((u["dim"] * 2, u.get("attn_cond_channels") or 1))
    return out


def row_blocks(u: dict) -> List[Tuple[int, int, int]]:
    """(C_in, C_out, N) of each K2 call of a forward."""
    init_dim, in_out, _ = _dims(u)
    ns = _lengths(u)
    out = []
    for i, (d_in, _) in enumerate(in_out):
        out += [(d_in, d_in, ns[i])] * 2
    for j, (d_in, d_out) in enumerate(reversed(in_out)):
        out += [(d_out + d_in, d_out, ns[len(in_out) - 1 - j])] * 2
    out.append((2 * init_dim, init_dim, ns[0]))
    return out


def mid_convs(u: dict) -> List[Tuple[int, int]]:
    """(K, N) of each K3 call of a forward (M is the rows)."""
    _, _, mid_ch = _dims(u)
    return [(3 * mid_ch, mid_ch)] * 4


def attentions(u: dict) -> int:
    """K7a calls of a forward, each (b, HEADS, rt, rt, DIM_HEAD)."""
    if u.get("simple", True):
        return 1
    depth = u.get("tfer_depth", 4)
    return depth // 2 + depth // 2 + 2 * (depth - depth // 2)


# ------------------------------------------------------------------------- #
# operations and bytes of each call                                         #
# ------------------------------------------------------------------------- #


def linattn_flops(rows: int, c: int, n: int) -> float:
    """qkv projection, context, apply and out projection."""
    return 2.0 * rows * n * (4 * HIDDEN * c + 2 * HIDDEN * DIM_HEAD)


def k1(rows, c, n, item=2):
    nbytes = 2 * rows * c * n * item + 4 * HIDDEN * c * item + c * (item + 8)
    return nbytes, linattn_flops(rows, c, n)


def k4(rows, c, n, item=2):
    """x and dy in, dx out; the weights in, their float32 gradients out;
    the forward recomputed from x and its products differentiated twice."""
    nbytes = 3 * rows * c * n * item + 4 * HIDDEN * c * (item + 4) + c * (item + 8 + 12)
    return nbytes, 3 * linattn_flops(rows, c, n)


def resnet_macs(c_in: int, c_out: int) -> int:
    return 3 * c_in * c_out + 3 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)


def _resnet_weights(c_in, c_out):
    return resnet_macs(c_in, c_out) + 3 * c_out + (c_out if c_in != c_out else 0)


def k2(rows, c_in, c_out, n, item=2, w_item=2):
    nbytes = rows * (c_in + c_out) * n * item + _resnet_weights(c_in, c_out) * w_item \
        + 2 * rows * c_out * item
    return nbytes, 2.0 * rows * n * resnet_macs(c_in, c_out)


def k5(rows, c_in, c_out, n, item=2, w_item=4):
    nbytes = rows * (2 * c_in + c_out) * n * item + _resnet_weights(c_in, c_out) * (w_item + 4) \
        + 2 * rows * c_out * (item + 4)
    return nbytes, 3 * 2.0 * rows * n * resnet_macs(c_in, c_out)


def k3(m, k, n, item=2):
    return m * k * item + k * n + 4 * n + m * n * item, 2.0 * m * k * n


def k7a(b, n, m, item=2):
    return b * HEADS * (2 * n + 2 * m) * DIM_HEAD * item, 4.0 * b * HEADS * n * m * DIM_HEAD


def k7b(b, n, m, item=2):
    """q, k, v and dO in, o and the logsumexp in float32, dq, dk, dv out;
    five products (S again, dV, dP, dQ, dK)."""
    nbytes = b * HEADS * (n + 2 * m + n) * DIM_HEAD * item + 4 * b * HEADS * n * (DIM_HEAD + 1) \
        + b * HEADS * (n + 2 * m) * DIM_HEAD * item
    return nbytes, 10.0 * b * HEADS * n * m * DIM_HEAD


def bound_per_forward(kernel: str, u: dict, b: int, rt: int, train: bool = False) -> float:
    """Seconds of the bounds of one forward's (or, for a backward kernel,
    one backward's) calls of ``kernel``, summed."""
    rows = b * rt
    w_item = 4 if train else 2
    if kernel == "k1":
        return sum(bound_s(*k1(rows, c, n)) for c, n in mixers(u))
    if kernel == "k4":
        return sum(bound_s(*k4(rows, c, n)) for c, n in mixers(u))
    if kernel == "k2":
        return sum(bound_s(*k2(rows, ci, co, n, w_item=w_item)) for ci, co, n in row_blocks(u))
    if kernel == "k5":
        return sum(bound_s(*k5(rows, ci, co, n, w_item=w_item)) for ci, co, n in row_blocks(u))
    if kernel == "k3":
        return sum(bound_s(*k3(rows, k, n), PEAK_INT8) for k, n in mid_convs(u))
    if kernel == "k7a":
        return attentions(u) * bound_s(*k7a(b, rt, rt))
    if kernel == "k7b":
        return attentions(u) * bound_s(*k7b(b, rt, rt))
    raise ValueError(f"unknown kernel {kernel!r}")


def calls_per_forward(kernel: str, u: dict) -> int:
    return {"k1": len(mixers(u)), "k4": len(mixers(u)), "k2": len(row_blocks(u)),
            "k5": len(row_blocks(u)), "k3": len(mid_convs(u)), "k7a": attentions(u),
            "k7b": attentions(u)}[kernel]


# ------------------------------------------------------------------------- #
# model FLOPs                                                               #
# ------------------------------------------------------------------------- #


def forward_flops(u: dict, b: int, rt: int) -> float:
    """FLOPs of one forward of ``b`` windows of ``rt`` RT rows."""
    init_dim, in_out, mid_ch = _dims(u)
    dim = u["dim"]
    time_dim, acid = 4 * dim, 2 * dim
    ic = u.get("init_cond_channels") or 1
    mz_c = u.get("attn_cond_channels") or 1
    ns = _lengths(u)
    rows = b * rt
    mz = ns[0]

    def resnet(r, c_in, c_out, n, t_rows):
        film = 2.0 * t_rows * time_dim * 2 * c_out if t_rows else 0.0
        return film + 2.0 * r * n * resnet_macs(c_in, c_out)

    def attend(n):
        return 4.0 * b * HEADS * n * n * DIM_HEAD

    def transformer(c, depth, cond_dim=None):
        f = 0.0
        for i in range(depth):
            hybrid = cond_dim is not None and i >= depth // 2
            f += 2.0 * b * rt * 3 * HIDDEN * c + attend(rt) + 2.0 * b * rt * c * HIDDEN
            if hybrid:
                f += 2.0 * b * rt * c * HIDDEN  # to_mid
                f += 2.0 * b * rt * 2 * HIDDEN * c + 2.0 * b * rt * HIDDEN * cond_dim + attend(rt)
            f += 2 * 2.0 * b * rt * 2 * c * c  # the feed-forward's two 1x1 convs
        return f

    f = 2.0 * b * (dim * time_dim + time_dim * time_dim)
    f += 2.0 * rows * time_dim * 2 * ic
    f += 2.0 * rows * mz * init_dim * (1 + ic) * 7
    if u.get("simple", True):
        f += 2.0 * b * rt * acid * mz_c * 7 + 2.0 * b * rt * acid * acid
        cond_dim = acid
    else:
        cond_dim = acid * mz_c
        f += 2.0 * rows * mz_c * acid * 7
        f += 2 * resnet(rows, acid, acid, mz_c, None)
        f += linattn_flops(rows, acid, mz_c)
        f += transformer(cond_dim, u.get("tfer_depth", 4) // 2)
    n_levels = len(in_out)
    for i, (d_in, d_out) in enumerate(in_out):
        n = ns[i]
        f += 2 * resnet(rows, d_in, d_in, n, rows) + linattn_flops(rows, d_in, n)
        if i == n_levels - 1:
            f += 2.0 * rows * n * d_out * d_in * 3
        else:
            f += 2.0 * rows * (n // 2) * d_out * d_in * 4
    f += 2 * resnet(b, mid_ch, mid_ch, rt, b)
    if u.get("simple", True):
        f += 2.0 * b * rt * 2 * HIDDEN * mid_ch + 2.0 * b * rt * HIDDEN * cond_dim + attend(rt)
        f += 2.0 * b * rt * mid_ch * HIDDEN
    else:
        f += transformer(mid_ch, u.get("tfer_depth", 4), cond_dim)
    for j, (d_in, d_out) in enumerate(reversed(in_out)):
        n = ns[n_levels - 1 - j]
        f += 2 * resnet(rows, d_out + d_in, d_out, n, rows) + linattn_flops(rows, d_out, n)
        up = 2 * n if j < n_levels - 1 else n
        f += 2.0 * rows * up * d_in * d_out * 3
    f += resnet(rows, 2 * init_dim, init_dim, mz, rows)
    f += 2.0 * rows * mz * (u.get("channels", 1)) * init_dim
    return f

