"""Plain float32 reference of the conditional UNet1d forward, both
``simple`` paths.

A frozen, functional copy of the published model's equations over a dict
of parameters keyed by the reference PyTorch UNet1d's state_dict names
(channel-first ``(batch, C, length)``; Conv1d weights (out, in, k), Linear
weights (out, in), norm gains (1, C, 1)). It imports nothing of the
program under test: the benchmark makes the weights and hands the same
dict to both sides.

Every product (conv, linear, einsum, matmul) takes its operands through
``pc``, a :class:`~cuda_bench.reference.precision.Precision`: float32 leaves
them as they are (the reference), a lower precision rounds them (the
control). Norms, softmax and elementwise math stay float32.

``int8_mid`` replaces the four mid-block conv weights by their symmetric
per-output-channel int8 quantization, dequantized (the serving path's
``quantize_mid``), derived here from the float32 weights.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .precision import Precision

HEADS = 4
DIM_HEAD = 32
HIDDEN = HEADS * DIM_HEAD
MID_CONVS = tuple(f"mid_block{i}.block{j}.proj.weight" for i in (1, 2) for j in (1, 2))


# ------------------------------------------------------------------------- #
# architecture                                                              #
# ------------------------------------------------------------------------- #


def dims(u: dict):
    """(init_dim, [(d_in, d_out) per level], time_dim, acid, mid_ch, out_dim)."""
    dim = u["dim"]
    mults = list(u["dim_mults"])
    ds = [dim] + [dim * m for m in mults]
    in_out = list(zip(ds[:-1], ds[1:]))
    stride = 2 ** (len(mults) - 1)
    mid_ch = ds[-1] * (u["downsample_dim"] // stride)
    return dim, in_out, dim * 4, dim * 2, mid_ch, u.get("channels", 1)


def param_shapes(u: dict) -> "OrderedDict[str, tuple]":
    """Name -> shape of every parameter of the conditional UNet1d block
    ``u`` (the config's ``UNet1d`` keys), in a fixed order."""
    init_dim, in_out, time_dim, acid, mid_ch, out_dim = dims(u)
    ic = u.get("init_cond_channels") or 1
    mz_c = u.get("attn_cond_channels") or 1
    simple = u.get("simple", True)
    depth = u.get("tfer_depth", 4)
    s: "OrderedDict[str, tuple]" = OrderedDict()

    def conv(name, c_out, c_in, k, bias=True):
        s[f"{name}.weight"] = (c_out, c_in, k)
        if bias:
            s[f"{name}.bias"] = (c_out,)

    def lin(name, c_out, c_in):
        s[f"{name}.weight"] = (c_out, c_in)
        s[f"{name}.bias"] = (c_out,)

    def resnet(name, c_in, c_out, time=True):
        if time:
            lin(f"{name}.mlp.1", 2 * c_out, time_dim)
        conv(f"{name}.block1.proj", c_out, c_in, 3)
        s[f"{name}.block1.norm.g"] = (1, c_out, 1)
        conv(f"{name}.block2.proj", c_out, c_out, 3)
        s[f"{name}.block2.norm.g"] = (1, c_out, 1)
        if c_in != c_out:
            conv(f"{name}.res_conv", c_out, c_in, 1)

    def linattn(name, c):
        s[f"{name}.fn.norm.g"] = (1, c, 1)
        conv(f"{name}.fn.fn.to_qkv", 3 * HIDDEN, c, 1, bias=False)
        conv(f"{name}.fn.fn.to_out.0", c, HIDDEN, 1)
        s[f"{name}.fn.fn.to_out.1.g"] = (1, c, 1)

    def attention(name, c, cond_dim=None, hybrid=False):
        if cond_dim is None or hybrid:
            conv(f"{name}.to_qkv", 3 * HIDDEN, c, 1, bias=False)
        if hybrid:
            conv(f"{name}.to_mid", c, HIDDEN, 1)
        if cond_dim is not None:
            conv(f"{name}.to_qv", 2 * HIDDEN, c, 1, bias=False)
            conv(f"{name}.to_k", HIDDEN, cond_dim, 1, bias=False)
        conv(f"{name}.to_out", c, HIDDEN, 1)

    def transformer(name, c, n_layers, cond_dim=None):
        for i in range(n_layers):
            hybrid = cond_dim is not None and i >= n_layers // 2
            attention(f"{name}.layers.{i}.0", c, cond_dim if hybrid else None, hybrid)
            s[f"{name}.layers.{i}.1.norm.g"] = (1, c, 1)
            s[f"{name}.layers.{i}.1.norm.b"] = (1, c, 1)
            conv(f"{name}.layers.{i}.1.conv1", 2 * c, c, 1)
            conv(f"{name}.layers.{i}.1.conv2", c, 2 * c, 1)

    lin("time_mlp.1", time_dim, u["dim"])
    lin("time_mlp.3", time_dim, time_dim)
    lin("init_cond_proj.to_scale_shift.1", 2 * ic, time_dim)
    conv("init_conv", init_dim, 1 + ic, 7)
    if simple:
        conv("attn_cond_proj.1.0", acid, mz_c, 7)
        conv("attn_cond_proj.1.2", acid, acid, 1)
        cond_dim = acid
    else:
        conv("attn_cond_proj.0.0", acid, 1, 7)
        resnet("attn_cond_proj.0.1", acid, acid, time=False)
        resnet("attn_cond_proj.0.2", acid, acid, time=False)
        linattn("attn_cond_proj.0.3", acid)
        cond_dim = acid * mz_c
        transformer("attn_cond_proj.1", cond_dim, depth // 2)
    for i, (d_in, d_out) in enumerate(in_out):
        resnet(f"downs.{i}.0", d_in, d_in)
        resnet(f"downs.{i}.1", d_in, d_in)
        linattn(f"downs.{i}.2", d_in)
        conv(f"downs.{i}.3", d_out, d_in, 3 if i == len(in_out) - 1 else 4)
    resnet("mid_block1", mid_ch, mid_ch)
    s["mid_attn.fn.norm.g"] = (1, mid_ch, 1)
    if simple:
        attention("mid_attn.fn.fn", mid_ch, cond_dim)
    else:
        transformer("mid_attn.fn.fn", mid_ch, depth, cond_dim)
    resnet("mid_block2", mid_ch, mid_ch)
    for j, (d_in, d_out) in enumerate(reversed(in_out)):
        last = j == len(in_out) - 1
        resnet(f"ups.{j}.0", d_out + d_in, d_out)
        resnet(f"ups.{j}.1", d_out + d_in, d_out)
        linattn(f"ups.{j}.2", d_out)
        conv(f"ups.{j}.3" if last else f"ups.{j}.3.1", d_in, d_out, 3)
    resnet("final_res_block", 2 * init_dim, init_dim)
    conv("final_conv", out_dim, init_dim, 1)
    return s


def quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel int8 of a conv weight (out, in, k),
    dequantized: ``round_half_even(w / s) * s``, s = max(absmax / 127,
    1e-12) over each output channel, clamped to [-127, 127]."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=(1, 2), keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w32 / s), -127, 127) * s


def int8_params(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``P`` with the four mid-block conv weights int8-quantized."""
    return {**P, **{n: quantize_int8(P[n]) for n in MID_CONVS}}


# ------------------------------------------------------------------------- #
# layers                                                                    #
# ------------------------------------------------------------------------- #


def conv1d(pc: Precision, x, w, b=None, stride=1, padding=0):
    return F.conv1d(pc(x), pc(w), b, stride=stride, padding=padding)


def conv1x1(pc: Precision, x, w, b=None):
    """A 1x1 conv as the product ``W @ x`` over (b, C_in, n)."""
    y = torch.matmul(pc(w[:, :, 0]), pc(x))
    return y if b is None else y + b[:, None]


def linear(pc: Precision, x, w, b):
    return F.linear(pc(x), pc(w), b)


def rmsnorm(x, g):
    """x / max(||x||_C, 1e-12) * g * sqrt(C) over dim 1."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12) * g.reshape(1, -1, 1) * (x.shape[1] ** 0.5)


def layernorm(x, g, b, eps=1e-5):
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g.reshape(1, -1, 1) + b.reshape(1, -1, 1)


def time_embedding(pc, P, u, time):
    half = u["dim"] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=time.device)
                      * -(math.log(u.get("sinusoidal_pos_emb_theta", 10000.0)) / (half - 1)))
    args = time.float()[:, None] * freqs[None, :]
    t = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    t = F.gelu(linear(pc, t, P["time_mlp.1.weight"], P["time_mlp.1.bias"]))
    return linear(pc, t, P["time_mlp.3.weight"], P["time_mlp.3.bias"])


def resnet_block(pc, P, name, x, t=None):
    """Two conv3 -> RMSNorm (-> FiLM from ``t``) -> SiLU blocks plus the
    residual (a 1x1 conv where the widths differ); ``t`` one time-embedding
    row per row of x."""
    scale = shift = None
    if t is not None and f"{name}.mlp.1.weight" in P:
        ss = linear(pc, F.silu(t), P[f"{name}.mlp.1.weight"], P[f"{name}.mlp.1.bias"])
        scale, shift = ss[:, :, None].chunk(2, dim=1)
    h = rmsnorm(conv1d(pc, x, P[f"{name}.block1.proj.weight"], P[f"{name}.block1.proj.bias"],
                       padding=1), P[f"{name}.block1.norm.g"])
    if scale is not None:
        h = h * (scale + 1.0) + shift
    h = F.silu(h)
    h = F.silu(rmsnorm(conv1d(pc, h, P[f"{name}.block2.proj.weight"],
                              P[f"{name}.block2.proj.bias"], padding=1),
                       P[f"{name}.block2.norm.g"]))
    if f"{name}.res_conv.weight" in P:
        return h + conv1d(pc, x, P[f"{name}.res_conv.weight"], P[f"{name}.res_conv.bias"])
    return h + x


def linear_attention(pc, P, name, x):
    """x + RMSNorm(W_out attn(RMSNorm(x)) + b): q softmaxed over each head's
    features (scaled by dim_head^-1/2), k over the sequence."""
    B, C, N = x.shape
    xn = rmsnorm(x, P[f"{name}.fn.norm.g"])
    qkv = torch.einsum("oc,bcn->bon", pc(P[f"{name}.fn.fn.to_qkv.weight"][:, :, 0]), pc(xn))
    q, k, v = (t.reshape(B, HEADS, DIM_HEAD, N) for t in qkv.chunk(3, dim=1))
    q = torch.softmax(q, dim=2) * DIM_HEAD ** -0.5
    k = torch.softmax(k, dim=3)
    ctx = torch.einsum("bhdn,bhen->bhde", pc(k), pc(v))
    out = torch.einsum("bhde,bhdn->bhen", pc(ctx), pc(q)).reshape(B, HIDDEN, N)
    y = torch.einsum("ch,bhn->bcn", pc(P[f"{name}.fn.fn.to_out.0.weight"][:, :, 0]), pc(out))
    y = y + P[f"{name}.fn.fn.to_out.0.bias"][None, :, None]
    return x + rmsnorm(y, P[f"{name}.fn.fn.to_out.1.g"])


def rope(x, rot_dim, theta=10000.0):
    """Rotary embedding of the first ``rot_dim`` features, adjacent pairs
    interleaved; x (..., seq, dim_head)."""
    seq = x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=x.device)
                          / rot_dim)
    freqs = torch.repeat_interleave(
        torch.arange(seq, dtype=torch.float32, device=x.device)[:, None] * inv[None], 2, dim=-1)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    rot = torch.stack([-xr[..., 1::2], xr[..., 0::2]], dim=-1).reshape(xr.shape)
    return torch.cat([xr * torch.cos(freqs) + rot * torch.sin(freqs), xp], dim=-1)


def attend(pc, q, k, v):
    """Softmax attention with RoPE over (b, h*c, n) q and (b, h*c, m) k, v."""
    def heads(t):
        b, hc, n = t.shape
        return t.reshape(b, HEADS, hc // HEADS, n).transpose(2, 3)

    q, k, v = heads(q), heads(k), heads(v)
    q, k = rope(q, DIM_HEAD // 2), rope(k, DIM_HEAD // 2)
    sim = torch.matmul(pc(q), pc(k).transpose(-1, -2)) * DIM_HEAD ** -0.5
    out = torch.matmul(pc(torch.softmax(sim, dim=-1)), pc(v))
    b, h, n, c = out.shape
    return out.transpose(2, 3).reshape(b, h * c, n)


def attention(pc, P, name, x, cond=None):
    """Self attention (``to_qkv``), cross attention (q, v from x; k from
    ``cond``), or the hybrid: self, ``to_mid``, then cross."""
    if f"{name}.to_mid.weight" in P:
        mid = attend(pc, *conv1x1(pc, x, P[f"{name}.to_qkv.weight"]).chunk(3, dim=1))
        x = conv1x1(pc, mid, P[f"{name}.to_mid.weight"], P[f"{name}.to_mid.bias"])
    if f"{name}.to_qv.weight" in P:
        q, v = conv1x1(pc, x, P[f"{name}.to_qv.weight"]).chunk(2, dim=1)
        out = attend(pc, q, conv1x1(pc, cond, P[f"{name}.to_k.weight"]), v)
    else:
        out = attend(pc, *conv1x1(pc, x, P[f"{name}.to_qkv.weight"]).chunk(3, dim=1))
    return conv1x1(pc, out, P[f"{name}.to_out.weight"], P[f"{name}.to_out.bias"])


def transformer(pc, P, name, x, cond=None):
    i = 0
    while f"{name}.layers.{i}.1.conv1.weight" in P:
        x = attention(pc, P, f"{name}.layers.{i}.0", x, cond) + x
        f = f"{name}.layers.{i}.1"
        h = layernorm(x, P[f"{f}.norm.g"], P[f"{f}.norm.b"])
        h = F.gelu(conv1x1(pc, h, P[f"{f}.conv1.weight"], P[f"{f}.conv1.bias"]))
        x = conv1x1(pc, h, P[f"{f}.conv2.weight"], P[f"{f}.conv2.bias"]) + x
        i += 1
    return x


# ------------------------------------------------------------------------- #
# the model                                                                 #
# ------------------------------------------------------------------------- #


def forward(P: Dict[str, torch.Tensor], u: dict, x, time, init_cond, attn_cond,
            pc: Optional[Precision] = None):
    """The denoiser's prediction (b, rt, mz) for x (b, rt, mz), time (b,),
    init_cond like x and attn_cond (b, rt) (the normalized mixture and MS1
    trace)."""
    pc = pc or Precision()
    init_dim, in_out, _, _, mid_ch, out_dim = dims(u)
    b, rt, mz = x.shape
    t = time_embedding(pc, P, u, time)
    t_rows = torch.repeat_interleave(t, rt, dim=0)

    ic = init_cond.reshape(b * rt, -1, mz)
    ss = linear(pc, F.silu(t_rows), P["init_cond_proj.to_scale_shift.1.weight"],
                P["init_cond_proj.to_scale_shift.1.bias"])
    scale, shift = ss[:, :, None].chunk(2, dim=1)
    h = torch.cat([ic * (scale + 1.0) + shift, x.reshape(b * rt, 1, mz)], dim=1)
    h = conv1d(pc, h, P["init_conv.weight"], P["init_conv.bias"], padding=3)
    r = h

    if u.get("simple", True):
        c = attn_cond.reshape(b, rt, -1).transpose(1, 2)
        c = F.gelu(conv1d(pc, c, P["attn_cond_proj.1.0.weight"], P["attn_cond_proj.1.0.bias"],
                          padding=3))
        cond = conv1d(pc, c, P["attn_cond_proj.1.2.weight"], P["attn_cond_proj.1.2.bias"])
    else:
        c = conv1d(pc, attn_cond.reshape(b * rt, 1, -1), P["attn_cond_proj.0.0.weight"],
                   P["attn_cond_proj.0.0.bias"], padding=3)
        c = resnet_block(pc, P, "attn_cond_proj.0.2", resnet_block(pc, P, "attn_cond_proj.0.1", c))
        c = linear_attention(pc, P, "attn_cond_proj.0.3", c)
        cond = transformer(pc, P, "attn_cond_proj.1", c.reshape(b, rt, -1).transpose(1, 2))

    skips = []
    n_levels = len(in_out)
    for i in range(n_levels):
        h = resnet_block(pc, P, f"downs.{i}.0", h, t_rows)
        skips.append(h)
        h = linear_attention(pc, P, f"downs.{i}.2", resnet_block(pc, P, f"downs.{i}.1", h, t_rows))
        skips.append(h)
        last = i == n_levels - 1
        h = conv1d(pc, h, P[f"downs.{i}.3.weight"], P[f"downs.{i}.3.bias"],
                   stride=1 if last else 2, padding=1)

    mid_dim, mzp = h.shape[1], h.shape[2]
    h = h.reshape(b, rt, mid_ch).transpose(1, 2)
    h = resnet_block(pc, P, "mid_block1", h, t)
    hn = rmsnorm(h, P["mid_attn.fn.norm.g"])
    if u.get("simple", True):
        h = attention(pc, P, "mid_attn.fn.fn", hn, cond) + h
    else:
        h = transformer(pc, P, "mid_attn.fn.fn", hn, cond) + h
    h = resnet_block(pc, P, "mid_block2", h, t)
    h = h.transpose(1, 2).reshape(b * rt, mid_dim, mzp)

    for j in range(n_levels):
        h = resnet_block(pc, P, f"ups.{j}.0", torch.cat([h, skips.pop()], dim=1), t_rows)
        h = resnet_block(pc, P, f"ups.{j}.1", torch.cat([h, skips.pop()], dim=1), t_rows)
        h = linear_attention(pc, P, f"ups.{j}.2", h)
        if j < n_levels - 1:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = conv1d(pc, h, P[f"ups.{j}.3.1.weight"], P[f"ups.{j}.3.1.bias"], padding=1)
        else:
            h = conv1d(pc, h, P[f"ups.{j}.3.weight"], P[f"ups.{j}.3.bias"], padding=1)

    h = resnet_block(pc, P, "final_res_block", torch.cat([h, r], dim=1), t_rows)
    h = conv1d(pc, h, P["final_conv.weight"], P["final_conv.bias"])
    return h.reshape(b, rt * out_dim, mz)
