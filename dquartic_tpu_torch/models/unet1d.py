"""1-D U-Net denoiser, conditional or not, ``simple=True`` or ``simple=False``.

Port of :class:`dquartic_tpu.models.unet1d.UNet1d`. Per-RT-row activations
stay channel-first ``(b·rt, C, mz')`` from the init conv to the head (the
JAX package's transposed-resident layout; torch convs are channel-first
either way), and the bottleneck pivot and the final head are pure
reshapes. ``fused_resnet`` chooses the down/up and final ResnetBlocks: the
K2 op (``True``) or the plain torch ResnetBlock (``False``, the default,
as in JAX, where these are XLA blocks). ``linear_attn_impl`` chooses every
linear-attention mixer's implementation (the K1 op, the K8 op or the plain
"xla" path; see
:func:`~dquartic_tpu_torch.models.attention.resolve_linear_attn_impl`).
The bottleneck runs channel-first over the RT axis, ``(b, C·mz', rt)``,
where the mid convs are either torch convs or int8 convs on the K3 op.

``activation_sharding=("dp", "sp")`` splits the m/z axis over the ``sp``
process group of the model's ``mesh`` (JAX's sharding constraint on
``(b·rt, mz', C)`` per level, with XLA's partitioning written out; see
:mod:`dquartic_tpu_torch.parallel.sequence`). Every rank calls ``forward``
with the same global inputs and gets the same global output; it computes
its slice of m/z at the levels of :func:`sharded_levels` (convs with
halos, the mixers on the K6 op), and the deeper levels and the bottleneck
in full. After the backward of a loss every rank computes alike, each
parameter's ``.grad`` is the rank's partial, and their sum over the group
is the gradient.

``init_conv`` takes x as one channel a row, whatever ``channels`` is (as
the JAX model reshapes it), plus the init condition's
``init_cond_channels`` when conditional; ``channels`` sets only the
output's width, ``channels · (2 if learned_variance else 1)`` a row.

``conditional=False`` (JAX's unconditional model) has no init condition
(``init_conv`` takes x alone), no MS1 tower, and
self attention at the bottleneck (``to_qkv``; with ``simple=False`` a
``Transformer1d`` of self-attention layers only); its ``forward`` accepts
and ignores ``init_cond`` and ``attn_cond``. ``simple=True`` conditions
on the MS1 trace through two convs over RT and mixes the bottleneck with
one cross attention. ``simple=False`` runs an
MS1 tower over the trace's m/z axis (conv7, two ResnetBlocks without time
embedding, a linear-attention mixer), pivots it channel-major
to ``(b, acid·mz_c, rt)`` and runs a self-attention ``Transformer1d`` of
depth ``tfer_depth // 2`` over RT; the bottleneck mixer is a
``Transformer1d`` of depth ``tfer_depth`` whose second half attends to that
condition. Softmax attention follows ``attn_impl`` (the flash op, K7, under
``"pallas"``).

Module and parameter names are those of the reference PyTorch UNet1d, so
for ``simple=True``
:func:`dquartic_tpu.compat.torch_ckpt.convert_unet1d_state_dict` maps this
module's ``state_dict()`` onto the JAX parameter tree. ``simple=False``
names its MS1 tower as that converter does (``attn_cond_proj.0.{0,1,2,3}``,
then ``attn_cond_proj.1`` for the transformer) and its transformers'
layers ``layers.{i}.0`` (attention) and ``layers.{i}.1`` (feed-forward);
:mod:`dquartic_tpu_torch.compat.jax_params` maps both trees.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, LinearAttentionBlock, PreNorm, Residual, Transformer1d
from .fused_blocks import ResnetBlockT
from ..parallel.sequence import sharded_levels, sp_gather, sp_slice
from ..parallel.sharding import shard_batch
from ..utils import profiling
from .layers import (
    ConditionalScaleShift, Conv1d, Downsample, Linear, ResnetBlock, SinusoidalPosEmb, Upsample,
)


class UNet1d(nn.Module):
    """Constructor arguments mirror the reference (and the JSON configs).
    ``downsample_dim`` is the m/z length the bottleneck is built for;
    a forward at another m/z raises. ``dtype`` is the compute dtype (flax's
    ``dtype``): inputs are cast to it and every conv, linear and kernel
    call casts its parameters to it at use, whatever dtype they are stored
    in. ``remat_blocks`` recomputes ResnetBlocks in the backward
    (``torch.utils.checkpoint``) instead of keeping their activations: the
    two mid blocks, and with ``fused_resnet=False`` every down/up and the
    final block too, as JAX's ``nn.remat(ResnetBlock)`` does;
    ``remat_linear_attn`` recomputes the mixers. The numbers are the same.

    ``dropout`` is accepted with ``fused_resnet=False`` and computes the
    deterministic model, as the JAX model does under its ``Trainer`` and
    ``DDIMSampler``, which never pass ``deterministic=False``; with
    ``fused_resnet=True`` or ``remat_blocks`` a nonzero dropout raises, as
    in JAX.

    ``activation_sharding`` (the JAX mesh axis names ``("dp", "sp")``)
    shards m/z over ``self.mesh``'s ``sp`` group, which the builder, the
    sampler or the trainer sets (``mesh=``); a forward without a mesh
    raises. It excludes ``fused_resnet``, as in JAX. ``kernel_dp_axis``
    names the mesh axis the rows are split over (JAX's row-sharded
    ``shard_map`` kernel variants): under data parallelism each rank runs
    the unchanged kernels on its own rows, so it changes no computation
    here; it excludes ``activation_sharding``, as in JAX.

    Under tensor parallelism (``mesh.tp > 1``) the model's wide leaves are
    split over the ``tp`` group by
    :func:`~dquartic_tpu_torch.parallel.tensor.shard_model` (the builder,
    the trainer or the sampler call it); every rank calls ``forward`` with
    the same inputs and gets the whole output."""

    def __init__(
        self,
        dim: int,
        init_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 3,
        dropout: float = 0.0,
        conditional: bool = True,
        init_cond_channels: Optional[int] = None,
        attn_cond_channels: Optional[int] = None,
        attn_cond_init_dim: Optional[int] = None,
        learned_variance: bool = False,
        sinusoidal_pos_emb_theta: float = 10000.0,
        attn_heads: int = 4,
        attn_dim_head: int = 32,
        tfer_dim_mult: int = 620,
        tfer_depth: int = 4,
        downsample_dim: int = 40000,
        simple: bool = True,
        pos_output_only: bool = False,
        attn_impl: str = "auto",
        linear_attn_impl: str = "auto",
        fused_resnet: bool = False,
        remat_blocks: bool = False,
        remat_linear_attn: bool = False,
        activation_sharding: Optional[Sequence[str]] = None,
        kernel_dp_axis: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if activation_sharding is not None:
            if fused_resnet:
                raise ValueError("fused_resnet is incompatible with activation_sharding")
            if kernel_dp_axis is not None:
                raise ValueError(
                    "kernel_dp_axis is incompatible with activation_sharding (sp partitions "
                    "the m/z axis the kernels own)")
            activation_sharding = tuple(activation_sharding)
            if len(activation_sharding) != 2:
                raise ValueError(f"activation_sharding names (dp, sp) axes, got {activation_sharding}")
        self.kernel_dp_axis = kernel_dp_axis
        self.activation_sharding = activation_sharding
        self.mesh = None  # set by build_model, DDIMSampler or Trainer (mesh=)
        if fused_resnet and dropout > 0:
            raise ValueError(
                "fused_resnet requires dropout == 0 (the fused kernel has no dropout path)")
        if remat_blocks and dropout > 0:
            raise ValueError("remat_blocks requires dropout == 0")
        del tfer_dim_mult  # ignored, as in the JAX package
        self.dim_mults = tuple(dim_mults)
        stride = 2 ** (len(self.dim_mults) - 1)
        if downsample_dim % stride:
            raise ValueError(f"downsample_dim={downsample_dim} is not divisible by {stride}")
        init_dim = init_dim if init_dim is not None else dim
        self.init_dim = init_dim
        self.out_dim = out_dim if out_dim is not None else channels * (2 if learned_variance else 1)
        self.pos_output_only = pos_output_only
        self.simple = simple
        self.conditional = conditional
        self.remat_blocks = remat_blocks
        self.remat_linear_attn = remat_linear_attn
        self.fused_resnet = fused_resnet
        self.compute_dtype = dtype
        time_dim = dim * 4
        dims = [init_dim] + [dim * m for m in self.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        ic = init_cond_channels or 1
        acid = attn_cond_init_dim if attn_cond_init_dim is not None else dim * 2

        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim, sinusoidal_pos_emb_theta),
            Linear(dim, time_dim),
            nn.GELU(),
            Linear(time_dim, time_dim),
        )
        if conditional:
            self.init_cond_proj = ConditionalScaleShift(ic, time_dim)
        # x enters as one channel a row whatever ``channels`` is, as in JAX
        self.init_conv = Conv1d(1 + (ic if conditional else 0), init_dim, 7, padding=3)
        attn = dict(heads=attn_heads, dim_head=attn_dim_head, attn_impl=attn_impl)
        mz_c = attn_cond_channels or 1
        RowBlock = ResnetBlockT if fused_resnet else ResnetBlock
        cond_dim = None  # the unconditional model: self attention at the bottleneck
        if conditional and simple:
            self.attn_cond_proj = nn.Sequential(
                nn.Identity(),  # mz_net of the simple model
                nn.Sequential(
                    Conv1d(mz_c, acid, 7, padding=3),
                    nn.GELU(),
                    Conv1d(acid, acid, 1),
                ),
            )
            cond_dim = acid
        elif conditional:
            cond_dim = acid * mz_c
            self.attn_cond_proj = nn.Sequential(
                nn.Sequential(  # mz_net, over the trace's m/z axis
                    Conv1d(1, acid, 7, padding=3),
                    ResnetBlock(acid, acid),
                    ResnetBlock(acid, acid),
                    LinearAttentionBlock(acid, linear_attn_impl),
                ),
                Transformer1d(cond_dim, depth=tfer_depth // 2, **attn),
            )

        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                RowBlock(d_in, d_in, time_dim),
                RowBlock(d_in, d_in, time_dim),
                LinearAttentionBlock(d_in, linear_attn_impl),
                Conv1d(d_in, d_out, 3, padding=1) if last else Downsample(d_in, d_out),
            ]))

        mid_dim = dims[-1]
        self.mid_ch = mid_dim * (downsample_dim // stride)
        self.mid_block1 = ResnetBlock(self.mid_ch, self.mid_ch, time_dim)
        if simple:
            mixer = Attention(self.mid_ch, cond_dim=cond_dim, **attn)
        else:
            mixer = Transformer1d(self.mid_ch, depth=tfer_depth, use_xattn=conditional,
                                  cond_dim=cond_dim or 1, **attn)
        self.mid_attn = Residual(PreNorm(self.mid_ch, mixer))
        self.mid_block2 = ResnetBlock(self.mid_ch, self.mid_ch, time_dim)

        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                RowBlock(d_out + d_in, d_out, time_dim),
                RowBlock(d_out + d_in, d_out, time_dim),
                LinearAttentionBlock(d_out, linear_attn_impl),
                Conv1d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in),
            ]))

        self.final_res_block = RowBlock(init_dim * 2, init_dim, time_dim)
        self.final_conv = Conv1d(init_dim, self.out_dim, 1)

    def use_kernels(self, enabled: bool = True) -> "UNet1d":
        """Route the K1/K2/K3/K7/K8 modules through their kernels (default) or
        through their plain PyTorch versions, e.g. to compare the two on a
        card. On CPU tensors the kernel wrappers run the plain versions
        either way."""
        for m in self.modules():
            if hasattr(m, "kernels"):
                m.kernels = enabled
        return self

    def _block(self, block: nn.Module, x: torch.Tensor, t: torch.Tensor,
               remat: bool = True, group=None) -> torch.Tensor:
        """A ResnetBlock, recomputed in the backward under ``remat_blocks``
        (``remat`` False: a fused row block, which JAX does not remat);
        ``group``: x is a rank's slice of m/z."""
        args = (x, t) if group is None else (x, t, group)
        if remat and self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _mixer(self, attn: nn.Module, x: torch.Tensor, group=None,
               sharded: bool = False) -> torch.Tensor:
        if self.remat_linear_attn and torch.is_grad_enabled():
            return checkpoint(attn, x, group, sharded, use_reentrant=False)
        return attn(x, group, sharded)

    def _cond_tower(self, attn_cond, b, rt, dtype, group):
        """The MS1 condition tower: (b, cond_dim, rt). Spans ``unet.cond``
        and ``unet.cond.backward``; the latter opens when the condition's
        gradient is complete and closes where it leaves the tower's first
        conv (no gradient reaches the trace itself, so that conv's weight
        gradient falls after the span)."""
        grad = profiling.backward_span("unet.cond.backward")
        with profiling.span("unet.cond"):
            if self.simple:
                cond = attn_cond.reshape(b, rt, -1).transpose(1, 2).to(dtype)
                conv, act, proj = self.attn_cond_proj[1]  # after the simple model's Identity
                return grad.exit(proj(act(grad.entry(conv(cond)))))  # (b, acid, rt)
            mz_net, tfer = self.attn_cond_proj
            conv, res1, res2, mixer = mz_net
            ac = res2(res1(grad.entry(conv(attn_cond.reshape(b * rt, 1, -1).to(dtype)))))
            ac = self._mixer(mixer, ac, group)  # (b*rt, acid, mz_c), on every rank
            return grad.exit(tfer(ac.reshape(b, rt, -1).transpose(1, 2)))

    def _sp_group(self):
        """The ``sp`` group the m/z axis splits over, or None."""
        if self.activation_sharding is None:
            return None
        if self.mesh is None:
            raise ValueError(
                "UNet1d(activation_sharding=...) runs on a mesh: pass mesh= to build_model, "
                "DDIMSampler or Trainer (or set model.mesh)")
        return self.mesh.sp_group if self.mesh.sp > 1 else None

    def forward(
        self,
        x: torch.Tensor,
        time: torch.Tensor,
        init_cond: Optional[torch.Tensor] = None,
        attn_cond: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x (b, rt, mz) or (rt, mz); time (b,); init_cond like x; attn_cond
        (b, rt) or (b, rt, mz_c) (both ignored by the unconditional model).
        Returns (b, rt·out_dim, mz)."""
        with profiling.span("unet.forward"):
            return self._forward(x, time, init_cond, attn_cond)

    def _forward(self, x, time, init_cond, attn_cond):
        if x.dim() == 2:
            x = x[None]
        b, rt, mz = x.shape
        n_levels = len(self.dim_mults)
        stride = 2 ** (n_levels - 1)
        if mz % stride != 0:
            raise ValueError(
                f"UNet1d requires the m/z length to be divisible by "
                f"2**(len(dim_mults)-1) = {stride} so the {n_levels}-level "
                f"down/up path round-trips (got mz={mz}; pad or re-bin the input, "
                f"e.g. to {((mz + stride - 1) // stride) * stride})"
            )
        dtype = self.compute_dtype
        if time.dim() == 0:
            time = time[None]
        group = self._sp_group()
        # levels [0, k) run on this rank's slice of m/z, the rest in full
        k = sharded_levels(mz, n_levels, self.mesh.sp) if group is not None else 0

        t = self.time_mlp[1:](self.time_mlp[0](time).to(dtype))
        t_rows = torch.repeat_interleave(t, rt, dim=0)  # (b*rt, time_dim): per-row FiLM

        x = x.reshape(b * rt, 1, mz).to(dtype)
        mesh = self.mesh if group is not None else None
        if self.conditional:
            if init_cond is None:
                init_cond = torch.zeros((b, rt, mz), dtype=dtype, device=x.device)
            ic = init_cond.reshape(b * rt, -1, mz).to(dtype)
            x, ic = shard_batch((x, ic), mesh)
            x = torch.cat([self.init_cond_proj(ic, t_rows), x], dim=1)
        else:
            x = shard_batch(x, mesh)
        x = self.init_conv(x, group)  # (b*rt, init_dim, mz)
        r = x

        # MS1 condition tower -> (b, cond_dim, rt), channel-major over (d, mz_c)
        cond = None
        if self.conditional and attn_cond is None:
            attn_cond = torch.zeros((b, rt), dtype=dtype, device=x.device)
        if self.conditional:
            cond = self._cond_tower(attn_cond, b, rt, dtype, group)

        rows = not self.fused_resnet  # row blocks that remat_blocks recomputes
        skips = []
        for i, (block1, block2, attn, down) in enumerate(self.downs):
            g = group if i < k else None  # None: every rank holds the whole level
            x = self._block(block1, x, t_rows, rows, g)
            skips.append(x)
            x = self._mixer(attn, self._block(block2, x, t_rows, rows, g), group, g is not None)
            skips.append(x)
            if g is not None and i + 1 == k < n_levels:
                x = down(sp_gather(x, group))  # into the first whole level
            else:
                x = down(x, g)
        if group is not None and k == n_levels:
            x = sp_gather(x, group)  # the bottleneck pivots the whole m/z axis

        # bottleneck: (b*rt, mid_dim, mz') -> (b, mid_dim*mz', rt); the
        # channel-major flattening is a reshape
        mid_dim, mzp = x.shape[1], x.shape[2]
        if mid_dim * mzp != self.mid_ch:
            raise ValueError(
                f"bottleneck width {mid_dim}*{mzp} at mz={mz} does not match the "
                f"{self.mid_ch} channels this model was built for"
            )
        grad = profiling.backward_span("unet.mid.backward")
        with profiling.span("unet.mid"):
            x = grad.entry(x.reshape(b, rt, self.mid_ch).transpose(1, 2))
            x = self._block(self.mid_block1, x, t)
            attn_grad = profiling.backward_span("unet.mid.attn.backward")
            with profiling.span("unet.mid.attn"):
                x = attn_grad.exit(self.mid_attn(attn_grad.entry(x), cond))
            x = self._block(self.mid_block2, x, t)
            x = grad.exit(x).transpose(1, 2).reshape(b * rt, mid_dim, mzp)
        if group is not None and k == n_levels:
            x = sp_slice(x, group)

        for j, (block1, block2, attn, up) in enumerate(self.ups):
            i = n_levels - 1 - j  # the level
            g = group if i < k else None
            x = self._block(block1, torch.cat([x, skips.pop()], dim=1), t_rows, rows, g)
            x = self._block(block2, torch.cat([x, skips.pop()], dim=1), t_rows, rows, g)
            x = self._mixer(attn, x, group, g is not None)
            if isinstance(up, nn.Sequential):  # Upsample: nearest x2, local to a slice; conv3
                x = up[0](x)
                x = sp_slice(up[1](x), group) if group is not None and i == k else up[1](x, g)
            else:
                x = up(x, g)

        x = self._block(self.final_res_block, torch.cat([x, r], dim=1), t_rows, rows, group)
        x = self.final_conv(x)
        if group is not None:
            x = sp_gather(x, group, grad="slice")  # every rank's loss sees the whole output
        x = x.reshape(b, rt * self.out_dim, mz)
        if self.pos_output_only:
            x = F.softplus(x)
        return x
