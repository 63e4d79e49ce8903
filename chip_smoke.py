#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA H100 (any
CUDA card with sm_90a). Phases, each of which must pass:

  1. print the card (name, power limit), the CUDA and nvcc versions, and
     build the kernels from ``dquartic_tpu_torch/csrc`` (timed);
  2. hold each CUDA kernel (K1 linear attention, K2 fused ResnetBlock, K3
     int8 matmul, K7a flash attention) against its plain PyTorch version at
     the main path's shapes, in float32 (TF32 off) and bfloat16, and time
     both; K1, K2, K3 and K7a also alone on the device (``torch.profiler``),
     K1 and K7a beside the floor of their exponentials at the SFU's rate;
     K3 beside ``torch._weight_int8pack_mm`` and at batch 8 and the
     production shape; K2 at the 29 ResnetBlock shapes of the canonical
     forward with the module's operands; sweep K7a
     against the plain attention and ``scaled_dot_product_attention`` over
     n = m from 34 to 16384 (the crossover behind ``attn_impl="auto"``);
  3. build the canonical UNet1d (``dquartic_train_config.json``, 1.2 B
     parameters, int8 mid convs, seeded random weights) through
     ``build_model`` and hold one forward on the kernels against one
     through the plain versions, in float32 and bfloat16;
  4. run ``DDIMSampler.predict`` for 50 steps on one synthetic
     (34 x 40000) pair batch in bf16, check the result and that every
     kernel was launched (K1 700, K2 1450, K3 200, K7a 50 times), then time
     ms/window on the kernel path and on the plain path (median of 3), and
     profile one serving forward: K1's, K2's and K3's device time, and every
     kernel's with their count;
  5. hold each backward kernel (K4 linear attention, K5 fused ResnetBlock,
     K7b flash attention) against autograd of its plain version at the
     training path's shapes,
     in float32 (TF32 off) and bfloat16, check that two identical calls
     give bitwise equal gradients, and time both at the level-0 shape (K4
     and K5 also on the device);
     time K4 at the ten mixer shapes and K5 at the 29 ResnetBlock shapes
     of a training step, around the wrapper and on the device; K7b at the
     RT lengths 34 and 340 around the wrapper and on the device, with its
     kernels a call (the one launch of ``flash_backward_plan``), beside
     the backward of ``scaled_dot_product_attention``, and at n = 16384
     (two launches) beside that library backward;
  6. full-width training of the canonical model through ``build_trainer``
     (bf16 compute on float32 master weights, AdamW + EMA, batch 1):
     (a) one step's gradients on the kernels against the plain path on the
     same weights and draws, float32 and bf16; (b) ``train_step`` 1 + 5
     times with a finite loss, moving parameters and EMA, and K1/K4 14,
     K2/K5 29, K7a/K7b 1 launches per step; (c) median ms/step of 5 on the kernel and
     the plain path, and the peak device memory; (d) one step under
     ``torch.profiler``: K4's and K5's device ms and launches a step (at
     most two a call), K7b's (one a call), the device's busy and idle share
     of the step timed in (c), the largest kernels;
  7. ``Trainer.train`` for 2 epochs of a 3-level model (m/z 256) writing
     latest and best checkpoints and ``build_trainer``'s ``metrics.jsonl``
     to a temporary directory, a resumed run from them, and a 10-step
     ``predict`` from the EMA weights;
  8. the ``simple=False`` UNet1d (the MS1 tower and the transformer
     bottleneck, ``tfer_depth`` 4, ``tpu.attn_impl = "pallas"``, full
     width, 2.8 B parameters): one forward with int8 mid convs on the
     kernels against the plain path, float32 and bf16; a 50-step
     ``predict`` (K1 750, K2 1450, K3 200, K7a 400 launches) and ms/window
     on both paths; training through ``build_trainer``: one step's
     gradients on the kernels against the plain path (in bf16 each path
     also against the float32 gradient, see BF16_TOWER; the bf16 gate's
     reading is logged), then ``train_step`` 1 + 5 times on each path with
     K7a/K7b 8, K1/K4 15, K2/K5 29 launches per step on the kernel path,
     ms/step and peak memory, and one kernel-path step under
     ``torch.profiler`` (K7b one launch a call);
  9. the row-blocked linear attention and the unfused UNet1d
     (``tpu.fused_resnet = false``, ``tpu.linear_attn_impl = "pallas"``):
     K8 and K9 against their plain version at every mixer shape of the
     path, a ragged N and N = 1, float32 and bf16, timed through the
     wrapper and alone, and on the device with their kernels a call (K8 1,
     K9 2: no torch op beside them); the sweep of K1, K8 and the "xla" path, whose
     crossover must be ``LINATTN_MIN_SEQ``; the full-width forward on the
     kernels against the plain path; a 50-step ``predict`` (K8 700, K1 0, K2 0, K3 200, K7a 50 launches)
     and ms/window; full-width training (no int8): one step's gradients
     on the kernels against the plain path, float32 and bf16, each bf16
     path also against the float32 gradient, then ``train_step`` 1 + 5
     times on each path with K8 14 launches per step (its gradient is the
     vjp of the recomputed reference, as in JAX's ``_fused`` custom_vjp),
     ms/step and peak memory;
 10. sequence parallelism over an sp = 2 group: K6a (both operand modes),
     K6b and K6c against their plain versions at the sharded widths of the
     mixers and a ragged N, float32 and bf16, timed at (34, 4, 20000)
     around the wrapper and on the device, with the kernels a call on the
     device (K6a 1, K6b 1, K6c 3, a mixer's forward K6a + K6b 2: no torch
     op beside them); N cut by hand into 2
     and 4 slices (one thread each, partials summed in rank order, one Z
     barrier in K6c) against K1 and K4 on the whole N; then two ranks
     spawned in one gloo group,
     both on this card, each running the unfused canonical model
     (``linear_attn_impl = "auto"``, m/z split in two): the full-width
     forward (f32, bf16), a 10-step ``predict`` in bf16 (K6a 120 and K6b
     120 launches per rank; its ms/window from CUDA events over that call)
     and in f32, and ``Trainer.train_step`` (f32, bf16; K6a
     24, K6b 12, K6c 12 per rank; the counted step timed), with the
     all_reduces of each forward and step counted (the K6 op's: 12 a
     forward, 36 a step), each held on rank 0 against the same call in
     one process (whose two mixers at N = 625 take the
     "xla" path, as at sp = 2); ms/window, ms/step and peak memory per
     rank, which say nothing of the speed of sequence parallelism (two
     ranks share one card);
 11. the port's command line (``dquartic_tpu_torch.cli``), run in this
     process: ``generate-config``; ``train`` at phase 7's depth (bf16,
     fused ResnetBlocks) on NPY windows made from ``--seed`` for 2 epochs
     (both checkpoints and ``metrics.jsonl``, K1, K2, K4, K5 launched),
     then for 3, resuming after epoch 1; ``predict --quantize-mid
     --fused-resnet --use-ema`` for 10 steps from that run's checkpoint;
     then the main path through the entry point: the canonical config
     (full width, bf16) over NPY windows of 34 x 40000, a params-only
     checkpoint of a seeded float32 model in the layout
     ``convert-checkpoint`` writes (4.8 GB), and ``predict --quantize-mid
     --fused-resnet --num-steps 50 --num-batches 1`` to npz, with phase 4's
     launches (K1 700, K2 1450, K3 200, K7a 50) and its ``pred`` bitwise
     equal to ``DDIMSampler.predict_batch`` in this process on the model
     built from the same file, the npz's mixture and MS1 and the same
     seed; the command's wall seconds, its sampling's device ms (CUDA
     events), and the seconds to write and to load the checkpoint;
 12. the remaining model families: (a) the unconditional canonical UNet1d
     (``conditional: false``) in the shipping serving config, its bf16
     forward on the kernels against the plain path and a 50-step
     ``predict`` (K1 700, K2 1450, K3 200, K7a 50 launches) with ms/window
     on both paths over 5 windows; (b) its full-width training step
     through ``build_trainer``: gradients on the kernels against the plain
     path (phase 6's gates), K4 14, K5 29, K7b 1 launches a step, ms/step;
     (c) the CustomTransformer of ``bench.py``'s ``transformer_train``
     mode (h1024, 8 heads, 8 layers, 34 x 40000, bs1): 1 + 20
     ``build_trainer`` steps timed by the port's ``StepTimer`` with the
     peak memory of ``device_memory_stats``, its bf16 forward and loss
     against float32 on the same weights, a 50-step ``predict`` (no kernel
     launched: it has none, as in JAX) and ``apply_quantized`` serving
     from ``quantize_params`` against the float weights; (d)
     ``FourierFeatures`` at its defaults against float64; (e)
     ``convert-checkpoint`` of seeded weights in the reference's
     CustomTransformer names and ``predict`` from the converted file, its
     ``pred`` bitwise equal to ``predict_batch`` in this process;
 13. data and tensor parallelism: K3 at a tp = 2 rank's column shard of a
     mid conv, (34, 30000, 5000) bf16, against its plain version, timed
     with its plain version and ``torch._weight_int8pack_mm`` beside its
     byte bound; then two ranks spawned in one gloo group, both on this
     card, each path held on rank 0 against the same call in one process
     on the global batch: (a) dp = 2, DDP over the rows: a
     ``Trainer.train_step`` of the canonical training config on a global
     batch of 2 (float32 and bf16, no EMA; phase 6's gradient gates; K1
     14, K2 29, K4 14, K5 29, K7a 1, K7b 1 a rank), with DDP's buckets
     and the other collectives a step counted, and a 50-step ``predict``
     of two windows in the serving config (K1 700, K2 1450, K3 200, K7a
     50 a rank; phase 3's gate; the gathered inputs bitwise); (b) tp = 2,
     the JAX rule's wide leaves split: the int8 serving ``predict`` of one
     window (K3 200 a rank on its column shard; rank 0's int8 shard
     bitwise the slice of the whole quantization) and a bf16 train step
     whose gathered gradients meet phase 6's gates, with the float32
     parameter bytes a rank (half the model's) and the peak memory; (c)
     the CustomTransformer's float32 step at dp = 2 and at tp = 2. The
     ms/window and ms/step a rank measure no dp or tp speed: the ranks
     share one card;
 14. the prediction hook and the identifiability loop: (a) ``train``
     through the CLI, in this process, on the canonical config (34 x 40000,
     bf16, fused ResnetBlocks; the factored optimizer) for one epoch of one
     batch with ``tpu.log_predictions`` and ``prediction_num_steps`` [10,
     50]: the hook's ``pred`` against ``DDIMSampler.sample`` on a model
     loaded from ``ema_state_dict()`` with the same noise, the train state
     and mode bitwise unchanged by the hook, its launches (K1 840, K2
     1740, K7a 60), the table and cosines in ``metrics.jsonl``, the 12
     panels where matplotlib is installed (where it is not, a recorder
     takes the renderer's place, said on a line of the log); (b)
     scripts/run_identifiability_torch.py's loop at the canonical width
     (x0, uniform, EMA 0.999, windows made on the card): ms/step, peak
     memory, the kernels a step and a 50-step sample, one eval; (c) the
     loop at m/z 2560: the window generator twice on one seed, bitwise;
     2N steps against N, a save, a resume and N more (the largest
     difference of the train state, and the parameters that differ);
     ms/step;
 15. (a) the async sharded checkpoint backend (``tpu.checkpoint_backend:
     "orbax"``, ``dquartic_tpu_torch/train/async_ckpt.py``) at full width:
     phase 6's trainer with the factored optimizer and no EMA, one epoch
     of two steps through ``Trainer.train`` writing latest and best (K1,
     K2, K4, K5, K7a, K7b launched), the state's bytes, the ms each save
     held the training thread, the background write's and the final
     wait's seconds, the pinned buffers' host memory and the staging's
     device memory, the msgpack path's ``_save`` of the same state; then
     the trainer saves again and at once takes its next step while the
     save is written; a trainer of another seed resumes the state from
     before the step, bitwise, and its next step's loss is the
     uninterrupted run's; (b) the examples on the card from the msgpack
     file of (a): ``predict_and_plot_torch`` (one full-width window, 10
     steps: K1 140, K2 290, K3 40), ``quantize_checkpoint_torch``
     (sizes and drift; K1 28, K2 58 in its two float forwards) and
     ``multichip_deconvolution_torch`` as one rank in the shipping config
     (10 steps: K1 140, K2 290, K3 40).

Each phase's seconds are logged as it ends and together on a line before
the kernels line. Phases 1-8 run ``tpu.linear_attn_impl = "pallas_t"`` (K1
at every mixer).
Each kernel's entry in the JSON line carries its time, its plain
version's, the time of one PyTorch call computing the same function where
one exists (``library_ms``), and ``bound_ms``: the least time for the
same work on an H100 SXM at 700 W, the larger of its bytes (each input
read once, each output written once) at 3.35 TB/s and its operations at
the peak of their type (67 TFLOP/s float32, 989 TFLOP/s bf16 tensor
cores); K1-K5, K7a, K7b, K8 and K9 also carry ``device_ms``
(``torch.profiler``). A short profiled window that saw fewer kernels than
expected is profiled again until one sees the count of the one before it;
each retry, with the wrappers' own launch counts over the window, is
listed under ``profile_retries``. The
log also gives K1's and K7a's exp floor, their exponentials at 16 a clock
per SM, beside the bound; the JSON line holds only measured times and
``bound_ms``.

It prints one JSON line of per-kernel results and, last, one JSON line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when there is no CUDA device, when it is run outside a checkout, or when
any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()  # the whole run, imports and the kernel build included
REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "dquartic_train_config.json")
RT, MZ, STEPS = 34, 40000, 50
SAMPLE_REPS = 3
# float32 kernel vs plain: sums in another order (split across CTAs, exp2
# with pre-scaled weights); values are O(1), so 1e-4 is ~1000 ulps.
F32_TOL = (1e-4, 1e-4)
# bf16: the kernels take bf16 activations and compute in float32, rounding
# only matmul operands (K1) and the output; they are held against the plain
# version run in float32 on the same bf16 values (and, for K2, the same
# bf16-rounded conv weights). Outputs are O(1) to O(10) (RMSNorm-scaled
# plus a unit-normal residual), where one bf16 ulp is up to 2^-5.
BF16_TOL = (3e-2, 3e-2)
# Whole-model forward, kernels vs plain versions: relative L2 error of the
# (1, 34, 40000) output. float32: summation order only, through ~60
# layers. bf16: roundings that differ per layer, accumulated over the net.
MODEL_REL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# Backward kernels vs autograd of the plain versions, max |error| over the
# largest entry of each gradient. float32: sums in another order over up to
# 40000 columns, and dW_k formed as the difference dW_k' - bmat T of two
# larger terms (as the TPU kernel forms it). bf16: the kernels take the
# bf16 activations and cotangent and compute in float32, so they are held
# against the plain version run in float32 on the same bf16 values (and,
# for K5, the same bf16-rounded conv weights); dx is rounded once to bf16.
GRAD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# One full-width step's gradients, kernels vs plain path on the same weights
# and draws: relative L2 of the whole gradient vector, and the smallest
# cosine between a parameter's two gradients. float32: summation order
# through ~60 layers. bf16: the plain path rounds every stage to bf16 where
# the kernels keep float32 inside, and the two roundings compound through
# the forward and the backward of the net.
STEP_GRAD_TOL = {"float32": (1e-3, 0.999), "bfloat16": (1e-1, 0.9)}
# simple=False in bf16: the MS1 tower's gradients (parameters under
# BF16_TOWER) are tiny (|g| ~1e-6 to 1e-4) and cancel over the RT axis, and
# either bf16 path reproduces them only to a cosine of 0.70-0.97 against the
# float32 gradient, the two paths in turn and at random over draws. So the
# per-tensor cosine between the paths is held outside the tower only, and
# each path's whole gradient against the float32 one: the kernel path's
# relative L2 error at most BF16_REL_RATIO times the plain path's (0.69 to
# 1.11 times over five draws on the card).
BF16_TOWER = "attn_cond_proj."
BF16_REL_RATIO = 1.5
TRAIN_STEPS = 5
# launches per full-width train step (29 ResnetBlocks, 14 mixers, the mid attention)
STEP_LAUNCHES = {"linear_attention": 14, "linear_attention_backward": 14,
                 "fused_resnet_block_t": 29, "fused_resnet_backward": 29, "int8_matmul": 0,
                 "flash_attention": 1, "flash_attention_backward": 1}
# K7 (flash attention) shapes (b, h, n, m) of phases 2 and 5: the UNet's RT
# axis at the canonical (34) and production (340) lengths, batch 8, and a
# ragged case; d = 32.
FLASH_SHAPES = ((1, 4, 34, 34), (1, 4, 340, 340), (8, 4, 34, 34), (1, 4, 130, 257))
FLASH_SWEEP = (34, 340, 1024, 2048, 5120, 8192, 16384)
# K7b past its one-launch limit (phase 5): the sweep's longest length
FLASH_BWD_LONG = FLASH_SWEEP[-1]
# launches per forward of the canonical (simple=True) model; its one softmax
# attention (the mid attention over the RT axis, n = 34) is K7a under
# attn_impl "auto" (FLASH_MIN_SEQ = 34)
SIMPLE_FORWARD = {"linear_attention": 14, "fused_resnet_block_t": 29, "int8_matmul": 4,
                  "flash_attention": 1}
# simple=False (phase 8): tfer_depth 4 gives 8 softmax attentions per
# forward (2 in the MS1 tower, 2 self + 2 hybrid x 2 in the bottleneck) and
# 15 linear-attention mixers (the 14 of the U-Net + the MS1 tower's).
TFER_DEPTH = 4
TFER_FORWARD = {"linear_attention": 15, "fused_resnet_block_t": 29, "int8_matmul": 4,
                "flash_attention": 8}
TFER_STEP = {"linear_attention": 15, "linear_attention_backward": 15,
             "fused_resnet_block_t": 29, "fused_resnet_backward": 29, "int8_matmul": 0,
             "flash_attention": 8, "flash_attention_backward": 8}
# phase 9: (C, N) of the 14 mixers of the canonical model (downs at
# dim_in, ups at dim_out), then ragged N and N = 1 (the simple=False MS1
# tower's mixer has acid = 8 channels and one column)
ROWS_SHAPES = ((4, 40000), (4, 20000), (8, 10000), (8, 5000), (12, 2500), (12, 1250),
               (16, 625), (16, 1250), (12, 5000), (8, 20000))
ROWS_EXTRA = ((8, 700), (12, 1025), (8, 1), (16, 1))
ROWS_FORWARD = {"fused_linear_attention": 14, "int8_matmul": 4, "flash_attention": 1}
# per train step: no K8 backward kernel
ROWS_STEP = {"fused_linear_attention": 14, "flash_attention": 1, "flash_attention_backward": 1}
# (C_in, C_out, N) of the 29 ResnetBlocks (K2) of the canonical forward: two
# a level down (dim 4, dim_mults (1, 2, 2, 3, 3, 4, 4)), two a level up on
# the concatenated skips, then final_res_block
RESNET_SHAPES = (
    [(c, c, MZ >> i) for i, c in enumerate((4, 4, 8, 8, 12, 12, 16)) for _ in "12"]
    + [(i + o, o, (MZ >> 6) << j) for j, (i, o) in enumerate(
        ((16, 16), (12, 16), (12, 12), (8, 12), (8, 8), (4, 8), (4, 4))) for _ in "12"]
    + [(8, 4, MZ)]
)
# K3 (M, K, N) beside the canonical (34, 30000, 10000): batch 8, and the
# production shape's mid conv (340 rows of 30016 m/z: 7504 channels)
K3_SHAPES = ((8 * RT, 30000, 10000), (340, 22512, 7504))
SWEEP_C = (4, 16)
SWEEP_N = (1, 625, 1250, 2500, 5000, 10000, 20000, 40000)
SWEEP_REPS = 5  # the mixer is host-bound at small N: medians of 5, impls in turn
# phase 10: sp ranks (processes of one gloo group) sharing the one card;
# (C, N / sp) of the 12 mixers that run K6 (N = 625 is odd: its two mixers
# take the "xla" path on every rank), then a ragged width
SP = 2
SP_SHAPES = tuple((C, N // SP) for C, N in ROWS_SHAPES if N % SP == 0) + ((8, 351),)
# K6 launches per rank: per forward K6a 12, K6b 12; per train step the
# forward's and, in the backward, K6a 12 more (the stats are recomputed)
# and K6c 12. With remat_linear_attn (not set here) the backward also
# recomputes the forward: K6a 12 x (2 + 1), K6b 12 x (1 + 1).
# (the mid attention runs whole on every rank: K7a 1, K7b 1)
SP_FORWARD = {"linear_attention_sp_stats": 12, "linear_attention_sp_apply": 12,
              "flash_attention": 1}
SP_STEP = {"linear_attention_sp_stats": 24, "linear_attention_sp_apply": 12,
           "linear_attention_sp_backward": 12, "flash_attention": 1,
           "flash_attention_backward": 1}
# Kernels a call of K6a (either operands), K6b, K6c and a split mixer's
# forward (K6a, the sum, K6b) on the device: one cluster launch; one launch;
# two cluster launches and the fixed-order sum of the gradients; two. No
# torch op runs on the device beside them.
SP_KERNELS_A_CALL = {"K6a": 1, "K6a float32 operands": 1, "K6b": 1, "K6c": 3,
                     "K6 forward": 2}
# all_reduces per rank of the 12 K6 mixers: one a forward (the stats), two
# a backward (the recomputed stats, then Z; T follows from Z and the summed
# stats). A K6c that also summed T would run 12 more a step (48).
SP_COLLECTIVES = {"forward": 12, "step": 12 * (1 + 2)}
# K6a's partials are sums over up to 20000 columns: an absolute tolerance
# of 1e-4 of the largest sum (float32, another summation order)
SP_STATS_TOL = (1e-4, 1e-4)
# float32 predict at sp = 2 against one process, same seed: relative L2 of
# the prediction; summation order only (halo convs on other shapes, K6 for
# K1, the "xla" path at N = 625); PR 15 read 1.248e-07 through 50 steps
SP_PREDICT_TOL = 1e-3
# the steps of phase 10's predicts (bf16 with its launches counted, and
# float32 against one process): the depth cut of that earlier path (was 50)
SP_STEPS = 10
# The one-process reference of phase 10 takes the sp path's dispatch: the
# two mixers at N = 625 (40000 / 2**6), which sp = 2 cannot split, on the
# "xla" path there too, and K1 (the arithmetic of K6) at every other one,
# so that the comparison sees the split alone.
SP_REF_MIN_SEQ = MZ // 2**6 + 1
# phase 11: windows in each NPY dataset of the command-line runs, the m/z
# of its small-depth training, and the steps of its small predict
CLI_WINDOWS = 4
CLI_MZ = 256
CLI_STEPS = 10
# phase 13: dp and tp ranks (processes of one gloo group) sharing the one
# card. K3 on a tp rank's column shard of a mid conv: the canonical
# (34, 30000, 10000) with its 10000 output columns split in DPTP.
DPTP = 2
DPTP_DEVICE = "cuda"  # each rank's device (one card for all)
K3_TP_SHAPE = (RT, 30000, 10000 // DPTP)
# The JAX rule's split leaves at tp = 2 hold 1,204,620,000 of the canonical
# model's 1,204,738,383 parameters: a rank holds about half the bytes.
TP_PARAM_SHARE = (0.49, 0.51)
# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): device memory
# bytes/s, and FLOP/s by the type of the operations.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """``bound_ms``: the larger of ``nbytes`` at the card's memory rate and
    ``flops`` at the peak of ``kind``; ``bound_by`` names the larger."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return dict(bound_ms=max(t_mem, t_ops), bound_by="bytes" if t_mem >= t_ops else "operations")


def linattn_bound(B, C, N, itemsize, tensors=2, passes=4, H=128) -> dict:
    """Linear attention over (B, C, N) (K1, K8, K9; the backward K4 with
    ``tensors=3``, ``passes=12``): ``tensors`` activation tensors moved
    once (x, y; x, dy, dx), ``passes`` float32 multiply-add passes of an
    H x C weight per column (k, A, q and M q^ forward; the backward
    recomputes the forward and differentiates each product twice)."""
    return bound(tensors * B * C * N * itemsize, 2 * passes * H * C * B * N, "float32")


def resnet_bound(B, c_in, c_out, N, itemsize, backward=False) -> dict:
    """A ResnetBlock on (B, c_in, N) (K2; K5 with ``backward``): x in and
    y out (the backward recomputes the forward from x and writes no y: x
    and dy in, dx out), two conv3s and a 1x1 conv where c_in != c_out,
    float32 operations (three times the forward's for the backward)."""
    macs = 3 * c_in * c_out + 3 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)
    moved = (2 * c_in + c_out) if backward else (c_in + c_out)
    return bound(moved * B * N * itemsize, (3 if backward else 1) * 2 * macs * B * N, "float32")


def flash_bound(b, h, n, m, d, itemsize, backward=False) -> dict:
    """Softmax attention (K7a; K7b with ``backward``): q, k, v in and o out
    (K7b: q, k, v, dO in, with o and lse in float32, and dq, dk, dv out),
    two n x m x d products (five in the backward) on bf16 tensor cores."""
    moved = (b * h * (n + 2 * m) * d) * (2 if backward else 1) + b * h * n * d
    extra = 4 * b * h * n * (d + 1) if backward else 0  # o and lse in float32
    return bound(moved * itemsize + extra, (10 if backward else 4) * b * h * n * m * d,
                 "bfloat16")


def exp_floor(exps: float) -> float:
    """ms of ``exps`` exponentials at the SFU's 16 a clock on each of the
    card's SMs at its highest SM clock (nvidia-smi ``clocks.max.sm``), a
    floor logged beside ``bound_ms`` for the kernels whose exponentials
    outnumber what the table's rates count."""
    import torch

    props = torch.cuda.get_device_properties(0)
    return exps / (props.multi_processor_count * 16 * sm_clock_hz()) * 1e3


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's highest SM clock in Hz (nvidia-smi ``clocks.max.sm``)."""
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    return float(clk.stdout.strip().splitlines()[0]) * 1e6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / max(reps, 1)


# Profiles taken of one set of calls before a kernel that ran is counted as
# missing: torch.profiler drops records in short windows, now and then all
# of one kernel's, and once every record of three profiles in a row. A
# profile that saw the same count as the one before it ends the retries:
# such a window loses the same records every time (PR 15's run 7 repeated
# K7b's 49 of 50 and K9's 36 of 40 five times each).
PROFILE_TRIES = 5

# Each profile taken again, in the order taken: what the profile before it
# missed, the wrappers' own launch counts over the profiled calls, and
# whether the retries ended on a repeated count. The kernels line carries
# them, so runs show whether the profiler drops records more often over time
# (why it drops them is not known).
PROFILE_RETRIES = []


# A spin of the card (torch.cuda._sleep, kernel "spin_kernel") before and
# after the profiled calls: late in a long process the profiler loses the
# records at the edges of a short window (all of a 1.5 ms window of K6b's
# launches in three tries, where a fresh process kept every record), and the
# spins take those edges. They are not counted.
PROFILE_PAD_S = 2e-3


def _kernel_events(fn, reps, warmup):
    """(events, launches): (name, device us, count) of every kernel
    ``torch.profiler`` saw in ``reps`` calls of ``fn`` (after ``warmup``),
    the padding spins left out, and the port's launch counters' increase
    over the profiled calls, by wrapper (its own count of what it
    launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dquartic_tpu_torch.ops import launch_counts

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pad = int(PROFILE_PAD_S * sm_clock_hz())
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(pad)
        torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    events = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "CUDA")) or not e.count \
                or "spin_kernel" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        events.append((e.key, e.self_cuda_time_total if us is None else us, e.count))
    return events, launched


def device_ms(fn, reps, *names, warmup=1):
    """Device time from ``torch.profiler`` over ``reps`` calls of ``fn``
    (after ``warmup``): {name: (ms per call, kernels per call, ms per call
    from each kernel's mean)} summed over the kernels whose names contain
    ``name``, and under ``"all"`` over every kernel. The third number sums
    each kernel's mean time once: for a call that launches each of its
    kernels once it stands even where the profiler drops records (it drops
    some in these short windows; a whole step's profile counted every
    launch). Profiles again where a named kernel left no record, until a
    profile sees the count of the one before it, and fails where it left
    none."""
    seen = None
    for _ in range(PROFILE_TRIES):
        sums = {name: [0.0, 0, 0.0] for name in names + ("all",)}
        events, launched = _kernel_events(fn, reps, warmup)
        for key, us, count in events:
            for name in names + ("all",):
                if name == "all" or name in key:
                    sums[name][0] += us
                    sums[name][1] += count
                    sums[name][2] += us / count
        missing = [name for name in names if not sums[name][1]]
        if not missing:
            break
        repeated = sums["all"][1] == seen
        PROFILE_RETRIES.append({"missing": missing, "kernels_seen": sums["all"][1],
                                "launched": launched, "repeated": repeated})
        if repeated:
            break
        seen = sums["all"][1]
        log(f"  the profiler saw no device time of {missing} (the wrappers launched "
            f"{launched}): profiling again")
    check(not missing, f"the profiler saw no device time of {missing} (the wrappers launched "
          f"{launched})")
    return {k: (us / 1e3 / reps, n / reps, mean / 1e3) for k, (us, n, mean) in sums.items()}


def device_kernels(fn, reps, kernels_expected=None, warmup=1):
    """Device time of whole calls of ``fn`` from ``torch.profiler``: (ms a
    call summed over every kernel record, kernels a call as the profiler
    counted them, the sorted names of the distinct kernels, ms a call from
    each distinct kernel's mean time once). Where the profiler drops
    records in a short window the names and, for a call that launches each
    of its kernels once, the last time stand; it profiles again while it
    saw fewer than ``kernels_expected`` kernels a call, until a profile
    sees the count of the one before it. Each short profile logs the
    wrappers' own launch counts beside the profiler's."""
    seen = None
    for _ in range(PROFILE_TRIES):
        events, launched = _kernel_events(fn, reps, warmup)
        n = sum(count for _, _, count in events)
        if kernels_expected is None or n >= kernels_expected * reps:
            break
        repeated = n == seen
        PROFILE_RETRIES.append({"kernels_seen": n, "expected": kernels_expected * reps,
                                "launched": launched, "repeated": repeated})
        log(f"  the profiler saw {n} of {kernels_expected * reps} kernels; the wrappers "
            f"launched {launched} in {reps} calls" +
            (": the same count again, no more profiles" if repeated else ": profiling again"))
        if repeated:
            break
        seen = n
    kinds = sorted({key.replace("(anonymous namespace)::", "").split("(")[0]
                    .replace("void ", "") for key, _, _ in events})
    return (sum(us for _, us, _ in events) / 1e3 / reps, n / reps, kinds,
            sum(us / count for _, us, count in events) / 1e3)


def phase_info():
    import torch

    from dquartic_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log("card (nvidia-smi name, power.limit):")
    log(smi.stdout.strip())
    log(f"highest SM clock (nvidia-smi clocks.max.sm): {sm_clock_hz() / 1e6:.0f} MHz")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels from {os.path.relpath(_build.CSRC, REPO)} for sm_90a "
        f"({[s.name for s in _build.sources()]}): "
        f"{'loaded a library already built' if prebuilt else 'built by nvcc'} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = _build.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        name = ""
        for line in ptxas.read_text().splitlines():
            if "Compiling entry function" in line:
                name = _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}: " + line.replace("ptxas info    :", "").strip())


def _kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel name: the last
    length-prefixed name of the ``_ZN...`` path and what follows it."""
    i, last = 3 if mangled.startswith("_ZN") else 2, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        last, i = mangled[j:j + n], j + n
    return last + mangled[i:i + 24]


def _err(out, ref):
    a, b = out.float(), ref.float()
    return float((a - b).abs().max()), float(((a - b).abs() / (b.abs() + 1e-6)).max())


def _compare(name, out, ref, tol, atol_scale=1.0):
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite kernel output")
    rtol, atol = tol
    atol = atol * atol_scale
    bad = ((out.float() - ref.float()).abs() > atol + rtol * ref.float().abs()).sum().item()
    max_abs, max_rel = _err(out, ref)
    log(f"  {name}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} tol (rtol {rtol:g}, "
        f"atol {atol:.3e}) -> {'ok' if bad == 0 else f'{bad} elements out of tolerance'}")
    check(bad == 0, f"{name}: kernel disagrees with its plain version")
    return max_abs


def k3_bound(M, K, N) -> dict:
    """K3 at (M, K, N) in bf16: the int8 weights, scales, x and out moved
    once; 2 M K N operations on bf16 tensor cores."""
    return bound(K * N + 4 * N + 2 * (M * K + M * N), 2 * M * K * N, "bfloat16")


def _k3_compare(name, out, ref, tol):
    # sums of K products: rounding scales with the size of the sums
    return _compare(name, out, ref, tol, atol_scale=float(ref.float().abs().max()))


def k3_library(x, q, s, ref, tol, shape="(34, 30000, 10000)") -> dict:
    """``library_ms`` of K3: ``torch._weight_int8pack_mm`` (x (M, K), int8
    weights (N, K), per-column scales in x's dtype), the one PyTorch call
    that forms x @ int8 weights x scale; its (N, K) weights and bf16 scales
    are made once, outside the timing, and its output is held against the
    plain version. Where the card's build has no kernel for it, the reason."""
    import torch

    try:
        wt, st = q.t().contiguous(), s.to(x.dtype)
        out = torch._weight_int8pack_mm(x, wt, st)
        _k3_compare("torch._weight_int8pack_mm (scales rounded to bf16)", out, ref, tol)
        ms = cuda_time(lambda: torch._weight_int8pack_mm(x, wt, st), 20)
        log(f"  torch._weight_int8pack_mm at {shape} bf16: {ms:.4f} ms")
        return dict(library_ms=ms, library="torch._weight_int8pack_mm")
    except SmokeFailure:
        raise
    except Exception as e:  # no CUDA kernel for it in this build
        first = (str(e).strip().splitlines() or [type(e).__name__])[0]
        log(f"  torch._weight_int8pack_mm on the card: {type(e).__name__}: {first}")
        return dict(library_ms=None, library_note=f"torch._weight_int8pack_mm: {first}")


def phase_k3_shapes(gen, results):
    """K3 bf16 at batch 8 (M = 272) and the production mid conv (340 rows,
    K 22512, N 7504) against its plain version, around the wrapper and on
    the device, beside its bound (reported, not gated)."""
    import torch

    from dquartic_tpu_torch.ops import int8_matmul as im

    rows = []
    for M, K, N in K3_SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        q, s = im.quantize_weight_matrix(torch.randn((K, N), generator=gen, device="cuda"))
        _k3_compare(f"K3 int8_matmul bfloat16 M={M} K={K} N={N}", im.int8_matmul(x, q, s),
                    im.int8_matmul_reference(x, q, s), (2**-7, 2**-8))
        ms = cuda_time(lambda: im.int8_matmul(x, q, s), 10)
        dev = device_ms(lambda: im.int8_matmul(x, q, s), 10, "int8_matmul_mma")["all"][0]
        bnd = k3_bound(M, K, N)
        log(f"  time int8_matmul bf16 ({M}, {K}, {N}): kernel {ms:.4f} ms, device {dev:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(M=M, K=K, N=N, ms=ms, device_ms=dev, **bnd))
        del x, q, s
        torch.cuda.empty_cache()
    results["int8_matmul"]["shapes"] = rows


def k2_host_costs(gen, results):
    """Host time of a K2 call and of two of its parts, on the host clock
    over 2000 calls: the op at (34, 4 -> 4, N 8), where the host sets the
    pace; ``torch.empty`` of its output; the ctypes call of the entry
    point with its 38 arguments, made to return before any CUDA call (B =
    0). What remains is the wrapper's Python and the launch."""
    import torch

    from dquartic_tpu_torch.ops import _build
    from dquartic_tpu_torch.ops import fused_resnet as fr

    def per_call_ms(fn, n=2000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    a = [randn(34, 4, 8), randn(4, 4, 3).permute(2, 1, 0), randn(4), randn(4, dt=torch.float32),
         *randn(34, 8).chunk(2, dim=-1), randn(4, 4, 3).permute(2, 1, 0), randn(4),
         randn(4, dt=torch.float32), None, None]
    entry = _build.library().dq_fused_resnet
    bare = [0] * (len(entry.argtypes) - 1) + [None]  # B = 0: refused before any CUDA call
    with torch.no_grad():
        costs = dict(host_ms_call=per_call_ms(lambda: fr.fused_resnet_block_t(*a)),
                     host_ms_empty=per_call_ms(lambda: torch.empty((34, 4, 8), dtype=torch.bfloat16,
                                                                   device="cuda")),
                     host_ms_ctypes=per_call_ms(lambda: entry(*bare)))
    log(f"  K2 on the host clock: a call {costs['host_ms_call']:.4f} ms, of which torch.empty "
        f"{costs['host_ms_empty']:.4f} ms and the bare ctypes call {costs['host_ms_ctypes']:.4f} ms")
    results["fused_resnet_block_t"].update(costs)


def phase_k2_shapes(gen, results):
    """K2 bf16 at the 29 ResnetBlock shapes of the canonical forward (B =
    34), its parameters as the module hands them over (bf16 conv weights
    seen through permute, bf16 biases, float32 gains, FiLM halves of one
    tensor): held against the plain version, timed around the wrapper and
    on the device; the device times summed over the 29."""
    import torch

    from dquartic_tpu_torch.ops import fused_resnet as fr

    def randn(*shape, s=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)

    log("  K2 bf16 at the ResnetBlock shapes (34, C_in -> C_out, N), module operands:")
    rows, total = [], 0.0
    with torch.no_grad():
        for c_in, c_out, N in sorted(set(RESNET_SHAPES), key=RESNET_SHAPES.index):
            count = RESNET_SHAPES.count((c_in, c_out, N))
            res = c_in != c_out
            film = randn(34, 2 * c_out, s=0.2)
            a = [randn(34, c_in, N), randn(c_out, c_in, 3, s=0.3).permute(2, 1, 0),
                 randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2, dt=torch.float32),
                 *film.chunk(2, dim=-1), randn(c_out, c_out, 3, s=0.3).permute(2, 1, 0),
                 randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2, dt=torch.float32),
                 randn(c_out, c_in, 1, s=0.3).permute(2, 1, 0) if res else None,
                 randn(c_out, s=0.1) if res else None]
            ref = fr.resnet_block_t_reference(*(None if v is None else v.float() for v in a))
            _compare(f"K2 bf16 {c_in}->{c_out} N={N}", fr.fused_resnet_block_t(*a), ref,
                     BF16_TOL)
            ms = cuda_time(lambda: fr.fused_resnet_block_t(*a), 20)
            dev = device_ms(lambda: fr.fused_resnet_block_t(*a), 20, "resnet_fwd")["resnet_fwd"][0]
            bnd = resnet_bound(34, c_in, c_out, N, 2)
            total += count * dev
            log(f"    {c_in}->{c_out} N={N} (x{count}): wrapper {ms:.4f} ms, device {dev:.4f} ms, "
                f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            rows.append(dict(c_in=c_in, c_out=c_out, N=N, count=count, ms=ms, device_ms=dev,
                             bound_ms=bnd["bound_ms"]))
    log(f"  K2 device ms summed over the {len(RESNET_SHAPES)} ResnetBlocks: {total:.4f}")
    results["fused_resnet_block_t"].update(shapes=rows, device_ms_29=total)


def phase_kernels(gen, results):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from dquartic_tpu_torch.ops import fused_resnet as fr
    from dquartic_tpu_torch.ops import int8_matmul as im
    from dquartic_tpu_torch.ops import linear_attention as la

    dev = torch.device("cuda")

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    def la_args(C, N):
        H = 128
        return [randn(34, C, N), randn(C, 3 * H, s=0.3), randn(H, C, s=0.1), randn(C, s=0.1),
                randn(C), 1.0 + randn(C, s=0.2)]

    def rn_args(c_in, c_out, N):
        res = c_in != c_out
        return [randn(34, c_in, N), randn(3, c_in, c_out, s=0.3), randn(c_out, s=0.1),
                1.0 + randn(c_out, s=0.2), randn(34, c_out, s=0.2), randn(34, c_out, s=0.2),
                randn(3, c_out, c_out, s=0.3), randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2),
                randn(1, c_in, c_out, s=0.3) if res else None,
                randn(c_out, s=0.1) if res else None]

    def bf16_values(t):
        return None if t is None else t.to(torch.bfloat16).to(torch.float32)

    errs = {"linear_attention": 0.0, "fused_resnet_block_t": 0.0, "int8_matmul": 0.0}
    timing = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        tag = str(dt).replace("torch.", "")
        for C, N in ((4, MZ), (16, MZ // 64)):
            a = la_args(C, N)
            a[0] = a[0].to(dt)
            out = la.linear_attention(*a)
            ref = la.linear_attention_nr_reference(a[0].float(), *a[1:], 4, 32)
            errs["linear_attention"] = max(errs["linear_attention"], _compare(
                f"K1 linear_attention {tag} (34, {C}, {N})", out, ref, tol))
            if dt == torch.bfloat16 and C == 4:
                timing["linear_attention"] = (
                    cuda_time(lambda: la.linear_attention(*a), 20),
                    cuda_time(lambda: la.linear_attention_nr_reference(*a, 4, 32), 5),
                    linattn_bound(34, C, N, 2),
                )
                k1_dev = device_ms(lambda: la.linear_attention(*a), 20, "linattn_cluster")
                check(k1_dev["linattn_cluster"][1] == 1 and k1_dev["all"][1] == 1,
                      f"K1 is not one launch a call: {k1_dev}")
                plan = la.linear_attention_plan(C, N)
                log(f"  K1 at (34, {C}, {N}) bf16: {plan['cluster']} CTAs per cluster, slice "
                    f"staged {plan['staged']}, {plan['smem_bytes']} B of shared memory a CTA; "
                    f"{k1_dev['all'][1]:g} kernel(s) a call, device "
                    f"{k1_dev['linattn_cluster'][0]:.4f} ms (torch.profiler)")
        for c_in, c_out, N in ((4, 4, MZ), (32, 16, MZ // 64), (8, 4, MZ)):
            a = rn_args(c_in, c_out, N)
            a[0] = a[0].to(dt)
            out = fr.fused_resnet_block_t(*a)
            # K2 consumes its conv weights rounded to the activation dtype
            ra = a if dt == torch.float32 else [
                bf16_values(v) if i in (0, 1, 6, 9) else v for i, v in enumerate(a)]
            ref = fr.resnet_block_t_reference(*ra)
            errs["fused_resnet_block_t"] = max(errs["fused_resnet_block_t"], _compare(
                f"K2 fused_resnet_block_t {tag} {c_in}->{c_out} N={N}", out, ref, tol))
            if dt == torch.bfloat16 and c_in == 4:
                with torch.no_grad():
                    timing["fused_resnet_block_t"] = (
                        cuda_time(lambda: fr.fused_resnet_block_t(*a), 20),
                        cuda_time(lambda: fr.resnet_block_t_reference(*a), 5),
                        resnet_bound(34, c_in, c_out, N, 2),
                    )
                    k2_dev = device_ms(lambda: fr.fused_resnet_block_t(*a), 20, "resnet_fwd")
                check(k2_dev["resnet_fwd"][1] == 1 and k2_dev["all"][1] == 1,
                      f"K2 is not one launch a call: {k2_dev}")
        x = randn(34, 3 * 10000).to(dt)
        q, s = im.quantize_weight_matrix(randn(3 * 10000, 10000))
        out = im.int8_matmul(x, q, s)
        ref = im.int8_matmul_reference(x, q, s)
        k3_tol = (1e-5, 1e-5) if dt == torch.float32 else (2**-7, 2**-8)
        errs["int8_matmul"] = max(errs["int8_matmul"], _k3_compare(
            f"K3 int8_matmul {tag} M=34 K=30000 N=10000", out, ref, k3_tol))
        if dt == torch.bfloat16:
            # bf16 x times int8 weights converted in registers to bf16
            # operands of the tensor cores (mma.sync), float32 sums
            timing["int8_matmul"] = (
                cuda_time(lambda: im.int8_matmul(x, q, s), 20),
                cuda_time(lambda: im.int8_matmul_reference(x, q, s), 5),
                k3_bound(34, 30000, 10000),
            )
            k3_dev = device_ms(lambda: im.int8_matmul(x, q, s), 20, "int8_matmul_mma",
                               "int8_matmul_reduce")
            check(k3_dev["all"][1] == 2, f"K3 is not two kernels a call: {k3_dev}")
            library = k3_library(x, q, s, ref, k3_tol)
        del q, s
    for name, (ms, plain_ms, bnd) in timing.items():
        log(f"  time {name} bf16 at the level-0 shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        results[name].update(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=None,
                             **bnd)
    results["fused_resnet_block_t"]["device_ms"] = k2_dev["resnet_fwd"][0]
    results["int8_matmul"].update(device_ms=k3_dev["all"][0], **library)
    log(f"  K2 at (34, 4, 40000) bf16 on the device: {k2_dev['resnet_fwd'][0]:.4f} ms; K3 at "
        f"(34, 30000, 10000) bf16 on the device: {k3_dev['all'][0]:.4f} ms (tensor-core pass "
        f"{k3_dev['int8_matmul_mma'][0]:.4f}, fixed-order reduce "
        f"{k3_dev['int8_matmul_reduce'][0]:.4f}) (torch.profiler)")
    phase_k3_shapes(gen, results)
    phase_k2_shapes(gen, results)
    k2_host_costs(gen, results)
    # two exponentials per feature and column: p of phase 0, q of the apply pass
    results["linear_attention"]["device_ms"] = k1_dev["linattn_cluster"][0]
    log(f"  K1 exp floor {exp_floor(2 * 128 * 34 * MZ):.4f} ms")
    # K1 at every mixer shape, bf16, with the weights as the module passes
    # them (bf16 views of the conv weights): around the wrapper and alone
    log("  K1 bf16 at the mixer shapes (34, C, N):")
    total = 0.0
    with torch.no_grad():
        for C, N in ROWS_SHAPES:
            a = la_args(C, N)
            a[0], a[3] = a[0].to(torch.bfloat16), a[3].to(torch.bfloat16)
            a[1], a[2] = (w.t().contiguous().to(torch.bfloat16).t() for w in a[1:3])
            ms = cuda_time(lambda: la.linear_attention(*a), 20)
            dev_ms = device_ms(lambda: la.linear_attention(*a), 20,
                               "linattn_cluster")["linattn_cluster"][0]
            total += dev_ms
            plan = la.linear_attention_plan(C, N)
            log(f"    ({C}, {N}): wrapper {ms:.4f} ms, device {dev_ms:.4f} ms, bound "
                f"{linattn_bound(34, C, N, 2)['bound_ms']:.4f} ms, exp floor "
                f"{exp_floor(2 * 128 * 34 * N):.4f} ms; {plan['cluster']} CTAs "
                f"a cluster")
    log(f"  K1 device ms summed over the {len(ROWS_SHAPES)} mixer shapes: {total:.4f}")
    phase_flash_forward(gen, results)


def _flash_inputs(gen, b, h, n, m, dt):
    import torch

    return [(torch.randn((b, h, x, 32), generator=gen, device="cuda")).to(dt)
            for x in (n, m, m)]


def phase_flash_forward(gen, results):
    """K7a against flash_attention_reference at the FLASH_SHAPES, float32
    and bf16, with times at the RT lengths 34 and 340; then the sweep of K7a
    against the plain attention that ``attn_impl="auto"`` picks below
    FLASH_MIN_SEQ."""
    import torch

    from dquartic_tpu_torch.ops import attention_dispatch as ad
    from dquartic_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    err, times = 0.0, {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).replace("torch.", "")
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            for b, h, n, m in FLASH_SHAPES:
                q, k, v = _flash_inputs(gen, b, h, n, m, dt)
                out = fa.flash_attention(q, k, v)
                _, out32, stats = fa._launch_forward(q, k, v, 32 ** -0.5)
                lse = fa.lse_of(stats)
                ref, ref_lse = fa.flash_attention_reference(q, k, v, 32 ** -0.5)
                err = max(err, _compare(f"K7a flash_attention {tag} ({b}, {h}, {n}, 32) x m {m}",
                                        out, ref, tol))
                _compare(f"K7a lse {tag} ({b}, {h}, {n}) x m {m}", lse, ref_lse, F32_TOL)
                if dt == torch.bfloat16:  # the float32 output K7b forms D from
                    ref32, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                            32 ** -0.5)
                    _compare(f"K7a float32 output {tag} ({b}, {h}, {n}) x m {m}", out32, ref32,
                             F32_TOL)
                if dt == torch.bfloat16 and (b, n) in ((1, 34), (1, 340)):
                    times[n] = (cuda_time(lambda: fa.flash_attention(q, k, v), 50),
                                cuda_time(lambda: fa.flash_attention_plain(q, k, v), 50),
                                cuda_time(lambda: sdpa(q, k, v), 50),
                                device_ms(lambda: fa.flash_attention(q, k, v), 50,
                                          "flash_fwd_mma")["flash_fwd_mma"][0])
        for n, (ms, plain_ms, lib_ms, dev_ms) in times.items():
            log(f"  time flash_attention bf16 (1, 4, {n}, 32): kernel {ms:.4f} ms (device "
                f"{dev_ms:.4f} ms, torch.profiler), plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms")
        results["flash_attention"].update(
            max_abs_err=err, ms=times[34][0], plain_ms=times[34][1], library_ms=times[34][2],
            device_ms=times[34][3], ms_340=times[340][0], plain_ms_340=times[340][1],
            library_ms_340=times[340][2], device_ms_340=times[340][3],
            **flash_bound(1, 4, 34, 34, 32, 2))
        log(f"  K7a exp floor at (1, 4, 34, 32): {exp_floor(4 * 34 * 34):.3e} ms")

        # the "auto" crossover: K7a against the plain ("xla") attention, with
        # scaled_dot_product_attention timed beside them
        log(f"  sweep, bf16 (1, 4, n, 32), n = m; FLASH_MIN_SEQ = {ad.FLASH_MIN_SEQ}:")
        wins, sweep = [], []
        for n in FLASH_SWEEP:
            q, k, v = _flash_inputs(gen, 1, 4, n, n, torch.bfloat16)
            reps = 20 if n <= 2048 else 5
            ms = cuda_time(lambda: fa.flash_attention(q, k, v), reps)
            plain = cuda_time(lambda: ad.xla_attention(q, k, v), reps)
            lib = cuda_time(lambda: sdpa(q, k, v), reps)
            wins.append(ms < plain)
            floor = exp_floor(4 * n * n)
            sweep.append(dict(n=n, ms=ms, plain_ms=plain, library_ms=lib))
            log(f"    n {n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"scaled_dot_product_attention {lib:.4f} ms, exp floor {floor:.4f} ms -> "
                f"{'kernel' if ms < plain else 'plain'} faster than plain")
            del q, k, v
            torch.cuda.empty_cache()
        first = next((n for i, n in enumerate(FLASH_SWEEP) if all(wins[i:])), None)
        log(f"  smallest swept n from which K7a wins: {first}")
        results["flash_attention"]["sweep"] = sweep
        check(first == ad.FLASH_MIN_SEQ,
              f"the sweep puts the crossover at {first}, FLASH_MIN_SEQ is {ad.FLASH_MIN_SEQ}")


def _model_inputs(gen, b=1):
    import torch

    dev = torch.device("cuda")
    x = torch.randn((b, RT, MZ), generator=gen, device=dev)
    ms2 = torch.rand((b, RT, MZ), generator=gen, device=dev)
    ms1 = torch.rand((b, RT), generator=gen, device=dev)
    return x, ms2, ms1


def _expect(per_call, calls=1, cfg=None):
    """Launch counts of every kernel: ``per_call`` times ``calls``, others 0.
    A float32 ``cfg`` under ``attn_impl = "auto"`` runs the plain attention
    (``flash_suits``: K7a's tensor-core body is bf16), so no K7a or K7b."""
    from dquartic_tpu_torch.ops import KERNELS

    counts = {name: per_call.get(name, 0) * calls for name in KERNELS}
    if cfg is not None and cfg["tpu"]["compute_dtype"] == "float32" and cfg["tpu"].get(
            "attn_impl", "auto") == "auto":
        counts["flash_attention"] = counts["flash_attention_backward"] = 0
    return counts


def phase_forward(config, seed, gen, per_forward, what="canonical UNet1d",
                  dtypes=("float32", "bfloat16")):
    import torch

    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.utils.builder import build_model

    x, ms2, ms1 = _model_inputs(gen)
    t = torch.full((1,), 500, dtype=torch.long, device="cuda")
    for dtype in dtypes:
        cfg = json.loads(json.dumps(config))
        cfg["tpu"]["compute_dtype"] = dtype
        model = build_model(cfg, device="cuda", seed=seed)
        n_params = sum(p.numel() for p in model.parameters()) + sum(
            b.numel() for b in model.buffers() if b.dtype == torch.int8)
        with torch.inference_mode():
            reset_launch_counts()
            out = model.use_kernels(True)(x, t, ms2 * 2 - 1, ms1 * 2 - 1)
            counts = launch_counts()
            ref = model.use_kernels(False)(x, t, ms2 * 2 - 1, ms1 * 2 - 1)
        model.use_kernels(True)
        torch.cuda.synchronize()
        check(counts == _expect(per_forward, cfg=cfg), f"forward launches {counts}")
        check(out.shape == (1, RT, MZ), f"forward shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()), "non-finite forward output")
        rel = float((out.float() - ref.float()).norm() / ref.float().norm())
        max_abs, _ = _err(out, ref)
        log(f"  {what} forward {dtype} ({n_params / 1e9:.3f} B params, int8 mid "
            f"convs): kernels vs plain rel L2 {rel:.3e} (tol {MODEL_REL_TOL[dtype]:g}), "
            f"max_abs {max_abs:.3e}, max|ref| {float(ref.float().abs().max()):.3e}, "
            f"launches {counts}")
        check(rel <= MODEL_REL_TOL[dtype], f"{dtype} forward: kernels disagree with plain path")
        del model
        torch.cuda.empty_cache()


def phase_sample(config, seed, gen, per_forward, what="canonical", results=None,
                 reps=SAMPLE_REPS):
    """One 50-step predict with its launch counts, then ms/window on the
    kernel and the plain path, ``reps`` windows each. Returns (launch
    counts, median ms/window by path, with every window's ms, sorted, under
    ``"runs"``).
    With ``results``, also the device time of one serving forward from
    ``torch.profiler``: K1's (K8's on the unfused "pallas" path) and every
    kernel's."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.utils.builder import build_model, build_process

    model = build_model(config, device="cuda", seed=seed)
    sampler = DDIMSampler(model, build_process(config))
    rng = np.random.default_rng(seed)
    batch = {k: rng.uniform(0, 1, s).astype(np.float32) for k, s in
             (("ms2_1", (1, RT, MZ)), ("ms1_1", (1, RT)), ("ms2_2", (1, RT, MZ)))}

    reset_launch_counts()
    t0 = time.perf_counter()
    recs = sampler.predict([batch], num_steps=STEPS, seed=seed, device="cuda")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    pred = recs[0]["pred"]
    log(f"  predict {STEPS} steps: pred {pred.shape}, finite {bool(np.isfinite(pred).all())}, "
        f"range [{pred.min():.4f}, {pred.max():.4f}], first call {wall:.2f} s wall, "
        f"launches {counts}")
    check(pred.shape == (1, RT, MZ), f"pred shape {pred.shape}")
    check(bool(np.isfinite(pred).all()), "non-finite prediction")
    check(bool(np.isfinite(recs[0]["pred_noise"]).all()), "non-finite pred_noise")
    expect = _expect(per_forward, STEPS, config)
    check(counts == expect, f"launch counts {counts} != {expect}")

    # ms/window: one warm-up sample, then SAMPLE_REPS timed samples per path;
    # the 50-step loop is host-launched, so samples spread with host load
    x_t, ms2, ms1 = _model_inputs(gen)
    per_window = {"runs": {}}
    for path, kernels in (("kernel", True), ("plain", False)):
        model.use_kernels(kernels)
        cuda_time(lambda: sampler.sample(x_t, ms2, ms1, STEPS), reps=0, warmup=1)
        runs = sorted(cuda_time(lambda: sampler.sample(x_t, ms2, ms1, STEPS), reps=1, warmup=0)
                      for _ in range(reps))
        per_window[path] = runs[len(runs) // 2]
        per_window["runs"][path] = runs
        log(f"  {STEPS}-step DDIM ms/window ({what}, bs1, 34x40000, bf16, int8 mid convs), {path} "
            f"path: median {per_window[path]:.2f} ms of {reps} "
            f"(min {runs[0]:.2f}, max {runs[-1]:.2f})")
    if results is not None and per_forward.get("fused_linear_attention"):
        model.use_kernels(True)
        t = torch.full((1,), 500, dtype=torch.long, device="cuda")
        with torch.inference_mode():
            dev = device_ms(lambda: model(x_t, t, ms2 * 2 - 1, ms1 * 2 - 1), 5,
                            "linattn_rows_cluster")
        k8_ms, k8_n, _ = dev["linattn_rows_cluster"]
        log(f"  one serving forward (torch.profiler, mean of 5): K8 {k8_n:g} launches recorded "
            f"({per_forward['fused_linear_attention']} made), {k8_ms:.4f} ms of device time; all "
            f"kernels {dev['all'][1]:g} launches, {dev['all'][0]:.4f} ms")
        results["fused_linear_attention"].update(device_ms_per_forward=k8_ms,
                                                 forward_device_ms=dev["all"][0],
                                                 forward_kernels=dev["all"][1])
    elif results is not None:
        model.use_kernels(True)
        t = torch.full((1,), 500, dtype=torch.long, device="cuda")
        with torch.inference_mode():
            dev = device_ms(lambda: model(x_t, t, ms2 * 2 - 1, ms1 * 2 - 1), 5, "linattn_cluster",
                            "resnet_fwd", "int8_matmul")
        k1_ms, k1_n = dev["linattn_cluster"][:2]
        log(f"  one serving forward (torch.profiler, mean of 5): K1 {k1_n:g} launches, "
            f"{k1_ms:.4f} ms of device time; K2 {dev['resnet_fwd'][1]:g} launches, "
            f"{dev['resnet_fwd'][0]:.4f} ms; K3 {dev['int8_matmul'][1]:g} kernels (2 a call), "
            f"{dev['int8_matmul'][0]:.4f} ms; all kernels {dev['all'][1]:g} launches, "
            f"{dev['all'][0]:.4f} ms")
        check(k1_n == per_forward["linear_attention"], f"K1 launches a forward {k1_n}")
        check(dev["resnet_fwd"][1] == per_forward["fused_resnet_block_t"],
              f"K2 launches a forward {dev['resnet_fwd'][1]}")
        results["linear_attention"].update(device_ms_per_forward=k1_ms,
                                           forward_device_ms=dev["all"][0],
                                           forward_kernels=dev["all"][1])
        results["fused_resnet_block_t"]["device_ms_per_forward"] = dev["resnet_fwd"][0]
        results["int8_matmul"]["device_ms_per_forward"] = dev["int8_matmul"][0]
    del model, sampler
    torch.cuda.empty_cache()
    return counts, per_window


def _scaled_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12)), float((a - b).abs().max())


def _compare_grads(name, got, ref, tol):
    import torch

    worst, worst_abs = 0.0, 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            check(g is None, f"{name}: gradient {i} should be None")
            continue
        check(g.shape == r.shape, f"{name}: gradient {i} shape {tuple(g.shape)} != {tuple(r.shape)}")
        check(bool(torch.isfinite(g.float()).all()), f"{name}: non-finite gradient {i}")
        err, abs_err = _scaled_err(g, r)
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    log(f"  {name}: worst max|err|/max|ref| {worst:.3e} (tol {tol:g}), max|err| {worst_abs:.3e}")
    check(worst < tol, f"{name}: backward kernel disagrees with autograd of its plain version")
    return worst_abs


def phase_backward_kernels(gen, results):
    """K4 and K5 against autograd of their plain versions, at the training
    path's shapes, float32 and bf16; determinism; times at level 0."""
    import torch

    from dquartic_tpu_torch.ops import fused_resnet as fr
    from dquartic_tpu_torch.ops import linear_attention as la

    dev = torch.device("cuda")

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    def bf16_values(t):
        return None if t is None else t.to(torch.bfloat16).to(torch.float32)

    errs = {"linear_attention_backward": 0.0, "fused_resnet_backward": 0.0}
    timing = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        for C, N in ((4, MZ), (16, MZ // 64)):
            H = 128
            x, dy = randn(34, C, N).to(dt), randn(34, C, N).to(dt)
            w = [randn(C, 3 * H, s=0.3), randn(H, C, s=0.1), randn(C, s=0.1), randn(C),
                 1.0 + randn(C, s=0.2)]
            got = la.linear_attention_backward(dy, x, *w)
            again = la.linear_attention_backward(dy, x, *w)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "K4: two identical calls gave different gradients")
            ref = la.linear_attention_backward_reference(dy.float(), x.float(), *w, 4, 32)
            errs["linear_attention_backward"] = max(errs["linear_attention_backward"], _compare_grads(
                f"K4 linear_attention_backward {tag} (34, {C}, {N})", got, ref, GRAD_TOL[tag]))
            if dt == torch.bfloat16 and C == 4:
                timing["linear_attention_backward"] = (
                    cuda_time(lambda: la.linear_attention_backward(dy, x, *w), 10),
                    cuda_time(lambda: la.linear_attention_backward_reference(dy, x, *w, 4, 32), 3),
                    linattn_bound(34, C, N, 2, tensors=3, passes=12),
                )
                k4_dev = device_ms(lambda: la.linear_attention_backward(dy, x, *w), 10,
                                   "linattn_bwd_cluster", "linattn_bwd_finish")
                plan = la.linear_attention_backward_plan(34, C, N)
                log(f"  K4 at (34, {C}, {N}) bf16: {plan['cluster']} CTAs per cluster, slices "
                    f"staged {plan['staged']}, {plan['smem_bytes']} B of shared memory a CTA")
            del got, again, ref
        for c_in, c_out, N in ((4, 4, MZ), (32, 16, MZ // 64), (8, 4, MZ)):
            res = c_in != c_out
            a = [randn(34, c_in, N).to(dt), randn(3, c_in, c_out, s=0.3), randn(c_out, s=0.1),
                 1.0 + randn(c_out, s=0.2), randn(34, c_out, s=0.2), randn(34, c_out, s=0.2),
                 randn(3, c_out, c_out, s=0.3), randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2),
                 randn(1, c_in, c_out, s=0.3) if res else None, randn(c_out, s=0.1) if res else None]
            dy = randn(34, c_out, N).to(dt)
            got = fr.fused_resnet_backward(dy, *a)
            again = fr.fused_resnet_backward(dy, *a)
            torch.cuda.synchronize()
            check(all((g is None and h is None) or torch.equal(g, h) for g, h in zip(got, again)),
                  "K5: two identical calls gave different gradients")
            # K5 uses the conv weights rounded to the activation dtype, as K2
            ra = [bf16_values(v) if dt == torch.bfloat16 and i in (0, 1, 6, 9)
                  else (None if v is None else v.float()) for i, v in enumerate(a)]
            ref = fr.resnet_block_t_backward_reference(dy.float(), *ra)
            errs["fused_resnet_backward"] = max(errs["fused_resnet_backward"], _compare_grads(
                f"K5 fused_resnet_backward {tag} {c_in}->{c_out} N={N}", got, ref, GRAD_TOL[tag]))
            if dt == torch.bfloat16 and c_in == 4:
                timing["fused_resnet_backward"] = (
                    cuda_time(lambda: fr.fused_resnet_backward(dy, *a), 10),
                    cuda_time(lambda: fr.resnet_block_t_backward_reference(dy, *a), 3),
                    resnet_bound(34, c_in, c_out, N, 2, backward=True),
                )
                k5_dev = device_ms(lambda: fr.fused_resnet_backward(dy, *a), 10, "resnet_bwd")
            del got, again, ref
    for name, (ms, plain_ms, bnd) in timing.items():
        log(f"  time {name} bf16 at the level-0 shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        results[name].update(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=None,
                             **bnd)
    for name, dev_ms, tag in (("linear_attention_backward", k4_dev, "K4 at (34, 4, 40000)"),
                              ("fused_resnet_backward", k5_dev, "K5 at 4->4, N 40000")):
        log(f"  {tag}, bf16, on the device (torch.profiler): its kernels "
            f"{dev_ms['all'][2]:.4f} ms a call (each kernel's mean once; the profiler saw "
            f"{dev_ms['all'][1]:g} launches a call; it drops records in these short windows, "
            f"phase 6 counts them over a whole step), around the wrapper "
            f"{results[name]['ms']:.4f} ms")
        results[name].update(device_ms=dev_ms["all"][2])
    log(f"  K4's two kernels: the cluster pass {k4_dev['linattn_bwd_cluster'][2]:.4f} ms, the "
        f"fixed-order sums {k4_dev['linattn_bwd_finish'][2]:.4f} ms")
    phase_k4_shapes(gen, results)
    phase_k5_shapes(gen, results)
    phase_flash_backward(gen, results)


def phase_k4_shapes(gen, results):
    """K4 bf16 at the mixer shapes (34, C, N) of the canonical model, the
    weights as the module passes them (bf16 views of the conv weights,
    float32 gains): around the wrapper and on the device, with its plan."""
    import torch

    from dquartic_tpu_torch.ops import linear_attention as la

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    log("  K4 bf16 at the mixer shapes (34, C, N), module weights:")
    rows, total = [], 0.0
    for C, N in ROWS_SHAPES:
        x, dy = randn(34, C, N).to(torch.bfloat16), randn(34, C, N).to(torch.bfloat16)
        w = [randn(3 * 128, C, s=0.3).to(torch.bfloat16).t(),
             randn(C, 128, s=0.1).to(torch.bfloat16).t(), randn(C, s=0.1).to(torch.bfloat16),
             randn(C), 1.0 + randn(C, s=0.2)]
        ms = cuda_time(lambda: la.linear_attention_backward(dy, x, *w), 10)
        dev = device_ms(lambda: la.linear_attention_backward(dy, x, *w), 10,
                        "linattn_bwd")["all"][2]
        bnd = linattn_bound(34, C, N, 2, tensors=3, passes=12)
        plan = la.linear_attention_backward_plan(34, C, N)
        total += dev
        log(f"    ({C}, {N}): wrapper {ms:.4f} ms, device {dev:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms; {plan['cluster']} CTAs a cluster, staged {plan['staged']}")
        rows.append(dict(C=C, N=N, ms=ms, device_ms=dev, bound_ms=bnd["bound_ms"],
                         cluster=plan["cluster"]))
    log(f"  K4 device ms summed over the {len(ROWS_SHAPES)} mixer shapes: {total:.4f}")
    results["linear_attention_backward"].update(shapes=rows, device_ms_shapes=total)


def phase_k5_shapes(gen, results):
    """K5 bf16 at the 29 ResnetBlock shapes of the canonical model (B = 34),
    its operands as the module hands them over: around the wrapper and on
    the device; the device times summed over the 29."""
    import torch

    from dquartic_tpu_torch.ops import fused_resnet as fr

    def randn(*shape, s=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)

    log("  K5 bf16 at the ResnetBlock shapes (34, C_in -> C_out, N), module operands:")
    rows, total = [], 0.0
    for c_in, c_out, N in sorted(set(RESNET_SHAPES), key=RESNET_SHAPES.index):
        count = RESNET_SHAPES.count((c_in, c_out, N))
        res = c_in != c_out
        film = randn(34, 2 * c_out, s=0.2)
        a = [randn(34, c_in, N), randn(c_out, c_in, 3, s=0.3).permute(2, 1, 0),
             randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2, dt=torch.float32),
             *film.chunk(2, dim=-1), randn(c_out, c_out, 3, s=0.3).permute(2, 1, 0),
             randn(c_out, s=0.1), 1.0 + randn(c_out, s=0.2, dt=torch.float32),
             randn(c_out, c_in, 1, s=0.3).permute(2, 1, 0) if res else None,
             randn(c_out, s=0.1) if res else None]
        dy = randn(34, c_out, N)
        ms = cuda_time(lambda: fr.fused_resnet_backward(dy, *a), 10)
        dev = device_ms(lambda: fr.fused_resnet_backward(dy, *a), 10, "resnet_bwd")["all"][2]
        bnd = resnet_bound(34, c_in, c_out, N, 2, backward=True)
        total += count * dev
        log(f"    {c_in}->{c_out} N={N} (x{count}): wrapper {ms:.4f} ms, device {dev:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(c_in=c_in, c_out=c_out, N=N, count=count, ms=ms, device_ms=dev,
                         bound_ms=bnd["bound_ms"]))
    log(f"  K5 device ms summed over the {len(RESNET_SHAPES)} ResnetBlocks: {total:.4f}")
    results["fused_resnet_backward"].update(shapes=rows, device_ms_29=total)


def phase_flash_backward(gen, results):
    """K7b against autograd of the flash op's plain version, run in float32
    on the same values, at the FLASH_SHAPES; determinism; times at the RT
    lengths 34 and 340 around the wrapper and on the device (its kernels a
    call, which must be flash_backward_plan's one launch), against the plain
    backward from the same saved (float32 out, stats) and the backward of
    ``scaled_dot_product_attention``; then at n = m = FLASH_BWD_LONG (two
    launches) against that library backward alone."""
    import torch

    from dquartic_tpu_torch.ops import flash_attention as fa

    scale = 32 ** -0.5
    err, times = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        for b, h, n, m in FLASH_SHAPES:
            q, k, v = _flash_inputs(gen, b, h, n, m, dt)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            # out: float32, and the rows' statistics, as autograd saves them
            _, out, stats = fa._launch_forward(q, k, v, scale)
            got = fa.flash_attention_backward(q, k, v, out, stats, do, scale)
            again = fa.flash_attention_backward(q, k, v, out, stats, do, scale)
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  "K7b: two identical calls gave different gradients")
            ts = [t.float().requires_grad_(True) for t in (q, k, v)]
            ref = torch.autograd.grad(fa.flash_attention_plain(ts[0], ts[1], ts[2], scale),
                                      ts, do.float())
            err = max(err, _compare_grads(
                f"K7b flash_attention_backward {tag} ({b}, {h}, {n}, 32) x m {m}", got, ref,
                GRAD_TOL[tag]))
            if dt == torch.bfloat16 and (b, n) in ((1, 34), (1, 340)):
                def call():
                    return fa.flash_attention_backward(q, k, v, out, stats, do, scale)

                plan = fa.flash_backward_plan(b, h, n, m)
                _, per_call, kinds, dev_ms = device_kernels(call, 50, plan["launches"])
                log(f"  K7b (1, 4, {n}, 32) bf16 on the device: kernels {kinds}, "
                    f"{per_call:g} a call as the profiler counted them (plan: "
                    f"{plan['launches']}, {plan['cluster']} CTAs a cluster)")
                check(len(kinds) == plan["launches"] and all("flash_bwd" in k for k in kinds),
                      f"K7b (1, 4, {n}): kernels on the device {kinds}, not its plan's")
                # the library call: autograd's backward of
                # scaled_dot_product_attention from its saved forward
                ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
                lo = torch.nn.functional.scaled_dot_product_attention(*ls)
                times[n] = (
                    cuda_time(call, 50),
                    cuda_time(lambda: fa.flash_attention_backward_reference(
                        q, k, v, out, stats, do, scale), 50),
                    cuda_time(lambda: torch.autograd.grad(lo, ls, do, retain_graph=True), 50),
                    dev_ms, len(kinds), flash_bound(b, h, n, m, 32, 2, backward=True),
                )
                del ls, lo
            del got, again, ref
    for n, (ms, plain_ms, lib_ms, dev_ms, launches, bnd) in times.items():
        log(f"  time flash_attention_backward bf16 (1, 4, {n}, 32): kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms in {launches} launch(es), torch.profiler), plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention backward {lib_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.3e} ms ({bnd['bound_by']})")
    n = FLASH_BWD_LONG
    q, k, v = _flash_inputs(gen, 1, 4, n, n, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    _, out, stats = fa._launch_forward(q, k, v, scale)
    long_ms = cuda_time(lambda: fa.flash_attention_backward(q, k, v, out, stats, do, scale), 5)
    ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lo = torch.nn.functional.scaled_dot_product_attention(*ls)
    long_lib = cuda_time(lambda: torch.autograd.grad(lo, ls, do, retain_graph=True), 5)
    log(f"  time flash_attention_backward bf16 (1, 4, {n}, 32), "
        f"{fa.flash_backward_plan(1, 4, n, n)['launches']} launches: kernel {long_ms:.4f} ms, "
        f"scaled_dot_product_attention backward {long_lib:.4f} ms, bound "
        f"{flash_bound(1, 4, n, n, 32, 2, backward=True)['bound_ms']:.4f} ms")
    del q, k, v, do, out, stats, ls, lo
    torch.cuda.empty_cache()
    results["flash_attention_backward"].update(
        max_abs_err=err, ms=times[34][0], plain_ms=times[34][1], library_ms=times[34][2],
        device_ms=times[34][3], kernels_a_call=times[34][4], ms_340=times[340][0],
        plain_ms_340=times[340][1], library_ms_340=times[340][2], device_ms_340=times[340][3],
        kernels_a_call_340=times[340][4], bound_ms_340=times[340][5]["bound_ms"],
        ms_long=long_ms, library_ms_long=long_lib, **times[34][5])


def _train_config(config, **tpu):
    cfg = json.loads(json.dumps(config))
    cfg["tpu"].update(quantize_mid=False, fused_resnet=True, **tpu)
    return cfg


def _pair_batch(seed, mz=None, rows=1):
    import numpy as np

    rng = np.random.default_rng(seed)
    mz = mz or MZ
    return {k: rng.uniform(0, 1, s).astype(np.float32) for k, s in
            (("ms2_1", (rows, RT, mz)), ("ms1_1", (rows, RT)), ("ms2_2", (rows, RT, mz)))}


def _step_backward(model, process, batch, t, eps) -> float:
    """One step's loss and backward; the gradients stay in ``.grad``."""
    import torch

    model.zero_grad(set_to_none=True)
    ms2_cond = 0.5 * batch["ms2_1"] + 0.5 * batch["ms2_2"]
    loss, _ = process.train_loss(model, batch["ms2_1"], ms2_cond, batch["ms1_1"], t=t, eps=eps)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach())


def _cos(a, b) -> float:
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-30))


def _rel_l2(got, ref) -> float:
    num = sum(float((a - b).square().sum()) for a, b in zip(got, ref))
    return (num / sum(float(b.square().sum()) for b in ref)) ** 0.5


def compare_step_grads(model, process, batch, t, eps, what="full-width", bf16_vs_f32=False):
    """One step's gradients on the kernels against the plain path on the
    same weights and draws, float32 and bf16 compute: relative L2 of the
    whole gradient vector and the worst per-tensor cosine. Holds one copy
    of the kernel path's gradients; the plain path's stay in ``.grad``.
    ``bf16_vs_f32`` also keeps the float32 gradient and, in bf16, holds
    both paths against it and the per-tensor cosine outside BF16_TOWER
    (see there). Returns each dtype's readings against its gate."""
    import torch

    names = [n for n, _ in model.named_parameters()]
    g32, readings = None, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        model.compute_dtype = dtype
        loss_k = _step_backward(model.use_kernels(True), process, batch, t, eps)
        gk = [p.grad.float().clone() for p in model.parameters()]
        loss_p = _step_backward(model.use_kernels(False), process, batch, t, eps)
        gp = [p.grad.float() for p in model.parameters()]
        model.use_kernels(True)
        rel = _rel_l2(gk, gp)
        cos = [(_cos(a, b), n) for a, b, n in zip(gk, gp, names)]
        worst = min(cos)
        finite = all(bool(torch.isfinite(a).all()) for a in gk)
        rel_tol, cos_tol = STEP_GRAD_TOL[tag]
        cos_note = f", tol {cos_tol:g}" if g32 is None else ""
        log(f"  {what} step gradients {tag}: loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
            f"rel L2 of the gradient vector {rel:.3e} (tol {rel_tol:g}), worst per-tensor "
            f"cosine {worst[0]:.6f} ({worst[1]}{cos_note}), all finite {finite}")
        check(finite, f"{tag}: non-finite gradient")
        if g32 is not None:
            worst = min(c for c in cos if not c[1].startswith(BF16_TOWER))
            rel_k, rel_p = _rel_l2(gk, g32), _rel_l2(gp, g32)
            tower = [min((_cos(g, r), n) for g, r, n in zip(grads, g32, names)
                         if n.startswith(BF16_TOWER)) for grads in (gk, gp)]
            log(f"  {what} step gradients {tag} against float32: rel L2 kernels {rel_k:.3e}, "
                f"plain {rel_p:.3e} (ratio {rel_k / rel_p:.3f}, tol {BF16_REL_RATIO:g}); MS1 tower "
                f"worst per-tensor cosine kernels {tower[0][0]:.6f} ({tower[0][1]}), plain "
                f"{tower[1][0]:.6f} ({tower[1][1]}); kernels vs plain outside the tower: "
                f"worst cosine {worst[0]:.6f} ({worst[1]}, tol {cos_tol:g})")
            check(rel_k <= BF16_REL_RATIO * rel_p,
                  f"{tag}: {what} gradients on the kernels are further from float32 than the "
                  f"plain path's")
        check(rel <= rel_tol and worst[0] >= cos_tol,
              f"{tag}: {what} gradients on the kernels disagree with the plain path")
        readings[tag] = dict(rel_l2=rel, worst_cosine=worst[0], worst_tensor=worst[1],
                             cosine_gate=cos_tol)
        if bf16_vs_f32 and dtype == torch.float32:
            g32 = gk
        del gk, gp
        model.zero_grad(set_to_none=True)
    return readings


def timed_steps(trainer, batch, gen, kernels, lr=1e-4):
    """TRAIN_STEPS ``train_step``s on the kernel or the plain path, each
    timed by CUDA events: (sorted ms, launch counts, peak GiB, losses)."""
    import torch

    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts

    trainer.model.use_kernels(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    runs, losses = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer.train_step(batch, lr, generator=gen)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    counts = launch_counts()
    trainer.model.use_kernels(True)
    return sorted(runs), counts, torch.cuda.max_memory_allocated() / 2**30, losses


def profile_step(step, step_ms):
    """One call of ``step`` under ``torch.profiler``, CUDA events around it:
    its ms, the device time of every kernel summed (each kernel's self
    time; the step runs on one stream, so the kernels do not overlap), the
    device's busy and idle share of ``step_ms`` (the step's ms timed without
    the profiler, whose own host work lengthens the profiled step) and of
    the profiled step, K4's and K5's device ms and launches, and the
    largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    by_name = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "CUDA")):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us:
            ms, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (ms + us / 1e3, n + e.count)
    busy = sum(ms for ms, _ in by_name.values())

    def of(name):
        hits = [v for k, v in by_name.items() if name in k]
        return sum(ms for ms, _ in hits), sum(n for _, n in hits)

    k4, k5, k7b = of("linattn_bwd"), of("resnet_bwd"), of("flash_bwd")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(step_ms=step_ms, profiled_step_ms=wall, device_ms=busy,
                busy_share=busy / step_ms, idle_share=1 - busy / step_ms,
                profiled_busy_share=busy / wall,
                k4_device_ms=k4[0], k4_launches=k4[1], k5_device_ms=k5[0], k5_launches=k5[1],
                k7b_device_ms=k7b[0], k7b_launches=k7b[1],
                top=[(k[:60], round(ms, 4), n) for k, (ms, n) in top])


def check_k7b_launches(prof, calls, what):
    """K7b's launches in a profiled step: ``calls`` calls at the RT axis, each
    the one launch of flash_backward_plan."""
    from dquartic_tpu_torch.ops import flash_attention as fa

    per_call = fa.flash_backward_plan(1, 4, RT, RT)["launches"]
    log(f"  {what}: K7b {prof['k7b_device_ms']:.4f} ms on the device in "
        f"{prof['k7b_launches']} launches for {calls} calls (plan: {per_call} a call)")
    check(prof["k7b_launches"] == calls * per_call,
          f"{what}: K7b ran {prof['k7b_launches']} launches for {calls} calls, not "
          f"{per_call} a call")
    return prof["k7b_launches"] / calls


def phase_train(config, seed, gen, results):
    """Full-width training through build_trainer: kernel vs plain gradients,
    six steps with launch counts, ms/step and peak memory."""
    import torch

    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 1).items()}
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    eps = torch.randn((1, RT, MZ), generator=gen, device=dev)

    # (a) one step's gradients, kernels vs plain path, same weights and draws
    cfg = _train_config(config, compute_dtype="float32")
    model = build_model(cfg, device=dev, seed=seed, trainable=True)
    compare_step_grads(model, build_process(cfg), batch, t, eps)
    del model
    torch.cuda.empty_cache()

    # (b) train_step 1 + 5 times through build_trainer, bf16 on float32 masters
    cfg = _train_config(config, compute_dtype="bfloat16")
    trainer = build_trainer(cfg, device=dev, seed=seed)
    n_params = trainer.num_parameters()
    probe = dict(trainer.model.named_parameters())["init_conv.weight"]
    idx = [i for i, p in enumerate(trainer.optimizer.params) if p is probe][0]
    p0, e0 = probe.detach().clone(), trainer.ema_params[idx].clone()
    m = trainer.train_step(batch, 1e-4, generator=gen)  # warm-up step
    torch.cuda.synchronize()
    losses = [float(m["loss"])]
    for path, kernels in (("kernel", True), ("plain", False)):
        runs, counts, peak, step_losses = timed_steps(trainer, batch, gen, kernels)
        losses += step_losses
        median = runs[len(runs) // 2]
        log(f"  train_step ({n_params / 1e9:.3f} B params, bs1, 34x40000, bf16 on float32 "
            f"masters, AdamW + EMA), {path} path: median {median:.2f} ms/step of "
            f"{TRAIN_STEPS} (min {runs[0]:.2f}, max {runs[-1]:.2f}), peak device memory "
            f"{peak:.2f} GiB, launches {counts}")
        if kernels:
            expect = _expect(STEP_LAUNCHES, TRAIN_STEPS)
            check(counts == expect, f"train launches {counts} != {expect}")
            for name, n in counts.items():
                results[name]["train_launches"] = n
            for name in ("linear_attention_backward", "fused_resnet_backward",
                         "flash_attention_backward"):
                results[name]["launches"] = counts[name]
            results["train"] = dict(ms_per_step=median, peak_gib=peak)
        else:
            results["train"].update(plain_ms_per_step=median, plain_peak_gib=peak)
    prof = profile_step(lambda: trainer.train_step(batch, 1e-4, generator=gen),
                        results["train"]["ms_per_step"])
    log(f"  one kernel-path train_step under torch.profiler: {prof['profiled_step_ms']:.2f} ms, "
        f"device busy {prof['device_ms']:.2f} ms: {100 * prof['busy_share']:.1f} % of the "
        f"{prof['step_ms']:.2f} ms step timed without the profiler (idle "
        f"{100 * prof['idle_share']:.1f} %), {100 * prof['profiled_busy_share']:.1f} % of the "
        f"profiled step; K4 {prof['k4_device_ms']:.4f} ms in "
        f"{prof['k4_launches']} launches, K5 {prof['k5_device_ms']:.4f} ms in "
        f"{prof['k5_launches']} launches; largest kernels {prof['top']}")
    check(prof["k4_launches"] <= 2 * STEP_LAUNCHES["linear_attention_backward"] and
          prof["k5_launches"] <= 2 * STEP_LAUNCHES["fused_resnet_backward"],
          f"K4 or K5 ran more than two launches a call: {prof}")
    for name, key in (("linear_attention_backward", "k4_launches"),
                      ("fused_resnet_backward", "k5_launches")):
        results[name]["launches_call"] = prof[key] / STEP_LAUNCHES[name]
    results["flash_attention_backward"]["launches_call"] = check_k7b_launches(
        prof, STEP_LAUNCHES["flash_attention_backward"], "the step's profile")
    results["train"]["profile"] = prof
    log(f"  losses over the {len(losses)} steps: {[round(v, 6) for v in losses]}")
    check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite training loss")
    moved = float((probe.detach() - p0).abs().max())
    ema_moved = float((trainer.ema_params[idx] - e0).abs().max())
    log(f"  init_conv.weight moved by max {moved:.3e}, its EMA by {ema_moved:.3e}")
    check(moved > 0 and ema_moved > 0, "parameters or EMA did not move")
    del trainer, probe
    torch.cuda.empty_cache()


def phase_train_loop(config, seed):
    """Trainer.train for 2 epochs at small depth with checkpoints, resume,
    and a 10-step predict from the EMA weights."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.train import latest_path_for, load_checkpoint
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    mz = 256
    cfg = _train_config(config, compute_dtype="bfloat16")
    cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=mz)
    data = [_pair_batch(seed + 10 + i, mz=mz) for i in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        best = os.path.join(tmp, "best_model.ckpt")
        cfg["model"]["checkpoint_path"] = best
        reset_launch_counts()
        trainer = build_trainer(cfg, device="cuda", seed=seed)
        trainer.train(data, epochs=2, warmup_epochs=1, learning_rate=1e-3, checkpoint_path=best)
        counts = launch_counts()
        latest = latest_path_for(best)
        check(os.path.exists(best) and os.path.exists(latest), "checkpoints were not written")
        ck = load_checkpoint(latest)
        check(ck["epoch"] == 1 and ck["step"] == 4, f"latest checkpoint epoch {ck['epoch']}")
        check(all(counts[k] > 0 for k in ("linear_attention", "linear_attention_backward",
                                          "fused_resnet_block_t", "fused_resnet_backward")),
              f"small-depth training did not run every kernel: {counts}")
        resumed = build_trainer(cfg, device="cuda", seed=seed)
        resumed.train(data, epochs=3, warmup_epochs=1, learning_rate=1e-3, checkpoint_path=best)
        check(resumed.step == 6, f"resumed run took {resumed.step - 4} steps after step 4, not 2")
        for tr in (trainer, resumed):
            tr.logger.finish()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        check([r["epoch"] for r in epochs] == [0, 1, 2] and all(
            {"train/loss", "learning_rate", "epoch_seconds", "steps_per_second"} <= set(r)
            for r in epochs), f"metrics.jsonl holds {epochs}")
        log(f"  metrics.jsonl: epochs {[r['epoch'] for r in epochs]}, losses "
            f"{[round(r['train/loss'], 6) for r in epochs]}")
        log(f"  2 epochs of 2 steps, checkpoints {sorted(os.listdir(tmp))} "
            f"({os.path.getsize(latest) / 2**20:.1f} MiB each), launches {counts}; resumed "
            f"after epoch {ck['epoch']} and ran epoch 2 (step {resumed.step})")
        model = build_model(cfg, device="cuda", seed=seed + 99)
        model.load_state_dict(resumed.ema_state_dict())
        recs = DDIMSampler(model, build_process(cfg)).predict(
            [data[0]], num_steps=10, seed=seed, device="cuda")
        pred = recs[0]["pred"]
        log(f"  10-step predict from the EMA weights: pred {pred.shape}, finite "
            f"{bool(np.isfinite(pred).all())}, range [{pred.min():.4f}, {pred.max():.4f}]")
        check(pred.shape == (1, RT, mz) and bool(np.isfinite(pred).all()), "bad EMA prediction")
        del trainer, resumed, model
    torch.cuda.empty_cache()


def _tfer_config(config, depth=TFER_DEPTH):
    cfg = json.loads(json.dumps(config))
    cfg["model"]["UNet1d"].update(simple=False, tfer_depth=depth)
    cfg["tpu"]["attn_impl"] = "pallas"
    return cfg


def phase_tfer(config, seed, gen, results):
    """The simple=False model at full width: forward, serving, training."""
    cfg = _tfer_config(config)
    phase_forward(cfg, seed, gen, TFER_FORWARD, what=f"simple=False UNet1d (tfer_depth {TFER_DEPTH})")
    counts, per_window = phase_sample(cfg, seed, gen, TFER_FORWARD, what="simple=False")
    for name, n in counts.items():
        results[name]["tfer_launches"] = n
    results["tfer"] = dict(ms_per_window=per_window["kernel"],
                           plain_ms_per_window=per_window["plain"])
    phase_tfer_train(config, seed, gen, results)


def phase_tfer_train(config, seed, gen, results):
    """Training of the full-depth simple=False model through build_trainer:
    one step's gradients, kernels vs plain; then 1 + TRAIN_STEPS steps per
    path. Each sub-step builds its own model and frees it (the kernel path's
    steps peak at about 63 GiB, the plain path's at about 66)."""
    import torch

    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 2).items()}
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    eps = torch.randn((1, RT, MZ), generator=gen, device=dev)

    cfg = _train_config(_tfer_config(config), compute_dtype="float32")
    model = build_model(cfg, device=dev, seed=seed, trainable=True)
    torch.cuda.reset_peak_memory_stats()
    readings = compare_step_grads(model, build_process(cfg), batch, t, eps,
                                  what=f"simple=False (tfer_depth {TFER_DEPTH})",
                                  bf16_vs_f32=True)
    gate = readings["bfloat16"]
    log(f"  peak device memory of the gradient comparison "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the bf16 gate reads a worst "
        f"per-tensor cosine of {gate['worst_cosine']:.6f} ({gate['worst_tensor']}) against "
        f"its {gate['cosine_gate']:g}")
    results["tfer"]["bf16_gradient_gate"] = gate
    del model
    torch.cuda.empty_cache()

    per_path = {}
    cfg = _train_config(_tfer_config(config), compute_dtype="bfloat16")
    for path, kernels in (("kernel", True), ("plain", False)):
        trainer = build_trainer(cfg, device=dev, seed=seed)
        n_params = trainer.num_parameters()
        trainer.model.use_kernels(kernels)
        trainer.train_step(batch, 1e-4, generator=gen)  # warm-up step
        runs, counts, peak, losses = timed_steps(trainer, batch, gen, kernels)
        median = runs[len(runs) // 2]
        log(f"  simple=False train_step (tfer_depth {TFER_DEPTH}, {n_params / 1e9:.3f} B params, "
            f"bs1, 34x40000, bf16 on float32 masters, AdamW + EMA), {path} path: median "
            f"{median:.2f} ms/step of {TRAIN_STEPS} (min {runs[0]:.2f}, max {runs[-1]:.2f}), "
            f"peak device memory {peak:.2f} GiB, launches {counts}, losses "
            f"{[round(v, 6) for v in losses]}")
        check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite training loss")
        if kernels:
            expect = _expect(TFER_STEP, TRAIN_STEPS)
            check(counts == expect, f"train launches {counts} != {expect}")
            for name, n in counts.items():
                results[name]["tfer_train_launches"] = n
            prof = profile_step(lambda: trainer.train_step(batch, 1e-4, generator=gen), median)
            results["flash_attention_backward"]["tfer_launches_call"] = check_k7b_launches(
                prof, TFER_STEP["flash_attention_backward"], "a simple=False step's profile")
        per_path[path] = dict(ms_per_step=median, peak_gib=peak, params=n_params)
        del trainer
        torch.cuda.empty_cache()
    results["tfer"].update(train=per_path)


def _rows_config(config, **tpu):
    """The path of phase 9: the unfused UNet1d, every mixer on K8."""
    cfg = json.loads(json.dumps(config))
    cfg["tpu"].update(fused_resnet=False, linear_attn_impl="pallas", **tpu)
    return cfg


def phase_rows_kernels(gen, results):
    """K8 and K9 against their plain version at ROWS_SHAPES + ROWS_EXTRA,
    float32 (TF32 off) and bf16 (against the plain version run in float32
    on the same bf16 values), on the model's channel-first memory; bf16
    times at every mixer shape through the wrapper and of the kernel alone
    (the launch of its checked arguments) and on the device with their
    kernels a call (K8 one, K9 two: the wrappers run no torch op on the
    device), beside the plain version's and the bound."""
    import torch

    from dquartic_tpu_torch.ops import linear_attention as la

    dev = torch.device("cuda")

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    ops = {"fused_linear_attention": (la.fused_linear_attention, False, "K8"),
           "fused_linear_attention_two_call": (la.fused_linear_attention_two_call, True, "K9")}
    errs = dict.fromkeys(ops, 0.0)
    table = []
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).replace("torch.", "")
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            for C, N in ROWS_SHAPES + ROWS_EXTRA:
                w = [randn(C, 384, s=0.3), randn(128, C, s=0.1), randn(C, s=0.1), randn(C)]
                x = randn(34, C, N).to(dt).transpose(1, 2)  # (B, N, C) view of (B, C, N)
                ref = la.linear_attention_rows_reference(x.float(), *w)
                for name, (op, _, label) in ops.items():
                    errs[name] = max(errs[name], _compare(
                        f"{label} {name} {tag} (34, {N}, {C})", op(x, *w), ref, tol))
                if dt == torch.bfloat16 and (C, N) in ROWS_SHAPES:
                    row = dict(C=C, N=N)
                    for name, (op, two_call, label) in ops.items():
                        launch, _ = la.rows_launcher(name, x, *w, 4, 32, two_call)
                        row[label] = (cuda_time(lambda: op(x, *w), 20), cuda_time(launch, 20))
                    for label, op, n_kernels in (("K8", la.fused_linear_attention, 1),
                                                 ("K9", la.fused_linear_attention_two_call, 2)):
                        _, per_call, kinds, once_ms = device_kernels(lambda: op(x, *w), 20,
                                                                     n_kernels)
                        check(len(kinds) == n_kernels and
                              all(k.startswith("linattn_rows_cluster") for k in kinds),
                              f"{label} (34, {N}, {C}): kernels on the device {kinds}, not "
                              f"its {n_kernels} modes of linattn_rows_cluster")
                        row[f"{label}_device"] = (once_ms, per_call)
                    row["plain"] = cuda_time(lambda: la.linear_attention_rows_reference(x, *w), 5)
                    row["bound"] = linattn_bound(34, C, N, 2)
                    table.append(row)
                del w, x, ref
            torch.cuda.empty_cache()
    log("  bf16 (34, N, C) on channel-first memory, ms: K8 and K9 each wrapper / kernels "
        "alone / on the device (kernels a call), K9 / K8 on the device, plain, bound:")
    for r in table:
        log(f"    C {r['C']:2d} N {r['N']:5d}: K8 {r['K8'][0]:.4f} / {r['K8'][1]:.4f} / "
            f"{r['K8_device'][0]:.4f} ({r['K8_device'][1]:.1f}), K9 {r['K9'][0]:.4f} / "
            f"{r['K9'][1]:.4f} / {r['K9_device'][0]:.4f} ({r['K9_device'][1]:.1f}), "
            f"{r['K9_device'][0] / r['K8_device'][0]:.3f}, plain {r['plain']:.4f}, bound "
            f"{r['bound']['bound_ms']:.4f} ({r['bound']['bound_by']})")
    top = table[0]  # the level-0 shape (34, 40000, 4)
    log(f"  K8 (34, {MZ}, 4): exp floor {exp_floor(2 * 128 * 34 * MZ):.4f} ms")
    # a row's columns all equal, float32: the plain version's own float32
    # sums drift there (cuBLAS adds a row's like terms in turn), so K8 is
    # held against the plain version in float64
    C, N = ROWS_SHAPES[0]
    w = [randn(C, 384, s=0.3), randn(128, C, s=0.1), randn(C, s=0.1), randn(C)]
    x = randn(34, C, 1).expand(34, C, N).contiguous().transpose(1, 2)
    ref = la.linear_attention_rows_reference(x.double(), *(t.double() for t in w)).float()
    drift = float((la.linear_attention_rows_reference(x, *w) - ref).abs().max())
    with torch.no_grad():
        y = la.fused_linear_attention(x, *w)
    log(f"  equal columns (34, {N}, {C}) float32: the plain version in float32 is max_abs "
        f"{drift:.3e} from float64")
    _compare(f"K8 equal columns float32 (34, {N}, {C}) vs the plain version in float64", y, ref,
             F32_TOL)
    del w, x, y, ref
    for name, (_, _, label) in ops.items():
        results[name].update(max_abs_err=errs[name], ms=top[label][0], kernel_ms=top[label][1],
                             plain_ms=top["plain"], library_ms=None, **top["bound"],
                             per_shape={f"{r['C']}x{r['N']}": r[label] for r in table})
    for name, (_, _, label) in ops.items():
        results[name].update(
            device_ms=top[f"{label}_device"][0], kernels_a_call=top[f"{label}_device"][1],
            device_per_shape={f"{r['C']}x{r['N']}": r[f"{label}_device"][0] for r in table})


def phase_rows_sweep(gen):
    """The "auto" crossover: the whole mixer (LinearAttention, bf16 serving
    weights, inference mode) under "pallas_t" (K1), "pallas" (K8) and
    "xla" at B = 34, C in SWEEP_C, N in SWEEP_N. Prints the smallest swept
    N from which K1 is faster than the "xla" path at every larger swept N
    and C, which must be LINATTN_MIN_SEQ."""
    import torch

    from dquartic_tpu_torch.models import attention as ma

    impls = ("pallas_t", "pallas", "xla")
    k1_wins = {}
    log(f"  sweep, bf16 mixer (34, C, N), ms by impl {impls}; LINATTN_MIN_SEQ = {ma.LINATTN_MIN_SEQ}:")
    with torch.inference_mode():
        for C in SWEEP_C:
            m = ma.LinearAttention(C).cuda()
            for p in m.parameters():
                p.data.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            m.to_qkv.to(torch.bfloat16)
            m.to_out[0].to(torch.bfloat16)
            g_pre = torch.ones(C, device="cuda")
            for N in SWEEP_N:
                x = torch.randn((34, C, N), generator=gen, device="cuda").to(torch.bfloat16)
                runs = {impl: [] for impl in impls}
                for _ in range(SWEEP_REPS):  # impls in turn; the median of each
                    for impl in impls:
                        m.impl = impl
                        runs[impl].append(cuda_time(lambda: m(x, g_pre), 20 if N <= 5000 else 5))
                t = {impl: sorted(r)[len(r) // 2] for impl, r in runs.items()}
                k1_wins.setdefault(N, []).append(t["pallas_t"] < t["xla"])
                best = min(t, key=t.get)
                log(f"    C {C:2d} N {N:5d}: " + ", ".join(f"{i} {t[i]:.4f}" for i in impls)
                    + f" -> {best} fastest")
                del x
            del m
            torch.cuda.empty_cache()
    wins = [all(k1_wins[n]) for n in SWEEP_N]
    first = next((n for i, n in enumerate(SWEEP_N) if all(wins[i:])), None)
    log(f"  smallest swept N from which K1 beats the xla path at every larger N and C: {first}")
    check(first == ma.LINATTN_MIN_SEQ,
          f"the sweep puts the crossover at {first}, LINATTN_MIN_SEQ is {ma.LINATTN_MIN_SEQ}")


def phase_rows_train(config, seed, gen, results):
    """Full-width training of the unfused "pallas" model (float32 masters,
    no int8) through build_trainer: one step's gradients, kernels vs plain
    path, float32 and bf16, and in bf16 each path against the float32
    gradient; then 1 + TRAIN_STEPS ``train_step``s per path with K8 14
    launches per step on the kernel path (its gradient is the recomputed
    reference's vjp, as in JAX's ``_fused`` custom_vjp), ms/step and peak
    memory. The plain path runs the mixers' reference under autograd."""
    import torch

    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 3).items()}
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    eps = torch.randn((1, RT, MZ), generator=gen, device=dev)

    cfg = _rows_config(config, quantize_mid=False, compute_dtype="float32")
    model = build_model(cfg, device=dev, seed=seed, trainable=True)
    compare_step_grads(model, build_process(cfg), batch, t, eps, what="unfused pallas",
                       bf16_vs_f32=True)
    del model
    torch.cuda.empty_cache()

    cfg = _rows_config(config, quantize_mid=False, compute_dtype="bfloat16")
    trainer = build_trainer(cfg, device=dev, seed=seed)
    n_params = trainer.num_parameters()
    trainer.train_step(batch, 1e-4, generator=gen)  # warm-up step
    torch.cuda.synchronize()
    per_path = {}
    for path, kernels in (("kernel", True), ("plain", False)):
        runs, counts, peak, losses = timed_steps(trainer, batch, gen, kernels)
        median = runs[len(runs) // 2]
        log(f"  unfused pallas train_step ({n_params / 1e9:.3f} B params, bs1, 34x40000, bf16 "
            f"on float32 masters, AdamW + EMA), {path} path: median {median:.2f} ms/step of "
            f"{TRAIN_STEPS} (min {runs[0]:.2f}, max {runs[-1]:.2f}), peak device memory "
            f"{peak:.2f} GiB, launches {counts}, losses {[round(v, 6) for v in losses]}")
        check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite training loss")
        if kernels:
            expect = _expect(ROWS_STEP, TRAIN_STEPS)
            check(counts == expect, f"train launches {counts} != {expect}")
            results["fused_linear_attention"]["train_launches"] = counts["fused_linear_attention"]
        per_path[path] = dict(ms_per_step=median, peak_gib=peak)
    results["rows"].update(train=per_path)
    del trainer
    torch.cuda.empty_cache()


def phase_rows(config, seed, gen, results):
    """Phase 9: K8/K9 against their plain version, the sweep, then the
    unfused "pallas" model: forward, 50-step predict (the main path of
    this phase: counts reset just before it, read just after), training."""
    phase_rows_kernels(gen, results)
    phase_rows_sweep(gen)
    cfg = _rows_config(config)
    phase_forward(cfg, seed, gen, ROWS_FORWARD, what="unfused UNet1d (linear_attn_impl pallas)")
    counts, per_window = phase_sample(cfg, seed, gen, ROWS_FORWARD, what="unfused pallas",
                                      results=results)
    results["fused_linear_attention"]["launches"] = counts["fused_linear_attention"]
    results["fused_linear_attention_two_call"]["launches"] = counts[
        "fused_linear_attention_two_call"]
    results["rows"] = dict(launches=counts, ms_per_window=per_window["kernel"],
                           plain_ms_per_window=per_window["plain"])
    phase_rows_train(config, seed, gen, results)


# --------------------------------------------------------------------- #
# phase 10: sequence parallel (K6a-c) over an sp = 2 group on one card  #
# --------------------------------------------------------------------- #


class _ThreadSum:
    """The ``reduce`` of a hand split: S threads on one card each hold a
    slice of N and sum their partials in rank order (no collective)."""

    def __init__(self, size):
        import threading

        self.barrier, self.slots = threading.Barrier(size, timeout=120), [None] * size

    def reduce_of(self, rank):
        def reduce(t):
            self.slots[rank] = t
            self.barrier.wait()
            total = self.slots[0].clone()
            for other in self.slots[1:]:
                total += other
            self.barrier.wait()
            t.copy_(total)
        return reduce


def _hand_split(x, dy, w, size):
    """K6 on ``size`` slices of N: K6a on each slice, the partials summed in
    rank order, K6b on each; then the backward's K6a (float32 operands),
    summed, and K6c on each slice in its own thread (given the sums and its
    own partials), the threads summing Z between its launches. No
    autograd: the engine runs the backward of all CUDA graphs on one device
    thread, which one waiting slice would block. Returns (y, [dx, summed
    weight gradients])."""
    import threading

    import torch

    from dquartic_tpu_torch.ops import linear_attention as la

    n = x.shape[2] // size
    xs = [x[:, :, r * n:(r + 1) * n].contiguous() for r in range(size)]
    dys = [dy[:, :, r * n:(r + 1) * n].contiguous() for r in range(size)]
    w_qkv, w_out, b_out, g, g_pre = w

    def summed(parts):
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    with torch.no_grad():
        st = summed([la.linear_attention_sp_stats(xr, w_qkv, g_pre) for xr in xs])
        y = torch.cat([la.linear_attention_sp_apply(xr, st, *w) for xr in xs], 2)
        local = [la.linear_attention_sp_stats(xr, w_qkv, g_pre, round_operands=False)
                 for xr in xs]
        st32 = summed(local)
        sums, grads, errors = _ThreadSum(size), [None] * size, []

        def run(r):
            try:
                grads[r] = la.linear_attention_sp_backward(dys[r], xs[r], *w, st32, local[r],
                                                           sums.reduce_of(r))
            except Exception as e:  # raised in the calling thread below
                errors.append(e)
                sums.barrier.abort()

        threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise errors[0]
        torch.cuda.synchronize()
    return y, [torch.cat([gr[0] for gr in grads], 2)] + [summed([gr[i] for gr in grads])
                                                         for i in range(1, 6)]


def phase_sp_kernels(gen, results):
    """K6a, K6b, K6c against their plain versions at the sharded widths of
    the 12 K6 mixers and a ragged N, float32 (TF32 off) and bf16; their
    times at (34, 4, 20000) bf16; then the hand split of N into 2 and 4
    slices against K1 and K4 on the whole N."""
    import torch

    from dquartic_tpu_torch.ops import linear_attention as la

    dev = torch.device("cuda")

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    def weights(C):
        return [randn(C, 384, s=0.3), randn(128, C, s=0.1), randn(C, s=0.1), randn(C),
                1.0 + randn(C, s=0.2)]

    names = ("linear_attention_sp_stats", "linear_attention_sp_apply",
             "linear_attention_sp_backward")
    errs = dict.fromkeys(names, 0.0)
    timing = {}
    no_sum = lambda t: None  # noqa: E731  (one slice: its partials are the sums)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for C, n in SP_SHAPES:
            w = weights(C)
            x, dy = randn(34, C, n).to(dt), randn(34, C, n).to(dt)
            with torch.no_grad():
                for rnd in (True, False):  # the forward's operands, the backward's
                    st = la.linear_attention_sp_stats(x, w[0], w[4], round_operands=rnd)
                    ref = la.sp_stats_reference(x, w[0], w[4], round_operands=rnd)
                    errs[names[0]] = max(errs[names[0]], _compare(
                        f"K6a sp_stats {tag} (34, {C}, {n}), "
                        f"{'rounded' if rnd else 'float32'} operands", st, ref, SP_STATS_TOL,
                        float(ref.abs().max())))
                _, _, m = la.sp_context(ref, w[0], w[1], round_m=dt == torch.bfloat16)
                y = la.linear_attention_sp_apply(x, ref, *w)
                ref_y = la.sp_apply_reference(x, m, w[0], w[2], w[3], w[4])
                errs[names[1]] = max(errs[names[1]], _compare(
                    f"K6b sp_apply {tag} (34, {C}, {n})", y, ref_y, tol))
                st32 = ref  # one slice: its own stats are the sums
                got = la.linear_attention_sp_backward(dy, x, *w, st32, st32, no_sum)
                ref_g = la.sp_backward_reference(dy, x, *w, st32, st32, no_sum)
            errs[names[2]] = max(errs[names[2]], _compare_grads(
                f"K6c sp_backward {tag} (34, {C}, {n})", got, ref_g, GRAD_TOL[tag]))
            if dt == torch.bfloat16 and (C, n) == SP_SHAPES[0]:
                calls = {  # kernel, plain version, reps
                    "K6a": (lambda: la.linear_attention_sp_stats(x, w[0], w[4]),
                            lambda: la.sp_stats_reference(x, w[0], w[4]), 20),
                    "K6a float32 operands": (
                        lambda: la.linear_attention_sp_stats(x, w[0], w[4], round_operands=False),
                        lambda: la.sp_stats_reference(x, w[0], w[4], round_operands=False), 20),
                    "K6b": (lambda: la.linear_attention_sp_apply(x, ref, *w),
                            lambda: la.sp_apply_reference(x, m, w[0], w[2], w[3], w[4]), 20),
                    "K6 forward": (
                        lambda: la._LinearAttentionSpFn.apply(x, *w, 4, 32, no_sum),
                        lambda: la.linear_attention_sp_apply(
                            x, la.sp_stats_reference(x, w[0], w[4]), *w), 10),
                    "K6c": (lambda: la.linear_attention_sp_backward(dy, x, *w, st32, st32, no_sum),
                            lambda: la.sp_backward_reference(dy, x, *w, st32, st32, no_sum), 10),
                }
                with torch.no_grad():
                    for what, (kernel, plain, reps) in calls.items():
                        timing[what] = (cuda_time(kernel, reps), cuda_time(plain, 3),
                                        device_kernels(kernel, reps, SP_KERNELS_A_CALL.get(what)))
            del w, x, dy, got, ref_g
        torch.cuda.empty_cache()
    bounds = {"K6a": linattn_bound(34, *SP_SHAPES[0], 2, tensors=1, passes=2),
              "K6b": linattn_bound(34, *SP_SHAPES[0], 2, tensors=2, passes=2),
              "K6c": linattn_bound(34, *SP_SHAPES[0], 2, tensors=3, passes=10),
              "K6": linattn_bound(34, *SP_SHAPES[0], 2, tensors=2, passes=4)}
    for what, (ms, plain_ms, (dev_ms, per_call, kinds, once_ms)) in timing.items():
        bnd = bounds[what.split()[0]]
        log(f"  time {what} bf16 (34, {SP_SHAPES[0][0]}, {SP_SHAPES[0][1]}): wrapper {ms:.4f} ms, "
            f"device {dev_ms:.4f} ms in {per_call:.1f} kernels a call, {once_ms:.4f} ms from each "
            f"kernel's mean once ({len(kinds)} kinds: {', '.join(kinds)}), plain "
            f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if what in SP_KERNELS_A_CALL:
            check(len(kinds) == SP_KERNELS_A_CALL[what],
                  f"{what}: {len(kinds)} kernels a call on the device, not "
                  f"{SP_KERNELS_A_CALL[what]} (a torch op beside the kernel, or a launch more)")
    # device ms: every K6 kernel runs once a call (the kinds checked above),
    # so each kernel's mean once stands where records drop
    def device(what):
        _, _, (_, per_call, _, once_ms) = timing[what]
        return dict(device_ms=once_ms, kernels_a_call=per_call)

    for name, what in zip(names, ("K6a", "K6b", "K6c")):
        ms, plain_ms, _ = timing[what]
        results[name].update(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=None,
                             **device(what), **bounds[what])
    results[names[0]].update(ms_float32_operands=timing["K6a float32 operands"][0],
                             device_ms_float32_operands=device("K6a float32 operands")["device_ms"])
    results[names[1]].update(forward_ms=timing["K6 forward"][0],
                             forward_device_ms=device("K6 forward")["device_ms"],
                             forward_kernels_a_call=device("K6 forward")["kernels_a_call"])

    # the hand split: K1 / K4 on the whole N against K6 over 2 and 4 slices
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        w = weights(4)
        x, dy = randn(34, 4, MZ).to(dt), randn(34, 4, MZ).to(dt)
        with torch.no_grad():
            ref_y = la.linear_attention(x, *w)
        ref_g = la.linear_attention_backward(dy, x, *w)
        for size in (2, 4):
            y, got = _hand_split(x, dy, w, size)
            _compare(f"hand split {size} x K6a/K6b vs K1 {tag} (34, 4, {MZ})", y, ref_y, tol)
            _compare_grads(f"hand split {size} x K6c vs K4 {tag} (34, 4, {MZ})", got, ref_g,
                           GRAD_TOL[tag])
        del w, x, dy, ref_g
    torch.cuda.empty_cache()


def _sp_config(config, dtype, sp):
    """The path of phase 10: the unfused canonical model, "auto" mixers, no
    int8, on a (1, sp, 1) mesh."""
    cfg = json.loads(json.dumps(config))
    cfg["tpu"].update(compute_dtype=dtype, quantize_mid=False, fused_resnet=False,
                      linear_attn_impl="auto", mesh={"dp": 1, "sp": sp, "tp": 1})
    return cfg


@contextlib.contextmanager
def _sp_dispatch():
    """The one-process reference with the sp path's mixer dispatch."""
    old = os.environ.get("DQUARTIC_LINATTN_MIN_SEQ")
    os.environ["DQUARTIC_LINATTN_MIN_SEQ"] = str(SP_REF_MIN_SEQ)
    try:
        yield
    finally:
        if old is None:
            del os.environ["DQUARTIC_LINATTN_MIN_SEQ"]
        else:
            os.environ["DQUARTIC_LINATTN_MIN_SEQ"] = old


def first_call_ms(fn):
    """``(ms, result)``: CUDA-event ms of one call of ``fn`` (its first: the
    sample of a rank whose ms/window measures no parallel speed)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


def _rank_log(rank, msg):
    log(f"  [rank {rank}] {msg}")


def _sp_rank(rank, init_method, config, seed, out_dir):
    """One of the SP ranks on cuda:0: the forward, an SP_STEPS-step
    predict and a train step at sp = SP, each then held on rank 0 against
    the same call in one process (sp = 1) while the other ranks wait."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.parallel import initialize_runtime, make_mesh
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_runtime("gloo", rank, SP, init_method, timeout_s=900)
    mesh = make_mesh(sp=SP)
    dev = torch.device("cuda")
    out = {"rank": rank}
    lead = rank == 0

    def inputs():
        g = torch.Generator(device=dev).manual_seed(seed + 10)
        return (torch.randn((1, RT, MZ), generator=g, device=dev),
                torch.full((1,), 500, dtype=torch.long, device=dev),
                torch.rand((1, RT, MZ), generator=g, device=dev) * 2 - 1,
                torch.rand((1, RT), generator=g, device=dev) * 2 - 1)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dist.barrier()

    # every all_reduce of this rank, and those the K6 op issues (a caller in
    # its module on the stack), counted here around torch.distributed
    k6_module = os.path.join("dquartic_tpu_torch", "ops", "linear_attention.py")
    collectives = {"all": 0, "k6": 0}
    real_all_reduce = dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        frame = sys._getframe(1)
        while frame is not None and not frame.f_code.co_filename.endswith(k6_module):
            frame = frame.f_back
        collectives["all"] += 1
        collectives["k6"] += frame is not None
        return real_all_reduce(*args, **kwargs)

    def count_collectives(what, fn):
        collectives.update(all=0, k6=0)
        result = fn()
        torch.cuda.synchronize()
        got = dict(collectives)
        check(got["k6"] == SP_COLLECTIVES[what],
              f"K6 all_reduces a {what}: {got['k6']}, not {SP_COLLECTIVES[what]}")
        _rank_log(rank, f"all_reduces a {what}: {got['all']}, of which K6 {got['k6']} "
                  f"(expected {SP_COLLECTIVES[what]})")
        out["collectives"][what] = got
        return result

    dist.all_reduce = counting_all_reduce
    out["collectives"] = {}

    # (a) the full-width forward, sp = SP against one process
    for dtype in ("float32", "bfloat16"):
        cfg = _sp_config(config, dtype, SP)
        model = build_model(cfg, device=dev, seed=seed, mesh=mesh)
        with torch.inference_mode():
            reset_launch_counts()
            y = count_collectives("forward", lambda: model(*inputs()))
            counts = launch_counts()
        check(counts == _expect(SP_FORWARD, cfg=cfg), f"sp forward launches {counts}")
        y = y.float().cpu()
        del model
        free()
        if lead:
            ref_model = build_model(_sp_config(config, dtype, 1), device=dev, seed=seed)
            with torch.inference_mode(), _sp_dispatch():
                ref = ref_model(*inputs()).float().cpu()
            rel = float((y - ref).norm() / ref.norm())
            _rank_log(rank, f"forward {dtype} at sp={SP} vs one process: rel L2 {rel:.3e} (tol "
                      f"{MODEL_REL_TOL[dtype]:g}), K6 launches {counts['linear_attention_sp_stats']}"
                      f" / {counts['linear_attention_sp_apply']}")
            check(rel <= MODEL_REL_TOL[dtype] and bool(torch.isfinite(y).all()),
                  f"sp forward {dtype} disagrees with one process")
            out[f"forward_rel_l2_{dtype}"] = rel
            del ref_model
        free()

    # (b) SP_STEPS-step predict: bf16 (the main path: counts and
    # ms/window), then float32 against one process with the same seed
    batch = _pair_batch(seed + 5)
    steps = SP_STEPS
    for dtype in ("bfloat16", "float32"):
        cfg = _sp_config(config, dtype, SP)
        model = build_model(cfg, device=dev, seed=seed, mesh=mesh)
        sampler = DDIMSampler(model, build_process(cfg), mesh=mesh)
        reset_launch_counts()
        ms, recs = first_call_ms(
            lambda: sampler.predict([batch], num_steps=steps, seed=seed, device=dev))
        pred = recs[0]["pred"]
        counts = launch_counts()
        check(bool(np.isfinite(pred).all()) and pred.shape == (1, RT, MZ), "bad sp prediction")
        check(counts == _expect(SP_FORWARD, steps, cfg), f"sp predict launches {counts}")
        if dtype == "bfloat16":
            out.update(predict_launches=counts, ms_per_window=ms)
            _rank_log(rank, f"predict {steps} steps bf16 at sp={SP}: launches "
                      f"K6a {counts['linear_attention_sp_stats']} K6b "
                      f"{counts['linear_attention_sp_apply']} (expected {SP_FORWARD} x "
                      f"{steps}); ms/window {ms:.2f} (CUDA events over this first call; 2 ranks "
                      "sharing one card)")
        del model, sampler
        free()
        if lead and dtype == "float32":
            ref_model = build_model(_sp_config(config, dtype, 1), device=dev, seed=seed)
            with _sp_dispatch():
                ref = DDIMSampler(ref_model, build_process(cfg)).predict(
                    [batch], num_steps=steps, seed=seed, device=dev)[0]["pred"]
            rel = float(np.linalg.norm(pred - ref) / np.linalg.norm(ref))
            _rank_log(rank, f"predict {steps} steps float32 at sp={SP} vs one process, same "
                      f"seed: rel L2 {rel:.3e} (tol {SP_PREDICT_TOL:g})")
            check(rel <= SP_PREDICT_TOL, "sp predict disagrees with one process")
            out["predict_rel_l2_float32"] = rel
            del ref_model
        free()

    # (c) one Trainer.train_step at sp = SP, timed, against one process;
    # float32 and bf16 (the path's dtype)
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 6).items()}
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    t = torch.randint(0, 1000, (1,), generator=g, device=dev)
    eps = torch.randn((1, RT, MZ), generator=g, device=dev)
    for dtype in ("float32", "bfloat16"):
        cfg = _sp_config(config, dtype, SP)
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(cfg, device=dev, seed=seed, mesh=mesh)
        reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()  # the counted step is the timed one (the count costs no device time)
        m = count_collectives("step", lambda: trainer.train_step(tbatch, 1e-4, t=t, eps=eps))
        end.record()
        counts = launch_counts()
        check(counts == _expect(SP_STEP, cfg=cfg), f"sp train launches {counts}")
        loss = float(m["loss"])
        names = [n for n, _ in trainer.model.named_parameters()]
        grads = [p.grad.float().cpu() for p in trainer.optimizer.params] if lead else None
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[f"train_{dtype}"] = dict(ms_per_step=start.elapsed_time(end), peak_gib=peak,
                                     launches=counts, loss=loss)
        _rank_log(rank, f"train_step {dtype} at sp={SP}: loss {loss:.6f}, launches K6a "
                  f"{counts['linear_attention_sp_stats']} K6b {counts['linear_attention_sp_apply']}"
                  f" K6c {counts['linear_attention_sp_backward']} (expected {SP_STEP}), ms/step "
                  f"{start.elapsed_time(end):.2f} (2 ranks sharing one card), peak device memory "
                  f"{peak:.2f} GiB")
        del trainer
        free()
        if lead:
            ref_tr = build_trainer(_sp_config(config, dtype, 1), device=dev, seed=seed)
            with _sp_dispatch():
                ref_loss = float(ref_tr.train_step(tbatch, 1e-4, t=t, eps=eps)["loss"])
            ref_g = [p.grad.float().cpu() for p in ref_tr.optimizer.params]
            del ref_tr
            rel = _rel_l2(grads, ref_g)
            worst = min((_cos(a, b), n) for a, b, n in zip(grads, ref_g, names))
            rel_tol, cos_tol = STEP_GRAD_TOL[dtype]
            _rank_log(rank, f"train_step {dtype} at sp={SP} vs one process: loss {loss:.6f} vs "
                      f"{ref_loss:.6f}; gradient rel L2 {rel:.3e} (tol {rel_tol:g}), worst "
                      f"per-tensor cosine {worst[0]:.6f} ({worst[1]})")
            check(abs(loss - ref_loss) <= MODEL_REL_TOL[dtype] * abs(ref_loss),
                  f"sp train loss {dtype} disagrees with one process")
            check(rel <= rel_tol, f"sp train gradients {dtype} disagree with one process")
            out[f"train_{dtype}"].update(grad_rel_l2=rel, worst_cos=worst[0])
            if dtype == "float32":
                check(worst[0] >= cos_tol, "sp train gradients float32: a tensor's cosine is "
                      f"below {cos_tol}")
                g32 = ref_g
            else:
                # bf16: the two paths round at other places (K6 for K1, the
                # "xla" mixers at N = 625, halo convs on other shapes), so
                # as in phases 8 and 9 each is held against the float32
                # gradient: the sp path may be at most BF16_REL_RATIO
                # times further from it than one process
                rel_sp, rel_one = _rel_l2(grads, g32), _rel_l2(ref_g, g32)
                _rank_log(rank, f"train_step bf16 against the float32 gradient: rel L2 sp={SP} "
                          f"{rel_sp:.3e}, one process {rel_one:.3e} (ratio {rel_sp / rel_one:.3f}, "
                          f"tol {BF16_REL_RATIO:g})")
                check(rel_sp <= BF16_REL_RATIO * rel_one,
                      "sp train gradients bf16 are further from float32 than one process's")
                out["train_bfloat16"].update(rel_vs_f32=rel_sp, one_process_rel_vs_f32=rel_one)
                del g32
            del ref_g, grads
        free()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn_ranks(fn, n, config, seed):
    """Spawn ``n`` ranks running ``fn(rank, init_method, config, seed,
    out_dir)`` in one gloo group, all on this card, and return their
    ``rank<r>.json``; a failed rank fails the phase with its traceback and
    the others are stopped."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        tmp.spawn(fn, args=(f"tcp://127.0.0.1:{port}", config, seed, out_dir), nprocs=n,
                  join=True)
        ranks = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    log(f"  {n} ranks done in {time.perf_counter() - t0:.1f} s")
    return ranks


def phase_sp(config, seed, gen, results):
    """Phase 10: K6 against its plain versions and the hand split in this
    process, then SP ranks spawned on the one card in a gloo group."""
    phase_sp_kernels(gen, results)
    ranks = _spawn_ranks(_sp_rank, SP, config, seed)
    lead = ranks[0]
    for name in ("linear_attention_sp_stats", "linear_attention_sp_apply"):
        results[name]["launches"] = lead["predict_launches"][name]
        results[name]["train_launches"] = lead["train_bfloat16"]["launches"][name]
    results["linear_attention_sp_backward"]["launches"] = (
        lead["train_bfloat16"]["launches"]["linear_attention_sp_backward"])
    results["sp"] = dict(
        note=f"{SP} ranks (processes in one gloo group) sharing one card: says nothing of the "
             "speed of sequence parallelism",
        forward_rel_l2={d: lead[f"forward_rel_l2_{d}"] for d in ("float32", "bfloat16")},
        predict_rel_l2_float32=lead["predict_rel_l2_float32"],
        collectives_per_rank=lead["collectives"],
        ms_per_window=[r["ms_per_window"] for r in ranks],
        train={d: [r[f"train_{d}"] for r in ranks] for d in ("float32", "bfloat16")})


def _cli(args):
    """Run one command of the port's CLI in this process; wall seconds."""
    from dquartic_tpu_torch.cli import cli

    log(f"  $ python -m dquartic_tpu_torch.cli {' '.join(args)}")
    t0 = time.perf_counter()
    cli.main(args, standalone_mode=False)
    return time.perf_counter() - t0


def _npy_windows(directory, seed, mz):
    """CLI_WINDOWS MS2 windows (RT x mz) and their MS1 traces from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(directory, f"{k}.npy") for k in ("ms2", "ms1")}
    np.save(paths["ms2"], rng.uniform(0, 100, (CLI_WINDOWS, RT, mz)).astype(np.float32))
    np.save(paths["ms1"], rng.uniform(0, 50, (CLI_WINDOWS, RT)).astype(np.float32))
    return paths


def _write_json(path, cfg):
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def phase_cli(seed, results):
    """generate-config, train + resume and a short predict at small depth,
    then the full-width predict of the shipping config from a checkpoint."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.infer import sampler as sampler_mod
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.train import (
        checkpoint_params, latest_path_for, load_checkpoint, save_checkpoint,
    )
    from dquartic_tpu_torch.utils.builder import build_model, build_process
    from dquartic_tpu_torch.utils.config import load_train_config

    with tempfile.TemporaryDirectory(prefix="dq_cli_") as tmp:
        free = subprocess.run(["df", "-h", tmp], capture_output=True, text=True, timeout=60)
        log(f"  free space where the checkpoints go: {free.stdout.strip().splitlines()[-1]}")
        cfg_path = os.path.join(tmp, "generated.json")
        _cli(["generate-config", cfg_path])
        generated = load_train_config(cfg_path)
        check(generated["model"]["UNet1d"]["downsample_dim"] == MZ
              and generated["tpu"]["optimizer"] == "adamw", "generate-config wrote another config")

        # small depth: train 2 epochs, resume to 3, predict from the EMA
        small = os.path.join(tmp, "small")
        os.makedirs(small)
        cfg = json.loads(json.dumps(generated))
        paths = _npy_windows(small, seed + 1, CLI_MZ)
        cfg["data"].update(parquet_directory=None, ms2_data_path=paths["ms2"],
                           ms1_data_path=paths["ms1"])
        best = os.path.join(small, "ckpt", "best_model.ckpt")
        cfg["model"].update(checkpoint_path=best, num_epochs=2, warmup_epochs=1, batch_size=1,
                            learning_rate=1e-3)
        cfg["model"]["UNet1d"].update(dim_mults=[1, 2, 2], downsample_dim=CLI_MZ)
        cfg["wandb"]["use_wandb"] = False
        cfg["tpu"].update(compute_dtype="bfloat16", fused_resnet=True)
        config2 = _write_json(os.path.join(small, "config.json"), cfg)
        reset_launch_counts()
        wall = _cli(["train", config2])
        counts = launch_counts()
        latest = latest_path_for(best)
        check(os.path.exists(best) and os.path.exists(latest), "train wrote no checkpoints")
        ck = load_checkpoint(latest)
        check((ck["epoch"], ck["step"]) == (1, 2 * CLI_WINDOWS),
              f"latest checkpoint epoch {ck['epoch']} step {ck['step']}")
        check(isinstance(ck["ema_params"], dict), "the EMA is not keyed by name")
        check(all(counts[k] > 0 for k in ("linear_attention", "linear_attention_backward",
                                          "fused_resnet_block_t", "fused_resnet_backward")),
              f"train did not run every kernel: {counts}")
        log(f"  train: 2 epochs of {CLI_WINDOWS} steps in {wall:.2f} s wall, launches {counts}")
        cfg["model"]["num_epochs"] = 3
        config3 = _write_json(os.path.join(small, "config3.json"), cfg)
        wall = _cli(["train", config3])
        ck = load_checkpoint(latest)
        check((ck["epoch"], ck["step"]) == (2, 3 * CLI_WINDOWS),
              f"resumed run ended at epoch {ck['epoch']} step {ck['step']}")
        with open(os.path.join(small, "ckpt", "metrics.jsonl")) as f:
            epochs = [json.loads(line)["epoch"] for line in f]
        check(epochs == [0, 1, 2], f"metrics.jsonl epochs {epochs}")
        log(f"  train resumed after epoch 1: epoch 2 in {wall:.2f} s wall, step {ck['step']}, "
            f"metrics.jsonl epochs {epochs}")
        out = os.path.join(small, "pred.npz")
        reset_launch_counts()
        wall = _cli(["predict", "--quantize-mid", "--fused-resnet", "--use-ema", "--num-steps",
                     str(CLI_STEPS), "--num-batches", "1", config3, latest, out])
        counts = launch_counts()
        pred = np.load(out)["pred_0"]
        check(pred.shape == (1, RT, CLI_MZ) and bool(np.isfinite(pred).all()),
              f"small predict: pred {pred.shape}, finite {bool(np.isfinite(pred).all())}")
        check(all(counts[k] > 0 for k in ("linear_attention", "fused_resnet_block_t",
                                          "int8_matmul")), f"small predict launches {counts}")
        log(f"  predict {CLI_STEPS} steps from the EMA: pred {pred.shape} finite, "
            f"{wall:.2f} s wall, launches {counts}")

        # full width: the shipping config through predict from a checkpoint
        full = os.path.join(tmp, "full")
        os.makedirs(full)
        with open(CONFIG) as f:
            cfg = json.load(f)
        paths = _npy_windows(full, seed + 2, MZ)
        cfg["data"].update(parquet_directory=None, ms2_data_path=paths["ms2"],
                           ms1_data_path=paths["ms1"])
        cfg["model"]["checkpoint_path"] = os.path.join(full, "best_model.ckpt")
        cfg["wandb"]["use_wandb"] = False
        cfg["tpu"]["compute_dtype"] = "bfloat16"
        config_full = _write_json(os.path.join(full, "config.json"), cfg)
        ckpt_path = os.path.join(full, "converted.ckpt")
        try:
            weights = build_model(load_train_config(config_full), device="cuda", seed=seed,
                                  trainable=True).state_dict()
            n_params = sum(v.numel() for v in weights.values())
            t0 = time.perf_counter()
            save_checkpoint(ckpt_path, {"epoch": 0, "best_loss": float("inf"), "step": 0,
                                        "params": weights, "opt_state": None,
                                        "ema_params": weights})
            write_s = time.perf_counter() - t0
            del weights
            torch.cuda.empty_cache()
            log(f"  full-width float32 checkpoint ({n_params / 1e9:.3f} B parameters, params "
                f"only): {os.path.getsize(ckpt_path) / 1e9:.2f} GB written in {write_s:.2f} s")

            out = os.path.join(full, "pred.npz")
            events = []
            timed = sampler_mod.DDIMSampler.predict_batch

            def predict_batch(self, *args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                res = timed(self, *args, **kwargs)
                end.record()
                events.append((start, end))
                return res

            sampler_mod.DDIMSampler.predict_batch = predict_batch
            reset_launch_counts()
            try:
                wall = _cli(["predict", "--quantize-mid", "--fused-resnet", "--num-steps",
                             str(STEPS), "--num-batches", "1", config_full, ckpt_path, out])
            finally:
                sampler_mod.DDIMSampler.predict_batch = timed
            counts = launch_counts()
            torch.cuda.synchronize()
            sample_ms = [s.elapsed_time(e) for s, e in events]
            check(len(sample_ms) == 1, f"{len(sample_ms)} windows sampled, not 1")
            serve_cfg = load_train_config(config_full)
            serve_cfg["tpu"].update(quantize_mid=True, fused_resnet=True)
            expect = _expect(SIMPLE_FORWARD, STEPS, serve_cfg)
            check(counts == expect, f"CLI predict launches {counts} != {expect}")
            npz = np.load(out)
            pred = npz["pred_0"]
            check(pred.shape == (1, RT, MZ) and bool(np.isfinite(pred).all()),
                  f"CLI pred {pred.shape}, finite {bool(np.isfinite(pred).all())}")

            # the same weights in this process: load the file, build through
            # build_model(state_dict=...), sample from the npz's inputs
            t0 = time.perf_counter()
            ck = load_checkpoint(ckpt_path, map_location="cpu")
            load_s = time.perf_counter() - t0
            model = build_model(serve_cfg, device="cuda", state_dict=checkpoint_params(ck))
            del ck
            sampler = DDIMSampler(model, build_process(serve_cfg))
            mixture = torch.from_numpy(npz["mixture_0"]).cuda()
            ms1 = torch.from_numpy(npz["ms1_1_0"]).cuda()
            ref, _ = sampler.predict_batch(torch.Generator(device="cuda").manual_seed(0),
                                           mixture, ms1, STEPS)
            ref = ref.float().cpu().numpy()
            same = bool(np.array_equal(ref, pred))
            log(f"  CLI predict, full width ({MZ} m/z, bf16, int8 mid convs, fused "
                f"ResnetBlocks, {STEPS} steps, 1 window): {wall:.2f} s wall for the command, "
                f"{sample_ms[0]:.2f} ms of sampling (CUDA events, the window's first sample "
                f"in this model); checkpoint {write_s:.2f} s to write, {load_s:.2f} s to "
                f"load; launches {counts}; pred range [{pred.min():.4f}, {pred.max():.4f}], "
                f"bitwise equal to predict_batch in this process: {same}")
            check(same, "the CLI's pred differs from predict_batch on the same weights: max "
                  f"|diff| {float(np.abs(ref - pred).max()):.3e}")
            results["cli"] = {"predict_wall_s": wall, "sample_ms_per_window": sample_ms[0],
                              "checkpoint_write_s": write_s, "checkpoint_load_s": load_s,
                              "launches": {k: v for k, v in counts.items() if v}}
            del model, sampler
        finally:
            if os.path.exists(ckpt_path):
                os.remove(ckpt_path)
            torch.cuda.empty_cache()


# phase 12: windows of the unconditional model's ms/window per path; the
# CustomTransformer of bench.py's transformer_train mode (h1024, 8 heads, 8
# layers over 34 x 40000 windows) and its timed steps after one warm-up;
# its bf16 forward and loss against float32 on the same weights and its
# int8 (quantize_params) serving against its float weights, relative L2
# (a dense net of 183 M weights: bf16 rounds each operand to 2^-9, int8
# each weight by up to absmax/254); FourierFeatures at its defaults against
# float64 (float32 FFTs: log2 of the length times float32's epsilon)
UNCOND_SAMPLE_REPS = 5
CT_SHAPE = dict(input_dim=MZ, hidden_dim=1024, num_heads=8, num_layers=8)
CT_STEPS = 20
CT_BF16_TOL = 5e-2
CT_QUANT_TOL = 5e-2
FOURIER_DIM = 4
FOURIER_TOL = 1e-5


def _ct_config(config, **tpu):
    """The CustomTransformer of CT_SHAPE, without the UNet1d's serving keys
    (the CLI's predict refuses them for this model, as JAX's)."""
    cfg = json.loads(json.dumps(config))
    cfg["model"]["use_model"] = "CustomTransformer"
    cfg["model"]["CustomTransformer"] = dict(CT_SHAPE)
    cfg["tpu"].update(quantize_mid=False, fused_resnet=False, **tpu)
    return cfg


def phase_unconditional(config, seed, gen, results):
    """(a) the unconditional canonical UNet1d in the shipping serving config:
    one bf16 forward against the plain path and a 50-step predict with its
    launches and ms/window; (b) its full-width training step: gradients
    against the plain path, launches and ms/step."""
    import torch

    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    cfg = json.loads(json.dumps(config))
    cfg["model"]["UNet1d"]["conditional"] = False
    phase_forward(cfg, seed, gen, SIMPLE_FORWARD, what="unconditional UNet1d",
                  dtypes=("bfloat16",))
    counts, per_window = phase_sample(cfg, seed, gen, SIMPLE_FORWARD, what="unconditional",
                                      reps=UNCOND_SAMPLE_REPS)
    for name in ("linear_attention", "fused_resnet_block_t", "int8_matmul", "flash_attention"):
        results[name]["unconditional_launches_window"] = counts[name]
    out = dict(launches_window={k: v for k, v in counts.items() if v},
               ms_per_window=per_window["kernel"], plain_ms_per_window=per_window["plain"],
               runs=per_window["runs"])

    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 3).items()}
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    eps = torch.randn((1, RT, MZ), generator=gen, device=dev)
    tcfg = _train_config(cfg, compute_dtype="float32")
    model = build_model(tcfg, device=dev, seed=seed, trainable=True)
    out["step_gradients"] = compare_step_grads(model, build_process(tcfg), batch, t, eps,
                                               what="unconditional")
    del model
    torch.cuda.empty_cache()
    trainer = build_trainer(_train_config(cfg, compute_dtype="bfloat16"), device=dev, seed=seed)
    trainer.train_step(batch, 1e-4, generator=gen)  # warm-up step
    runs, counts, peak, losses = timed_steps(trainer, batch, gen, True)
    median = runs[len(runs) // 2]
    log(f"  unconditional train_step ({trainer.num_parameters() / 1e9:.3f} B params, bs1, "
        f"34x40000, bf16 on float32 masters, AdamW + EMA): median {median:.2f} ms/step of "
        f"{TRAIN_STEPS} (min {runs[0]:.2f}, max {runs[-1]:.2f}), peak device memory "
        f"{peak:.2f} GiB, launches {counts}, losses {[round(v, 6) for v in losses]}")
    expect = _expect(STEP_LAUNCHES, TRAIN_STEPS)
    check(counts == expect, f"unconditional train launches {counts} != {expect}")
    check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite training loss")
    for name in ("linear_attention_backward", "fused_resnet_backward", "flash_attention_backward"):
        results[name]["unconditional_launches_step"] = counts[name] / TRAIN_STEPS
    out.update(ms_per_step=median, step_runs=runs, peak_gib=peak)
    results["families"]["unconditional"] = out
    del trainer
    torch.cuda.empty_cache()


def phase_custom_transformer(config, seed, gen, results):
    """(c) the CustomTransformer at bench.py's transformer_train shape:
    build_trainer steps timed by the port's StepTimer with the peak memory
    of device_memory_stats; one bf16 forward and loss against float32 on
    the same weights; a 50-step predict; apply_quantized serving from
    quantize_params against the float weights."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.ops.quantization import (
        apply_quantized, quantize_params, quantized_nbytes,
    )
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer
    from dquartic_tpu_torch.utils.profiling import StepTimer, device_memory_stats

    dev = torch.device("cuda")
    cfg = _ct_config(config, compute_dtype="bfloat16")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 4).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer = build_trainer(cfg, device=dev, seed=seed)
    n_params = trainer.num_parameters()
    timer, losses = StepTimer(sync=True), []
    for _ in range(CT_STEPS + 1):  # the summary leaves out the first (warm-up) step
        with timer.step():
            loss = timer.observe(trainer.train_step(batch, 1e-5, generator=gen)["loss"])
        losses.append(float(loss))
    counts = launch_counts()
    summary, mem = timer.summary(), device_memory_stats()[0]
    runs = sorted(1e3 * np.asarray(timer.times[1:]))
    c = CT_SHAPE
    log(f"  CustomTransformer train_step ({n_params / 1e6:.1f} M params, h{c['hidden_dim']}/"
        f"{c['num_heads']}h/{c['num_layers']}L, bs1, {RT}x{MZ}, bf16 on float32 masters, AdamW + EMA), StepTimer(sync=True) over "
        f"{CT_STEPS} steps after a warm-up: median {summary['p50_ms']:.2f} ms/step (min "
        f"{runs[0]:.2f}, max {runs[-1]:.2f}, mean {summary['mean_ms']:.2f}, p95 "
        f"{summary['p95_ms']:.2f}); device_memory_stats: peak {mem['peak_bytes_mb']:.1f} MB, "
        f"in use {mem['bytes_in_use_mb']:.1f} MB of {mem['bytes_limit_mb']:.1f} MB; losses "
        f"first {losses[0]:.6f} last {losses[-1]:.6f}; kernel launches {sum(counts.values())}")
    check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite training loss")
    check(sum(counts.values()) == 0, f"the CustomTransformer reached a kernel: {counts}")
    out = dict(params=n_params, train=dict(summary, min_ms=runs[0], peak_mb=mem["peak_bytes_mb"]))

    model, proc = trainer.model, trainer.process
    x_t = torch.randn((1, RT, MZ), generator=gen, device=dev)
    ms1 = torch.rand((1, RT), generator=gen, device=dev) * 2 - 1
    t = torch.full((1,), 500, dtype=torch.long, device=dev)
    tt = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    eps = torch.randn((1, RT, MZ), generator=gen, device=dev)
    mix = 0.5 * batch["ms2_1"] + 0.5 * batch["ms2_2"]
    fwd, loss = {}, {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            model.compute_dtype = dtype
            fwd[dtype] = model(x_t, t, None, ms1).float()
            loss[dtype] = float(proc.train_loss(model, batch["ms2_1"], mix, batch["ms1_1"], t=tt,
                                                eps=eps)[0])
        rel = float((fwd[torch.bfloat16] - fwd[torch.float32]).norm() / fwd[torch.float32].norm())
        loss_rel = abs(loss[torch.bfloat16] - loss[torch.float32]) / abs(loss[torch.float32])
        log(f"  CustomTransformer bf16 vs float32 on the same weights: forward rel L2 {rel:.3e}, "
            f"loss {loss[torch.bfloat16]:.6f} vs {loss[torch.float32]:.6f} (rel {loss_rel:.3e}); "
            f"tol {CT_BF16_TOL:g}")
        check(rel <= CT_BF16_TOL and loss_rel <= CT_BF16_TOL,
              "the bf16 CustomTransformer disagrees with float32")
        qsd = quantize_params(model.state_dict())
        ref = fwd[torch.bfloat16]
        q_out = apply_quantized(model, qsd, x_t, t, None, ms1).float()
        q_rel = float((q_out - ref).norm() / ref.norm())
        q_ms = cuda_time(lambda: apply_quantized(model, qsd, x_t, t, None, ms1), reps=5)
        f_ms = cuda_time(lambda: model(x_t, t, None, ms1), reps=5)
    nbytes = (quantized_nbytes(qsd), quantized_nbytes(model.state_dict()))
    log(f"  apply_quantized (bf16 compute, int8 weights dequantized per call): rel L2 "
        f"{q_rel:.3e} against the float weights (tol {CT_QUANT_TOL:g}); {nbytes[0] / 1e6:.1f} MB "
        f"of int8 + scales against {nbytes[1] / 1e6:.1f} MB float32; {q_ms:.3f} ms a forward "
        f"against {f_ms:.3f} ms (CUDA events, mean of 5)")
    check(q_rel <= CT_QUANT_TOL, "int8 serving of the CustomTransformer disagrees with float")
    out.update(bf16_vs_f32_rel_l2=rel, bf16_vs_f32_loss_rel=loss_rel, quantized_rel_l2=q_rel,
               quantized_bytes=nbytes[0], float_bytes=nbytes[1], quantized_forward_ms=q_ms,
               float_forward_ms=f_ms)
    del qsd

    serve = build_model(cfg, device=dev, state_dict=trainer.ema_state_dict())
    del trainer, model
    sampler = DDIMSampler(serve, build_process(cfg))
    rng = np.random.default_rng(seed + 5)
    window = {k: rng.uniform(0, 1, s).astype(np.float32) for k, s in
              (("ms2_1", (1, RT, MZ)), ("ms1_1", (1, RT)), ("ms2_2", (1, RT, MZ)))}
    reset_launch_counts()
    recs = sampler.predict([window], num_steps=STEPS, seed=seed, device="cuda")
    pred = recs[0]["pred"]
    check(pred.shape == (1, RT, MZ) and bool(np.isfinite(pred).all()),
          f"CustomTransformer pred {pred.shape}, finite {bool(np.isfinite(pred).all())}")
    check(sum(launch_counts().values()) == 0, "the CustomTransformer's predict reached a kernel")
    ms2 = torch.from_numpy(recs[0]["mixture"]).to(dev)
    ms1w = torch.from_numpy(recs[0]["ms1_1"]).to(dev)
    windows = sorted(cuda_time(lambda: sampler.sample(x_t, ms2, ms1w, STEPS), reps=1, warmup=0)
                     for _ in range(3))
    log(f"  CustomTransformer {STEPS}-step predict (bf16, from the EMA weights): pred "
        f"{pred.shape} finite, range [{pred.min():.4f}, {pred.max():.4f}]; ms/window median "
        f"{windows[1]:.2f} of 3 (min {windows[0]:.2f}, max {windows[2]:.2f})")
    out["ms_per_window"] = windows
    results["families"]["custom_transformer"] = out
    del serve, sampler
    torch.cuda.empty_cache()


def phase_fourier(seed, results):
    """(d) FourierFeatures at its defaults (h 10000, w 34) against the same
    filter evaluated in float64, and its time."""
    import torch

    from dquartic_tpu_torch.models import FourierFeatures

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    m = FourierFeatures(FOURIER_DIM).cuda()
    h, w = m.complex_weight.shape[1:3]
    with torch.no_grad():
        m.complex_weight.normal_(0.0, 0.02, generator=gen)
        x = torch.randn((1, FOURIER_DIM, h, w), generator=gen, device="cuda")
        out = m(x)
        xf = torch.fft.rfft2(x.double(), dim=(2, 3), norm="ortho")
        wf = torch.view_as_complex(m.complex_weight.double())
        ref = torch.fft.irfft2(xf * wf[None, :, :, : xf.shape[3]], s=(h, w), dim=(2, 3),
                               norm="ortho")
        rel = float((out.double() - ref).norm() / ref.norm())
        ms = cuda_time(lambda: m(x), reps=20)
    log(f"  FourierFeatures (dim {FOURIER_DIM}, h {h}, w {w}, float32 cuFFT): rel L2 {rel:.3e} "
        f"against float64 (tol {FOURIER_TOL:g}); {ms:.4f} ms a call (CUDA events, mean of 20)")
    check(out.shape == x.shape and bool(torch.isfinite(out).all()), "bad FourierFeatures output")
    check(rel <= FOURIER_TOL, "FourierFeatures disagrees with float64")
    results["families"]["fourier"] = dict(rel_l2_vs_float64=rel, ms=ms)


def _reference_names(sd, num_layers):
    """The port's CustomTransformer state_dict in the reference module's
    names: each layer's q, k and v packed into nn.MultiheadAttention's
    ``attention.in_proj_*``, its output as ``attention.out_proj``, the
    feed-forward as ``ff.0`` and ``ff.2``."""
    import torch

    out = {k: v for k, v in sd.items() if not k.startswith("layers.")}
    for i in range(num_layers):
        p = f"layers.{i}"
        for w in ("weight", "bias"):
            out[f"{p}.attention.in_proj_{w}"] = torch.cat([sd[f"{p}.{n}_proj.{w}"] for n in "qkv"])
            out[f"{p}.attention.out_proj.{w}"] = sd[f"{p}.out_proj.{w}"]
            out[f"{p}.ff.0.{w}"], out[f"{p}.ff.2.{w}"] = sd[f"{p}.ff1.{w}"], sd[f"{p}.ff2.{w}"]
            for n in ("norm1", "norm2"):
                out[f"{p}.{n}.{w}"] = sd[f"{p}.{n}.{w}"]
    return out


def phase_custom_transformer_cli(config, seed, results):
    """(e) convert-checkpoint of seeded weights in the reference's
    CustomTransformer names, then the CLI's 50-step predict from the
    converted file, its pred bitwise equal to predict_batch in this process
    on the model built from the same file."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.train import checkpoint_params, load_checkpoint
    from dquartic_tpu_torch.utils.builder import build_model, build_process
    from dquartic_tpu_torch.utils.config import load_train_config

    with tempfile.TemporaryDirectory(prefix="dq_ct_") as tmp:
        cfg = _ct_config(config, compute_dtype="bfloat16")
        paths = _npy_windows(tmp, seed + 8, MZ)
        cfg["data"].update(parquet_directory=None, ms2_data_path=paths["ms2"],
                           ms1_data_path=paths["ms1"])
        cfg["model"]["checkpoint_path"] = os.path.join(tmp, "best_model.ckpt")
        config_path = _write_json(os.path.join(tmp, "config.json"), cfg)
        weights = {k: v.cpu() for k, v in build_model(cfg, device="cuda", seed=seed + 9,
                                                      trainable=True).state_dict().items()}
        ref_path, conv_path = os.path.join(tmp, "reference.ckpt"), os.path.join(tmp, "conv.ckpt")
        torch.save({"model_state_dict": _reference_names(weights, CT_SHAPE["num_layers"]),
                    "epoch": 7, "best_loss": 0.25}, ref_path)
        wall_convert = _cli(["convert-checkpoint", ref_path, conv_path, config_path])
        ck = load_checkpoint(conv_path, map_location="cpu")
        check((ck["epoch"], ck["step"], ck["opt_state"]) == (7, 0, None)
              and ck["params"].keys() == weights.keys()
              and all(torch.equal(ck["params"][k], v) for k, v in weights.items()),
              "convert-checkpoint did not carry the reference's weights over unchanged")
        out = os.path.join(tmp, "pred.npz")
        wall = _cli(["predict", "--num-steps", str(STEPS), "--num-batches", "1", config_path,
                     conv_path, out])
        npz = np.load(out)
        pred = npz["pred_0"]
        check(pred.shape == (1, RT, MZ) and bool(np.isfinite(pred).all()),
              f"CLI pred {pred.shape}, finite {bool(np.isfinite(pred).all())}")
        serve_cfg = load_train_config(config_path)
        model = build_model(serve_cfg, device="cuda", state_dict=checkpoint_params(ck))
        sampler = DDIMSampler(model, build_process(serve_cfg))
        ref, _ = sampler.predict_batch(torch.Generator(device="cuda").manual_seed(0),
                                       torch.from_numpy(npz["mixture_0"]).cuda(),
                                       torch.from_numpy(npz["ms1_1_0"]).cuda(), STEPS)
        ref = ref.float().cpu().numpy()
        same = bool(np.array_equal(ref, pred))
        log(f"  CustomTransformer through the CLI: convert-checkpoint {wall_convert:.2f} s wall, "
            f"predict ({STEPS} steps, 1 window, bf16) {wall:.2f} s wall; pred range "
            f"[{pred.min():.4f}, {pred.max():.4f}], bitwise equal to predict_batch in this "
            f"process: {same}")
        check(same, "the CLI's CustomTransformer pred differs from predict_batch on the same "
              f"weights: max |diff| {float(np.abs(ref - pred).max()):.3e}")
        results["families"]["custom_transformer_cli"] = dict(convert_wall_s=wall_convert,
                                                             predict_wall_s=wall)
        del model, sampler
    torch.cuda.empty_cache()


def phase_families(config, seed, gen, results):
    """Phase 12: the unconditional UNet1d, the CustomTransformer,
    FourierFeatures and the CustomTransformer's command line."""
    t0 = time.perf_counter()
    results["families"] = {}
    log("  (a, b) the unconditional UNet1d: serving and training")
    phase_unconditional(config, seed, gen, results)
    log("  (c) the CustomTransformer at bench.py's transformer_train shape")
    phase_custom_transformer(config, seed, gen, results)
    log("  (d) FourierFeatures")
    phase_fourier(seed, results)
    log("  (e) the CustomTransformer through convert-checkpoint and predict")
    phase_custom_transformer_cli(config, seed, results)
    results["families"]["phase_s"] = time.perf_counter() - t0
    log(f"  phase 12: {results['families']['phase_s']:.1f} s")


def phase_k3_tp(gen, results):
    """K3 at a tp = 2 rank's column shard of a mid conv, (34, 30000, 5000)
    bf16: against its plain version, timed around the wrapper, its plain
    version and ``torch._weight_int8pack_mm``, beside its byte bound."""
    import torch

    from dquartic_tpu_torch.ops import int8_matmul as im

    M, K, N = K3_TP_SHAPE
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    q, s = im.quantize_weight_matrix(torch.randn((K, N), generator=gen, device="cuda"))
    ref = im.int8_matmul_reference(x, q, s)
    tol = (2**-7, 2**-8)
    err = _k3_compare(f"K3 int8_matmul bfloat16 at the tp shard ({M}, {K}, {N})",
                      im.int8_matmul(x, q, s), ref, tol)
    ms = cuda_time(lambda: im.int8_matmul(x, q, s), 20)
    plain = cuda_time(lambda: im.int8_matmul_reference(x, q, s), 20)
    dev = device_ms(lambda: im.int8_matmul(x, q, s), 10, "int8_matmul_mma")["all"][0]
    lib = k3_library(x, q, s, ref, tol, shape=f"({M}, {K}, {N})")
    bnd = k3_bound(M, K, N)
    log(f"  time int8_matmul bf16 ({M}, {K}, {N}) (a tp = {DPTP} rank's mid conv): kernel "
        f"{ms:.4f} ms, device {dev:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib.get('library_ms')}, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    results["int8_matmul"]["tp_shard"] = dict(M=M, K=K, N=N, ms=ms, device_ms=dev,
                                              plain_ms=plain, max_abs_err=err, **lib, **bnd)
    del x, q, s, ref
    torch.cuda.empty_cache()


def _dptp_config(config, dp=1, tp=1, batch=1):
    cfg = json.loads(json.dumps(config))
    cfg["tpu"]["mesh"] = {"dp": dp, "sp": 1, "tp": tp}
    cfg["model"]["batch_size"] = batch
    return cfg


def _dptp_rank(rank, init_method, config, seed, out_dir):
    """One of the DPTP ranks on cuda:0, each path run at dp = DPTP and at
    tp = DPTP and held on rank 0 against the same call in one process (on
    the global batch) while the other ranks wait with their memory freed:
    (a) dp: a train step (float32, bf16) and a 50-step predict of two
    windows; (b) tp: an int8 predict of one window and a bf16 train step;
    (c) the CustomTransformer's step at dp and at tp."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.parallel import initialize_runtime, local_rows, make_mesh
    from dquartic_tpu_torch.parallel.tensor import gather, leaf_specs
    from dquartic_tpu_torch.utils.builder import build_model, build_process, build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_runtime("gloo", rank, DPTP, init_method, timeout_s=900)
    meshes = {"dp": make_mesh(dp=DPTP), "tp": make_mesh(tp=DPTP)}
    dev = torch.device(DPTP_DEVICE)
    out = {"rank": rank}
    lead = rank == 0

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dist.barrier()

    # every all_reduce and all_gather of this rank, counted around
    # torch.distributed (DDP's bucket all_reduces run in its reducer and
    # are read from its logging data)
    calls = {"all_reduce": 0, "all_gather": 0}
    for fn in tuple(calls):
        real = getattr(dist, fn)

        def counted(*args, _real=real, _fn=fn, **kwargs):
            calls[_fn] += 1
            return _real(*args, **kwargs)

        setattr(dist, fn, counted)

    def step_grads(trainer, batch, t, eps):
        """One train_step; its loss and gradient norm (before clipping),
        launches, collectives and (on rank 0) every gradient whole on the
        host, gathered over tp (clipped: the norm holds their scale)."""
        calls.update(all_reduce=0, all_gather=0)
        reset_launch_counts()
        m = trainer.train_step(batch, 1e-4, t=t, eps=eps)
        torch.cuda.synchronize()
        counts, colls = launch_counts(), dict(calls)
        specs = leaf_specs(trainer.model)
        grads = []
        for n, p in zip(trainer.param_names, trainer.optimizer.params):
            gr = p.grad
            if n in specs:
                spec, dim = specs[n]
                gr = gather(gr, spec.group, dim)
            grads.append(gr.float().cpu() if lead else None)
        return (float(m["loss"]), float(m["grad_norm"])), counts, colls, grads

    def timed(trainer, batch, gen, n=2):
        runs = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(batch, 1e-4, generator=gen)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        return sorted(runs)[len(runs) // 2]

    def hold(what, metrics, grads, ref_cfg, batch, t, eps, dtype):
        """On rank 0: the one-process step of ``ref_cfg`` on the global
        batch, its loss, gradient norm and gradients against the mesh's
        (phase 6 gates; the norm, taken before clipping, at the loss's)."""
        loss, norm = metrics
        ref_tr = build_trainer(ref_cfg, device=dev, seed=seed)
        ref_m = ref_tr.train_step(batch, 1e-4, t=t, eps=eps)
        ref_loss, ref_norm = float(ref_m["loss"]), float(ref_m["grad_norm"])
        ref_g = [p.grad.float().cpu() for p in ref_tr.optimizer.params]
        del ref_tr
        rel = _rel_l2(grads, ref_g)
        # a gradient that is zero up to rounding (the CustomTransformer's key
        # biases: a shift of every logit of a row, which softmax ignores)
        # has no direction to hold: the cosine skips tensors below 1e-6 of
        # the largest
        top = max(float(b.norm()) for b in ref_g)
        worst = min(_cos(a, b) for a, b in zip(grads, ref_g) if float(b.norm()) > 1e-6 * top)
        rel_tol, cos_tol = STEP_GRAD_TOL[dtype]
        _rank_log(rank, f"{what} {dtype} vs one process: loss {loss:.6f} vs {ref_loss:.6f}; "
                  f"gradient norm {norm:.6f} vs {ref_norm:.6f}; "
                  f"gradient rel L2 {rel:.3e} (tol {rel_tol:g}), worst per-tensor cosine "
                  f"{worst:.6f} (tol {cos_tol:g})")
        check(abs(loss - ref_loss) <= MODEL_REL_TOL[dtype] * abs(ref_loss),
              f"{what} {dtype}: loss disagrees with one process")
        check(abs(norm - ref_norm) <= MODEL_REL_TOL[dtype] * abs(ref_norm),
              f"{what} {dtype}: gradient norm disagrees with one process")
        check(rel <= rel_tol and worst >= cos_tol,
              f"{what} {dtype}: gradients disagree with one process")
        return dict(loss=loss, ref_loss=ref_loss, grad_norm=norm, ref_grad_norm=ref_norm,
                    grad_rel_l2=rel, worst_cos=worst)

    # (a) dp = DPTP: one train step on a global batch of DPTP windows, each
    # rank its row, against one process on the whole batch
    mesh = meshes["dp"]
    gbatch = {k: torch.as_tensor(v, device=dev)
              for k, v in _pair_batch(seed + 20, rows=DPTP).items()}
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    t = torch.randint(0, 1000, (DPTP,), generator=g, device=dev)
    eps = torch.randn((DPTP, RT, MZ), generator=g, device=dev)
    for dtype in ("float32", "bfloat16"):
        # no EMA: two ranks' float32 states and DDP's buckets share the card
        base = _train_config(config, compute_dtype=dtype, ema_decay=None)
        cfg = _dptp_config(base, dp=DPTP, batch=DPTP)
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(cfg, device=dev, seed=seed, mesh=mesh)
        # DDP's bucket all_reduces run in its reducer: counted by a comm hook
        # that runs DDP's own all_reduce hook
        reduced = []

        def count_buckets(state, bucket):
            reduced.append(bucket.buffer().numel())
            return default_hooks.allreduce_hook(state, bucket)

        trainer._denoise.register_comm_hook(mesh.dp_group, count_buckets)
        metrics, counts, colls, grads = step_grads(trainer, local_rows(gbatch, mesh), t, eps)
        check(counts == _expect(STEP_LAUNCHES, cfg=cfg), f"dp train launches {counts}")
        # the first step reduces every gradient in one all_reduce; DDP then
        # rebuilds its buckets in the order the backward makes them
        first = len(reduced)
        colls["all_reduce"] -= first  # the hook's all_reduces are the buckets
        n_grads = sum(p.numel() for p in trainer.optimizer.params)
        check(sum(reduced) == n_grads, f"DDP reduced {sum(reduced)} gradient values")
        reduced.clear()
        ms = timed(trainer, local_rows(gbatch, mesh), g)
        buckets = len(reduced) // 2
        check(sum(reduced) == 2 * n_grads, f"DDP reduced {sum(reduced)} values in two steps")
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[f"dp_train_{dtype}"] = dict(launches=counts, collectives=colls, ddp_buckets=buckets,
                                        ddp_buckets_first_step=first, ms_per_step=ms,
                                        peak_gib=peak)
        _rank_log(rank, f"dp={DPTP} train_step {dtype}: loss {metrics[0]:.6f}, launches "
                  f"{counts}; "
                  f"collectives a step: {buckets} DDP bucket all_reduces ({first} in the first "
                  f"step) + {colls}; "
                  f"ms/step {ms:.2f} ({DPTP} ranks sharing one card: no dp speed), peak "
                  f"{peak:.2f} GiB")
        del trainer
        free()
        if lead:
            out[f"dp_train_{dtype}"].update(hold(f"dp={DPTP} train_step", metrics, grads,
                                                 _dptp_config(base, batch=DPTP), gbatch, t,
                                                 eps, dtype))
        del grads
        free()

    # (a) dp = DPTP: a 50-step predict of DPTP windows in the serving
    # config, each rank its window; the records gathered
    pbatch = _pair_batch(seed + 22, rows=DPTP)
    cfg = _dptp_config(config, dp=DPTP, batch=DPTP)
    model = build_model(cfg, device=dev, seed=seed, mesh=mesh)
    sampler = DDIMSampler(model, build_process(cfg), mesh=mesh)
    reset_launch_counts()
    ms, recs = first_call_ms(lambda: sampler.predict([local_rows(pbatch, mesh)],
                                                     num_steps=STEPS, seed=seed, device=dev))
    rec = recs[0]
    counts = launch_counts()
    check(counts == _expect(SIMPLE_FORWARD, STEPS), f"dp predict launches {counts}")
    check(rec["pred"].shape == (DPTP, RT, MZ) and bool(np.isfinite(rec["pred"]).all()),
          "bad dp prediction")
    out["dp_predict"] = dict(launches=counts, ms_per_window=ms)
    _rank_log(rank, f"dp={DPTP} predict {STEPS} steps of {DPTP} windows: launches {counts}; "
              f"ms/window {ms:.2f} ({DPTP} ranks sharing one card: no dp speed)")
    del model, sampler
    free()
    if lead:
        ref_model = build_model(_dptp_config(config, batch=DPTP), device=dev, seed=seed)
        ref = DDIMSampler(ref_model, build_process(cfg)).predict(
            [pbatch], num_steps=STEPS, seed=seed, device=dev)[0]
        del ref_model
        rel = float(np.linalg.norm(rec["pred"] - ref["pred"]) / np.linalg.norm(ref["pred"]))
        same = all(np.array_equal(rec[k], ref[k]) for k in ("ms2_1", "ms1_1", "mixture"))
        _rank_log(rank, f"dp={DPTP} predict vs one process on the {DPTP} windows, same seed: "
                  f"pred rel L2 {rel:.3e} (tol {MODEL_REL_TOL['bfloat16']:g}), inputs gathered "
                  f"bitwise {same}")
        check(rel <= MODEL_REL_TOL["bfloat16"] and same, "dp predict disagrees with one process")
        out["dp_predict"]["pred_rel_l2"] = rel
    free()

    # (b) tp = DPTP: the int8 serving predict of one window, the mid convs
    # on their column shards (K3 at (34, 30000, 5000))
    mesh = meshes["tp"]
    pbatch = _pair_batch(seed + 23)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(_dptp_config(config, tp=DPTP), device=dev, seed=seed, mesh=mesh)
    wq = model.mid_block1.block1.proj.weight_q
    check(tuple(wq.shape) == K3_TP_SHAPE[1:], f"tp int8 shard {tuple(wq.shape)}")
    wq0 = wq.cpu() if lead else None
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters()) + sum(
        b.numel() * b.element_size() for b in model.buffers())
    sampler = DDIMSampler(model, build_process(config), mesh=mesh)
    calls.update(all_reduce=0, all_gather=0)
    reset_launch_counts()
    ms, recs = first_call_ms(lambda: sampler.predict([pbatch], num_steps=STEPS, seed=seed,
                                                     device=dev))
    rec = recs[0]
    counts, colls = launch_counts(), dict(calls)
    check(counts == _expect(SIMPLE_FORWARD, STEPS), f"tp predict launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["tp_predict"] = dict(launches=counts, collectives=colls, ms_per_window=ms,
                             serving_bytes=nbytes, peak_gib=peak)
    _rank_log(rank, f"tp={DPTP} int8 predict {STEPS} steps: launches {counts}, collectives "
              f"{colls}; serving weights {nbytes / 1e9:.3f} GB a rank; ms/window {ms:.2f} "
              f"({DPTP} ranks sharing one card: no tp speed), peak {peak:.2f} GiB")
    del model, sampler
    free()
    if lead:
        ref_model = build_model(_dptp_config(config), device=dev, seed=seed)
        whole = ref_model.mid_block1.block1.proj.weight_q.cpu()
        sliced = torch.equal(wq0, whole[:, :K3_TP_SHAPE[2]])
        ref = DDIMSampler(ref_model, build_process(config)).predict(
            [pbatch], num_steps=STEPS, seed=seed, device=dev)[0]
        del ref_model
        rel = float(np.linalg.norm(rec["pred"] - ref["pred"]) / np.linalg.norm(ref["pred"]))
        _rank_log(rank, f"tp={DPTP} int8 predict vs one process: pred rel L2 {rel:.3e} (tol "
                  f"{MODEL_REL_TOL['bfloat16']:g}); rank 0's int8 shard is the slice of the "
                  f"whole quantization bitwise: {sliced}")
        check(rel <= MODEL_REL_TOL["bfloat16"] and sliced, "tp predict disagrees with one process")
        out["tp_predict"].update(pred_rel_l2=rel, int8_shard_is_slice=sliced)
    free()

    # (b) tp = DPTP: a bf16 train step, the gathered gradients against one
    # process; parameter bytes and peak memory a rank
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 24).items()}
    g = torch.Generator(device=dev).manual_seed(seed + 25)
    t = torch.randint(0, 1000, (1,), generator=g, device=dev)
    eps = torch.randn((1, RT, MZ), generator=g, device=dev)
    cfg = _dptp_config(_train_config(config, compute_dtype="bfloat16"), tp=DPTP)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(cfg, device=dev, seed=seed, mesh=mesh)
    held = sum(p.numel() for p in trainer.optimizer.params)
    metrics, counts, colls, grads = step_grads(trainer, tbatch, t, eps)
    check(counts == _expect(STEP_LAUNCHES, cfg=cfg), f"tp train launches {counts}")
    ms = timed(trainer, tbatch, g)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["tp_train"] = dict(launches=counts, collectives=colls, param_bytes=4 * held,
                           ms_per_step=ms, peak_gib=peak)
    _rank_log(rank, f"tp={DPTP} train_step bf16: loss {metrics[0]:.6f}, launches {counts}, "
              f"collectives {colls}; float32 parameters a rank {4 * held / 1e9:.3f} GB; "
              f"ms/step {ms:.2f} ({DPTP} ranks sharing one card: no tp speed), peak "
              f"{peak:.2f} GiB")
    del trainer
    free()
    if lead:
        whole = sum(g.numel() for g in grads)
        out["tp_train"].update(whole_param_bytes=4 * whole, **hold(
            f"tp={DPTP} train_step", metrics, grads,
            _dptp_config(_train_config(config, compute_dtype="bfloat16")), tbatch, t, eps,
            "bfloat16"))
        share = held / whole
        _rank_log(rank, f"tp={DPTP}: a rank holds {share:.4f} of the {4 * whole / 1e9:.3f} GB of "
                  f"float32 parameters")
        check(TP_PARAM_SHARE[0] <= share <= TP_PARAM_SHARE[1], f"tp share {share}")
    del grads
    free()

    # (c) the CustomTransformer (float32): a step at dp = DPTP on DPTP
    # windows and at tp = DPTP on one, each against one process
    for axis in ("dp", "tp"):
        mesh = meshes[axis]
        rows = DPTP if axis == "dp" else 1
        cbatch = {k: torch.as_tensor(v, device=dev)
                  for k, v in _pair_batch(seed + 26, rows=rows).items()}
        g = torch.Generator(device=dev).manual_seed(seed + 27)
        t = torch.randint(0, 1000, (rows,), generator=g, device=dev)
        eps = torch.randn((rows, RT, MZ), generator=g, device=dev)
        base = _ct_config(config, compute_dtype="float32")
        cfg = _dptp_config(base, batch=rows, **{axis: DPTP})
        trainer = build_trainer(cfg, device=dev, seed=seed, mesh=mesh)
        metrics, counts, colls, grads = step_grads(trainer, local_rows(cbatch, mesh), t, eps)
        held = sum(p.numel() for p in trainer.optimizer.params)
        out[f"ct_{axis}"] = dict(collectives=colls, params_held=held)
        del trainer
        free()
        if lead:
            out[f"ct_{axis}"].update(hold(f"CustomTransformer {axis}={DPTP} train_step",
                                          metrics, grads, _dptp_config(base, batch=rows), cbatch,
                                          t, eps, "float32"))
        del grads
        free()

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_dp_tp(config, seed, gen, results):
    """Phase 13: K3 at a tp rank's shard in this process, then DPTP ranks
    spawned on the one card in a gloo group, at dp = DPTP and tp = DPTP."""
    import torch

    phase_k3_tp(gen, results)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_dptp_rank, DPTP, config, seed)
    lead = ranks[0]
    for name, row in results.items():
        if not isinstance(row, dict) or "source" not in row:
            continue
        row["dp_launches_per_rank"] = dict(
            predict=lead["dp_predict"]["launches"][name],
            train_step=lead["dp_train_bfloat16"]["launches"][name])
        row["tp_launches_per_rank"] = dict(predict=lead["tp_predict"]["launches"][name],
                                           train_step=lead["tp_train"]["launches"][name])
    results["dp_tp"] = dict(
        note=f"{DPTP} ranks (processes in one gloo group) sharing one card: the times say "
             "nothing of the speed of data or tensor parallelism",
        ranks=ranks, phase_s=time.perf_counter() - t0)


# phase 14: (a) the CLI's train with tpu.log_predictions at full width, one
# epoch of one batch of HOOK_BATCH pairs from HOOK_WINDOWS windows (the
# hook's own pair is the one left), the hook's step counts cut to
# HOOK_STEPS for time, the factored optimizer (checkpoints of 9.6 GB, not
# AdamW's 19 GB); (b) the identifiability loop at the canonical width, one
# warm-up and IDF_FULL_STEPS timed steps at IDF_FULL_BATCH pairs, then one
# eval; (c) the loop at the experiment's width IDF_MZ: the generator twice
# on one seed, 2 IDF_RESUME_N steps against IDF_RESUME_N + save + resume +
# IDF_RESUME_N, and IDF_TIMED_STEPS steps timed for the acceptance runs'
# estimate. The recipe of (b) and (c): x0, uniform, EMA 0.999, the
# on-device generator (IDF_INFINITE).
HOOK_WINDOWS, HOOK_BATCH = 3, 2
HOOK_STEPS = [10, 50]
IDF_FULL_BATCH = 2
IDF_FULL_STEPS = 3
IDF_MZ = 2560
IDF_RESUME_N = 5
IDF_TIMED_STEPS = 20
IDF_RECIPE = dict(pred="x0", weighting="uniform", ema="0.999", infinite=True, overfit=False)
# the hook's pred against DDIMSampler.sample on a model loaded from the EMA:
# the same kernels on the same tensors; bitwise expected, held to this
# relative L2 (bf16 compute) if a library call rounds otherwise
HOOK_PRED_TOL = 1e-3


def _import_idf():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import run_identifiability_torch as idf

    return idf


def _train_state(trainer):
    """Clones of the trainer's parameters, EMA and optimizer state."""
    opt = trainer.optimizer.state_dict()
    return ([p.detach().clone() for p in trainer.optimizer.params],
            [e.clone() for e in trainer.ema_params],
            [v.clone() for k in ("v_row", "v_col", "v") for v in opt.get(k, []) if v is not None],
            opt.get("count"))


def _state_diff(a, b) -> float:
    """The largest |difference| between two ``_train_state``s."""
    check(a[3] == b[3] and all(len(x) == len(y) for x, y in zip(a[:3], b[:3])),
          "the two states differ in structure")
    return max(float((x.float() - y.float()).abs().max()) for part in range(3)
               for x, y in zip(a[part], b[part]))


def phase_viz_hook(seed, results):
    """(a) ``train`` through the CLI with the prediction hook at full width."""
    import importlib.util

    import numpy as np
    import torch

    import dquartic_tpu_torch.utils.viz as viz
    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.utils.builder import build_model
    from dquartic_tpu_torch.utils.config import load_train_config

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if not have_mpl:
        log("  matplotlib is not installed on this machine: no PNG is rendered here; the "
            "renderer is replaced by a recorder, and rendering is held on the CPU by "
            "tests/test_torch_viz.py")
    seen, hook_runs = [], []
    draw = viz.plot_single_prediction

    def recorder(*arrays, **kw):
        seen.append([np.array(a) for a in arrays])
        if have_mpl:
            return draw(*arrays, **kw)
        return [os.path.join(kw["out_dir"], f"{kw['prefix']}{i}.png") for i in range(6)]

    call = viz.PredictionLoggingHook.__call__

    def watched(self, epoch, best_loss, trainer):
        before = _train_state(trainer)
        training = trainer.model.training
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        call(self, epoch, best_loss, trainer)
        torch.cuda.synchronize()
        hook_runs.append(dict(epoch=epoch, trainer=trainer, s=time.perf_counter() - t0,
                              launches=launch_counts(),
                              diff=_state_diff(before, _train_state(trainer)),
                              mode_kept=trainer.model.training == training))
        del before

    with tempfile.TemporaryDirectory(prefix="dq_viz_") as tmp:
        rng = np.random.default_rng(seed + 14)
        paths = {k: os.path.join(tmp, f"{k}.npy") for k in ("ms2", "ms1")}
        np.save(paths["ms2"], rng.uniform(0, 100, (HOOK_WINDOWS, RT, MZ)).astype(np.float32))
        np.save(paths["ms1"], rng.uniform(0, 50, (HOOK_WINDOWS, RT)).astype(np.float32))
        with open(CONFIG) as f:
            cfg = json.load(f)
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg["data"].update(parquet_directory=None, ms2_data_path=paths["ms2"],
                           ms1_data_path=paths["ms1"])
        cfg["model"].update(checkpoint_path=os.path.join(ckpt_dir, "best_model.ckpt"),
                            num_epochs=1, batch_size=HOOK_BATCH)
        cfg["wandb"]["use_wandb"] = False
        cfg["tpu"].update(compute_dtype="bfloat16", fused_resnet=True, optimizer="factored",
                          log_predictions=True, prediction_num_steps=HOOK_STEPS,
                          log_every_n_epochs=1)
        config_path = _write_json(os.path.join(tmp, "config.json"), cfg)
        viz.plot_single_prediction = recorder
        viz.PredictionLoggingHook.__call__ = watched
        reset_launch_counts()
        try:
            wall = _cli(["train", config_path])
        finally:
            viz.plot_single_prediction = draw
            viz.PredictionLoggingHook.__call__ = call
        check(len(hook_runs) == 1, f"the hook ran {len(hook_runs)} times, not once")
        run = hook_runs[0]
        trainer = run.pop("trainer")
        check(run["diff"] == 0.0 and run["mode_kept"],
              f"the hook changed the train state: max |diff| {run['diff']}, mode kept "
              f"{run['mode_kept']}")
        check(len(seen) == len(HOOK_STEPS), f"{len(seen)} renders, not {len(HOOK_STEPS)}")

        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        tables = [r for r in records if r.get("_table") == "predictions_table"]
        check(len(tables) == 1 and [row[0] for row in tables[0]["rows"]] == HOOK_STEPS,
              f"metrics.jsonl holds {len(tables)} prediction tables")
        cosines = {k: r[k] for r in records for k in r if k.startswith("predictions/cosine_")}
        check(sorted(cosines) == sorted(f"predictions/cosine_{n}steps" for n in HOOK_STEPS),
              f"logged cosines {sorted(cosines)}")
        pngs = sorted(p for p in os.listdir(ckpt_dir) if p.endswith(".png"))
        if have_mpl:
            check(len(pngs) == 6 * len(HOOK_STEPS) and all(
                os.path.exists(p) for row in tables[0]["rows"] for p in row[4:]),
                  f"panels written: {pngs}")

        # the hook's pred against the sampler on a model loaded from the EMA
        serve_cfg = load_train_config(config_path)
        ref = build_model(serve_cfg, device="cuda", trainable=True)
        ref.load_state_dict(trainer.ema_state_dict())
        ref.requires_grad_(False).eval()
        sampler = DDIMSampler(ref, trainer.process)
        errs, same = [], []
        for ns, arrays in zip(HOOK_STEPS, seen):
            g = torch.Generator(device="cuda").manual_seed(viz.noise_seed(0, run["epoch"], ns))
            noise = torch.randn((1, RT, MZ), generator=g, device="cuda")
            cond = torch.from_numpy(arrays[2]).cuda()[None]
            ms1 = torch.from_numpy(arrays[3]).cuda()[None]
            pred, _ = sampler.sample(noise, cond, ms1, num_steps=ns)
            pred = pred[0].float().cpu().numpy()
            same.append(bool(np.array_equal(pred, arrays[4])))
            errs.append(float(np.linalg.norm(pred - arrays[4]) / (np.linalg.norm(pred) + 1e-30)))
        del ref, sampler, trainer
        torch.cuda.empty_cache()
        check(all(np.isfinite(a[4]).all() for a in seen), "the hook's pred is not finite")
        check(max(errs) <= HOOK_PRED_TOL, f"the hook's pred is {errs} (rel L2) from the "
              "sampler's on a model loaded from the EMA")
        expect = _expect({k: v for k, v in SIMPLE_FORWARD.items() if k != "int8_matmul"},
                         sum(HOOK_STEPS))
        check(run["launches"] == expect, f"hook launches {run['launches']} != {expect}")
        log(f"  CLI train, full width (34 x {MZ}, bf16, fused, factored), 1 step of "
            f"{HOOK_BATCH} pairs + the hook at {HOOK_STEPS} steps: {wall:.2f} s wall, the hook "
            f"{run['s']:.2f} s; launches in the hook {run['launches']}; train state and mode "
            f"unchanged by the hook (max |diff| {run['diff']}); pred vs DDIMSampler.sample on "
            f"a model loaded from ema_state_dict(): bitwise {same}, rel L2 {errs}; cosines "
            f"{cosines}; panels {len(pngs)} PNG (matplotlib {'present' if have_mpl else 'absent'})")
        results["viz_hook"] = dict(wall_s=wall, hook_s=run["s"], bitwise=same, rel_l2=errs,
                                   cosines=cosines, pngs=len(pngs), matplotlib=have_mpl,
                                   launches={k: v for k, v in run["launches"].items() if v})


def _idf_steps(idf, exp, first, n, timed=False):
    """Global steps first .. first + n - 1: (ms per step, losses on the host)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [idf.train_step(exp, s) for s in range(first, first + n)]
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    return start.elapsed_time(end) / n, wall, torch.stack(losses).tolist()


def phase_idf_full(seed, results):
    """(b) the identifiability loop at the canonical width: steps and one eval."""
    import numpy as np
    import torch

    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts

    idf = _import_idf()
    with tempfile.TemporaryDirectory(prefix="dq_idf_full_") as tmp:
        knobs = idf.Knobs(root=tmp, steps=IDF_FULL_STEPS + 1, total=24000, batch=IDF_FULL_BATCH,
                          mz=MZ, device="cuda", **IDF_RECIPE)
        t0 = time.perf_counter()
        exp = idf.setup(knobs)
        setup_s = time.perf_counter() - t0
        idf.train_step(exp, 1)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ms, wall, losses = _idf_steps(idf, exp, 2, IDF_FULL_STEPS)
        per_step = {k: v / IDF_FULL_STEPS for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(bool(np.isfinite(losses).all()), f"losses {losses}")
        target, other, mix, m1i, _ = idf._pair(exp.ms2, exp.ms1, *idf.eval_pairs(knobs)[0][1:],
                                                exp.device)
        reset_launch_counts()
        with torch.inference_mode():
            idf.sample50(exp, None, exp.eval_noise, mix, m1i)
        sample = {k: v for k, v in launch_counts().items() if v}
        t0 = time.perf_counter()
        recs = idf.run_eval(exp, IDF_FULL_STEPS + 1)
        eval_s = time.perf_counter() - t0
        check(len(recs) == 6 and all(np.isfinite(r["sep50"]) for r in recs),
              f"eval records {recs}")
        check(all(per_step.get(k, 0) > 0 for k in STEP_LAUNCHES if k != "int8_matmul"),
              f"a step did not launch every kernel: {per_step}")
        log(f"  identifiability loop at 34 x {MZ} ({exp.trainer.num_parameters() / 1e9:.3f} B "
            f"parameters, batch {IDF_FULL_BATCH}, bf16, remat, factored, EMA, x0, uniform, "
            f"on-device windows): set-up {setup_s:.1f} s; {ms:.2f} ms/step on the device "
            f"clock ({wall:.2f} wall), peak {peak:.2f} GiB, losses {losses}; launches a step "
            f"{per_step}; a 50-step sample {sample}; one eval (6 records, 612 forwards) "
            f"{eval_s:.1f} s: {json.dumps(recs)}")
        results["idf_full"] = dict(ms_per_step=ms, wall_ms_per_step=wall, peak_gib=peak,
                                   losses=losses, launches_per_step=per_step,
                                   launches_per_sample=sample, eval_s=eval_s, evals=recs,
                                   setup_s=setup_s)
        del exp
    torch.cuda.empty_cache()


def phase_idf_small(seed, results):
    """(c) the loop at the experiment's width: repeatable generator, resume,
    ms/step."""
    import torch

    idf = _import_idf()
    one = idf.make_windows(torch.Generator(device="cuda").manual_seed(seed), 16, IDF_MZ)
    two = idf.make_windows(torch.Generator(device="cuda").manual_seed(seed), 16, IDF_MZ)
    gen_same = all(torch.equal(a, b) for a, b in zip(one, two))
    check(gen_same, "the window generator gave two results on one seed")
    n = IDF_RESUME_N
    with tempfile.TemporaryDirectory(prefix="dq_idf_") as tmp:
        def knobs(name):
            return idf.Knobs(root=os.path.join(tmp, name), steps=2 * n, total=24000, batch=8,
                             mz=IDF_MZ, device="cuda", **IDF_RECIPE)

        whole = idf.setup(knobs("whole"))
        params = whole.trainer.num_parameters()
        _idf_steps(idf, whole, 1, 2 * n)
        first = idf.setup(knobs("legs"))
        _idf_steps(idf, first, 1, n)
        idf.save(first, n)
        ckpt_mb = os.path.getsize(os.path.join(tmp, "legs", "state.ckpt")) / 2**20
        del first
        second = idf.setup(knobs("legs"))
        check(idf.resume(second) == n, "resume read another step")
        _idf_steps(idf, second, n + 1, n)
        a, b = _train_state(whole.trainer), _train_state(second.trainer)
        diff = _state_diff(a, b)
        differ = []
        if diff:
            names = second.trainer.param_names
            differ = sorted(((float((x - y).abs().max()), nm) for nm, x, y in
                             zip(names, a[0], b[0]) if not torch.equal(x, y)), reverse=True)
        del a, b, second
        ms, wall, losses = _idf_steps(idf, whole, 2 * n + 1, IDF_TIMED_STEPS)
        check(all(v == v for v in losses), f"losses {losses}")
        log(f"  identifiability loop at 34 x {IDF_MZ} ({params / 1e6:.3f} M parameters, batch "
            f"8): the generator bitwise equal on one seed: {gen_same}; {2 * n} steps against "
            f"{n} + save ({ckpt_mb:.1f} MiB) + resume + {n}: max |diff| of the train state "
            f"{diff}" + (f", {len(differ)} parameters differ, largest {differ[:6]}"
                         if differ else " (bitwise)")
            + f"; {ms:.2f} ms/step on the device clock ({wall:.2f} wall) over "
            f"{IDF_TIMED_STEPS} steps, losses {[round(v, 4) for v in losses[-3:]]}")
        results["idf_small"] = dict(generator_bitwise=gen_same, resume_max_abs_diff=diff,
                                    params_differing=[nm for _, nm in differ],
                                    ms_per_step=ms, wall_ms_per_step=wall, ckpt_mib=ckpt_mb)
        del whole
    torch.cuda.empty_cache()


def phase_viz_idf(seed, results):
    """Phase 14: the prediction hook and the identifiability loop."""
    import torch

    from dquartic_tpu_torch.ops import KERNELS

    t0 = time.perf_counter()
    phase_viz_hook(seed, results)
    phase_idf_full(seed, results)
    phase_idf_small(seed, results)
    for name in KERNELS:
        row = results.get(name)
        if not isinstance(row, dict) or "source" not in row:
            continue
        row["viz_idf_launches"] = dict(
            hook=results["viz_hook"]["launches"].get(name, 0),
            idf_step=results["idf_full"]["launches_per_step"].get(name, 0),
            idf_sample=results["idf_full"]["launches_per_sample"].get(name, 0))
    results["viz_idf"] = dict(hook=results.pop("viz_hook"), idf_full=results.pop("idf_full"),
                              idf_small=results.pop("idf_small"),
                              phase_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()


# phase 15: (a) the async sharded checkpoint backend (tpu.checkpoint_backend
# "orbax") at full width: phase 6's trainer settings with the factored
# optimizer and no EMA (5 GB a save, where AdamW + EMA would be 19 GB:
# scripts/time_async_ckpt_torch.py takes that one), one epoch of
# ASYNC_BATCHES batches writing latest and best, then a save with the next
# step taken at once while it is written, resumed by a trainer of another
# seed that takes the same step; (b) the
# examples/*_torch.py on the card from the msgpack file (a) writes of the
# same state.
ASYNC_BATCHES = 2
# the steps of predict_and_plot_torch (one window) and of
# multichip_deconvolution_torch
EXAMPLE_STEPS = 10
# quantize_checkpoint_torch's drift forwards (float mid convs) over its 8 RT
# rows: the mid attention at n = 8 < FLASH_MIN_SEQ takes the plain path
DRIFT_FORWARD = {"linear_attention": 14, "fused_resnet_block_t": 29}


def _rss_gib() -> float:
    """This process's resident host memory (``VmRSS``), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def phase_async_ckpt(config, seed, gen, results, optimizer="factored", ema=None,
                     keep_file=None):
    """Phase 15 (a): the async backend at full width; with ``keep_file``
    the msgpack file of the saved state is left there for (b). Returns the
    measurements."""
    import shutil

    import numpy as np
    import torch

    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.utils.builder import build_trainer

    dev = torch.device("cuda")
    cfg = _train_config(config, compute_dtype="bfloat16", optimizer=optimizer, ema_decay=ema,
                        checkpoint_backend="orbax")
    root = tempfile.mkdtemp(prefix="chip_smoke_async_")
    df = shutil.disk_usage(root)
    log(f"  checkpoints in {root}: {df.free / 1e9:.1f} GB free of {df.total / 1e9:.1f}")
    path = os.path.join(root, "best_model.ckpt")
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in _pair_batch(seed + 40 + i).items()}
               for i in range(ASYNC_BATCHES)]
    out = dict(optimizer=optimizer, ema_decay=ema)
    try:
        a = build_trainer(cfg, device=dev, seed=seed)
        backend = a._async
        # the backend timed from outside: each save on the training thread, each
        # writer thread, the staging copies on the device, the buffers' making
        saves, real_save = [], backend.save

        def timed_save(p, header, leaves=None):
            t0 = time.perf_counter()
            real_save(p, header, leaves)
            saves.append(dict(path=os.path.basename(p), again=leaves is None,
                              held_ms=(time.perf_counter() - t0) * 1e3, job=backend._last))

        backend.save = timed_save
        real_write, write_s = backend._write, {}

        def timed_write(job):
            t0 = time.perf_counter()
            real_write(job)
            write_s[id(job)] = time.perf_counter() - t0

        backend._write = timed_write
        real_wait = backend.wait
        waits = []

        def timed_wait():
            t0 = time.perf_counter()
            real_wait()
            waits.append(time.perf_counter() - t0)

        backend.wait = timed_wait
        real_prepare, prepared = backend.prepare, []

        def timed_prepare(leaves):  # the pinned buffers: host memory made before the loop
            rss, t0 = _rss_gib(), time.perf_counter()
            real_prepare(leaves)
            prepared.append((time.perf_counter() - t0, _rss_gib() - rss))

        backend.prepare = timed_prepare
        real_stage, staged_gib, stage_events = backend._stage, [], []

        def measured_stage(leaves):  # the device memory and time of a staging's copies
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
            staged = real_stage(leaves)
            events[1].record()
            stage_events.append(events)
            staged_gib.append((torch.cuda.max_memory_allocated() - before) / 2**30)
            return staged

        backend._stage = measured_stage
        reset_launch_counts()
        t0 = time.perf_counter()
        a.train(batches, epochs=1, warmup_epochs=0, learning_rate=1e-4, checkpoint_path=path)
        train_s = time.perf_counter() - t0
        out["state_bytes"] = sum(t.numel() * t.element_size()  # AdamW's moments made
                                 for t, _ in a._shard_leaves().values())
        counts = launch_counts()
        expect = _expect(STEP_LAUNCHES, ASYNC_BATCHES)
        check(counts == expect, f"async-backend epoch launches {counts} != {expect}")
        check(len(saves) == 2 and [s["again"] for s in saves] == [False, True],
              f"the epoch's saves {[(s['path'], s['again']) for s in saves]}: not latest, then "
              "best again")
        out.update(
            train_s=train_s, launches=counts, final_wait_s=waits[-1],
            prepare_s=prepared[0][0], prepare_host_rss_gib=prepared[0][1],
            staging_device_gib=max(staged_gib),
            staging_device_ms=[e[0].elapsed_time(e[1]) for e in stage_events],
            saves=[dict(path=s["path"], again=s["again"], held_ms=s["held_ms"],
                        write_s=write_s[id(s["job"])]) for s in saves])
        latest = backend.latest_path_for(path)
        files = sorted(os.listdir(latest))
        check(files == ["meta.json", "shard-00000-of-00001.pt"] and
              os.path.exists(os.path.join(path, "meta.json")),
              f"the latest and best directories: {files}")
        with open(os.path.join(latest, "meta.json")) as f:
            meta = json.load(f)
        check((meta["epoch"], meta["step"], meta["optimizer"]) == (0, ASYNC_BATCHES, optimizer),
              f"latest meta {meta['epoch'], meta['step'], meta['optimizer']}")

        # the msgpack path's _save of the same state (synchronous, mesh rank 0)
        a._async = None
        msgpack_path = keep_file or os.path.join(root, "msgpack.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a._save(msgpack_path, 0, 1.0)
        msgpack_ms = (time.perf_counter() - t0) * 1e3
        a._async = backend
        out.update(msgpack_save_held_ms=msgpack_ms,
                   msgpack_file_gb=os.path.getsize(msgpack_path) / 1e9)
        log(f"  async backend, {optimizer}{' + EMA' if ema else ''}: state "
            f"{out['state_bytes'] / 1e9:.3f} GB; pinned host buffers made before the loop in "
            f"{out['prepare_s']:.2f} s (host RSS +{out['prepare_host_rss_gib']:.2f} GiB); epoch "
            f"of {ASYNC_BATCHES} steps {train_s:.2f} s, launches {counts}; saves held the "
            "training thread " +
            ", ".join(f"{s['path']}{' (same snapshot)' if s['again'] else ''} "
                      f"{s['held_ms']:.1f} ms (write {s['write_s']:.2f} s)"
                      for s in out["saves"]) +
            f"; the staging copies {out['staging_device_ms'][0]:.1f} device ms and "
            f"+{out['staging_device_gib']:.3f} GiB of device memory; the final "
            f"wait {out['final_wait_s']:.2f} s; the msgpack path's _save held {msgpack_ms:.1f} "
            f"ms ({out['msgpack_file_gb']:.3f} GB file)")

        # a save, then at once the uninterrupted run's next step while it is
        # written: the step's in-place updates must not reach the files (the
        # staging copies come before them on the trainer's stream). A fresh
        # trainer of another seed resumes the state from before the step,
        # bitwise, and its next step's loss is the uninterrupted run's.
        for p in a.optimizer.params:
            p.grad = None
        torch.cuda.empty_cache()
        pre = {k: t.clone() for k, (t, _) in a._shard_leaves().items()}
        pre_step = (a.step, a.optimizer.named_state(a.param_names)[0]["count"])
        a._save(latest, 1, 1.0)
        losses = []
        g = torch.Generator(device=dev).manual_seed(seed + 44)
        losses.append(float(a.train_step(batches[0], 1e-4, generator=g)["loss"]))
        a._async.wait()
        moved = [k for k, (t, _) in a._shard_leaves().items() if not torch.equal(t, pre[k])]
        check(bool(moved), "the step after the save left every leaf as it was")
        del a
        torch.cuda.empty_cache()
        b = build_trainer(cfg, device=dev, seed=seed + 1)
        t0 = time.perf_counter()
        meta, tensors, epoch, _, resumed = b._async.restore_or_init(
            path, b._shard_layout(), optional=("ema/",))
        check(resumed and epoch == 1, "the fresh trainer did not resume the save before the step")
        b._load_shards(meta, tensors)
        del tensors
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        got = {k: t for k, (t, _) in b._shard_leaves().items()}
        bad = [k for k in pre if k not in got or not torch.equal(got[k], pre[k])]
        got_step = (b.step, b.optimizer.named_state(b.param_names)[0]["count"])
        check(not bad and got.keys() == pre.keys() and got_step == pre_step,
              f"the resumed state is not the state saved before the step: {bad[:5]}, step and "
              f"count {got_step} / {pre_step}")
        del got, pre
        g = torch.Generator(device=dev).manual_seed(seed + 44)
        losses.append(float(b.train_step(batches[0], 1e-4, generator=g)["loss"]))
        check(losses[0] == losses[1] and np.isfinite(losses[0]),
              f"the next step's loss: uninterrupted {losses[0]!r}, resumed {losses[1]!r}")
        out.update(next_loss=losses[0], leaves_the_step_moved=len(moved))
        log(f"  a save, then the next step at once while it is written, then wait; a trainer "
            f"of seed {seed + 1} resumes in {out['resume_s']:.2f} s: every leaf, the step and "
            f"the count bitwise the state before the step ({len(moved)} leaves the step moved); "
            f"its next step's loss {losses[1]:.6f} bitwise the uninterrupted run's")
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def phase_examples(seed, ckpt, results):
    """Phase 15 (b): predict_and_plot_torch (one full-width window, 10
    steps), quantize_checkpoint_torch (its drift) and
    multichip_deconvolution_torch (one rank, the shipping config, 10 steps)
    on the card, from ``ckpt``, each with its K1, K2 and K3 launches
    counted."""
    import importlib.util

    import numpy as np
    import torch

    from dquartic_tpu_torch.ops import launch_counts, reset_launch_counts
    from dquartic_tpu_torch.utils.config import load_train_config

    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = _npy_windows(tmp, seed + 50, MZ)
        cfg = load_train_config(CONFIG)
        cfg["data"].update(parquet_directory=None, ms2_data_path=data["ms2"],
                           ms1_data_path=data["ms1"])
        cfg["wandb"]["use_wandb"] = False
        cfg["tpu"].update(compute_dtype="bfloat16", quantize_mid=True, fused_resnet=True,
                          linear_attn_impl="pallas_t")
        config_path = _write_json(os.path.join(tmp, "config.json"), cfg)

        def run(name, expect, fn):
            reset_launch_counts()
            t0 = time.perf_counter()
            res = fn(example(name))
            wall = time.perf_counter() - t0
            counts = {k: n for k, n in launch_counts().items() if n}
            check(counts == expect, f"{name}: launches {counts}, not {expect}")
            out[name] = dict(wall_s=wall, launches=counts, **res)
            log(f"  {name}: {wall:.2f} s wall, launches K1 {counts.get('linear_attention', 0)} "
                f"K2 {counts.get('fused_resnet_block_t', 0)} K3 {counts.get('int8_matmul', 0)} "
                f"(all: {counts}); {res}")
            torch.cuda.empty_cache()

        def predict(ex):
            metrics = ex.predict_and_plot(config_path, ckpt, os.path.join(tmp, "pp"),
                                          num_steps=EXAMPLE_STEPS, num_windows=1, device=dev)
            check(len(metrics) == 1 and np.isfinite(metrics[0]["cosine_vs_target"]),
                  f"predict_and_plot_torch metrics {metrics}")
            with open(os.path.join(tmp, "pp", "metrics.json")) as f:
                check(json.load(f) == metrics, "metrics.json is not the metrics returned")
            return dict(cosine_vs_target=metrics[0]["cosine_vs_target"])

        run("predict_and_plot_torch", {k: n * EXAMPLE_STEPS for k, n in SIMPLE_FORWARD.items()},
            predict)

        def quantize(ex):
            res = ex.quantize_checkpoint(config_path, ckpt, os.path.join(tmp, "q.ckpt"), dev)
            check(np.isfinite(res["drift"]) and 0 < res["drift"] < 0.25 and
                  res["q_mb"] < res["raw_mb"] / 3, f"quantize_checkpoint_torch {res}")
            return res

        run("quantize_checkpoint_torch", {k: 2 * n for k, n in DRIFT_FORWARD.items()}, quantize)

        def multichip(ex):
            device, n = ex.start(dev)
            check(n == 1, f"multichip_deconvolution_torch: {n} ranks, not one")
            records, mesh = ex.deconvolve_windows(load_train_config(config_path), ckpt, device,
                                                  n, num_steps=EXAMPLE_STEPS, num_batches=1,
                                                  seed=seed)
            ex.save_records(records, os.path.join(tmp, "mc.npz"))
            pred = np.load(os.path.join(tmp, "mc.npz"))["pred_0"]
            check(mesh is None and pred.shape == (1, RT, MZ) and bool(np.isfinite(pred).all()),
                  f"multichip_deconvolution_torch: pred {pred.shape}")
            return dict(pred_abs_mean=float(np.abs(pred).mean()))

        run("multichip_deconvolution_torch",
            {k: n * EXAMPLE_STEPS for k, n in SIMPLE_FORWARD.items()}, multichip)
    results["examples"] = out


def phase_async_and_examples(config, seed, gen, results):
    """Phase 15: (a), then (b) from (a)'s msgpack file."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.ckpt")
        results["async_ckpt"] = phase_async_ckpt(config, seed, gen, results, keep_file=ckpt)
        phase_examples(seed, ckpt, results)
        for name, row in results.items():
            if isinstance(row, dict) and "source" in row:
                row["phase15_launches"] = dict(
                    async_epoch=results["async_ckpt"]["launches"].get(name, 0),
                    **{ex: results["examples"][ex]["launches"].get(name, 0)
                       for ex in results["examples"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and data")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "dquartic_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from dquartic_tpu_torch.utils.config import load_train_config

    config = load_train_config(CONFIG)
    config["tpu"].update(compute_dtype="bfloat16", quantize_mid=True, fused_resnet=True,
                         linear_attn_impl="pallas_t")
    # build_trainer's metrics log: JSONL, never a wandb run, even where wandb is installed
    config["wandb"]["use_wandb"] = False
    results = {
        "linear_attention": dict(source="dquartic_tpu_torch/csrc/linear_attention.cu",
                                 replaces="dquartic_tpu/ops/linear_attention.py:606"),
        "fused_resnet_block_t": dict(source="dquartic_tpu_torch/csrc/fused_resnet.cu",
                                     replaces="dquartic_tpu/ops/fused_resnet.py:241"),
        "int8_matmul": dict(source="dquartic_tpu_torch/csrc/int8_matmul.cu",
                            replaces="dquartic_tpu/ops/int8_matmul.py:111"),
        "linear_attention_backward": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_bwd.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:998"),
        "fused_resnet_backward": dict(source="dquartic_tpu_torch/csrc/fused_resnet_bwd.cu",
                                      replaces="dquartic_tpu/ops/fused_resnet.py:500"),
        "flash_attention": dict(source="dquartic_tpu_torch/csrc/flash_attention.cu",
                                replaces="dquartic_tpu/ops/flash_attention.py:99"),
        "flash_attention_backward": dict(
            source="dquartic_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="dquartic_tpu/ops/flash_attention.py:237",
            note="K7b: one cluster launch a call at n, m <= 512 (bf16 on tensor cores), "
                 "two past it; times at (1, 4, 34, 32) bf16, *_340 at n = 340, *_long at "
                 "n = 16384"),
        "fused_linear_attention": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_rows.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:276",
            note="K8: one cluster launch a call that reads the weights as they are, running "
                 "max per tile, bf16 products on tensor cores at float32 accuracy; times at "
                 "(34, 40000, 4) bf16 on channel-first memory, launches per predict of the "
                 "unfused pallas model (phase 9)"),
        "fused_linear_attention_two_call": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_rows.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:1139",
            note="K9: two launches a call, K8's kernel in its context mode (a cluster "
                 "launch writing each row's M) and its apply mode (a plain grid); no model "
                 "path reaches it, in JAX either; held against its plain version in phase 9"),
        "linear_attention_sp_stats": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_sp.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:1555",
            note="K6a: one cluster launch a call (K1's kernel in its stats mode, "
                 "csrc/linear_attention.cu; K4's for bf16 with float32 operands); launches "
                 "per rank of the sp=2 predict (phase 10)"),
        "linear_attention_sp_apply": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_sp.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:1589",
            note="K6b: one launch a call (K1's kernel in its apply mode, "
                 "csrc/linear_attention.cu: M folded from the summed stats, no cluster); "
                 "launches per rank of the sp=2 predict (phase 10); forward_*: a split "
                 "mixer's forward, K6a and K6b (no collective)"),
        "linear_attention_sp_backward": dict(
            source="dquartic_tpu_torch/csrc/linear_attention_sp.cu",
            replaces="dquartic_tpu/ops/linear_attention.py:1797",
            note="K6c: three launches a call (K4's kernel twice, csrc/linear_attention_bwd.cu, "
                 "and its fixed-order sum), one all_reduce; calls per rank of the sp=2 train "
                 "step"),
    }
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    seed = args.seed

    def phase_predict():
        counts, _ = phase_sample(config, seed, gen, SIMPLE_FORWARD, results=results)
        for name, n in counts.items():
            results[name]["launches"] = n

    phases = [
        ("card and build", phase_info),
        ("kernels vs plain versions", lambda: phase_kernels(gen, results)),
        ("canonical UNet1d forward, kernels vs plain",
         lambda: phase_forward(config, seed, gen, SIMPLE_FORWARD)),
        ("50-step DDIM deconvolution through DDIMSampler.predict", phase_predict),
        ("backward kernels vs autograd of the plain versions",
         lambda: phase_backward_kernels(gen, results)),
        ("full-width training through build_trainer",
         lambda: phase_train(config, seed, gen, results)),
        ("Trainer.train at small depth: checkpoints, resume, EMA predict",
         lambda: phase_train_loop(config, seed)),
        ("simple=False UNet1d (transformer bottleneck, flash attention)",
         lambda: phase_tfer(config, seed, gen, results)),
        ("row-blocked linear attention (K8, K9) and the unfused UNet1d",
         lambda: phase_rows(config, seed, gen, results)),
        (f"sequence parallel (K6a-c) over an sp = {SP} group on one card",
         lambda: phase_sp(config, seed, gen, results)),
        ("the command line: generate-config, train, resume, predict",
         lambda: phase_cli(seed, results)),
        ("the remaining model families: unconditional UNet1d, CustomTransformer, "
         "FourierFeatures", lambda: phase_families(config, seed, gen, results)),
        (f"data and tensor parallelism, dp = {DPTP} and tp = {DPTP} on one card",
         lambda: phase_dp_tp(config, seed, gen, results)),
        ("the prediction hook through the CLI and the identifiability loop",
         lambda: phase_viz_idf(seed, results)),
        ("the async sharded checkpoint backend at full width, and the examples on the card",
         lambda: phase_async_and_examples(config, seed, gen, results)),
    ]
    phase_s = {}
    try:
        for n, (what, run) in enumerate(phases, 1):
            log(f"== phase {n}: {what}")
            t0 = time.perf_counter()
            run()
            phase_s[n] = time.perf_counter() - t0
            log(f"== phase {n}: {phase_s[n]:.1f} s")
    except Exception as e:  # any failed phase fails the run, with its traceback
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    total = time.perf_counter() - T_START
    log(f"total {total:.1f} s (build included)")
    log("phase seconds: " + json.dumps({"phases": {str(k): round(v, 1) for k, v in
                                                   phase_s.items()},
                                        "total": round(total, 1)}))
    train = results.pop("train")
    log(f"train step: {json.dumps(train)}")
    log(f"simple=False: {json.dumps(results.pop('tfer'))}")
    log(f"unfused pallas: {json.dumps(results.pop('rows'))}")
    log(f"sequence parallel: {json.dumps(results.pop('sp'))}")
    log(f"command line: {json.dumps(results.pop('cli'))}")
    log(f"model families: {json.dumps(results.pop('families'))}")
    log(f"data and tensor parallelism: {json.dumps(results.pop('dp_tp'))}")
    log(f"prediction hook and identifiability: {json.dumps(results.pop('viz_idf'))}")
    log(f"async checkpoints: {json.dumps(results.pop('async_ckpt'))}")
    log(f"examples: {json.dumps(results.pop('examples'))}")
    kernels = [dict(name=k, route="cuda", **v) for k, v in results.items()]
    print(json.dumps({"kernels": kernels, "profile_retries": PROFILE_RETRIES}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
