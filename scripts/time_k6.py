#!/usr/bin/env python3
"""Times of the sequence-parallel linear-attention kernels K6a-c, of the
row-blocked K8 and K9 and of the flash-attention K7a and K7b of the PyTorch
port, with K1 and K4 beside them, for one or more checkouts on one CUDA
card.

    python3 scripts/time_k6.py [--reps N] [TREE ...]

Each TREE is the root of a checkout of the repository (default: the one
holding this script). Each is timed in a process of its own, in the order
given, so two versions compare within one call when they are given as
parent, change, change, parent. Every tree builds its kernels into its own
``dquartic_tpu_torch/_build`` first, all trees at once.

For each tree the script times, in bf16 with float32 weights (as phase 10 of
``chip_smoke.py`` holds them):

* K6a (``linear_attention_sp_stats``) at (34, 4, 20000) with rounded
  operands (the forward) and with float32 operands (the backward's
  recompute), and K6c (``linear_attention_sp_backward``) at the same shape
  with a reduce that does nothing (one slice: its partials are the sums);
* K6b (``linear_attention_sp_apply``) at the same shape as the tree's op
  takes it (from the summed stats; in a tree whose op takes the folded
  context M, from M), and the forward's whole step from the summed stats to
  y (there: ``sp_context`` and the op);
* K1 (``linear_attention``) and K4 (``linear_attention_backward``) at
  (34, 4, 40000), the level-0 shape of one process;
* K8 (``fused_linear_attention``) and K9
  (``fused_linear_attention_two_call``) at the (C, N) of every mixer of the
  canonical model with B = 34, on channel-first memory (the model's), and
  at (34, 40000, 4) also the kernels alone (``rows_launcher``'s launch) and
  K8 on row-major memory;
* K7a (``flash_attention``, untracked) at (1, 4, 34, 32) and K7b
  (``flash_attention_backward``, from the float32 output and the rows'
  statistics) at (1, 4, 34, 32), (8, 4, 34, 32), (1, 4, 340, 32) and
  (1, 4, 16384, 32), with the backward of ``scaled_dot_product_attention``
  at the last;

each around the wrapper (CUDA events over back-to-back calls, the mean) and
on the device (``torch.profiler`` over whole calls, padded by a 2 ms spin
of the card before and after that is not counted: the device time of every
kernel a call runs, and how many kernels that is). With ``--window`` it
also times, in each tree, the path on which K8 runs: the canonical model
unfused with ``tpu.linear_attn_impl = "pallas"`` (bf16, int8 mid convs,
seeded random weights), 50-step ``DDIMSampler.sample`` of one (34, 40000)
window (CUDA events, the median of 3 after one warm-up), and one of its
forwards on the device (K8's kernels and all). It prints the card
(``nvidia-smi`` name and power limit) and one JSON line a tree.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (C, N) of the 14 mixers of the canonical model (chip_smoke.py's ROWS_SHAPES)
ROWS_SHAPES = ((4, 40000), (4, 20000), (8, 10000), (8, 5000), (12, 2500), (12, 1250),
               (16, 625), (16, 1250), (12, 5000), (8, 20000))
# (b, h, n) of K7b: the RT axis at 34 and 340, batch 8, and a long sequence
FLASH_BWD_SHAPES = ((1, 4, 34), (8, 4, 34), (1, 4, 340), (1, 4, 16384))
PAD_S = 2e-3  # the spin before and after a profiled window (chip_smoke.py's PROFILE_PAD_S)


def _events_ms(fn, reps, warmup=3):
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
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def _pad_cycles() -> int:
    """PAD_S in cycles of the card's highest SM clock (nvidia-smi)."""
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.split()[0]
    return int(PAD_S * float(clk) * 1e6)


def _device_ms(fn, reps, name=None):
    """(device ms a call, kernels a call) over every kernel the calls ran;
    with ``name``, also the device ms a call of the kernels whose names hold
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = _pad_cycles()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(pad)
        torch.cuda.synchronize()
    us = named = 0.0
    n = 0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "CUDA")) or not e.count \
                or "spin_kernel" in e.key:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        us += t
        named += t if name and name in e.key else 0.0
        n += e.count
    out = (us / 1e3 / reps, n / reps)
    return out + (named / 1e3 / reps,) if name else out


def time_window(out):
    """The unfused "pallas" path's ms/window and one forward's device time."""
    import torch

    from dquartic_tpu_torch.infer import DDIMSampler
    from dquartic_tpu_torch.utils.builder import build_model, build_process
    from dquartic_tpu_torch.utils.config import load_train_config

    cfg = load_train_config(os.path.join(os.getcwd(), "dquartic_train_config.json"))
    cfg["tpu"].update(compute_dtype="bfloat16", quantize_mid=True, fused_resnet=False,
                      linear_attn_impl="pallas")
    model = build_model(cfg, device="cuda", seed=0)
    sampler = DDIMSampler(model, build_process(cfg))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x_t = torch.randn((1, 34, 40000), generator=gen, device="cuda")
    ms2 = torch.rand((1, 34, 40000), generator=gen, device="cuda")
    ms1 = torch.rand((1, 34), generator=gen, device="cuda")
    runs = sorted(_events_ms(lambda: sampler.sample(x_t, ms2, ms1, 50), 1, warmup=w)
                  for w in (1, 0, 0))
    t = torch.full((1,), 500, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        every, _, k8 = _device_ms(lambda: model(x_t, t, ms2 * 2 - 1, ms1 * 2 - 1), 5,
                                  "linattn_rows")
    out["window"] = dict(ms_per_window=runs[1], ms_runs=runs, forward_device_ms=every,
                         forward_k8_device_ms=k8)


def time_flash(out, both, gen, reps):
    """K7a at (1, 4, 34, 32) and K7b at FLASH_BWD_SHAPES, bf16; the backward
    of ``scaled_dot_product_attention`` at the longest."""
    import torch

    from dquartic_tpu_torch.ops import flash_attention as fa

    scale = 32 ** -0.5
    for b, h, n in FLASH_BWD_SHAPES:
        q, k, v, do = (torch.randn((b, h, n, 32), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        if n == 34 and b == 1:
            with torch.no_grad():
                both("K7a_1x34", lambda: fa.flash_attention(q, k, v))
        _, o32, stats = fa._launch_forward(q, k, v, scale)
        out_reps = reps if n <= 512 else 5
        both(f"K7b_{b}x{n}", lambda: fa.flash_attention_backward(q, k, v, o32, stats, do, scale),
             out_reps)
        if n > 512:
            ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
            lo = torch.nn.functional.scaled_dot_product_attention(*ls)
            both(f"sdpa_backward_{b}x{n}",
                 lambda: torch.autograd.grad(lo, ls, do, retain_graph=True), out_reps)
            del ls, lo
        del q, k, v, do, lse, o32
        torch.cuda.empty_cache()


def time_tree(reps, window=False):
    """Times of the checkout this process imports (run by ``--child``)."""
    import torch

    from dquartic_tpu_torch.ops import linear_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    C = 4
    w = [randn(C, 384, s=0.3), randn(128, C, s=0.1), randn(C, s=0.1), randn(C),
         1.0 + randn(C, s=0.2)]
    out = {"tree": os.getcwd()}

    def both(name, fn, n=reps):
        ms = _events_ms(fn, n)
        dev, kernels = _device_ms(fn, n)
        out[name] = dict(wrapper_ms=ms, device_ms=dev, kernels_a_call=kernels)

    x, dy = randn(34, C, 20000).to(torch.bfloat16), randn(34, C, 20000).to(torch.bfloat16)
    with torch.no_grad():
        st = la.linear_attention_sp_stats(x, w[0], w[4])
        if "stats" in inspect.signature(la.linear_attention_sp_apply).parameters:
            k6b = lambda: la.linear_attention_sp_apply(x, st, *w)  # noqa: E731
            both("K6b", k6b)
            both("K6b_from_stats", k6b)
        else:  # the op takes M, which the forward folds with sp_context first
            m = la.sp_context(st, w[0], w[1], round_m=True)[2]
            both("K6b", lambda: la.linear_attention_sp_apply(x, m, w[0], *w[2:]))
            both("K6b_from_stats", lambda: la.linear_attention_sp_apply(
                x, la.sp_context(st, w[0], w[1], round_m=True)[2], w[0], *w[2:]))
        both("K6a_rounded", lambda: la.linear_attention_sp_stats(x, w[0], w[4]))
        both("K6a_float32", lambda: la.linear_attention_sp_stats(x, w[0], w[4],
                                                                 round_operands=False))
        st = la.sp_stats_reference(x, w[0], w[4], round_operands=False)
        no_sum = lambda t: None  # noqa: E731
        # the backward takes the rank's own stats beside the summed ones
        # where it has a `stats_local` argument
        local = ((st,) if "stats_local" in inspect.signature(la.linear_attention_sp_backward)
                 .parameters else ())
        both("K6c", lambda: la.linear_attention_sp_backward(dy, x, *w, st, *local, no_sum))
    x, dy = randn(34, C, 40000).to(torch.bfloat16), randn(34, C, 40000).to(torch.bfloat16)
    with torch.no_grad():
        both("K1", lambda: la.linear_attention(x, *w))
    both("K4", lambda: la.linear_attention_backward(dy, x, *w))
    del x, dy
    with torch.no_grad():
        for C, N in ROWS_SHAPES:
            wr = [randn(C, 384, s=0.3), randn(128, C, s=0.1), randn(C, s=0.1), randn(C)]
            xr = randn(34, C, N).to(torch.bfloat16).transpose(1, 2)  # (B, N, C) view
            both(f"K8_{C}x{N}", lambda: la.fused_linear_attention(xr, *wr))
            both(f"K9_{C}x{N}", lambda: la.fused_linear_attention_two_call(xr, *wr))
            if (C, N) == ROWS_SHAPES[0]:
                launch, _ = la.rows_launcher("fused_linear_attention", xr, *wr, 4, 32, False)
                both("K8_alone", launch)
                launch, _ = la.rows_launcher("fused_linear_attention_two_call", xr, *wr, 4, 32,
                                             True)
                both("K9_alone", launch)
                xm = xr.contiguous()
                both("K8_row_major", lambda: la.fused_linear_attention(xm, *wr))
    time_flash(out, both, gen, reps)
    if window:
        time_window(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--window", action="store_true",
                    help="also time the unfused pallas path's 50-step sample")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:  # in a tree: its package is on sys.path
        print(json.dumps(time_tree(args.reps, args.window)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_k6: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    build = "from dquartic_tpu_torch.ops import _build; _build.library()"
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=t,
                               env=dict(os.environ, PYTHONPATH=t))
              for t in dict.fromkeys(trees)]
    if any(p.wait() for p in builds):
        print("time_k6: a build failed", file=sys.stderr)
        return 1
    for tree in trees:
        child = [sys.executable, os.path.abspath(__file__), "--child", "--reps", str(args.reps)]
        rc = subprocess.run(child + ["--window"] * args.window, cwd=tree,
                            env=dict(os.environ, PYTHONPATH=tree)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
