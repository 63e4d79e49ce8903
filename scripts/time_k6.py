#!/usr/bin/env python3
"""Times of the sequence-parallel linear-attention kernels K6a and K6c of the
PyTorch port, with K1 and K4 beside them, for one or more checkouts on one
CUDA card.

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
* K1 (``linear_attention``) and K4 (``linear_attention_backward``) at
  (34, 4, 40000), the level-0 shape of one process;

each around the wrapper (CUDA events over back-to-back calls, the mean) and
on the device (``torch.profiler`` over whole calls: the device time of every
kernel a call runs, and how many kernels that is). It prints the card
(``nvidia-smi`` name and power limit) and one JSON line a tree.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _device_ms(fn, reps):
    """(device ms a call, kernels a call) over every kernel the calls ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "CUDA")) or not e.count:
            continue
        t = getattr(e, "self_device_time_total", None)
        us += e.self_cuda_time_total if t is None else t
        n += e.count
    return us / 1e3 / reps, n / reps


def time_tree(reps):
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

    def both(name, fn):
        ms = _events_ms(fn, reps)
        dev, kernels = _device_ms(fn, reps)
        out[name] = dict(wrapper_ms=ms, device_ms=dev, kernels_a_call=kernels)

    x, dy = randn(34, C, 20000).to(torch.bfloat16), randn(34, C, 20000).to(torch.bfloat16)
    with torch.no_grad():
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
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:  # in a tree: its package is on sys.path
        print(json.dumps(time_tree(args.reps)), flush=True)
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
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--reps",
                             str(args.reps)], cwd=tree, env=dict(os.environ, PYTHONPATH=tree)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
