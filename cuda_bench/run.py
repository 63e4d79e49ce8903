"""The benchmark of the PyTorch and CUDA port (``dquartic_tpu_torch``) on
NVIDIA cards.

    python3 cuda_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card this process sees and
prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``breakdown`` (``--trace 1``) and ``checks`` (each number compared, beside
its limit; also the last lines of standard error). Without a card, or
with fewer cards than the cell asks for, it prints no result and exits
with 3; where JAX, flax, optax or the JAX package were loaded it exits
with 4.

``--program control`` puts the plain reference, its products in fp8, in
the program's place: the comparison's control, never part of a benchmark
run. Traces go to ``cuda_bench/_out/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cuda_bench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--program", choices=("port", "control"), default="port")
    return p.parse_args(argv)


def result(cell, bench: dict, res: dict, chips: int) -> dict:
    checks = harness.judge(res["numbers"], cell.workload["check"]["limits"])
    out = {"correct": harness.correct_of(checks, res["failed"]),
           "attempted": res["attempted"], "failed": res["failed"]}
    device = dict(harness.device_info(chips), memory_peak_bytes=res["memory_peak_bytes"])
    if cell.trace:
        sl = res["rec"]["slice"]
        metrics = harness.per_layer(cell, bench, res["rec"])
        device.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if cell.name in m.get("workloads", [cell.name])}
    out.update(metrics=metrics, device=device)
    if cell.trace:
        out["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    harness.mark(T_PROCESS, "import torch")

    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        harness.log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        harness.log(f"{args.workload} needs {entry['chips']} CUDA device(s); this process sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    cell = harness.Cell.load(args.workload, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), program=args.program)
    res = harness.mode(cell.workload["mode"]).run(cell, T_PROCESS)
    harness.log(f"{args.workload} seed {args.seed} on {harness.power_limit()}")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or of the JAX package were loaded: {bad}: no result")
        return 4
    out = result(cell, bench, res, entry["chips"])
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
