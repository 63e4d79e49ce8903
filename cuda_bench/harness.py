"""What every mode of the benchmark shares: the cell's files found by name,
the program's configuration, the device's readings, the comparison's
numbers and the result line.

A cell (``cuda_bench/workloads/<cell>.json``) names its configuration
(``cuda_bench/configs/<config>.json``: the model block as it is run), its
traffic (``cuda_bench/traffic/<traffic>.json``: the generator's
parameters, the batch, the pool), its mode (``cuda_bench/modes/<mode>.py``)
with the mode's settings, the ``tpu`` block the program runs under
(precision and kernel path), and the limits of its comparison. A per-layer
metric is ``cuda_bench/metrics/<metric>.py``, whose ``read(rec)`` returns
the metric from the traced run's records, or None where it finds nothing
to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(HERE, "_out")  # the traced runs' chrome traces
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dquartic_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"
    program: str = "port"  # or "control": the reference in the lower precision

    @classmethod
    def load(cls, name: str, **kw) -> "Cell":
        wl = load_json("workloads", f"{name}.json")
        return cls(name=name, workload=wl, config=load_json("configs", f"{wl['config']}.json"),
                   traffic=load_json("traffic", f"{wl['traffic']}.json"), **kw)

    @property
    def unet(self) -> dict:
        return self.config["model"]["UNet1d"]

    def program_config(self) -> dict:
        """The port's configuration: the model block as it is run, the
        cell's ``tpu`` block, no data files, no wandb."""
        model = {k: v for k, v in self.config["model"].items()}
        return {"data": {"parquet_directory": None, "ms2_data_path": None,
                         "ms1_data_path": None, "normalize": "minmax"},
                "model": model, "wandb": {"use_wandb": False}, "threads": 4,
                "tpu": json.loads(json.dumps(self.workload["tpu"]))}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def mark(t_process: float, phase: str, device=None) -> None:
    """Log the seconds from the process's start to the end of a phase of
    set-up (waiting for the card's work first where ``device`` is given)."""
    if device is not None:
        sync(device)
    log(f"set-up: {phase} done at {time.perf_counter() - t_process:.3f} s")


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def quantile(values: List[float], q: int, n: int = 100) -> float:
    """The q-th of ``n`` quantiles (``statistics.quantiles``, exclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=n)[q - 1]


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's,
    optax's or the JAX package's (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def leaf_gaps(prog: List[float], ref: List[float], keep: Optional[List[bool]] = None):
    """Each kept leaf's gap between the program's and the reference's norm,
    against the larger of that leaf's reference norm and the median
    leaf's: {index: gap}."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return {i: abs(prog[i] - ref[i]) / max(ref[i], med) if math.isfinite(prog[i]) else math.inf
            for i in idx}


def gap_of_norms(prog, ref, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep).values())


def median_gap(prog, ref, keep=None) -> float:
    """The median leaf's gap (:func:`leaf_gaps`)."""
    return statistics.median(leaf_gaps(prog, ref, keep).values())


def worst_leaves(prog, ref, names, keep=None, k=3, yard=None) -> str:
    """The ``k`` leaves of the widest gap, each with both norms (and the
    yardstick's, where given)."""
    gaps = leaf_gaps(prog, ref, keep)
    top = sorted(gaps, key=gaps.get, reverse=True)[:k]
    return "; ".join(f"{names[i]} {gaps[i]:.4g} ({prog[i]:.4g} against {ref[i]:.4g}"
                     + (f", in bf16 {yard[i]:.4g})" if yard is not None else ")") for i in top)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number without a limit is still shown."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def correct_of(checks: Dict[str, dict], failed: int) -> bool:
    ok = failed == 0
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        if lim is None:
            continue
        ok = ok and v is not None and math.isfinite(v) and v <= lim
    return ok


def per_layer(cell: Cell, bench: dict, rec: dict) -> Dict[str, dict]:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in bench["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"cuda_bench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def mode(name: str):
    return importlib.import_module(f"cuda_bench.modes.{name}")
