"""A kernel's share of its roofline in the traced slice.

The bound of the calls the slice ran (the configuration's shapes times
the forwards or backwards in the slice, :mod:`.model`) over the device
time of the kernel's records. Where the profiler kept fewer records of
the kernel's main launch than the calls it ran (it drops some in short
windows), the time is scaled up by the calls over the records seen, so
a dropped record never reads as speed.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from . import model

BACKWARD = ("k4", "k5", "k7b")


def kernel_seconds(rec: dict, kernel: str, patterns: Sequence[str], main: str) -> Optional[float]:
    """Device seconds of ``kernel``'s calls in the slice, scaled for
    dropped records; None where the slice holds none of its records."""
    passes = rec["backwards"] if kernel in BACKWARD else rec["forwards"]
    expected = model.calls_per_forward(kernel, rec["unet"]) * passes
    seconds, seen = 0.0, 0
    for name, _, dur in rec["slice"]["kernels"]:
        if any(p in name for p in patterns):
            seconds += dur / 1e6
            seen += main in name and "finish" not in name
    print(f"slice: {kernel} {seen} records of {expected} calls, {seconds:.6f} s",
          file=sys.stderr)
    if not seen or not seconds or not expected:
        return None
    return seconds * max(1.0, expected / seen)


def bound_seconds(rec: dict, kernel: str) -> float:
    passes = rec["backwards"] if kernel in BACKWARD else rec["forwards"]
    return passes * model.bound_per_forward(kernel, rec["unet"], rec["b"], rec["rt"],
                                            train=rec["train"])


def roofline(rec: dict, kernels: Sequence[tuple]) -> Optional[float]:
    """Percent of the roofline of ``kernels``, each (kernel, patterns,
    main), together: their bounds summed over their times summed."""
    if not rec.get("slice"):
        return None
    bound = time = 0.0
    for kernel, patterns, main in kernels:
        s = kernel_seconds(rec, kernel, patterns, main)
        if s is None:
            return None
        time += s
        bound += bound_seconds(rec, kernel)
    return 100.0 * bound / time
