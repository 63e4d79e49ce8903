"""The one generator of the benchmark's traffic: DIA MS2 windows with their
exact MS1 traces, paired into the pair batches a dataset yields.

A frozen copy of the identifiability study's on-device window generator
(``draw_windows``, ``assemble_windows``, ``pair_batch`` of
``scripts/run_identifiability_torch.py``): each window holds
``n_peptides`` peptides, each a Gaussian elution profile over RT (centre
and width uniform) times a sparse spectrum of 5-11 fragments (log-normal
intensities, a five-bin peak shape), scaled by a log-normal amplitude;
its MS1 trace is the sum of the amplitude-scaled profiles. A pair batch
takes two windows per row, both MS2 maps min-max scaled by their joint
range and the MS1 trace by its own, as the training dataset does.

The parameters come from a traffic file (``cuda_bench/traffic/<name>.json``);
the m/z width from the configuration.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def draw(generator: torch.Generator, n: int, mz: int, p: dict) -> Dict[str, torch.Tensor]:
    dev = generator.device
    n_pep, frag = p["n_peptides"], p["fragments"]
    kw = dict(generator=generator, device=dev)
    c0, c1 = p["centre"]
    w0, w1 = p["width"]
    margin = p["fragment_margin"]
    return dict(
        c=torch.empty((n, n_pep), device=dev).uniform_(c0, c1, generator=generator),
        s=torch.empty((n, n_pep), device=dev).uniform_(w0, w1, generator=generator),
        nf=torch.randint(frag[0], frag[1], (n, n_pep), **kw),
        pos=torch.randint(margin, mz - margin, (n, n_pep, frag[1]), **kw),
        z_int=torch.randn((n, n_pep, frag[1]), **kw),
        z_amp=torch.randn((n, n_pep), **kw),
    )


def assemble(d: Dict[str, torch.Tensor], mz: int, p: dict):
    """(n, rt, mz) MS2 windows and their (n, rt) MS1 traces; each
    fragment's bins are added one fragment at a time and the peptides
    summed in order, so the same draws give bitwise the same windows."""
    c, s, nf, pos = d["c"], d["s"], d["nf"], d["pos"]
    n, n_pep = c.shape
    max_f = pos.shape[-1]
    dev = c.device
    t = torch.arange(p["rt"], dtype=torch.float32, device=dev)
    prof = torch.exp(-0.5 * ((t[None, None, :] - c[..., None]) / s[..., None]) ** 2)
    inten = torch.exp(p["log_intensity_sd"] * d["z_int"])
    inten = inten * (torch.arange(max_f, device=dev)[None, None, :] < nf[..., None])
    rows = torch.arange(n * n_pep, device=dev)
    posf = pos.reshape(n * n_pep, max_f)
    intf = inten.reshape(n * n_pep, max_f)
    shape = torch.tensor(p["peak_shape"], dtype=torch.float32, device=dev)
    half = len(p["peak_shape"]) // 2
    spec = torch.zeros((n * n_pep, mz), dtype=torch.float32, device=dev)
    for k, off in enumerate(range(-half, half + 1)):
        for f in range(max_f):
            spec[rows, posf[:, f] + off] += shape[k] * intf[:, f]
    spec = spec.reshape(n, n_pep, mz)
    aprof = torch.exp(p["log_amplitude_sd"] * d["z_amp"])[..., None] * prof
    W = aprof[:, 0, :, None] * spec[:, 0, None, :]
    M = aprof[:, 0]
    for q in range(1, n_pep):
        W = W + aprof[:, q, :, None] * spec[:, q, None, :]
        M = M + aprof[:, q]
    return W, M


def pair(a2, b2, a1) -> Dict[str, torch.Tensor]:
    lo = torch.minimum(a2.amin(dim=(1, 2)), b2.amin(dim=(1, 2)))[:, None, None]
    hi = torch.maximum(a2.amax(dim=(1, 2)), b2.amax(dim=(1, 2)))[:, None, None]
    s = torch.clamp(hi - lo, min=1e-12)
    l1 = a1.amin(dim=1, keepdim=True)
    s1 = torch.clamp(a1.amax(dim=1, keepdim=True) - l1, min=1e-12)
    return {"ms2_1": (a2 - lo) / s, "ms1_1": (a1 - l1) / s1, "ms2_2": (b2 - lo) / s}


def pool(p: dict, mz: int, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``p["pool_batches"]`` host pair batches of ``p["batch"]`` rows, made
    on ``device`` from ``seed``: numpy float32, as a dataset yields them."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, b = p["pool_batches"], p["batch"]
    W, M = assemble(draw(g, 2 * n * b, mz, p), mz, p)
    W, M = W.reshape(n, 2, b, p["rt"], mz), M.reshape(n, 2, b, p["rt"])
    return [{k: v.cpu().numpy() for k, v in pair(W[i, 0], W[i, 1], M[i, 0]).items()}
            for i in range(n)]
