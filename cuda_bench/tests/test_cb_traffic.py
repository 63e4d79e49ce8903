"""The traffic is made from the seed alone, as the frozen generator's
original makes it."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from cb_helpers import ROOT
from cuda_bench.traffic import generator

TRAFFIC = os.path.join(ROOT, "cuda_bench", "traffic")


def _params(name):
    return dict(json.load(open(os.path.join(TRAFFIC, name + ".json"))), pool_batches=2)


@pytest.mark.parametrize("name", ["windows.closed-b8", "pairs.train-b1"])
def test_same_seed_same_traffic(name):
    p = _params(name)
    a = generator.pool(p, 512, 2 ** 40 + 3, "cpu")
    b = generator.pool(p, 512, 2 ** 40 + 3, "cpu")
    c = generator.pool(p, 512, 2 ** 40 + 4, "cpu")
    assert len(a) == 2 and a[0]["ms2_1"].shape == (p["batch"], p["rt"], 512)
    for x, y, z in zip(a, b, c):
        for k in x:
            assert x[k].dtype == np.float32
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["ms2_1"], z["ms2_1"])
        assert x["ms2_1"].min() >= 0 and x["ms2_1"].max() <= 1
        assert np.allclose(x["ms1_1"].max(axis=1), 1) and np.allclose(x["ms1_1"].min(axis=1), 0)


def test_generator_is_the_identifiability_generator():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import run_identifiability_torch as idf

    p = _params("windows.closed-b8")
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    W, M = generator.assemble(generator.draw(g1, 6, 512, p), 512, p)
    W0, M0, _ = idf.assemble_windows(idf.draw_windows(g2, 6, 512), 512)
    torch.testing.assert_close(W, W0, rtol=0, atol=0)
    torch.testing.assert_close(M, M0, rtol=0, atol=0)
    a2, b2, a1 = W[:3], W[3:], M[:3]
    mine, theirs = generator.pair(a2, b2, a1), idf.pair_batch(a2, b2, a1, M[3:])
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0)
