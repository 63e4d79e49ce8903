"""The yardstick's FLOP counts equal ``torch.utils.flop_counter`` over the
plain reference at a small size: the model's forward (``mfu``) and each
kernel's call, forward and, for K4 and K5, forward and backward."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cb_helpers import ROOT, SMALL
from cuda_bench.reference import unet1d as R
from cuda_bench.reference.precision import Precision
from cuda_bench.roofline import model as M
from cuda_bench.weights import Weights

PC = Precision()


def _u(simple):
    u = json.load(open(os.path.join(ROOT, "dquartic_train_config.json")))["model"]["UNet1d"]
    # two MS1 columns: over one, einsum forms the tower mixer's context as a
    # broadcast product, which the counter does not see
    return dict(u, **SMALL, simple=simple, tfer_depth=4, attn_cond_channels=1 if simple else 2)


def _count(fn, backward=False):
    with FlopCounterMode(display=False) as fc:
        out = fn()
        if backward:
            out.sum().backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("simple", [True, False])
def test_forward_flops(simple):
    u = _u(simple)
    P = Weights(R.param_shapes(u), 3, "cpu").make()
    b, rt, mz = 2, 8, u["downsample_dim"]
    ac = torch.rand(b, rt, u["attn_cond_channels"])
    args = (torch.randn(b, rt, mz), torch.tensor([4, 600]), torch.rand(b, rt, mz), ac)
    with torch.no_grad():
        assert _count(lambda: R.forward(P, u, *args)) == M.forward_flops(u, b, rt)


def test_kernel_flops():
    u = _u(False)
    P = Weights(R.param_shapes(u), 4, "cpu").make()
    rows, rt = 3, 8
    for c, n in M.mixers(u)[:3] + M.mixers(u)[-1:]:
        name = next(k[:-len(".fn.norm.g")] for k, s in R.param_shapes(u).items()
                    if k.endswith(".fn.norm.g") and s[1] == c)
        x = torch.randn(rows, c, n, requires_grad=True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        assert _count(lambda: R.linear_attention(PC, leaves, name, x)) == M.k1(rows, c, n)[1]
        assert _count(lambda: R.linear_attention(PC, leaves, name, x), True) == M.k4(rows, c, n)[1]
    shapes = R.param_shapes(u)
    for i, (ci, co, n) in enumerate(M.row_blocks(u)):
        name = f"downs.{i // 2}.{i % 2}" if i < 6 else \
            (f"ups.{(i - 6) // 2}.{i % 2}" if i < 12 else "final_res_block")
        assert shapes[f"{name}.block1.proj.weight"][:2] == (co, ci)
        x = torch.randn(rows, ci, n, requires_grad=True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        assert _count(lambda: R.resnet_block(PC, leaves, name, x)) == M.k2(rows, ci, co, n)[1]
        assert _count(lambda: R.resnet_block(PC, leaves, name, x), True) == \
            M.k5(rows, ci, co, n)[1]
    (k, n), = set(M.mid_convs(u))
    x = torch.randn(2, n, rt)
    w = R.int8_params(P)["mid_block1.block1.proj.weight"]
    assert _count(lambda: R.conv1d(PC, x, w, padding=1)) == M.k3(2 * rt, k, n)[1]
    q, kk, v = (torch.randn(2, R.HIDDEN, rt) for _ in range(3))
    assert _count(lambda: R.attend(PC, q, kk, v)) == M.k7a(2, rt, rt)[1]


def test_kernel_calls_per_forward_at_full_width():
    u = json.load(open(os.path.join(ROOT, "cuda_bench", "configs", "unet-simple.json")))
    u = u["model"]["UNet1d"]
    assert len(M.mixers(u)) == 14 and len(M.row_blocks(u)) == 29
    assert M.attentions(u) == 1 and M.mid_convs(u) == [(30000, 10000)] * 4
    full = dict(u, simple=False, tfer_depth=4)
    assert len(M.mixers(full)) == 15 and M.attentions(full) == 8
    assert sorted(set(M.mixers(u))) == sorted({(4, 40000), (4, 20000), (8, 10000), (8, 5000),
                                               (12, 2500), (12, 1250), (16, 625), (8, 20000),
                                               (12, 5000), (16, 1250)})
