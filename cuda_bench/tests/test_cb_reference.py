"""The plain reference agrees with the port's plain path at a small m/z:
the forward of both ``simple`` paths (float32 weights and int8 mid convs),
and one training step (loss, clipped gradient, parameters, EMA)."""

import json
import os

import pytest
import torch

from cb_helpers import ROOT, SMALL
from cuda_bench.reference import ddim, unet1d as R
from cuda_bench.weights import Weights

from dquartic_tpu_torch.utils.builder import build_model, build_trainer
from dquartic_tpu_torch.utils.logging import NoOpLogger

# float32 on both sides; what is left is the order of sums over at most a
# few thousand terms behind normalizations that keep values O(1).
TOL = dict(rtol=2e-5, atol=2e-5)


def _config(simple: bool, quantize: bool = False):
    cfg = json.load(open(os.path.join(ROOT, "dquartic_train_config.json")))
    cfg["model"]["UNet1d"].update(SMALL, simple=simple, tfer_depth=4)
    cfg["tpu"].update(compute_dtype="float32", fused_resnet=True, quantize_mid=quantize)
    cfg["wandb"]["use_wandb"] = False
    return cfg


def _inputs(seed, b=2, rt=8, mz=256):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, rt, mz, generator=g), torch.tensor([3, 801]),
            torch.rand(b, rt, mz, generator=g) * 2 - 1, torch.rand(b, rt, generator=g) * 2 - 1)


@pytest.mark.parametrize("simple", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
def test_forward_matches_the_port(simple, quantize):
    cfg = _config(simple, quantize)
    u = cfg["model"]["UNet1d"]
    P = Weights(R.param_shapes(u), 77, "cpu").make()
    model = build_model(cfg, device="cpu", state_dict=P)
    if not quantize:
        sd = model.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == dict(R.param_shapes(u))
    args = _inputs(5)
    with torch.no_grad():
        out = model(*args)
        ref = R.forward(R.int8_params(P) if quantize else P, u, *args)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("simple", [True, False])
def test_param_shapes_at_full_width(simple):
    cfg = json.load(open(os.path.join(ROOT, "dquartic_train_config.json")))
    cfg["model"]["UNet1d"].update(simple=simple, tfer_depth=4)
    from dquartic_tpu_torch.models.unet1d import UNet1d

    with torch.device("meta"):
        m = UNet1d(**{k: v for k, v in cfg["model"]["UNet1d"].items()})
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == dict(R.param_shapes(cfg["model"]["UNet1d"]))


@pytest.mark.parametrize("simple", [True, False])
def test_one_train_step_matches_the_port(simple):
    cfg = _config(simple)
    u = cfg["model"]["UNet1d"]
    weights = Weights(R.param_shapes(u), 78, "cpu")
    trainer = build_trainer(cfg, device="cpu", seed=0, logger=NoOpLogger())
    trainer.model.load_state_dict(weights.make())
    trainer.init_state()
    g = torch.Generator().manual_seed(9)
    batch = {"ms2_1": torch.rand(1, 8, 256, generator=g), "ms1_1": torch.rand(1, 8, generator=g),
             "ms2_2": torch.rand(1, 8, 256, generator=g)}
    t, eps = torch.tensor([417]), torch.randn(1, 8, 256, generator=g)
    lr = 1e-3
    loss = trainer.train_step(batch, lr, t=t, eps=eps)["loss"]

    P = weights.make()
    P0 = {n: v.clone() for n, v in P.items()}
    names = list(P)
    params = [P[n].requires_grad_(True) for n in names]
    ref_loss = ddim.train_loss(lambda *a: R.forward(dict(zip(names, params)), u, *a), batch, t, eps)
    grads = torch.autograd.grad(ref_loss, params)
    opt = ddim.AdamW(params, ema_decay=0.999)
    clipped = opt.step(list(grads), lr)
    torch.testing.assert_close(loss, ref_loss.detach(), **TOL)
    port = dict(zip(trainer.param_names, trainer.optimizer.params))
    ema = dict(zip(trainer.param_names, trainer.ema_params))
    state = trainer.optimizer.adamw.state
    for n, p, c, e in zip(names, params, clipped, opt.ema):
        torch.testing.assert_close(state[port[n]]["exp_avg"] / 0.1, c, rtol=1e-4, atol=1e-6)
        # Adam's first update is g / (|g| + eps) per element: a gradient within
        # round-off of 0 may flip it, so an element may differ by up to 2 lr
        torch.testing.assert_close(port[n].detach(), p.detach(), rtol=0, atol=2 * lr)
        torch.testing.assert_close(ema[n], e, rtol=0, atol=2 * lr * 1e-3)
        w0 = P0[n]
        torch.testing.assert_close((port[n].detach() - w0).norm(), (p.detach() - w0).norm(),
                                   rtol=1e-3, atol=0)
