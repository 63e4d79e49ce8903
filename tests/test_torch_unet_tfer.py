"""UNet1d(simple=False) — the MS1 tower and the transformer bottleneck —
against the JAX package on the same weights: the forward, one
``train_loss`` gradient, and the parameter mapping both ways.

Weights are made with numpy from a seed in the JAX tree's shapes and
carried across by ``jax_params_to_torch``. Everything runs in float32 on
the CPU, where the port's kernel ops run their plain versions and the JAX
package's Pallas kernels run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
from dquartic_tpu.core import make_schedule as jax_make_schedule
from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu_torch.compat.jax_params import (
    grads_state_dict, jax_params_to_torch, torch_to_jax_params,
)
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.models import UNet1d
from test_torch_model import MODEL_TOL, SMALL, random_params
from test_torch_transformer import _flat, _t

# One gradient per parameter, max |error| over the largest entry (the
# UNet1d gradient tolerance of tests/test_torch_trainer.py).
GRAD_TOL = 1e-4


RT, MZ = 6, 64
FULL = dict(SMALL, dim_mults=(1, 2), downsample_dim=MZ, simple=False, tfer_depth=2)


def _cfg(mz_c):
    return dict(FULL, attn_cond_channels=mz_c)


def _inputs(b, mz_c, seed):
    rng = np.random.default_rng(seed)
    ac_shape = (b, RT) if mz_c == 1 else (b, RT, mz_c)
    return dict(
        x=rng.normal(size=(b, RT, MZ)).astype(np.float32),
        t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
        ic=rng.uniform(-1, 1, size=(b, RT, MZ)).astype(np.float32),
        ac=rng.uniform(-1, 1, size=ac_shape).astype(np.float32),
    )


def _jax_params(mz_c, seed):
    i = _inputs(1, mz_c, 0)
    shapes = jax.eval_shape(JaxUNet1d(**_cfg(mz_c)).init, jax.random.PRNGKey(0),
                            i["x"], i["t"], i["ic"], i["ac"])
    return random_params(shapes, seed)


def _port(params, mz_c, attn_impl):
    model = UNet1d(**_cfg(mz_c), attn_impl=attn_impl, fused_resnet=True)
    sd = jax_params_to_torch(params, FULL["dim_mults"])
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("b,mz_c,attn_impl", [
    (1, 1, "pallas"), (2, 1, "xla"), (1, 8, "xla"), (2, 8, "pallas"),
])
def test_unet_simple_false_matches_jax(b, mz_c, attn_impl):
    """The scalar and the (b, rt, 8) MS1 condition; the JAX side with its
    flash kernel (interpret mode) and fused ResnetBlocks under "pallas", its
    plain XLA path under "xla"."""
    params = _jax_params(mz_c, seed=20 + mz_c)
    jmodel = JaxUNet1d(**_cfg(mz_c), attn_impl=attn_impl,
                       fused_resnet=attn_impl == "pallas")
    i = _inputs(b, mz_c, seed=b)
    ref = jax.jit(jmodel.apply)(params, i["x"], i["t"], i["ic"], i["ac"])
    with torch.no_grad():
        out = _port(params, mz_c, attn_impl)(
            _t(i["x"]), torch.from_numpy(i["t"]).long(), _t(i["ic"]), _t(i["ac"]))
    assert out.shape == (b, RT, MZ)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_unet_simple_false_train_loss_grads_match_jax():
    """One ``train_loss`` gradient with the JAX rng's (t, eps) injected, the
    port's gradients mapped onto the JAX tree by ``torch_to_jax_params``;
    the JAX side runs its flash kernel and its blockwise backward."""
    params = _jax_params(1, seed=30)
    rng = np.random.default_rng(31)
    x0 = rng.uniform(0, 1, (2, RT, MZ)).astype(np.float32)
    ms2 = rng.uniform(0, 1, (2, RT, MZ)).astype(np.float32)
    ms1 = rng.uniform(0, 1, (2, RT)).astype(np.float32)
    key = jax.random.PRNGKey(32)
    t_rng, noise_rng = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_rng, (2,), 0, 1000))
    eps = np.asarray(jax.random.normal(noise_rng, x0.shape, dtype=jnp.float32))

    jmodel = JaxUNet1d(**_cfg(1), attn_impl="pallas")
    jproc = JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps"))

    def jloss(p):
        fn = lambda x, tt, ic, ac: jmodel.apply(p, x, tt, ic, ac)  # noqa: E731
        return jproc.train_loss(fn, key, jnp.asarray(x0), jnp.asarray(ms2), jnp.asarray(ms1))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    port = _port(params, 1, "pallas")
    proc = DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))
    loss, _ = proc.train_loss(port, _t(x0), _t(ms2), _t(ms1), t=torch.tensor(t),
                              eps=_t(eps))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = _flat(torch_to_jax_params(grads_state_dict(port), FULL["dim_mults"]))
    ref = _flat(jg)
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.max(np.abs(got[k] - ref[k])) / (np.max(np.abs(ref[k])) + 1e-12)
        assert err < GRAD_TOL, (k, err)


def test_simple_false_params_round_trip():
    """JAX tree -> port state_dict -> JAX tree is the identity, and the
    port's state_dict holds every parameter of the module."""
    params = _jax_params(8, seed=40)
    sd = jax_params_to_torch(params, FULL["dim_mults"])
    assert sd.keys() == UNet1d(**_cfg(8), fused_resnet=True).state_dict().keys()
    back = _flat(torch_to_jax_params(sd, FULL["dim_mults"]))
    ref = _flat(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
