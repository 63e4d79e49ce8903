"""UNet1d with ``channels != 1`` against the JAX package on the same weights.

The JAX model reshapes x (b, rt, mz) to one channel a row, whatever
``channels`` is, and its ``init_conv`` takes that one channel plus the init
condition's ``init_cond_channels``; ``channels`` sets only the output's
width, ``channels`` rows a window row. The port builds ``init_conv`` the
same way, so a JAX tree maps onto it through ``jax_params_to_torch``.
Weights are made with numpy from a seed in the JAX tree's shapes; both
sides run in float32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from dquartic_tpu.models import UNet1d as JaxUNet1d
from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch, torch_to_jax_params
from dquartic_tpu_torch.models import UNet1d
from test_torch_model import random_params

RT, MZ = 4, 16
# float32 on both sides, summation order only (tests/test_torch_model.py)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(dim=4, dim_mults=(1, 2), init_cond_channels=1, attn_cond_channels=1,
            downsample_dim=MZ, tfer_depth=2)


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(b, RT, MZ)).astype(np.float32),
                t=rng.integers(0, 1000, size=(b,)).astype(np.int32),
                ic=rng.uniform(-1, 1, size=(b, RT, MZ)).astype(np.float32),
                ac=rng.uniform(-1, 1, size=(b, RT)).astype(np.float32))


@pytest.mark.parametrize("channels", [3, 2])
@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("simple", [True, False])
def test_unet_channels_matches_jax(channels, conditional, simple):
    """The forward of UNet1d(channels=3 or 2), (b, rt·channels, mz),
    against JAX to 1e-4; the port's init_conv has JAX's inputs, and the
    parameter map is the identity both ways."""
    kw = dict(BASE, channels=channels, conditional=conditional, simple=simple)
    i = _inputs(2, seed=channels + 2 * conditional + 4 * simple)
    jmodel = JaxUNet1d(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), i["x"], i["t"], i["ic"],
                            i["ac"])
    params = random_params(shapes, seed=31 + channels)
    ref = np.asarray(jax.jit(jmodel.apply)(params, i["x"], i["t"], i["ic"], i["ac"]))
    assert ref.shape == (2, RT * channels, MZ)

    model = UNet1d(**kw).eval()
    sd = jax_params_to_torch(params, kw["dim_mults"])
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    assert model.init_conv.weight.shape[1] == 1 + (1 if conditional else 0)
    with torch.no_grad():
        out = model(torch.from_numpy(i["x"]), torch.from_numpy(i["t"]).long(),
                    torch.from_numpy(i["ic"]), torch.from_numpy(i["ac"])).numpy()
    np.testing.assert_allclose(out, ref, **MODEL_TOL)
    back = jax.tree_util.tree_leaves(torch_to_jax_params(model.state_dict(), kw["dim_mults"]))
    for a, b in zip(back, jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
