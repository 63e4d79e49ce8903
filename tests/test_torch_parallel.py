"""Data and tensor parallelism of the port: the (dp, sp, tp) mesh, the JAX
tp rule, the seeded split model, one Trainer step (DDP over the rows, the
JAX rule's leaves split over tp) on five meshes against the JAX step, the
two double-counting faults caught, and a JAX checkpoint loaded onto a tp
mesh. The paths (every family, the sampler, checkpoints across tp sizes,
feeding) are in tests/test_torch_parallel_paths.py, the launcher in
tests/test_torch_parallel_cli.py.

The ranks are processes of one gloo group on the CPU (one pool of eight for
the module, the largest mesh's; a mesh of n ranks runs on ranks 0 .. n-1), where the port's
kernel wrappers run their plain versions and the collectives are real.
Inputs and weights are made with numpy from a seed in this process, which
also runs the JAX side on one device (JAX's own tests hold its meshes equal
to one device: tests/test_parallel.py). The rank processes import no JAX:
the JAX imports of this module are inside its tests.

The rule that decides everything: a step or a predict on any mesh computes
what it computes on one process for the same global batch, seed and
weights. Tolerances are those of tests/test_torch_sp.py's step: loss and
gradient norm rtol 1e-5; parameters rtol 1e-5 with atol 2·lr (Adam's first
update is about lr·sign(g)); the EMA atol 2·lr·1e-3.
"""

import contextlib
import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dquartic_tpu_torch.parallel.tensor as ptensor
import dquartic_tpu_torch.train.optim as poptim
from dquartic_tpu_torch.core import DDIMProcess, make_schedule
from dquartic_tpu_torch.infer import DDIMSampler
from dquartic_tpu_torch.models import UNet1d
from dquartic_tpu_torch.models.transformer import CustomTransformer
from dquartic_tpu_torch.parallel import (
    Mesh, full_state_dict, initialize_runtime, local_rows, make_mesh, shard_model,
)
from dquartic_tpu_torch.train import Trainer, make_optimizer
from dquartic_tpu_torch.utils.builder import build_model
from dquartic_tpu_torch.utils.config import load_train_config

MESHES = [(2, 1, 1), (1, 1, 2), (2, 1, 2), (2, 2, 1), (2, 2, 2)]
RT, MZ = 4, 32
# the JAX rule at test widths: the tiny model's widest axes are 16 to 384;
# at m/z 32 its mid convs are 128 x 128, so the factored optimizer factors
# them (optax's min_dim_size_to_factor 128) across their split axis
MIN = 16
LR = 1e-3
TINY = dict(dim=4, channels=1, dim_mults=(1, 2), conditional=True, init_cond_channels=1,
            attn_cond_channels=1, downsample_dim=MZ, simple=True)
CT = dict(input_dim=MZ, hidden_dim=32, num_heads=2, num_layers=2)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dquartic_train_config.json")


# --------------------------------------------------------------------- #
# the pool of ranks                                                     #
# --------------------------------------------------------------------- #


def _rank_main(rank, init_method, inq, outq, module, world, shapes):
    import importlib

    torch.set_num_threads(1)
    funcs = vars(importlib.import_module(module))
    initialize_runtime("gloo", rank, world, init_method, timeout_s=120)
    # every process makes every mesh's groups, in one order
    meshes = {s: make_mesh(*s, ranks=range(int(np.prod(s)))) for s in shapes}
    while True:
        task = inq.get()
        if task is None:
            break
        name, shape, args = task
        try:
            res = funcs[name](meshes[shape], *args) if rank < np.prod(shape) else None
            outq.put((rank, True, res))
        except Exception:  # reported to the test, which fails with it
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class _Ranks:
    """Processes in one gloo group, as many as the largest of the (dp, sp,
    tp) mesh ``shapes``; ``run(name, shape, *args)`` calls
    ``module.name(mesh, *args)`` on the ranks of the mesh ``shape`` and
    returns their results in mesh-rank order."""

    def __init__(self, module, shapes=MESHES):
        self.world = world = max(int(np.prod(s)) for s in shapes)
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, f"tcp://127.0.0.1:{port}", self.inqs[r], self.outq,
                                        module, world, shapes))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name, shape, *args):
        for q in self.inqs:
            q.put((name, shape, args))
        got, failed = {}, []
        for _ in range(self.world):  # every answer, so that none is left for the next task
            try:
                rank, ok, res = self.outq.get(timeout=300)
            except queue.Empty:
                pytest.fail(f"{name}: a rank did not answer")
            got[rank] = res
            if not ok:
                failed.append(f"{name} failed on rank {rank}:\n{res}")
        if failed:
            pytest.fail("\n".join(failed))
        return [got[r] for r in range(int(np.prod(shape)))]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ranks():
    pool = _Ranks(__name__)
    yield pool
    pool.close()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(sd):
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def _process():
    return DDIMProcess(schedule=make_schedule(1000, "cosine", "eps"))


def _batch(b, seed, mz=MZ):
    rng = np.random.default_rng(seed)
    return {"ms2_1": rng.uniform(0, 1, (b, RT, mz)).astype(np.float32),
            "ms1_1": rng.uniform(0, 1, (b, RT)).astype(np.float32),
            "ms2_2": rng.uniform(0, 1, (b, RT, mz)).astype(np.float32)}


def _unet(mesh, sd, **kw):
    """The tiny UNet1d on the mesh's path: m/z split under sp (unfused, as
    in JAX), fused ResnetBlocks otherwise, loaded with the whole ``sd``."""
    sp = mesh is not None and mesh.sp > 1
    model = UNet1d(**{**TINY, **kw}, fused_resnet=not sp,
                   activation_sharding=("dp", "sp") if sp else None)
    model.mesh = mesh
    if sd is not None:
        model.load_state_dict({k: _t(v) for k, v in sd.items()})
    return model


def _small_config():
    config = load_train_config(CONFIG)
    config["model"]["UNet1d"].update(dim_mults=[1, 2], downsample_dim=MZ)
    config["model"]["batch_size"] = 2
    config["tpu"].update(fused_resnet=True, linear_attn_impl="pallas_t")
    return config


# --------------------------------------------------------------------- #
# the mesh                                                              #
# --------------------------------------------------------------------- #


def _coords(mesh):
    def members(group):
        return None if group is None else sorted(dist.get_process_group_ranks(group))

    return (mesh.rank, mesh.dp_rank, mesh.sp_rank, mesh.tp_rank,
            members(mesh.dp_group), members(mesh.sp_group), members(mesh.tp_group))


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_follows_jax_device_order(ranks, shape):
    """Rank (d·sp + s)·tp + t sits at (d, s, t), JAX's ``reshape(dp, sp,
    tp)``; each axis group holds the ranks that differ only there."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    for r, (rank, d, s, t, dpg, spg, tpg) in enumerate(ranks.run("_coords", shape)):
        assert rank == r and grid[d, s, t] == r
        for group, line in ((dpg, grid[:, s, t]), (spg, grid[d, :, t]), (tpg, grid[d, s, :])):
            assert group == (None if len(line) == 1 else sorted(line.tolist()))


def test_mesh_refuses_a_mismatch():
    with pytest.raises(ValueError, match="must be >= 1"):
        make_mesh(dp=0)
    assert make_mesh(1, 1, 1).shape == {"dp": 1, "sp": 1, "tp": 1}
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 4"):
        make_mesh(dp=2, tp=2)


# --------------------------------------------------------------------- #
# the JAX rule                                                          #
# --------------------------------------------------------------------- #


def _tiny(family):
    return {**TINY, "simple": family == "simple", "tfer_depth": 2}


def _jax_tree(family):
    import jax

    from dquartic_tpu.models import CustomTransformer as JaxCT
    from dquartic_tpu.models import UNet1d as JaxUNet1d
    from test_torch_model import random_params

    b = _batch(1, 0)
    x, t, ic, ac = b["ms2_1"], np.zeros((1,), np.int32), b["ms2_2"], b["ms1_1"]
    if family == "ct":
        model = JaxCT(**CT)
        ic = None
    else:
        model = JaxUNet1d(**_tiny(family))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t, ic, ac)
    return model, random_params(shapes, seed=41)


@pytest.mark.parametrize("family", ["simple", "tfer", "ct"])
def test_tp_rule_matches_jax_shardings(family):
    """Each tp rank's shard of every leaf, at min_tp_features 16, equals the
    torch layout of the addressable shard that JAX's ``shardings_for_tree``
    gives on a (dp 1, tp 2) CPU mesh, and so do the leaves left whole."""
    import jax

    from dquartic_tpu.parallel import make_mesh as jax_make_mesh
    from dquartic_tpu.parallel import shardings_for_tree
    from dquartic_tpu_torch.compat.jax_params import jax_params_to_torch, torch_layouts

    _, params = _jax_tree(family)
    jmesh = jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    placed = jax.device_put(params, shardings_for_tree(params, jmesh, min_tp_features=MIN))
    sd = jax_params_to_torch(params)
    layouts = torch_layouts(sd)
    n_split = 0
    for t in range(2):
        model = CustomTransformer(**CT) if family == "ct" else UNet1d(**_tiny(family))
        shard_model(model, Mesh(tp=2, rank=t), MIN)
        model.load_state_dict(ptensor.shard_state_dict(model, {k: _t(v) for k, v in sd.items()}))
        got = model.state_dict()
        for name, (path, perm) in layouts.items():
            leaf = placed["params"]
            for key in path:
                leaf = leaf[key]
            (shard,) = [s for s in leaf.addressable_shards if s.device == jmesh.devices[0, t]]
            data = np.asarray(shard.data)
            want = data.reshape(1, -1, 1) if perm is None else np.transpose(data, perm)
            np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
            n_split += t == 0 and data.shape != leaf.shape
    assert n_split > 5


def test_tp_init_gathers_to_the_one_process_model():
    """build_model at tp = 2 draws each split leaf whole and keeps the
    rank's shard: the shards gathered are the seed's one-process model,
    bitwise; an int8 shard is the slice of the whole quantization."""
    config = _small_config()
    ref = build_model(config, device="cpu", seed=5, trainable=True).state_dict()
    qref = build_model(dict(config, tpu=dict(config["tpu"], quantize_mid=True)),
                       device="cpu", seed=5).state_dict()
    for t in range(2):
        mesh = Mesh(tp=2, rank=t)
        got = build_model(config, device="cpu", seed=5, trainable=True, mesh=mesh,
                          tp_min_features=MIN)
        q = build_model(dict(config, tpu=dict(config["tpu"], quantize_mid=True)),
                        device="cpu", seed=5, mesh=mesh, tp_min_features=MIN)
        specs = ptensor.leaf_specs(got)
        for name, v in got.state_dict().items():
            want = ref[name] if name not in specs else ptensor.own(ref[name], *specs[name])
            assert torch.equal(v, want), name
        qspecs = ptensor.leaf_specs(q)
        assert "mid_block1.block1.proj.weight_q" in qspecs
        for name, v in q.state_dict().items():
            want = qref[name] if name not in qspecs else ptensor.own(qref[name], *qspecs[name])
            assert torch.equal(v, want), name


def test_the_split_has_one_owner():
    """build_model (or the Trainer, for a model given whole) splits the
    wide leaves: the sampler refuses an unsplit model on a tp mesh, the
    Trainer one split at another width, and a model is split once."""
    mesh = Mesh(tp=2, rank=0)
    with pytest.raises(ValueError, match="split over it"):
        DDIMSampler(UNet1d(**TINY), _process(), mesh=mesh)
    model = shard_model(UNet1d(**TINY), mesh, MIN)
    DDIMSampler(model, _process(), mesh=mesh)
    with pytest.raises(ValueError, match="split at min_tp_features 16, not the Trainer's 2048"):
        Trainer(model, _process(), mesh=mesh)
    with pytest.raises(ValueError, match="split over tp already"):
        shard_model(model, mesh, MIN)


# --------------------------------------------------------------------- #
# one Trainer step against JAX                                          #
# --------------------------------------------------------------------- #


def _gather_sums(real):
    def backward(ctx, g):  # sums the cotangent over the ranks, then slices
        return real(ctx, ptensor._sum(g, ctx.group))

    return staticmethod(backward)


def _norm_every_rank(real):
    def global_norm(tensors, split=None, group=None):  # counts replicated leaves tp times
        sq = torch.stack(torch._foreach_norm([t.float() for t in tensors])).square().sum()
        if group is not None:
            dist.all_reduce(sq, group=group)
        return sq.sqrt()

    return global_norm


def _local_mean(real):
    def _mean(self, t, over_split):  # the tp all_reduce removed
        return t.div_(dist.get_world_size(self.tp_group)) if over_split else t

    return _mean


def _split_not_updated(real):
    def step(self, lr):  # the split leaves keep their values
        split = [p for p, d in zip(self.params, self._dims()) if d is not None]
        kept = [p.detach().clone() for p in split]
        norm = real(self, lr)
        with torch.no_grad():
            torch._foreach_copy_(split, kept)
        return norm

    return step


# the faults patched in for the negative tests: (owner, attribute, patch)
FAULTS = {
    "gather_sums": [(ptensor._Gather, "backward", _gather_sums)],
    "norm_every_rank": [(poptim, "global_norm", _norm_every_rank)],
    "factored_local_mean": [(poptim.ClippedFactoredRMS, "_mean", _local_mean)],
    "split_not_updated": [(poptim.ClippedAdamW, "step", _split_not_updated),
                          (poptim.ClippedFactoredRMS, "step", _split_not_updated)],
}


@contextlib.contextmanager
def _fault(kind):
    """A fault patched in for the negative tests (None: none)."""
    patches = FAULTS.get(kind, [])
    real = [owner.__dict__[name] for owner, name, _ in patches]
    for (owner, name, patch), r in zip(patches, real):
        setattr(owner, name, patch(r.__func__ if isinstance(r, staticmethod) else r))
    try:
        yield
    finally:
        for (owner, name, _), r in zip(patches, real):
            setattr(owner, name, r)


def _step(mesh, sd, batch, t, eps, kind, fault=None):
    model = _unet(mesh, sd)
    tr = Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind=kind),
                 mesh=mesh, tp_min_features=MIN)
    with _fault(fault):
        m = tr.train_step(local_rows({k: _t(v) for k, v in batch.items()}, mesh), LR,
                          t=_t(t), eps=_t(eps))
    payload = tr.checkpoint_payload(0, 0.0)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = [v for st in tr.optimizer.state_dict()["state"].values()
               for k, v in st.items() if k != "step"] if kind == "adamw" else []
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=_np(full_state_dict(model)), shapes=shapes,
                moments=sum(v.numel() for v in moments),
                opt=_named_state(tr, kind), grads=_whole_grads(model),
                ema=None if payload is None else _np(payload["ema_params"]))


def _whole_grads(model):
    """The clipped gradient the optimizer took, gathered whole, by name."""
    specs = ptensor.leaf_specs(model)
    out = {}
    for n, p in model.named_parameters():
        g = p.grad
        if n in specs:
            g = ptensor.gather(g, specs[n][0].group, specs[n][1])
        out[n] = g.numpy()
    return out


def _named_state(tr, kind):
    """The optimizer's state gathered whole, keyed as the JAX state maps
    onto the port (``jax_checkpoint_to_port``): {moment: {name: array}}."""
    sd = tr.optimizer.state_dict(whole="cpu")
    if kind == "adamw":
        return {k: {n: sd["state"][i][k].numpy() for i, n in enumerate(tr.param_names)}
                for k in ("exp_avg", "exp_avg_sq")}
    return {k: {n: None if v is None else v.numpy() for n, v in zip(tr.param_names, sd[k])}
            for k in ("v_row", "v_col", "v")}


_JAX_STEPS = {}


def _jax_step(kind):
    """The single-device JAX Trainer step on the tiny model: weights, batch,
    draws and the state after it (computed once per optimizer)."""
    if kind in _JAX_STEPS:
        return _JAX_STEPS[kind]
    import flax
    import jax
    import jax.numpy as jnp

    from dquartic_tpu.core import DDIMProcess as JaxDDIMProcess
    from dquartic_tpu.core import make_schedule as jax_make_schedule
    from dquartic_tpu.models import UNet1d as JaxUNet1d
    from dquartic_tpu.train import Trainer as JaxTrainer
    from dquartic_tpu.train.optim import make_optimizer as jax_make_optimizer
    from dquartic_tpu_torch.compat.jax_params import _opt_state_to_port, jax_params_to_torch
    from test_torch_model import random_params
    from test_torch_trainer import _flat, _jax_draws

    batch = _batch(2, 11)
    jtr = JaxTrainer(JaxUNet1d(**TINY),
                     JaxDDIMProcess(schedule=jax_make_schedule(1000, "cosine", "eps")),
                     optimizer=jax_make_optimizer(kind=kind), seed=0)
    params = random_params(jax.eval_shape(lambda: jtr.init_params(batch)), seed=12)
    key = jax.random.PRNGKey(13)
    t, eps = _jax_draws(key, 2, batch["ms2_1"].shape)
    state, m = jtr.train_step(jtr._fresh_state(params),
                              {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(LR), key)
    opt = _opt_state_to_port(flax.serialization.to_state_dict(state.opt_state), state.params)
    _JAX_STEPS[kind] = dict(
        state=state, sd=jax_params_to_torch(params), batch=batch, t=np.asarray(t),
        eps=np.asarray(eps),
        loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
        params=_flat(state.params), ema=_flat(state.ema_params),
        opt={k: {n: None if a is None else np.asarray(a) for n, a in v.items()}
             for k, v in opt.items() if k not in ("kind", "count")})
    return _JAX_STEPS[kind]


def _scaled(got, want, tol, what, slack=0.0):
    """|got - want| within ``tol`` of the leaf's largest magnitude, plus
    ``slack`` (elementwise)."""
    err = np.abs(np.asarray(got, np.float64) - want) - slack
    err = np.max(err) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} of the leaf's largest magnitude"


def _rounding(p1):
    """What the float32 roundings of the two steps' parameter arithmetic
    (two each at most: the decay's product and the update's sum) move the
    difference of their (p1 - p0)/lr."""
    return 4 * np.spacing(np.abs(p1).astype(np.float32)).astype(np.float64) / LR


def _check_step(out, ref, shape):
    """Loss, norm, parameters and EMA at the tolerances of the module
    docstring, then the optimizer (:func:`_check_optimizer`)."""
    from dquartic_tpu_torch.compat.jax_params import torch_to_jax_params
    from test_torch_trainer import _flat

    for r, o in enumerate(out):
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(o["grad_norm"], ref["grad_norm"], rtol=1e-5)
        got = _flat(torch_to_jax_params(o["params"]))
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2 * LR, err_msg=f"rank {r} {k}")
        _check_optimizer(o, ref, r)
    ema = _flat(torch_to_jax_params(out[0]["ema"]))
    for k, v in ref["ema"].items():
        np.testing.assert_allclose(ema[k], v, rtol=1e-5, atol=2 * LR * 1e-3, err_msg=k)


def _check_optimizer(o, ref, r):
    """What atol 2·lr on the parameters cannot see (a first update is
    about lr·O(1)), each within 1e-4 of its leaf's largest magnitude. The
    state, gathered whole, against JAX's: Adam's moments, the factored row,
    column and full statistics (the port's gradients hold JAX's to about
    3.1e-5 of that on these meshes, their squares to 4.7e-5). The update
    (p1 - p0)/lr against
    the one a one-process optimizer takes from the whole clipped gradients:
    against JAX's it is about sign(g) on every leaf Adam or the factored
    optimizer does not factor, which the summation order flips where g is
    near 0."""
    for mk, want in ref["opt"].items():
        for n, v in want.items():
            assert (o["opt"][mk][n] is None) == (v is None), (mk, n)
            if v is not None:
                _scaled(o["opt"][mk][n], v, 1e-4, f"rank {r} {mk} {n}")
    names = list(o["grads"])
    params = [torch.nn.Parameter(_t(ref["sd"][n]).clone()) for n in names]
    for p, n in zip(params, names):
        p.grad = _t(o["grads"][n])
    make_optimizer(params, kind="factored" if "v" in ref["opt"] else "adamw").step(LR)
    for p, n in zip(params, names):
        p0 = ref["sd"][n].astype(np.float64)
        _scaled((o["params"][n] - p0) / LR, (p.detach().numpy() - p0) / LR, 1e-4,
                f"rank {r} update {n}", _rounding(o["params"][n]))


@pytest.mark.parametrize("kind", ["adamw", "factored"])
@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 1, 2), (2, 1, 2), (2, 2, 1)])
def test_trainer_step_matches_jax(ranks, shape, kind):
    """One Trainer step on the mesh against the single-device JAX step from
    the same weights, global batch and draws: every rank's state, gathered
    whole, and the EMA of rank 0's checkpoint. Under tp each rank holds
    only its shards and their optimizer state (half the split leaves)."""
    ref = _jax_step(kind)
    out = ranks.run("_step", shape, ref["sd"], ref["batch"], ref["t"], ref["eps"], kind)
    _check_step(out, ref, shape)
    whole = sum(int(np.prod(v.shape)) for v in out[0]["params"].values())
    for o in out:
        held = sum(int(np.prod(s)) for s in o["shapes"].values())
        assert held == whole if shape[2] == 1 else whole / 2 < held < whole
        assert o["moments"] == (2 * held if kind == "adamw" else 0)


def test_trainer_step_on_the_full_mesh_matches_jax(ranks):
    """(dp, sp, tp) = (2, 2, 2): eight ranks, AdamW, the smallest shape."""
    ref = _jax_step("adamw")
    _check_step(ranks.run("_step", (2, 2, 2), ref["sd"], ref["batch"], ref["t"], ref["eps"],
                          "adamw"), ref, (2, 2, 2))


@pytest.mark.parametrize("fault", ["gather_sums", "norm_every_rank"])
def test_the_step_checks_catch_double_counting(ranks, fault):
    """The faults of double counting make the step check fail: a gather
    whose backward sums (tp times the split leaves' gradients) and a norm
    that counts the replicated leaves on every tp rank."""
    ref = _jax_step("adamw")
    out = ranks.run("_step", (1, 1, 2), ref["sd"], ref["batch"], ref["t"], ref["eps"], "adamw",
                    fault)
    with pytest.raises(AssertionError):
        _check_step(out, ref, (1, 1, 2))


@pytest.mark.parametrize("fault,kind", [("factored_local_mean", "factored"),
                                        ("split_not_updated", "adamw"),
                                        ("split_not_updated", "factored")])
def test_the_step_checks_catch_optimizer_faults(ranks, fault, kind):
    """The optimizer's tp faults make the step check fail, and its check
    of the optimizer's state and update fails on its own: the factored
    means over a split axis taken on the shard (their tp all_reduce
    removed), and a step that leaves the split leaves as they were (Adam's
    parameters then stay within atol 2·lr)."""
    ref = _jax_step(kind)
    out = ranks.run("_step", (1, 1, 2), ref["sd"], ref["batch"], ref["t"], ref["eps"], kind,
                    fault)
    with pytest.raises(AssertionError):
        _check_step(out, ref, (1, 1, 2))
    with pytest.raises(AssertionError, match="of the leaf's largest magnitude"):
        _check_optimizer(out[0], ref, 0)


def _load_jax(mesh, path, kind):
    from dquartic_tpu_torch.train import load_checkpoint

    model = _unet(None, None)
    tr = Trainer(model, _process(), optimizer=make_optimizer(model.parameters(), kind=kind),
                 mesh=mesh, tp_min_features=MIN)
    tr._load(load_checkpoint(path, "cpu"))
    payload = tr.checkpoint_payload(0, 0.0)
    return None if payload is None else (
        _np(payload["params"]), _np(payload["ema_params"]),
        [None if v is None else v.numpy() for k in ("v_row", "v_col", "v")
         for v in payload["opt_state"][k]], payload["step"])


def test_a_jax_checkpoint_loads_onto_a_tp_mesh(ranks, tmp_path):
    """The JAX Trainer's msgpack file after a factored step, resumed at
    tp = 2: rank 0's checkpoint of the state it holds, gathered whole, is
    bitwise the one-process load (parameters, EMA and the factored
    statistics, whose split axes differ from the leaves')."""
    from dquartic_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    path = str(tmp_path / "dquartic_latest_checkpoint.ckpt")
    jax_save_checkpoint(path, {"epoch": np.int64(0), "best_loss": np.float64(1.0),
                               "state": _jax_step("factored")["state"]})
    ref = _load_jax(None, path, "factored")
    got = ranks.run("_load_jax", (1, 1, 2), path, "factored")
    assert got[1] is None and got[0][3] == ref[3] == 1
    for part in range(2):
        for k, v in ref[part].items():
            np.testing.assert_array_equal(got[0][part][k], v, err_msg=k)
    for a, b in zip(got[0][2], ref[2]):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
