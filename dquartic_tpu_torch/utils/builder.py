"""Build the port's mesh, model, DDIM process, dataset and trainer from a
config dict.

Port of ``build_mesh`` / ``apply_mesh_model_flags`` / ``build_model`` /
``build_process`` / ``build_dataset`` / ``build_trainer`` of
:mod:`dquartic_tpu.utils.builder` for the UNet1d (conditional or not) and the
CustomTransformer.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import DDIMProcess, make_schedule
from ..data import DIAMSDataset, PairBatches, prefetch_iterator
from ..models.layers import LayerNorm1d, RMSNorm, lecun_normal_
from ..models.transformer import CustomTransformer, LayerNorm
from ..models.unet1d import UNet1d
from ..ops.quantization import quantize_mid_block_params
from ..parallel.distributed import row_range
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.tensor import MIN_TP_FEATURES, leaf_specs, own, shard_model, shard_state_dict
from ..train import Trainer, make_optimizer
from .device import resolve_device
from .logging import NoOpLogger, make_logger

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
# Modules whose parameters stay float32 in every dtype, as JAX keeps them:
# the gains of RMSNorm and LayerNorm1d, LayerNorm1d's bias, and the
# CustomTransformer's LayerNorms.
_NORMS = (RMSNorm, LayerNorm1d, LayerNorm)


def _init_keys(cls) -> set:
    code = cls.__init__.__code__
    return set(code.co_varnames[1:code.co_argcount])


_UNET_KEYS = _init_keys(UNet1d)
_TRANSFORMER_KEYS = _init_keys(CustomTransformer)


def build_mesh(config: Dict[str, Any], batch_size: Optional[int] = None) -> Optional[Mesh]:
    """The mesh of ``tpu.mesh`` (JAX ``build_mesh``): None for one device.
    A None ``dp`` is the largest degree up to the processes that ``sp·tp``
    leave that divides ``batch_size`` (all of them when it is None; one
    process: dp = 1), so idle processes are left out rather than given an
    uneven batch. A mesh of more than one rank needs a running process
    group of ``dp·sp·tp`` ranks
    (:func:`~dquartic_tpu_torch.parallel.initialize_runtime`, or the
    launcher ``python -m torch.distributed.run``); without one it raises,
    naming the launcher. No axis is dropped."""
    m = config["tpu"]["mesh"]
    sp, tp, dp = m.get("sp") or 1, m.get("tp") or 1, m.get("dp")
    if dp is None:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        avail = max(1, world // (sp * tp))
        dp = avail if batch_size is None else next(
            d for d in range(avail, 0, -1) if batch_size % d == 0)
    if dp * sp * tp == 1:
        return None
    return make_mesh(dp=dp, sp=sp, tp=tp)


def apply_mesh_model_flags(unet: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """The mesh-dependent UNet1d keys (JAX ``apply_mesh_model_flags``),
    each unless the ``UNet1d`` block names it already: a mesh with
    ``sp > 1`` shards m/z, ``activation_sharding=("dp", "sp")``; one with
    ``dp > 1`` and ``sp == 1`` sets ``kernel_dp_axis="dp"``."""
    if mesh is not None and mesh.sp > 1 and unet.get("activation_sharding") is None:
        unet = dict(unet, activation_sharding=("dp", "sp"))
    if mesh is not None and mesh.dp > 1 and mesh.sp == 1 and unet.get("kernel_dp_axis") is None:
        unet = dict(unet, kernel_dp_axis="dp")
    return unet


@torch.no_grad()
def _unet_leaf(name: str, t: torch.Tensor, generator: torch.Generator) -> None:
    if name.endswith(".g"):
        t.fill_(1.0)
    elif name.endswith(("bias", ".b")):
        t.zero_()
    else:
        lecun_normal_(t, t[0].numel(), generator)


@torch.no_grad()
def init_leaves(model: torch.nn.Module, rule, generator: torch.Generator) -> None:
    """Initialize each parameter in order by ``rule(name, tensor,
    generator)``. A leaf split over tp is drawn whole on its device, one
    leaf at a time, and the rank keeps its shard, so the ranks' shards
    gather to the model one process draws from the same generator."""
    specs = leaf_specs(model)
    for name, p in model.named_parameters():
        if name not in specs:
            rule(name, p, generator)
            continue
        spec, dim = specs[name]
        whole = torch.empty(spec.full_shape(name.rpartition(".")[2], p.shape), dtype=p.dtype,
                            device=p.device)
        rule(name, whole, generator)
        p.copy_(own(whole, spec, dim))
        del whole


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights of a UNet1d: norm gains 1, biases
    (LayerNorm1d's ``b`` among them) 0, other weights flax's LeCun normal
    (:func:`~dquartic_tpu_torch.models.layers.lecun_normal_`: truncated at
    two standard deviations, variance 1/fan_in), as the JAX initializers."""
    init_leaves(model, _unet_leaf, generator)


def _unet_kwargs(config: Dict[str, Any], trainable: bool, mesh) -> Tuple[Dict[str, Any], bool]:
    """The UNet1d's constructor keys from the ``UNet1d`` block and ``tpu``
    (see :func:`build_model`), and whether its mid convs are int8."""
    u = dict(config["model"]["UNet1d"])
    if "attn_impl" in u:
        raise ValueError(
            "attn_impl belongs in the tpu section of the config, not in model.UNet1d "
            "(the JAX build_model passes tpu.attn_impl, so a second one is a duplicate "
            "keyword there)"
        )
    tpu = config["tpu"]
    quantize = bool(tpu.get("quantize_mid") or u.pop("quantize_mid", False))
    unknown = set(u) - _UNET_KEYS
    if unknown:
        raise ValueError(f"Unknown UNet1d config keys: {sorted(unknown)}")
    u = apply_mesh_model_flags(u, mesh)
    u.setdefault("linear_attn_impl", tpu.get("linear_attn_impl", "auto"))
    tpu_fused = tpu.get("fused_resnet") and not (trainable and u.get("activation_sharding"))
    u["fused_resnet"] = bool(u.get("fused_resnet") or tpu_fused)
    u["attn_impl"] = tpu["attn_impl"]
    return u, quantize


def _transformer_kwargs(config: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The CustomTransformer's constructor keys, as the JAX ``build_model``
    reads them: the block's keys, unknown ones (``attn_impl`` among them)
    refused. The ``tpu`` keys of the UNet1d (``fused_resnet``,
    ``linear_attn_impl``, ``attn_impl``) do not apply and are not read; a
    mesh that splits m/z (``sp > 1``) raises: no sequence-parallel path
    exists for this model."""
    c = dict(config["model"]["CustomTransformer"])
    unknown = set(c) - _TRANSFORMER_KEYS
    if unknown:
        raise ValueError(f"Unknown CustomTransformer config keys: {sorted(unknown)}")
    sp = mesh.sp if mesh is not None else (config["tpu"].get("mesh", {}).get("sp") or 1)
    if sp > 1:
        raise ValueError(
            f"tpu.mesh sp={sp}: the CustomTransformer has no sequence-parallel path, in JAX "
            "either (the mesh splits the UNet1d's m/z axis); it takes dp and tp (ROADMAP.md "
            "Queue 1 item 7)")
    return c


def build_model(
    config: Dict[str, Any], device=None, seed: int = 0, trainable: bool = False, mesh=None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    tp_min_features: int = MIN_TP_FEATURES,
) -> torch.nn.Module:
    """The ``model.use_model`` denoiser (``"UNet1d"`` or
    ``"CustomTransformer"``, from the config block of that name) with seeded
    random weights,
    or the float weights of ``state_dict`` (a trained model's, e.g. from
    :func:`~dquartic_tpu_torch.train.checkpoint.checkpoint_params`), on
    ``device`` (None: the card; raises without one), computing in
    ``tpu.compute_dtype``, its softmax attention by ``tpu.attn_impl``; with
    ``tpu.quantize_mid`` (or the ``UNet1d`` key) the mid convs are int8.

    The implementation keys resolve as the JAX package resolves them:
    ``linear_attn_impl`` from ``tpu``, overridden by a key of the same name
    in the ``UNet1d`` block (the JAX ``build_model``'s ``setdefault``);
    ``fused_resnet`` true when either the ``UNet1d`` key or
    ``tpu.fused_resnet`` is (the JAX ``build_trainer`` and ``predict``), so
    ``fused_resnet: false`` in both builds the unfused model with plain
    ResnetBlocks; ``remat_linear_attn`` and ``remat_blocks`` reach the
    model.

    ``mesh`` (None: :func:`build_mesh` of ``tpu.mesh`` and the batch size)
    with ``sp > 1``
    builds the model with ``activation_sharding`` (or the ``UNet1d`` key of
    that name) on that mesh; every rank builds the same weights from the
    same seed. Under ``activation_sharding`` a trainable model leaves
    ``tpu.fused_resnet`` aside, as the JAX ``build_trainer`` does, and a
    serving model with it raises, as JAX ``predict`` does. ``dp > 1``
    sets ``kernel_dp_axis`` (:func:`apply_mesh_model_flags`). ``tp > 1``
    splits the JAX rule's wide leaves (``tp_min_features``: 2048, JAX's
    ``Trainer`` default) over the ``tp`` group before the model is
    materialized, so a rank never holds the whole model: seeded leaves are
    drawn whole one at a time and cut (gathered, they are the one-process
    model of that seed), and a whole ``state_dict`` is cut to the rank's
    shards; int8 mid convs quantize their shards (per-column scales: the
    slice of the whole quantization). The CustomTransformer takes dp and
    tp alike and raises for ``sp > 1``.

    ``trainable=False`` (serving) stores the parameters in the compute
    dtype, norm gains and biases in float32, and no parameter needs grad:
    the float weights (seeded or loaded) are quantized first, then cast, so
    a model built from a state_dict is bitwise the one built from the seed
    that made those weights.
    ``trainable=True`` keeps float32 master parameters that require grad;
    they are cast to the compute dtype at use, as flax's
    ``param_dtype=float32`` does.

    The model is built on the meta device and materialized on ``device``,
    so the canonical models (1.2 B parameters, 2.8 B with ``simple=False``)
    are never built on the host.

    A ``CustomTransformer`` takes the keys of its block only (see
    :func:`_transformer_kwargs`): ``tpu.quantize_mid`` and
    ``tpu.fused_resnet`` are the UNet1d's and are not read here, as in the
    JAX ``build_model`` (``build_trainer`` refuses ``quantize_mid`` for any
    model, the CLI's ``predict`` both flags for this one). Its seeded
    weights are flax's initialization (``CustomTransformer.init_weights``);
    serving keeps its LayerNorms float32."""
    m = config["model"]
    dtype = _DTYPES[config["tpu"]["compute_dtype"]]
    quantize = False
    if m["use_model"] == "CustomTransformer":
        kwargs, cls = _transformer_kwargs(config, mesh), CustomTransformer
        rule = CustomTransformer.init_leaf
    elif m["use_model"] != "UNet1d":
        raise ValueError(f"Invalid model class: {m['use_model']}")
    if mesh is None:
        mesh = build_mesh(config, m.get("batch_size"))
    if m["use_model"] == "UNet1d":
        kwargs, quantize = _unet_kwargs(config, trainable, mesh)
        cls, rule = UNet1d, _unet_leaf

    device = resolve_device(device, "build_model")
    with torch.device("meta"):
        model = cls(**kwargs, dtype=dtype)
    if cls is UNet1d:
        model.mesh = mesh
    shard_model(model, mesh, tp_min_features)
    model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(shard_state_dict(model, state_dict))
    else:
        init_leaves(model, rule, torch.Generator(device=device).manual_seed(seed))
    if trainable:
        if quantize:
            raise ValueError("int8 mid convs (quantize_mid) are inference only")
        return model.train()
    if quantize:
        quantize_mid_block_params(model)
    keep = {f"{mn}.{pn}" for mn, mod in model.named_modules() if isinstance(mod, _NORMS)
            for pn, _ in mod.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        if name not in keep:
            p.data = p.data.to(dtype)
    return model.requires_grad_(False).eval()


def build_process(config: Dict[str, Any]) -> DDIMProcess:
    m = config["model"]
    schedule = make_schedule(
        num_timesteps=m["num_timesteps"],
        schedule_type=m["beta_schedule_type"],
        pred_type=m["pred_type"],
        weighting=config["tpu"].get("loss_weighting", "reference"),
    )
    return DDIMProcess(
        schedule=schedule,
        auto_normalize=m["auto_normalize"],
        ms1_loss_weight=m["ms1_loss_weight"],
        parity_neighbor_stepping=not config["tpu"].get("ddim_proper_stepping", False),
        clip_denoised=config["tpu"].get("clip_denoised", bool(m["auto_normalize"])),
    )


def build_dataset(config: Dict[str, Any], seed: int = 0, mesh=None, device=None):
    """The pair dataset of ``config["data"]`` (NPY files or a parquet
    directory) in batches of ``model.batch_size``, prefetched
    ``tpu.prefetch`` deep onto ``device`` (None: the card; raises without
    one), as the JAX ``build_dataset``. Every rank builds it alike from
    ``seed`` and draws the same global batches; under a mesh with
    ``dp > 1`` each keeps (fetches, stacks, copies) only its replica's
    contiguous rows, ``model.batch_size / dp`` of them (a batch size dp
    does not divide raises), and the sp and tp ranks of a replica take the
    same rows."""
    device = resolve_device(device, "build_dataset")
    d = config["data"]
    dataset = DIAMSDataset(
        parquet_directory=d["parquet_directory"],
        ms2_file=d["ms2_data_path"],
        ms1_file=d["ms1_data_path"],
        normalize=d["normalize"],
        seed=seed,
    )
    batch_size = config["model"]["batch_size"]
    batches = PairBatches(dataset, batch_size=batch_size, rows=row_range(batch_size, mesh))
    return prefetch_iterator(batches, device, size=config["tpu"]["prefetch"])


def build_logger(config: Dict[str, Any], mesh=None):
    """The metrics logger of the JAX ``build_trainer``: wandb from the
    config's ``wandb`` block when ``use_wandb`` is set and wandb is
    installed, else a JSONL log at ``<dirname(model.checkpoint_path)>/
    metrics.jsonl``. Under a mesh only mesh rank 0 logs, as only it writes
    checkpoints; the other ranks get a no-op logger."""
    if mesh is not None and mesh.rank != 0:
        return NoOpLogger()
    w = config.get("wandb", {})
    log_dir = os.path.dirname(config["model"].get("checkpoint_path", "")) or "."
    return make_logger(
        use_wandb=bool(w.get("use_wandb")),
        log_dir=log_dir,
        wandb_kwargs=dict(
            project=w.get("wandb_project"),
            name=w.get("wandb_name"),
            id=w.get("wandb_id"),
            resume=w.get("wandb_resume"),
            mode=w.get("wandb_mode", "offline"),
            config={
                "architecture": w.get("wandb_architecture"),
                "dataset": w.get("wandb_dataset"),
                **config["model"],
            },
        ),
        run_name=w.get("wandb_name"),
    )


def build_trainer(config: Dict[str, Any], device=None, seed: int = 0, logger=None,
                  mesh=None) -> Trainer:
    """Trainer over the trainable ``model.use_model`` denoiser (float32
    master weights computing in
    ``tpu.compute_dtype``) with the ``tpu.optimizer`` and ``tpu.ema_decay``
    of the config, as the JAX ``build_trainer`` wires them, on ``device``
    (None: the card; raises without one), on ``mesh`` (None:
    :func:`build_mesh` of ``tpu.mesh`` and the batch size), logging its
    epochs to ``logger``
    (None: :func:`build_logger` of the config). On a mesh the trainer runs
    dp as DDP and tp on the leaves :func:`build_model` split.

    ``tpu.checkpoint_backend`` is ``"msgpack"`` (the default: single
    ``torch.save`` files under the JAX package's names, written from mesh
    rank 0; the JAX package's msgpack files resume too) or ``"orbax"``,
    the JAX name of the async sharded backend
    (:mod:`~dquartic_tpu_torch.train.async_ckpt`, the port's own format);
    an unknown value raises, as in the JAX ``Trainer``."""
    m = config["model"]
    if config["tpu"].get("quantize_mid") or (
            m["use_model"] == "UNet1d" and m["UNet1d"].get("quantize_mid")):
        raise ValueError(
            "tpu.quantize_mid / UNet1d.quantize_mid is inference-only and cannot appear "
            "in a training config: int8 weights are frozen post-training artifacts with "
            "no gradient. Train with float32 master weights, then quantize for predict."
        )
    device = resolve_device(device, "build_trainer")
    if mesh is None:
        mesh = build_mesh(config, config["model"].get("batch_size"))
    model = build_model(config, device=device, seed=seed, trainable=True, mesh=mesh)
    if logger is None:
        logger = build_logger(config, mesh)
    return Trainer(
        model,
        build_process(config),
        optimizer=make_optimizer(model.parameters(), kind=config["tpu"].get("optimizer", "adamw")),
        ema_decay=config["tpu"]["ema_decay"],
        logger=logger,
        seed=seed,
        mesh=mesh,
        checkpoint_backend=config["tpu"].get("checkpoint_backend", "msgpack"),
    )
