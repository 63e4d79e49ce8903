"""The training runtime (port of :class:`dquartic_tpu.train.trainer.Trainer`),
on one device or on a mesh whose ``sp`` axis splits m/z over a process
group.

One train step: on-device multiplexing ``ms2_cond = w0·ms2_1 + w1·ms2_2``,
the diffusion loss, backward (through the K4/K5 kernels on a card),
global-norm clipping, AdamW at the epoch's learning rate, and an EMA of
the parameters. The loop follows the JAX semantics: the learning rate is
set per epoch by the warmup-cosine schedule, the host syncs once per epoch
(unless ``sync_every_batch``), latest and best checkpoints are written
with auto-resume after the stored epoch, and a callback can stop training.

The train state is the model's float32 parameters, the optimizer state,
the EMA tensors and the step count; it lives in this object and its model
and is updated in place. Checkpoints keep the EMA keyed by parameter name,
so a serving model can load it without a Trainer; the positional list of
earlier files still loads. A JAX checkpoint (flax msgpack) resumes too:
:func:`~dquartic_tpu_torch.train.checkpoint.load_checkpoint` maps it.

On a ``mesh`` (one process per rank, every rank running the same loop):

* ``dp``: the model is wrapped in ``DistributedDataParallel`` over the
  ``dp`` group, which averages the gradients over the replicas in buckets
  while the backward runs. Each rank's batch holds its own rows (as
  ``build_dataset(mesh=...)`` yields them); the timesteps and noise of a
  step are drawn for the whole global batch from the same generator on
  every rank, which keeps its rows, so a step equals the one-process step
  on the global batch. Injected ``t``/``eps`` are global too.
* ``sp``: every rank of the group runs the same rows; the model computes
  its slice of m/z and the loss on the whole prediction, each rank's
  backward leaves its partial gradients, and the step sums them over the
  group before clipping.
* ``tp``: the wide leaves are split over the ``tp`` group at
  ``tp_min_features``, by ``build_model(mesh=...)`` or, for a model given
  whole, by the Trainer
  (:func:`~dquartic_tpu_torch.parallel.tensor.shard_model`); each rank
  keeps its shards, their gradients, optimizer state and EMA; the
  clipping norm is the global one.

The loss and the gradient norm in the metrics are the global ones; the
EMA is alike on every replica. With ``checkpoint_backend="msgpack"`` (the
default) only mesh rank 0 writes checkpoints, the whole state gathered
over tp one leaf at a time (the file a single process writes); a resume
cuts each rank's shards from it. With ``"orbax"`` (the JAX name of its
async backend) the saves are async and sharded
(:mod:`~dquartic_tpu_torch.train.async_ckpt`): every tp rank of the
first replica writes its own shards, and a resume reads them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.diffusion import DDIMProcess
from ..parallel.distributed import row_range
from ..parallel.sequence import sp_all_reduce
from ..parallel.tensor import MIN_TP_FEATURES, full_state_dict, gather, leaf_specs, own, \
    shard_model, shard_state_dict
from ..utils import profiling
from .async_ckpt import AsyncCheckpointBackend
from .callbacks import CallbackHandler
from .checkpoint import latest_path_for, restore_or_init, save_checkpoint
from .optim import ClippedAdamW, ClippedFactoredRMS, WarmupCosineSchedule, make_optimizer


# DDP's bucket size: the canonical model's 4.82 GB of float32 gradients go
# in a handful of all_reduces a step (a leaf larger than a bucket is one)
DP_BUCKET_MB = 256


class Trainer:
    """Owns the model, process, optimizer and EMA, and runs the loop."""

    def __init__(
        self,
        model: torch.nn.Module,
        process: DDIMProcess,
        optimizer: Union[ClippedAdamW, ClippedFactoredRMS, None] = None,
        ema_decay: Optional[float] = 0.999,
        mixture_weights: Tuple[float, float] = (0.5, 0.5),
        logger=None,
        callback_handler: Optional[CallbackHandler] = None,
        seed: int = 0,
        sync_every_batch: bool = False,
        mesh=None,
        tp_min_features: int = MIN_TP_FEATURES,
        checkpoint_backend: str = "msgpack",
    ):
        if checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(f"Unknown checkpoint_backend: {checkpoint_backend!r}")
        self.checkpoint_backend = checkpoint_backend
        self._async = AsyncCheckpointBackend(mesh) if checkpoint_backend == "orbax" else None
        self.model = model
        self.mesh = mesh
        self.sp_group = None
        if mesh is not None and mesh.sp > 1:
            if getattr(model, "activation_sharding", None) is None:
                raise ValueError(
                    f"a mesh with sp={mesh.sp} needs a model whose activation_sharding splits "
                    "m/z over it (build_trainer sets it from tpu.mesh)")
            model.mesh = mesh
            self.sp_group = mesh.sp_group
        split_at = getattr(model, "tp_min_features", None)
        if split_at is None:
            shard_model(model, mesh, tp_min_features)
        elif split_at != tp_min_features:
            raise ValueError(f"the model's wide leaves are split at min_tp_features {split_at}, "
                             f"not the Trainer's {tp_min_features}")
        self.process = process
        self.optimizer = optimizer if optimizer is not None else make_optimizer(model.parameters())
        self.ema_decay = ema_decay
        self.mixture_weights = mixture_weights
        self.logger = logger
        self.callback_handler = callback_handler or CallbackHandler()
        self.seed = seed
        self.sync_every_batch = sync_every_batch
        self.device = next(model.parameters()).device
        by_id = {id(p): n for n, p in model.named_parameters()}
        # the names of the optimizer's parameters, in its order
        self.param_names = [by_id[id(p)] for p in self.optimizer.params]
        specs = leaf_specs(model)
        # for each of the optimizer's parameters, (tp spec, axis) or None
        self._splits = [specs.get(n) for n in self.param_names]
        if any(s is not None for s in self._splits):
            self.optimizer.shard(mesh.tp_group, [None if s is None else s[1] for s in self._splits])
        self._denoise = model
        if mesh is not None and mesh.dp > 1:
            from torch.nn.parallel import DistributedDataParallel

            # the replicas are built alike from one seed: no broadcast at start
            self._denoise = DistributedDataParallel(
                model, process_group=mesh.dp_group, init_sync=False,
                gradient_as_bucket_view=True, bucket_cap_mb=DP_BUCKET_MB)
        self.step = 0
        self.ema_params: Optional[list] = None
        self.init_state()

    # ------------------------------------------------------------------ #
    # state                                                              #
    # ------------------------------------------------------------------ #

    def init_state(self) -> None:
        """Fresh optimizer moments, EMA = a copy of the parameters, step 0."""
        self.optimizer.reset()
        self.step = 0
        self.ema_params = (
            [p.detach().clone() for p in self.optimizer.params]
            if self.ema_decay is not None
            else None
        )

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.optimizer.params)

    @property
    def is_lead(self) -> bool:
        """Mesh rank 0 (or no mesh): the rank that logs and writes."""
        return self.mesh is None or self.mesh.rank == 0

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the EMA parameters in place of the
        trained ones, for ``model.load_state_dict`` (e.g. of the model a
        :class:`~dquartic_tpu_torch.infer.DDIMSampler` runs); under tp, the
        rank's shards, for a model split alike."""
        if self.ema_params is None:
            raise ValueError("this trainer keeps no EMA (ema_decay=None)")
        return {**self.model.state_dict(), **self._ema_by_name()}

    def _ema_by_name(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema_params is None:
            return None
        return dict(zip(self.param_names, self.ema_params))

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------ #
    # step                                                               #
    # ------------------------------------------------------------------ #

    def train_step(
        self,
        batch: Dict[str, Any],
        lr: float,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a pair batch (``ms2_1``, ``ms1_1``,
        ``ms2_2``; under dp, the rank's rows). The timesteps and noise are
        the injected ``t`` (B,) and ``eps`` (N(0, 1), B rows like
        ``ms2_1``), or are drawn from ``generator``; B is the global batch,
        the rank's rows times dp. Returns device scalars ``loss`` and
        ``grad_norm`` (before clipping), both global."""
        with profiling.request("train_step"):
            with profiling.span("train_step.batch"):
                b = self._device_batch(batch)
                w0, w1 = self.mixture_weights
                ms2_cond = w0 * b["ms2_1"] + w1 * b["ms2_2"]
                t, eps = self._draws(b["ms2_1"], generator, t, eps)
            self.optimizer.zero_grad()
            with profiling.span("train_step.forward"):
                loss, _ = self.process.train_loss(
                    self._denoise, b["ms2_1"], ms2_cond, b["ms1_1"], t=t, eps=eps
                )
            with profiling.span("train_step.backward"):
                loss.backward()
                if self.sp_group is not None:  # each rank holds its partial gradients
                    for p in self.optimizer.params:
                        if p.grad is not None:
                            sp_all_reduce(p.grad, self.sp_group)
                loss = loss.detach()
                if self.mesh is not None and self.mesh.dp > 1:  # the mean over the replicas' rows
                    loss = sp_all_reduce(loss.clone(), self.mesh.dp_group).div_(self.mesh.dp)
            with profiling.span("train_step.optimizer"):
                grad_norm = self.optimizer.step(lr)
            if self.ema_params is not None:
                with profiling.span("train_step.ema"):
                    d = self.ema_decay
                    params = [p.detach() for p in self.optimizer.params]
                    torch._foreach_mul_(self.ema_params, d)
                    torch._foreach_add_(self.ema_params, params, alpha=1.0 - d)
            self.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def _draws(self, x: torch.Tensor, generator, t, eps):
        """The step's timesteps and noise for the global batch (the rank's
        rows times dp), injected or drawn from ``generator`` in that order,
        then this rank's rows of them."""
        dp = 1 if self.mesh is None else self.mesh.dp
        rows = x.shape[0] * dp
        if t is None:
            t = torch.randint(0, self.process.schedule.num_timesteps, (rows,),
                              generator=generator, device=x.device)
        if eps is None:
            eps = torch.randn((rows, *x.shape[1:]), generator=generator, dtype=x.dtype,
                              device=x.device)
        if dp == 1:
            return t, eps
        if t.shape[0] != rows or eps.shape[0] != rows:
            raise ValueError(f"under dp={dp} the injected t and eps hold the global batch's "
                             f"{rows} rows (got {t.shape[0]} and {eps.shape[0]})")
        r = row_range(rows, self.mesh)
        return t[r.start:r.stop], eps[r.start:r.stop]

    # ------------------------------------------------------------------ #
    # loop                                                               #
    # ------------------------------------------------------------------ #

    def train(
        self,
        dataset: Iterable,
        epochs: int,
        warmup_epochs: int = 5,
        learning_rate: float = 1e-4,
        checkpoint_path: str = "best_model.ckpt",
        log_every_n_epochs: int = 100,
        checkpoint_every_n_epochs: int = 1,
        best_every_n_epochs: int = 1,
        prediction_hook: Optional[Callable[[int, float, "Trainer"], None]] = None,
    ) -> "Trainer":
        """Run the training loop with the JAX package's epoch semantics.

        ``dataset`` is any iterable of pair batches, optionally with
        ``reset_epoch()``. The draws of epoch e come from a generator
        seeded with (seed, e), so a resumed run draws what an
        uninterrupted one would. ``best_every_n_epochs`` is the minimum
        gap between best-model writes; a pending best is flushed at the
        last epoch."""
        if warmup_epochs > 0:
            lr_of_epoch = WarmupCosineSchedule.clamped(learning_rate, warmup_epochs, epochs)
        else:
            lr_of_epoch = lambda e: learning_rate  # noqa: E731

        if self._async is not None:
            meta, tensors, start_epoch, best_loss, resumed = self._async.restore_or_init(
                checkpoint_path, self._shard_layout(), optional=("ema/",))
            latest = self._async.latest_path_for(checkpoint_path)
        else:
            # a split model cuts its shards from the whole state on the host
            where = "cpu" if any(self._splits) else self.device
            ckpt, start_epoch, best_loss, resumed = restore_or_init(checkpoint_path, where)
            latest = latest_path_for(checkpoint_path)
        if resumed:
            # the stored epoch is the last completed one: continue after it
            start_epoch += 1
            if self._async is not None:
                self._load_shards(meta, tensors)
            else:
                self._load(ckpt)

        if self._async is not None:  # the pinned host buffers, before the loop
            self._async.prepare(self._shard_prototypes())
        best_epoch = start_epoch
        best_pending = False
        generator = torch.Generator(device=self.device)
        for epoch in range(start_epoch, epochs):
            if hasattr(dataset, "reset_epoch"):
                dataset.reset_epoch()
            lr = float(np.float32(lr_of_epoch(epoch)))
            generator.manual_seed(self.seed * 1_000_003 + epoch)

            t0 = time.time()
            losses = []
            for batch_idx, batch in enumerate(dataset):
                metrics = self.train_step(batch, lr, generator=generator)
                losses.append(metrics["loss"])
                if self.sync_every_batch:
                    val = float(metrics["loss"])
                    self.callback_handler.batch_callback(batch_idx, val)
                    if self.logger is not None:
                        epoch_len = len(dataset) if hasattr(dataset, "__len__") else len(losses)
                        self.logger.log(
                            {"batch/train_loss": val, "batch": batch_idx + epoch * epoch_len}
                        )

            # one host sync per epoch
            losses = torch.stack(losses).tolist() if losses else []
            if not self.sync_every_batch:
                for i, val in enumerate(losses):
                    self.callback_handler.batch_callback(i, val)
            avg_loss = float(np.mean(losses)) if losses else float("nan")
            dt = time.time() - t0
            if self.logger is not None:
                self.logger.log({
                    "epoch": epoch, "train/loss": avg_loss, "learning_rate": lr,
                    "epoch_seconds": dt, "steps_per_second": len(losses) / dt if dt > 0 else 0.0,
                })
            if self.is_lead:
                print(f"[Training] Epoch={epoch + 1}, lr={lr}, loss={avg_loss}")

            saved = False
            if (epoch + 1) % checkpoint_every_n_epochs == 0 or epoch == epochs - 1:
                self._save(latest, epoch, avg_loss)
                saved = True
            if avg_loss < best_loss:
                best_loss = avg_loss
                best_epoch = epoch + 1
                best_pending = True
            if best_pending and ((epoch + 1) % best_every_n_epochs == 0 or epoch == epochs - 1):
                self._save(checkpoint_path, epoch, best_loss, again=saved)
                best_pending = False

            if prediction_hook is not None and (epoch == 0 or epoch % log_every_n_epochs == 0):
                prediction_hook(best_epoch, best_loss, self)

            if not self.callback_handler.epoch_callback(epoch=epoch, epoch_loss=avg_loss):
                print(f"Training stopped at epoch {epoch}")
                break

        if self._async is not None:
            self._async.wait()  # the last async save written before returning
        if self.is_lead:
            print(f"Best model checkpoint saved at epoch {best_epoch} with loss: {best_loss:.6f}")
        return self

    def _save(self, path: str, epoch: int, loss: float, again: bool = False) -> None:
        """Write the train state to ``path``: the msgpack backend's file
        from mesh rank 0, or the async backend's shards from every rank of
        the first replica (``again``: the state of the save just before,
        whose snapshot is reused)."""
        if self._async is not None:
            opt, _ = self.optimizer.named_state(self.param_names)
            header = {"epoch": epoch, "best_loss": loss, "step": self.step,
                      "optimizer": opt["kind"], "count": opt["count"]}
            self._async.save(path, header, None if again else self._shard_leaves())
            return
        payload = self.checkpoint_payload(epoch, loss)
        if payload is not None:
            save_checkpoint(path, payload)

    # the async backend's keys: "params/<state_dict name>", "ema/<name>",
    # "opt/<moment>/<name>"; each leaf this rank's tensor as it is

    def _shard_leaves(self):
        """``{key: (tensor, split axis or None)}`` of this rank's train
        state, its shards under tp, with no gather."""
        specs = leaf_specs(self.model)
        leaves = {f"params/{n}": (t, specs[n][1] if n in specs else None)
                  for n, t in self.model.state_dict().items()}
        axes = [None if s is None else s[1] for s in self._splits]
        if self.ema_params is not None:
            leaves.update({f"ema/{n}": (e, a)
                           for n, e, a in zip(self.param_names, self.ema_params, axes)})
        _, moments = self.optimizer.named_state(self.param_names)
        leaves.update({f"opt/{k}": v for k, v in moments.items()})
        return leaves

    def _shard_layout(self):
        """``{key: (this rank's shape, split axis or None)}`` of the leaves
        a resume reads."""
        layout = {k: (tuple(t.shape), a) for k, (t, a) in self._shard_leaves().items()
                  if not k.startswith("opt/")}
        layout.update({f"opt/{k}": v
                       for k, v in self.optimizer.state_layout(self.param_names).items()})
        return layout

    def _shard_prototypes(self):
        """:meth:`_shard_leaves` with each optimizer moment that its first
        step makes (AdamW's) stood for by its parameter, whose shape and
        dtype it takes."""
        leaves = self._shard_leaves()
        params = dict(zip(self.param_names, self.optimizer.params))
        for key, (_, axis) in self._shard_layout().items():
            if key not in leaves:  # "opt/<moment>/<name>"
                leaves[key] = (params[key.split("/", 2)[2]], axis)
        return leaves

    def _load_shards(self, meta: Dict[str, Any], tensors: Dict[str, torch.Tensor]) -> None:
        """Load this rank's shards of an async checkpoint (as
        :meth:`_load` loads a whole one)."""
        kind = self.optimizer.kind
        if meta["optimizer"] != kind:
            raise ValueError(f"optimizer state of kind {meta['optimizer']!r} cannot load into "
                             f"the {kind!r} optimizer (tpu.optimizer)")
        params = {k[len("params/"):]: t for k, t in tensors.items() if k.startswith("params/")}
        self.model.load_state_dict(params)
        named: Dict[str, Any] = {"kind": kind, "count": meta["count"]}
        for k, t in tensors.items():
            if k.startswith("opt/"):
                moment, name = k[len("opt/"):].split("/", 1)
                named.setdefault(moment, {})[name] = t
        self.optimizer.load_state_dict(named, self.param_names, sharded=True)
        self.step = int(meta["step"])
        if self.ema_params is not None and f"ema/{self.param_names[0]}" in tensors:
            torch._foreach_copy_(self.ema_params,
                                 [tensors[f"ema/{n}"] for n in self.param_names])

    def checkpoint_payload(self, epoch: int, loss: float) -> Optional[Dict[str, Any]]:
        """The checkpoint of the train state on mesh rank 0, None on the
        others. Every replica holds the same state, so only the tp group of
        rank 0 takes part: it gathers each split leaf, its optimizer state
        and its EMA whole onto the host, one leaf at a time."""
        m = self.mesh
        if m is not None and (m.dp_rank or m.sp_rank or (m.tp == 1 and m.rank)):
            return None
        ema = self._ema_by_name()
        if any(self._splits):
            params = full_state_dict(self.model, "cpu")
            opt = self.optimizer.state_dict(whole="cpu")
            if ema is not None:
                ema = {n: (e if s is None else gather(e, s[0].group, s[1])).cpu()
                       for (n, e), s in zip(ema.items(), self._splits)}
        else:
            params, opt = self.model.state_dict(), self.optimizer.state_dict()
        if not self.is_lead:
            return None
        return {"epoch": epoch, "best_loss": loss, "step": self.step, "params": params,
                "opt_state": opt, "ema_params": ema}

    def _load(self, ckpt: Dict[str, Any]) -> None:
        """Load a checkpoint's train state: the port's own, whose EMA is
        keyed by name (a positional list in earlier files), or a JAX one as
        :func:`~dquartic_tpu_torch.train.checkpoint.load_checkpoint` maps it
        (the optimizer state keyed by name). Its leaves are whole; under tp
        each rank keeps its shards."""
        self.model.load_state_dict(shard_state_dict(self.model, ckpt["params"]))
        if ckpt.get("opt_state") is None:
            raise ValueError("the checkpoint holds no optimizer state to resume from "
                             "(a converted reference checkpoint holds weights only)")
        self.optimizer.load_state_dict(ckpt["opt_state"], self.param_names)
        self.step = int(ckpt["step"])
        ema = ckpt.get("ema_params")
        if self.ema_params is not None and ema is not None:
            if isinstance(ema, dict):
                ema = [ema[n] for n in self.param_names]
            ema = [e if s is None else own(e, s[0], s[1]) for e, s in zip(ema, self._splits)]
            torch._foreach_copy_(self.ema_params, list(ema))
