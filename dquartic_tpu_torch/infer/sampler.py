"""Batched DDIM inference on a torch denoiser.

Port of :class:`dquartic_tpu.infer.sampler.DDIMSampler` (``sample``,
``predict_batch``, ``predict``) and of the prediction parquet files
(``save_predictions_parquet``, ``load_predictions_parquet``; pyarrow is
imported inside them). The model holds its own weights, so no parameter
tree is passed (``sample`` takes other tensors by name, e.g. a Trainer's
EMA, without copying the model); noise comes from an explicit
:class:`torch.Generator`.
Everything runs under ``torch.inference_mode``.

On a ``mesh`` every rank calls the same methods with the same seed:

* ``dp``: each rank's batches hold its own rows (as
  ``build_dataset(mesh=...)`` yields them). ``predict_batch`` draws the
  noise x_T for the whole global batch (the rank's rows times dp) and keeps
  the rank's rows, and ``predict`` gathers every record's arrays over the
  replicas, so its records are those of one process on the global batch;
* ``sp``: each rank computes its slice of m/z and the model returns the
  whole prediction (``activation_sharding``);
* ``tp``: the model's wide leaves are split over the ``tp`` group, as
  ``build_model(mesh=...)`` splits them (an unsplit model raises), and
  the model returns the whole prediction on every rank.

The DDIM steps are per element, so every rank of a replica gets the
unsharded result for that seed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.diffusion import DDIMProcess
from ..parallel.distributed import row_range
from ..parallel.tensor import gather
from ..utils import profiling
from ..utils.device import resolve_device


def with_params(model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]] = None):
    """``model`` as a denoiser that runs on ``params`` (tensors by
    state_dict name, e.g. a Trainer's ``ema_state_dict()``) in place of its
    own, through ``torch.func.functional_call``: nothing is copied and the
    model's own tensors are left as they are. ``params`` None: the model."""
    if params is None:
        return model

    def denoise(*args):
        return torch.func.functional_call(model, params, args)

    return denoise


class DDIMSampler:
    def __init__(self, model: torch.nn.Module, process: DDIMProcess, mesh=None):
        self.model = model
        self.process = process
        self.mesh = mesh
        if mesh is not None and mesh.sp > 1:
            if getattr(model, "activation_sharding", None) is None:
                raise ValueError(
                    f"a mesh with sp={mesh.sp} needs a model whose activation_sharding splits "
                    "m/z over it (build_model sets it from the mesh)")
            model.mesh = mesh
        if mesh is not None and mesh.tp > 1 and getattr(model, "tp_min_features", None) is None:
            raise ValueError(
                f"a mesh with tp={mesh.tp} needs a model whose wide leaves are split over it "
                "(build_model splits them from the mesh)")

    @property
    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    @torch.inference_mode()
    def sample(
        self,
        x_t: torch.Tensor,
        ms2_cond: Optional[torch.Tensor] = None,
        ms1_cond: Optional[torch.Tensor] = None,
        num_steps: int = 1000,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reverse-diffuse ``x_t`` into a clean MS2 map; returns
        ``(x0_hat, pred_noise)``, with the model's own weights or with
        ``params`` (:func:`with_params`)."""
        return self.process.sample(with_params(self.model, params), x_t, ms2_cond, ms1_cond,
                                   num_steps=num_steps)

    def predict_batch(
        self,
        generator: torch.Generator,
        ms2_cond: torch.Tensor,
        ms1_cond: Optional[torch.Tensor],
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Start from N(0, I) noise drawn from ``generator`` (which must
        live on ``ms2_cond``'s device); under dp, drawn for the global batch
        and cut to this rank's rows."""
        rows = ms2_cond.shape[0] * self._dp
        x_t = torch.randn((rows, *ms2_cond.shape[1:]), generator=generator,
                          dtype=torch.float32, device=ms2_cond.device)
        r = row_range(rows, self.mesh)
        return self.sample(x_t[r.start:r.stop], ms2_cond, ms1_cond, num_steps)

    def predict(
        self,
        dataset: Iterable,
        mixture_weights: Tuple[float, float] = (0.5, 0.5),
        num_steps: int = 1000,
        seed: int = 0,
        device=None,
    ) -> List[Dict[str, np.ndarray]]:
        """Deconvolve each pair batch (``ms2_1``, ``ms1_1``, ``ms2_2``; numpy
        arrays or tensors, e.g. from :func:`~dquartic_tpu_torch.utils.builder.build_dataset`):
        the mixture ``w0·ms2_1 + w1·ms2_2`` is the condition. Each record
        holds the target, its MS1, the mixture, the prediction and the
        removed signal, as numpy arrays. ``device=None`` is the card (raises
        without one). Under dp each batch holds the rank's rows, and every
        rank returns the records of the global batches (gathered over the
        replicas)."""
        device = resolve_device(device, "DDIMSampler.predict")
        generator = torch.Generator(device=device).manual_seed(seed)
        out: List[Dict[str, np.ndarray]] = []
        for batch in dataset:
            with profiling.request("predict"):
                with profiling.span("predict.to_device"):
                    ms2_1, ms1_1, ms2_2 = (torch.as_tensor(batch[k], device=device)
                                           for k in ("ms2_1", "ms1_1", "ms2_2"))
                ms2_cond = mixture_weights[0] * ms2_1 + mixture_weights[1] * ms2_2
                pred, pred_noise = self.predict_batch(generator, ms2_cond, ms1_1, num_steps)
                rec = {"ms2_1": ms2_1, "ms1_1": ms1_1, "mixture": ms2_cond,
                       "pred": pred.float(), "pred_noise": pred_noise.float()}
                if self._dp > 1:  # the replicas' rows, in rank order
                    rec = {k: gather(v.contiguous(), self.mesh.dp_group, 0)
                           for k, v in rec.items()}
                with profiling.span("predict.to_host"):
                    out.append({k: v.cpu().numpy() for k, v in rec.items()})
        return out


PREDICTION_SCHEMA_FIELDS = (
    ("ms2_1", "ms2_shape"),
    ("ms1_1", "ms1_shape"),
    ("mixture", "ms2_shape"),
    ("pred", "ms2_shape"),
    ("pred_noise", "ms2_shape"),
)


def save_predictions_parquet(records: List[Dict[str, np.ndarray]], path: str) -> None:
    """Write prediction records as one parquet row per batch: arrays
    flattened float32 with explicit shape columns, the conventions of the
    training-slice schema (the JAX package's file, column for column)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols: Dict[str, list] = {"batch_index": list(range(len(records)))}
    cols["ms2_shape"] = [list(np.asarray(r["ms2_1"]).shape) for r in records]
    cols["ms1_shape"] = [list(np.asarray(r["ms1_1"]).shape) for r in records]
    for name, _shape_col in PREDICTION_SCHEMA_FIELDS:
        cols[name] = [np.asarray(r[name], np.float32).ravel() for r in records]

    schema = pa.schema(
        [("batch_index", pa.int64()),
         ("ms2_shape", pa.list_(pa.int64())),
         ("ms1_shape", pa.list_(pa.int64()))]
        + [(name, pa.list_(pa.float32())) for name, _ in PREDICTION_SCHEMA_FIELDS]
    )
    pq.write_table(pa.Table.from_pydict(cols, schema=schema), path)


def load_predictions_parquet(path: str) -> List[Dict[str, np.ndarray]]:
    """Inverse of :func:`save_predictions_parquet`."""
    import pyarrow.parquet as pq

    tbl = pq.read_table(path)
    out: List[Dict[str, np.ndarray]] = []
    for i in range(tbl.num_rows):
        row = {c: tbl.column(c)[i].as_py() for c in tbl.column_names}
        out.append({name: np.asarray(row[name], np.float32).reshape(row[shape_col])
                    for name, shape_col in PREDICTION_SCHEMA_FIELDS})
    return out
