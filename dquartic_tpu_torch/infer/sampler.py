"""Batched DDIM inference on a torch denoiser.

Port of :class:`dquartic_tpu.infer.sampler.DDIMSampler` (``sample``,
``predict_batch``, ``predict``) and of the prediction parquet files
(``save_predictions_parquet``, ``load_predictions_parquet``; pyarrow is
imported inside them). The model holds its own weights, so no parameter
tree is passed; noise comes from an explicit :class:`torch.Generator`.
Everything runs under ``torch.inference_mode``.

With a ``mesh`` whose ``sp > 1`` every rank of the group calls the same
methods on the same data with the same seed: each draws the whole
window's noise alike, the model computes the rank's slice of m/z and
returns the whole prediction (``activation_sharding``), and the DDIM steps,
which are per element, run alike on every rank, so every rank gets the
unsharded result for that seed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.diffusion import DDIMProcess
from ..utils.device import resolve_device


class DDIMSampler:
    def __init__(self, model: torch.nn.Module, process: DDIMProcess, mesh=None):
        self.model = model
        self.process = process
        if mesh is not None and mesh.sp > 1:
            if getattr(model, "activation_sharding", None) is None:
                raise ValueError(
                    f"a mesh with sp={mesh.sp} needs a model whose activation_sharding splits "
                    "m/z over it (build_model sets it from the mesh)")
            model.mesh = mesh

    @torch.inference_mode()
    def sample(
        self,
        x_t: torch.Tensor,
        ms2_cond: Optional[torch.Tensor] = None,
        ms1_cond: Optional[torch.Tensor] = None,
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reverse-diffuse ``x_t`` into a clean MS2 map; returns
        ``(x0_hat, pred_noise)``."""
        return self.process.sample(self.model, x_t, ms2_cond, ms1_cond, num_steps=num_steps)

    def predict_batch(
        self,
        generator: torch.Generator,
        ms2_cond: torch.Tensor,
        ms1_cond: Optional[torch.Tensor],
        num_steps: int = 1000,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Start from N(0, I) noise drawn from ``generator`` (which must
        live on ``ms2_cond``'s device)."""
        x_t = torch.randn(
            ms2_cond.shape, generator=generator, dtype=torch.float32, device=ms2_cond.device
        )
        return self.sample(x_t, ms2_cond, ms1_cond, num_steps)

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
        without one)."""
        device = resolve_device(device, "DDIMSampler.predict")
        generator = torch.Generator(device=device).manual_seed(seed)
        out: List[Dict[str, np.ndarray]] = []
        for batch in dataset:
            ms2_1, ms1_1, ms2_2 = (torch.as_tensor(batch[k], device=device)
                                   for k in ("ms2_1", "ms1_1", "ms2_2"))
            ms2_cond = mixture_weights[0] * ms2_1 + mixture_weights[1] * ms2_2
            pred, pred_noise = self.predict_batch(generator, ms2_cond, ms1_1, num_steps)
            out.append(
                {
                    "ms2_1": ms2_1.cpu().numpy(),
                    "ms1_1": ms1_1.cpu().numpy(),
                    "mixture": ms2_cond.cpu().numpy(),
                    "pred": pred.float().cpu().numpy(),
                    "pred_noise": pred_noise.float().cpu().numpy(),
                }
            )
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
