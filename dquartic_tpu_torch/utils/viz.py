"""Prediction panels and the periodic prediction-logging hook (port of
:mod:`dquartic_tpu.utils.viz`).

The renderers (``_axis_extent``, ``_peakmap``, ``_peakmap_plotly``,
``_peakmap_ms``, ``_chromatogram``, ``plot_single_prediction``) are host
numpy code copied from the JAX package's file, names, file names, backends
and all: matplotlib (imported when a panel is drawn) writes PNG files, and
the ``plotly``/``ms_plotly`` backends write HTML where plotly is installed
and the matplotlib panels where it is not, as in the JAX file. The
``ms_*`` backends draw the reference's pyopenms_viz-style 3-D spike
peakmaps natively; the dataset's real RT/m-z axes are used where it
carries them.

:class:`PredictionLoggingHook` is the trainer's ``prediction_hook``: every
N epochs it deconvolves one window at several step counts with the
trainer's EMA weights and logs the six panels and the reconstruction
cosine (reference model_interface.py:669-976).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


def _axis_extent(arr_2d, rt_axis, mz_axis):
    """(extent, xlabel, ylabel) for an (rt, mz) panel."""
    n_rt, n_mz = np.asarray(arr_2d).shape
    if (
        rt_axis is not None
        and mz_axis is not None
        and len(rt_axis) == n_rt
        and len(mz_axis) == n_mz
    ):
        return (
            [float(rt_axis[0]), float(rt_axis[-1]), float(mz_axis[0]), float(mz_axis[-1])],
            "Retention Time (s)",
            "m/z",
        )
    return [0, n_rt, 0, n_mz], "RT Index", "m/z Index"


def _peakmap(
    arr: np.ndarray,
    title: str,
    path: str,
    rt_axis: Optional[np.ndarray] = None,
    mz_axis: Optional[np.ndarray] = None,
    backend: str = "matplotlib",
) -> str:
    extent, xlabel, ylabel = _axis_extent(arr, rt_axis, mz_axis)
    if backend in ("ms_matplotlib", "ms_plotly"):
        return _peakmap_ms(arr, title, path, rt_axis, mz_axis, backend=backend)
    if backend == "plotly":
        return _peakmap_plotly(arr, title, path, rt_axis, mz_axis, xlabel, ylabel)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    im = ax.imshow(
        np.asarray(arr).T,
        aspect="auto",
        origin="lower",
        interpolation="nearest",
        cmap="viridis",
        extent=extent,
    )
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="intensity")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def _peakmap_plotly(arr, title, path, rt_axis, mz_axis, xlabel, ylabel) -> str:
    """Plotly heatmap panel (reference backend="ms_plotly" parity,
    model_interface.py:805). Falls back to matplotlib when plotly is not
    installed. Writes HTML (interactive) since static plotly export needs
    kaleido."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return _peakmap(arr, title, path, rt_axis, mz_axis, backend="matplotlib")

    a = np.asarray(arr)
    x = rt_axis if rt_axis is not None and len(rt_axis) == a.shape[0] else np.arange(a.shape[0])
    y = mz_axis if mz_axis is not None and len(mz_axis) == a.shape[1] else np.arange(a.shape[1])
    fig = go.Figure(data=go.Heatmap(z=a.T, x=np.asarray(x), y=np.asarray(y), colorscale="Viridis"))
    fig.update_layout(title=title, xaxis_title=xlabel, yaxis_title=ylabel, width=800, height=500)
    html_path = os.path.splitext(path)[0] + ".html"
    fig.write_html(html_path, include_plotlyjs="cdn")
    return html_path


def _peakmap_ms(
    arr: np.ndarray,
    title: str,
    path: str,
    rt_axis: Optional[np.ndarray] = None,
    mz_axis: Optional[np.ndarray] = None,
    backend: str = "ms_matplotlib",
    plot_3d: bool = True,
    max_points: int = 4000,
) -> str:
    """pyopenms_viz-style peakmap, reimplemented natively.

    The reference's plot_single_prediction melts the dense (rt, mz) mesh
    into (x=index, y=index, intensity) points and hands them to
    pyopenms_viz ``kind="peakmap"`` with ``plot_3d=True`` and
    backend "ms_matplotlib"/"ms_plotly"
    (reference model_interface.py:796-976, 1153-1173).
    pyopenms_viz renders that as 3-D intensity spikes colored by
    intensity. Here the same mesh-melt happens in numpy, the
    ``max_points`` most intense points are kept (a dense 34x40000 mesh is
    unplottable as spikes — pyopenms_viz inputs are sparse peak lists),
    and the spikes render on a matplotlib 3-D axis or a plotly Scatter3d;
    physical RT/m-z axes are used when available, index axes otherwise
    (the reference always uses index axes here)."""
    a = np.asarray(arr, dtype=np.float64)
    n_rt, n_mz = a.shape
    rt_vals = (
        np.asarray(rt_axis, dtype=np.float64)
        if rt_axis is not None and len(rt_axis) == n_rt
        else np.arange(n_rt, dtype=np.float64)
    )
    mz_vals = (
        np.asarray(mz_axis, dtype=np.float64)
        if mz_axis is not None and len(mz_axis) == n_mz
        else np.arange(n_mz, dtype=np.float64)
    )
    xlabel = "Retention Time (s)" if rt_axis is not None and len(rt_axis) == n_rt else "RT Index"
    ylabel = "m/z" if mz_axis is not None and len(mz_axis) == n_mz else "m/z Index"

    # mesh melt (reference _ms2_mesh_to_df) + top-k sparsification
    flat = a.ravel()
    k = min(max_points, flat.size)
    idx = np.argpartition(flat, flat.size - k)[flat.size - k:]
    idx = idx[np.argsort(flat[idx])[::-1]]
    ri, mi = np.unravel_index(idx, a.shape)
    x = rt_vals[ri]
    y = mz_vals[mi]
    z = flat[idx]

    if backend == "ms_plotly":
        try:
            import plotly.graph_objects as go
        except ImportError:
            backend = "ms_matplotlib"
        else:
            if plot_3d:
                # spikes: each peak is a (x, y, 0) -> (x, y, z) segment;
                # None-separated coordinates draw all segments in ONE trace
                xs = np.repeat(x, 3).astype(object)
                ys = np.repeat(y, 3).astype(object)
                zs = np.empty(3 * len(z), dtype=object)
                zs[0::3] = 0.0
                zs[1::3] = z
                xs[2::3] = None
                ys[2::3] = None
                zs[2::3] = None
                fig = go.Figure(
                    data=go.Scatter3d(
                        x=xs, y=ys, z=zs, mode="lines",
                        line=dict(color=np.repeat(z, 3), colorscale="Viridis", width=2),
                    )
                )
                fig.update_layout(
                    title=title, width=800, height=500,
                    scene=dict(
                        xaxis_title=xlabel, yaxis_title=ylabel, zaxis_title="intensity"
                    ),
                )
            else:
                fig = go.Figure(
                    data=go.Scatter(
                        x=x, y=y, mode="markers",
                        marker=dict(color=z, colorscale="Viridis", size=4),
                    )
                )
                fig.update_layout(
                    title=title, xaxis_title=xlabel, yaxis_title=ylabel,
                    width=800, height=500,
                )
            html_path = os.path.splitext(path)[0] + ".html"
            fig.write_html(html_path, include_plotlyjs="cdn")
            return html_path

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if plot_3d:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        fig = plt.figure(figsize=(8, 5))
        ax = fig.add_subplot(projection="3d")
        segs = np.zeros((len(z), 2, 3))
        segs[:, 0, 0] = segs[:, 1, 0] = x
        segs[:, 0, 1] = segs[:, 1, 1] = y
        segs[:, 1, 2] = z
        lc = Line3DCollection(segs, cmap="viridis", linewidths=0.8)
        lc.set_array(z)
        ax.add_collection3d(lc)
        ax.set_xlim(rt_vals.min(), max(rt_vals.max(), rt_vals.min() + 1e-9))
        ax.set_ylim(mz_vals.min(), max(mz_vals.max(), mz_vals.min() + 1e-9))
        zmax = float(z.max()) if len(z) else 1.0
        ax.set_zlim(min(0.0, float(z.min()) if len(z) else 0.0), zmax if zmax > 0 else 1.0)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_zlabel("intensity")
        ax.set_title(title)
        fig.colorbar(lc, ax=ax, label="intensity", shrink=0.6)
    else:
        fig, ax = plt.subplots(figsize=(8, 5))
        sc = ax.scatter(x, y, c=z, cmap="viridis", s=6)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        fig.colorbar(sc, ax=ax, label="intensity")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def _chromatogram(
    arr: np.ndarray,
    title: str,
    path: str,
    rt_axis: Optional[np.ndarray] = None,
    backend: str = "matplotlib",
) -> str:
    arr = np.asarray(arr)
    if rt_axis is not None and len(rt_axis) == len(arr):
        x, xlabel = np.asarray(rt_axis), "Retention Time (s)"
    else:
        x, xlabel = np.arange(len(arr)), "RT Index"
    # pyopenms_viz chromatograms are plain 1-D intensity lines; the ms_*
    # backends route to the matching native renderer
    if backend == "ms_plotly":
        backend = "plotly"
    elif backend == "ms_matplotlib":
        backend = "matplotlib"
    if backend == "plotly":
        try:
            import plotly.graph_objects as go

            fig = go.Figure(data=go.Scatter(x=x, y=arr, mode="lines"))
            fig.update_layout(
                title=title, xaxis_title=xlabel, yaxis_title="Intensity", width=800, height=300
            )
            html_path = os.path.splitext(path)[0] + ".html"
            fig.write_html(html_path, include_plotlyjs="cdn")
            return html_path
        except ImportError:
            pass
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(x, arr)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Intensity")
    ax.set_title(title)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_single_prediction(
    x_0: np.ndarray,
    x_noise: np.ndarray,
    ms2_cond: np.ndarray,
    ms1_cond: np.ndarray,
    pred: np.ndarray,
    pred_noise: np.ndarray,
    out_dir: str = ".",
    prefix: str = "",
    rt_axis: Optional[np.ndarray] = None,
    mz_axis: Optional[np.ndarray] = None,
    backend: str = "matplotlib",
) -> List[str]:
    """Render the six reference panels (model_interface.py:796-976);
    returns file paths. ``rt_axis``/``mz_axis`` switch the panels to
    physical axes; ``backend`` in {"matplotlib", "plotly",
    "ms_matplotlib", "ms_plotly"} — the ``ms_*`` values reproduce the
    reference's pyopenms_viz 3-D peakmap styling natively."""
    os.makedirs(out_dir, exist_ok=True)
    p = lambda name: os.path.join(out_dir, f"{prefix}{name}.png")  # noqa: E731
    pm = lambda arr, title, name: _peakmap(  # noqa: E731
        arr, title, p(name), rt_axis=rt_axis, mz_axis=mz_axis, backend=backend
    )
    paths = [
        pm(x_0, "Target MS2", "ms2_target"),
        (
            _chromatogram(ms1_cond, "Query MS1", p("ms1"), rt_axis=rt_axis, backend=backend)
            if np.asarray(ms1_cond).ndim == 1
            else pm(ms1_cond, "Query MS1", "ms1")
        ),
        pm(x_noise, "Noise MS2", "ms2_noise"),
        pm(ms2_cond, "Noised MS2 Input", "ms2_input"),
        pm(pred_noise, "Predicted Noise MS2", "pred_noise"),
        pm(pred, "Predicted MS2", "pred"),
    ]
    return paths


def noise_seed(seed: int, epoch: int, num_steps: int) -> int:
    """The seed of the hook's noise for one epoch and step count: ``seed``
    and ``epoch * 10000 + num_steps``, the JAX hook's
    ``fold_in(PRNGKey(seed), epoch * 10000 + num_steps)``."""
    return seed * 1_000_003 + epoch * 10000 + num_steps


class PredictionLoggingHook:
    """Trainer ``prediction_hook``: sample one window at several step
    counts and log panel paths + reconstruction metrics
    (model_interface.py:669-794). Uses the dataset's real RT/m-z axes
    when available.

    :meth:`Trainer.train <dquartic_tpu_torch.train.trainer.Trainer.train>`
    calls it as ``hook(epoch, best_loss, trainer)``. The window is one
    ``dataset.sample_pair()`` (a :class:`~dquartic_tpu_torch.data.DIAMSDataset`),
    its mixture ``w0·ms2_1 + w1·ms2_2`` the condition. The sampler's model is
    the trainer's; it runs with the trainer's EMA weights (``use_ema`` and
    an EMA kept) through ``torch.func.functional_call``, which copies no
    weight, else with the trained ones, in eval mode. The parameters, the
    EMA, the optimizer state and the model's train/eval mode are as they
    were when the hook returns.

    The noise of each step count is drawn from a ``torch.Generator`` on the
    trainer's device seeded by :func:`noise_seed` (the JAX hook's
    ``fold_in``); the draws are torch's, not JAX's. The cosine of the
    prediction with the target is taken in float64.

    On a mesh every rank samples (the model's collectives need them all)
    and only the lead rank (``trainer.is_lead``) renders and logs."""

    def __init__(
        self,
        sampler,
        dataset,
        logger,
        out_dir: str = ".",
        num_steps: Sequence[int] = (100, 500, 1000),
        mixture_weights=(0.5, 0.5),
        use_ema: bool = True,
        seed: int = 0,
        backend: str = "matplotlib",
    ):
        self.sampler = sampler
        self.dataset = dataset
        self.logger = logger
        self.out_dir = out_dir
        self.num_steps = tuple(num_steps)
        self.mixture_weights = mixture_weights
        self.use_ema = use_ema
        self.seed = seed
        self.backend = backend

    def _axes_for_drawn_row(self):
        """Axes of the window actually plotted: slices carry per-row
        rt/m-z bounds, so the drawn row's axes (dataset.last_indices)
        are fetched after each sample_pair(); index axes otherwise."""
        idx = getattr(self.dataset, "last_indices", None)
        if idx is not None and hasattr(self.dataset, "axes_for"):
            axes = self.dataset.axes_for(idx[0])
            if axes is not None:
                return axes
        return None, None

    def __call__(self, epoch: int, best_loss: float, trainer) -> None:
        import torch

        params = (
            trainer.ema_state_dict()
            if self.use_ema and trainer.ema_params is not None
            else None
        )
        ms2_1, ms1_1, ms2_2, _ = self.dataset.sample_pair()
        rt_axis, mz_axis = self._axes_for_drawn_row()
        w0, w1 = self.mixture_weights
        ms2_cond = w0 * ms2_1 + w1 * ms2_2
        device = trainer.device
        ms1 = torch.as_tensor(ms1_1, device=device)[None]
        cond = torch.as_tensor(ms2_cond, device=device)[None]
        lead = trainer.is_lead
        generator = torch.Generator(device=device)
        model = self.sampler.model
        was_training = model.training
        model.eval()
        rows = []
        try:
            for ns in self.num_steps:
                generator.manual_seed(noise_seed(self.seed, epoch, ns))
                noise = torch.randn((1, *ms2_1.shape), generator=generator,
                                    dtype=torch.float32, device=device)
                pred, pred_noise = self.sampler.sample(noise, cond, ms1, num_steps=ns,
                                                       params=params)
                if not lead:
                    continue
                pred_np = pred[0].float().cpu().numpy()
                target = np.asarray(ms2_1, np.float64).ravel()
                p64 = pred_np.astype(np.float64).ravel()
                cos = float(
                    np.dot(p64, target)
                    / (np.linalg.norm(p64) * np.linalg.norm(target) + 1e-12)
                )
                paths = plot_single_prediction(
                    ms2_1,
                    ms2_2,
                    ms2_cond,
                    ms1_1,
                    pred_np,
                    pred_noise[0].float().cpu().numpy(),
                    out_dir=self.out_dir,
                    prefix=f"e{epoch}_s{ns}_",
                    rt_axis=rt_axis,
                    mz_axis=mz_axis,
                    backend=self.backend,
                )
                rows.append([ns, epoch, best_loss, cos] + paths)
                if self.logger is not None:
                    self.logger.log(
                        {f"predictions/cosine_{ns}steps": cos, "epoch": epoch}, commit=False
                    )
        finally:
            model.train(was_training)
        if lead and self.logger is not None:
            self.logger.log_table(
                "predictions_table",
                [
                    "Num Steps",
                    "Epoch",
                    "Loss",
                    "Reconstruction Cosine",
                    "Target MS2",
                    "Target MS1",
                    "Noise MS2",
                    "Simulated Noise MS2 Input",
                    "Predicted MS2 Noise",
                    "Predicted MS2",
                ],
                rows,
            )
