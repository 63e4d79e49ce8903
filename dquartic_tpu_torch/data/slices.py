"""Offline training-data generation: sqMass -> RT-windowed parquet slices.

A copy of :mod:`dquartic_tpu.data.slices`: the port imports nothing of the
JAX package, and the same input gives the same tables in both. It imports
pandas, pyarrow and scipy at load time, so nothing else in the port
imports it at load time.

Rebuild of the reference pipeline
(dquartic/utils/data_generation.py:229-387) with the same
output contract — one parquet file of flattened (rt x m/z) MS1/MS2 window
slices with the exact Arrow schema (data_generation.py:273-290) — but a
simpler, faster dense path:

  * The long-form signal is pivoted **once** into a CSR matrix indexed by
    the union RT grid (the reference re-joins a full RT x m/z cross
    product per batch, data_generation.py:39-89); extracting a window is
    then a contiguous row slice.
  * No chunked ThreadPoolExecutor over m/z (data_generation.py:134-176) —
    the single CSR build replaces it. ``num_chunks``/``threads`` are
    accepted for CLI parity and ignored.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
from scipy.sparse import csr_matrix

from .sqmass import SqMassLoader

SLICE_SCHEMA = pa.schema(
    [
        ("file", pa.string()),
        ("slice_index", pa.int64()),
        ("mz_isolation_target", pa.float64()),
        ("mz_start", pa.float64()),
        ("mz_end", pa.float64()),
        ("rt_start", pa.float64()),
        ("rt_end", pa.float64()),
        ("ms1_data", pa.list_(pa.float32())),
        ("ms2_data", pa.list_(pa.float32())),
        ("ms1_shape", pa.list_(pa.int64())),
        ("ms2_shape", pa.list_(pa.int64())),
        ("rt_values", pa.list_(pa.float32())),
        ("mz_values_ms1", pa.list_(pa.float32())),
        ("mz_values_ms2", pa.list_(pa.float32())),
    ]
)


def sliding_windows(
    unique_sorted_rt: np.ndarray, window_size: int, sliding_step: int
) -> List[np.ndarray]:
    """Overlapping full-length RT windows (data_generation.py:261-271)."""
    windows = []
    n = len(unique_sorted_rt)
    for start in range(0, n, sliding_step):
        end = start + window_size
        if end <= n:
            windows.append(unique_sorted_rt[start:end])
    return windows


def densify_on_grid(df: pd.DataFrame, rt_grid: np.ndarray):
    """Pivot long-form signal onto (union-RT x unique-m/z) as CSR.

    Returns (csr_matrix, unique_mz). Intensities of duplicate
    (RT, m/z) cells are summed, like the reference's groupby-sum
    (data_generation.py:78).
    """
    unique_mz = np.sort(df["mz"].dropna().unique())
    rt_index = {rt: i for i, rt in enumerate(rt_grid)}
    mz_index = {mz: i for i, mz in enumerate(unique_mz)}

    rows = df["RETENTION_TIME"].map(rt_index).to_numpy()
    cols = df["mz"].map(mz_index).to_numpy()
    vals = df["intensity"].to_numpy()
    ok = ~(pd.isna(rows) | pd.isna(cols))
    mat = csr_matrix(
        (vals[ok], (rows[ok].astype(np.int64), cols[ok].astype(np.int64))),
        shape=(len(rt_grid), len(unique_mz)),
    )
    return mat, unique_mz


def generate_data_slices(
    input_file: str,
    output_file: str,
    isolation_window_index: int,
    window_size: int = 34,
    sliding_step: int = 5,
    mz_ppm_tol: int = 10,
    bin_mz: bool = True,
    ms1_fixed_mz_size: int = 150,
    ms2_fixed_mz_size: int = 30_000,
    batch_size: int = 500,
    batch_writing_size: int = 20,
    num_chunks: int = 3,
    threads: int = 3,
    loader: Optional[SqMassLoader] = None,
) -> int:
    """Generate window slices for one isolation window; returns the number
    of rows written. Signature mirrors the reference
    (data_generation.py:229-243) — ``num_chunks``/``threads`` are accepted
    for compatibility and unused (see module docstring)."""
    del num_chunks, threads

    if loader is None:
        loader = SqMassLoader(input_file)
        loader.load_all_data()

    rt_grid = np.unique(
        np.concatenate(
            [
                loader.ms1_data["RETENTION_TIME"].unique(),
                loader.ms2_data["RETENTION_TIME"].unique(),
            ]
        )
    )
    windows = sliding_windows(rt_grid, window_size, sliding_step)
    print(
        f"[{datetime.datetime.now().isoformat()}] Number of RT window slices: {len(windows)}"
    )

    current_iso = loader.iso_win_info.iloc[isolation_window_index]
    print(
        f"[{datetime.datetime.now().isoformat()}] {isolation_window_index} of "
        f"{len(loader.iso_win_info)} Processing isolation target "
        f"{current_iso['ISOLATION_TARGET']}"
    )

    ms1_tgt = loader.extract_ms1_slice(current_iso, mz_ppm_tol, bin_mz, ms1_fixed_mz_size)
    ms2_tgt = loader.extract_ms2_slice(current_iso, bin_mz, ms2_fixed_mz_size)

    ms1_mat, ms1_mz = densify_on_grid(ms1_tgt, rt_grid)
    ms2_mat, ms2_mz = densify_on_grid(ms2_tgt, rt_grid)

    rt_pos = {rt: i for i, rt in enumerate(rt_grid)}
    writer = pq.ParquetWriter(output_file, schema=SLICE_SCHEMA)
    rows_written = 0
    pending: List[dict] = []

    def flush():
        nonlocal pending, rows_written
        if pending:
            writer.write_table(pa.Table.from_pylist(pending, schema=SLICE_SCHEMA))
            rows_written += len(pending)
            pending = []

    try:
        for i, window in enumerate(windows):
            start = rt_pos[window[0]]
            end = rt_pos[window[-1]]
            ms1_slice = ms1_mat[start : end + 1, :].toarray()
            ms2_slice = ms2_mat[start : end + 1, :].toarray()
            # empty-window skip (data_generation.py:127-130, 170-174)
            if ms1_slice.size == 0 or ms2_slice.size == 0:
                continue
            if ms1_slice.max() == 0 or ms2_slice.max() == 0:
                continue
            pending.append(
                {
                    "file": os.path.basename(input_file),
                    "slice_index": i,
                    "mz_isolation_target": float(current_iso["ISOLATION_TARGET"]),
                    "mz_start": float(current_iso["mzStart"]),
                    "mz_end": float(current_iso["mzEnd"]),
                    "rt_start": float(window[0]),
                    "rt_end": float(window[-1]),
                    "ms1_data": ms1_slice.flatten().astype(np.float32),
                    "ms2_data": ms2_slice.flatten().astype(np.float32),
                    "ms1_shape": list(ms1_slice.shape),
                    "ms2_shape": list(ms2_slice.shape),
                    "rt_values": np.asarray(window, dtype=np.float32),
                    "mz_values_ms1": np.asarray(ms1_mz, dtype=np.float32),
                    "mz_values_ms2": np.asarray(ms2_mz, dtype=np.float32),
                }
            )
            if len(pending) >= batch_size * batch_writing_size:
                print(f"[{datetime.datetime.now().isoformat()}] Writing out batch of data...")
                flush()
        flush()
    finally:
        writer.close()
    return rows_written
