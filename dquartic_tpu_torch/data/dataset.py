"""Paired DIA-MS dataset.

A copy of :mod:`dquartic_tpu.data.dataset`: the port imports nothing of the
JAX package, and the same seed gives the same arrays in both. pyarrow is imported
only inside :class:`_ParquetStore`, so NPY data loads without it.

Host-side replacement for the reference ``DIAMSDataset``
(dquartic/utils/data_loader.py:10-185) with the same two
backends and pair semantics, rebuilt to feed an accelerator:

  * **NPY backend** — memory-mapped MS2 ``(N, rt, mz)`` / MS1 ``(N, rt)``
    arrays (data_loader.py:35-38).
  * **Parquet backend** — sequential row-group streaming through a
    shuffle buffer, decoded zero-copy from Arrow buffers (no per-row
    Python objects), replacing the reference's two DuckDB point queries
    per item (data_loader.py:161-185), which cannot feed an accelerator.
    ``streaming=False`` falls back to LRU-cached random row-group access.
  * **Pair sampling** — a random non-identical pair per draw, de-duplicated
    within an epoch (data_loader.py:111-159). Unlike the reference's
    process-global ``used_pairs`` set (racy across DataLoader workers,
    data_loader.py:48), sampling here is explicit-RNG and single-owner.
  * **Normalization** — per-pair min-max over the joint MS2 range; the MS1
    scale comes from the *first* split only, exactly like the reference
    (data_loader.py:71-79). ``normalize=None`` is identity (the reference
    raises, data_loader.py:80-81 — a bug, fixed here).

Batching and device transfer live in :class:`PairBatches` /
:mod:`dquartic_tpu_torch.data.pipeline`; mixing (the 0.5/0.5 synthetic
multiplexing) happens on the device inside the train step.
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Dict, Iterator, Literal, Optional, Tuple

import numpy as np


def _list_col_buffers(tbl, name: str, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-copy (values, offsets) numpy views of a parquet list column.

    Arrow list arrays are a flat value buffer plus int32 offsets; viewing
    both as numpy avoids the per-row Python-object materialization of
    ``to_pydict()`` (the reference's DuckDB point queries had the same
    per-row overhead, data_loader.py:161-185).
    """
    col = tbl.column(name)
    chunk = col.chunk(0) if col.num_chunks == 1 else col.combine_chunks()
    values = np.asarray(chunk.values)
    if values.dtype != dtype:
        values = values.astype(dtype)
    offsets = np.asarray(chunk.offsets)
    return values, offsets


class _ParquetStore:
    """Random access over a directory of slice parquet files.

    Maintains (file, row-group) offsets and an LRU cache of decoded row
    groups so that random pair access degrades to sequential row-group
    reads instead of full-directory scans. Row groups decode to flat
    numpy buffers (zero-copy from Arrow), never Python lists.
    """

    META_COLUMNS = [
        "slice_index",
        "mz_isolation_target",
        "mz_start",
        "mz_end",
        "rt_start",
        "rt_end",
    ]

    def __init__(self, directory: str, cache_groups: int = 8):
        import pyarrow.parquet as pq

        self._pq = pq
        self.files = sorted(glob.glob(os.path.join(directory, "*.parquet")))
        if not self.files:
            raise ValueError(f"No parquet files found in {directory!r}")
        self._handles = [pq.ParquetFile(f) for f in self.files]

        # (file_idx, rg_idx, start_row, num_rows) per row group, global order
        self.groups = []
        total = 0
        for fi, h in enumerate(self._handles):
            for gi in range(h.num_row_groups):
                n = h.metadata.row_group(gi).num_rows
                self.groups.append((fi, gi, total, n))
                total += n
        self.num_rows = total
        self._starts = np.array([g[2] for g in self.groups])

        self._cache: "OrderedDict[Tuple[int, int], dict]" = OrderedDict()
        self._cache_groups = cache_groups

        meta = [h.read(columns=self.META_COLUMNS) for h in self._handles]
        import pyarrow as pa

        meta_tbl = pa.concat_tables(meta)
        self.meta = {
            c: np.asarray(meta_tbl.column(c)) for c in self.META_COLUMNS
        }

    def _row_group(self, fi: int, gi: int) -> dict:
        key = (fi, gi)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        tbl = self._handles[fi].read_row_group(
            gi, columns=["ms1_data", "ms2_data", "ms1_shape", "ms2_shape"]
        )
        data = {
            name: _list_col_buffers(tbl, name, dtype)
            for name, dtype in (
                ("ms1_data", np.float32),
                ("ms2_data", np.float32),
                ("ms1_shape", np.int64),
                ("ms2_shape", np.int64),
            )
        }
        self._cache[key] = data
        if len(self._cache) > self._cache_groups:
            self._cache.popitem(last=False)
        return data

    @staticmethod
    def _row_from_decoded(data: dict, off: int) -> Tuple[np.ndarray, np.ndarray]:
        out = []
        for name, shape_name in (("ms1_data", "ms1_shape"), ("ms2_data", "ms2_shape")):
            vals, voff = data[name]
            svals, soff = data[shape_name]
            shape = svals[soff[off] : soff[off + 1]]
            out.append(vals[voff[off] : voff[off + 1]].reshape(shape))
        return out[0], out[1]

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (ms1, ms2) arrays for global row ``idx``."""
        g = int(np.searchsorted(self._starts, idx, side="right")) - 1
        fi, gi, start, _ = self.groups[g]
        data = self._row_group(fi, gi)
        return self._row_from_decoded(data, idx - start)

    def axes(self, idx: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Real (rt_values, mz_values_ms2) axes for global row ``idx``
        (SLICE_SCHEMA carries them per slice; the reference keeps them in
        its parquet schema too, data_generation.py:219-222, but never
        threads them to plots). Returns None if the files predate the
        axis columns."""
        g = int(np.searchsorted(self._starts, idx, side="right")) - 1
        fi, gi, start, _ = self.groups[g]
        h = self._handles[fi]
        names = {c.name for c in h.schema_arrow}
        if not {"rt_values", "mz_values_ms2"} <= names:
            return None
        tbl = h.read_row_group(gi, columns=["rt_values", "mz_values_ms2"])
        off = idx - start
        rt = np.asarray(tbl.column("rt_values")[off].values, dtype=np.float32)
        mz = np.asarray(tbl.column("mz_values_ms2")[off].values, dtype=np.float32)
        return rt, mz


class _ShuffleBufferStream:
    """Sequential row-group streaming with a shuffle buffer.

    Row groups are visited in a fresh random order each pass and decoded
    once (zero-copy); rows fill a reservoir from which pairs are drawn at
    random. Every draw replaces the two consumed slots with the next
    streamed rows, so disk access stays strictly sequential per row group
    while pair sampling stays well-mixed — the SURVEY §7 replacement for
    the reference's two random DuckDB point queries per item
    (data_loader.py:161-185).
    """

    def __init__(self, store: _ParquetStore, rng: np.random.Generator, buffer_size: int = 256):
        self.store = store
        self.rng = rng
        self.buffer_size = max(2, min(buffer_size, store.num_rows))
        self._rows = self._row_iter()
        # buffer entries: (global_idx, ms1, ms2)
        self.buffer = [next(self._rows) for _ in range(self.buffer_size)]

    def _row_iter(self):
        n_groups = len(self.store.groups)
        while True:
            for g in self.rng.permutation(n_groups):
                fi, gi, start, n = self.store.groups[int(g)]
                data = self.store._row_group(fi, gi)
                for off in self.rng.permutation(n):
                    off = int(off)
                    ms1, ms2 = self.store._row_from_decoded(data, off)
                    yield (start + off, ms1, ms2)

    def _advance(self, slot: int) -> None:
        self.buffer[slot] = next(self._rows)

    def draw_pair(self, used_pairs: set, max_tries: int = 10000):
        meta = self.store.meta
        for _ in range(max_tries):
            a = int(self.rng.integers(0, len(self.buffer)))
            b = int(self.rng.integers(0, len(self.buffer)))
            if a == b:
                continue
            ia, ib = self.buffer[a][0], self.buffer[b][0]
            if ia == ib:
                continue
            # same non-identity rule as the random-access path: distinct
            # (isolation target, slice index), reference data_loader.py:135-147
            if (
                meta["mz_isolation_target"][ia] == meta["mz_isolation_target"][ib]
                and meta["slice_index"][ia] == meta["slice_index"][ib]
            ):
                continue
            pair = (ia, ib) if ia < ib else (ib, ia)
            if pair in used_pairs:
                continue
            used_pairs.add(pair)
            ea, eb = self.buffer[a], self.buffer[b]
            self._advance(a)
            self._advance(b)
            return ea[1], ea[2], eb[1], eb[2], (ia, ib)
        raise RuntimeError(
            "Exhausted distinct pairs for this epoch; call reset_epoch()."
        )


class DIAMSDataset:
    """See module docstring. Constructor mirrors the reference
    (data_loader.py:33-49)."""

    def __init__(
        self,
        parquet_directory: Optional[str] = None,
        ms2_file: Optional[str] = None,
        ms1_file: Optional[str] = None,
        normalize: Literal[None, "minmax"] = "minmax",
        seed: int = 0,
        ms1_norm_from_first: bool = True,
        streaming: bool = True,
        shuffle_buffer: int = 256,
    ):
        self.stream: Optional[_ShuffleBufferStream] = None
        if parquet_directory is None and ms1_file is not None and ms2_file is not None:
            self.ms2_data = np.load(ms2_file, mmap_mode="r")
            self.ms1_data = np.load(ms1_file, mmap_mode="r")
            self.data_type = "npy"
            print(
                f"Info: Loaded {len(self.ms2_data)} MS2 slice samples and "
                f"{len(self.ms1_data)} MS1 slice samples from NPY files."
            )
        elif parquet_directory is not None and ms1_file is None and ms2_file is None:
            self.store = _ParquetStore(parquet_directory)
            self.data_type = "parquet"
            if streaming:
                self.stream = _ShuffleBufferStream(
                    self.store, np.random.default_rng(seed + 1), shuffle_buffer
                )
            print(
                f"Info: Loaded {self.store.num_rows} MS2/MS1 slice samples from Parquet files."
            )
        else:
            raise ValueError(
                "Invalid input data arguments. Please provide either a "
                "`parquet_directory` or `ms2_file` and `ms1_file`. Got "
                f"parquet_directory={parquet_directory}, ms2_file={ms2_file}, "
                f"ms1_file={ms1_file}."
            )

        if normalize not in (None, "minmax"):
            raise ValueError("Invalid normalization method. Valid options are: None, 'minmax'.")
        self.normalize = normalize
        self.ms1_norm_from_first = ms1_norm_from_first
        self.rng = np.random.default_rng(seed)
        self.used_pairs: set = set()
        self.epoch_reset = False
        # global row indices of the most recent sample_pair() draw, so
        # consumers (PredictionLoggingHook) can fetch the drawn rows'
        # physical axes via axes_for()
        self.last_indices: Optional[Tuple[int, int]] = None

    # -- reference-compatible surface ---------------------------------- #

    def __len__(self) -> int:
        if self.data_type == "parquet":
            return self.store.num_rows
        return len(self.ms2_data)

    def reset_epoch(self) -> None:
        """Clear the per-epoch pair de-duplication set (data_loader.py:90-93)."""
        self.used_pairs.clear()
        self.epoch_reset = True

    def __getitem__(self, idx: int):
        """Draw a random pair (``idx`` is ignored, like the reference,
        data_loader.py:57-68) and return
        (ms2_1, ms1_1, ms2_2, ms1_2) float32 arrays."""
        return self.sample_pair()

    def axes(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Real (RT seconds, m/z) axis values for plotting, when the
        backing store carries them (parquet slices do; NPY files don't)."""
        return self.axes_for(0)

    def axes_for(self, idx: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Per-row (RT seconds, m/z) axis values for global row ``idx``.
        Slices carry individual rt/m-z windows (SLICE_SCHEMA), so plots of
        a drawn pair must use that row's axes, not row 0's."""
        if self.data_type == "parquet":
            try:
                return self.store.axes(idx)
            except Exception:
                return None
        return None

    # -- sampling ------------------------------------------------------ #

    def _draw_indices(self) -> Tuple[int, int]:
        n = len(self)
        for _ in range(10 * n * n + 100):
            i = int(self.rng.integers(0, n))
            j = int(self.rng.integers(0, n))
            if i == j:
                continue
            if self.data_type == "parquet":
                m = self.store.meta
                if (
                    m["mz_isolation_target"][i] == m["mz_isolation_target"][j]
                    and m["slice_index"][i] == m["slice_index"][j]
                ):
                    continue
            pair = (i, j) if i < j else (j, i)
            if pair in self.used_pairs:
                continue
            self.used_pairs.add(pair)
            return i, j
        raise RuntimeError("Exhausted distinct pairs for this epoch; call reset_epoch().")

    def _fetch(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.data_type == "npy":
            return (
                np.asarray(self.ms1_data[idx], dtype=np.float32),
                np.asarray(self.ms2_data[idx], dtype=np.float32),
            )
        return self.store.get(idx)

    def skip_pair(self) -> None:
        """Advance every draw of :meth:`sample_pair` (the pair's indices,
        the de-duplication set, the stream's buffer) without fetching or
        normalizing the pair: another process's row of a global batch."""
        if self.stream is not None:
            self.last_indices = self.stream.draw_pair(self.used_pairs)[-1]
        else:
            self.last_indices = self._draw_indices()

    def sample_pair(self):
        if self.stream is not None:
            ms1_1, ms2_1, ms1_2, ms2_2, idx = self.stream.draw_pair(self.used_pairs)
            self.last_indices = idx
        else:
            i, j = self._draw_indices()
            self.last_indices = (i, j)
            ms1_1, ms2_1 = self._fetch(i)
            ms1_2, ms2_2 = self._fetch(j)

        if self.normalize == "minmax":
            ms2_min = min(ms2_1.min(), ms2_2.min())
            ms2_max = max(ms2_1.max(), ms2_2.max())
            ms2_scale = (ms2_max - ms2_min) or 1.0
            # Reference quirk kept: MS1 scale from split 1 only
            # (data_loader.py:73-74).
            ms1_min = ms1_1.min()
            ms1_max = ms1_1.max()
            if not self.ms1_norm_from_first:
                ms1_min = min(ms1_min, ms1_2.min())
                ms1_max = max(ms1_max, ms1_2.max())
            ms1_scale = (ms1_max - ms1_min) or 1.0

            ms2_1 = (ms2_1 - ms2_min) / ms2_scale
            ms2_2 = (ms2_2 - ms2_min) / ms2_scale
            ms1_1 = (ms1_1 - ms1_min) / ms1_scale
            ms1_2 = (ms1_2 - ms1_min) / ms1_scale

        return (
            ms2_1.astype(np.float32),
            ms1_1.astype(np.float32),
            ms2_2.astype(np.float32),
            ms1_2.astype(np.float32),
        )


class PairBatches:
    """An epoch-iterable of stacked pair batches for the trainer.

    Yields ``len(dataset) // batch_size`` dict batches per epoch, matching
    the reference DataLoader's epoch length (one draw per sample index,
    cli.py:86). Exposes ``reset_epoch`` for the trainer to forward.

    ``rows`` (a range of row indices of the global batch) keeps those rows
    only: every process draws the same global batch from the same RNG and
    fetches, normalizes and stacks its own rows alone (the port's
    counterpart of the JAX ``_device_batch``'s per-process feeding).
    """

    def __init__(self, dataset: DIAMSDataset, batch_size: int = 1, drop_last: bool = True,
                 rows: Optional[range] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rows = range(batch_size) if rows is None else rows

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def reset_epoch(self) -> None:
        self.dataset.reset_epoch()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(len(self)):
            samples = []
            for i in range(self.batch_size):
                if i in self.rows:
                    samples.append(self.dataset.sample_pair())
                else:
                    self.dataset.skip_pair()
            ms2_1, ms1_1, ms2_2, ms1_2 = (np.stack(cols) for cols in zip(*samples))
            yield {"ms2_1": ms2_1, "ms1_1": ms1_1, "ms2_2": ms2_2, "ms1_2": ms1_2}
