"""sqMass (SQLite) raw-data ingestion.

A copy of :mod:`dquartic_tpu.data.sqmass`: the port imports nothing of the
JAX package, and the same file gives the same frames in both.

Host-side reader with the same capability as the reference
``SqMassRawLoader`` (dquartic/utils/raw_data_parser.py),
built on sqlite3 + zlib + numpy/pandas (the reference additionally pulls
in polars and memory_profiler). Produces long-form DataFrames with
columns ``SPECTRUM_ID, NATIVE_ID, RETENTION_TIME, mz, intensity``.

Behavioral notes vs the reference:
  * The ppm-tolerance computation in ``extract_ms1_slice`` is dead code
    there (computed then overwritten by the isolation-window bounds,
    raw_data_parser.py:106-110); here the window bounds are used directly
    and ``ppm_tol`` is accepted for CLI compatibility only.
  * Fixed-count binning uses ``num_bins`` edges from min to max
    (``num_bins - 1`` real bins) with bin-mean m/z relabeling and right
    padding up to ``num_bins`` distinct m/z values, matching
    raw_data_parser.py:270-278 + 119-158 (pd.cut semantics: values at the
    left edge fall out of every bin and are dropped).
"""

from __future__ import annotations

import sqlite3
import struct
import zlib
from typing import Optional

import numpy as np
import pandas as pd


def decompress_spectrum(blob: bytes, compression: int) -> Optional[np.ndarray]:
    """Decode one DATA blob into a float64 array.

    sqMass compression codes: 0/2 = raw doubles, 1/3 = zlib doubles
    (the reference handles only zlib, raw_data_parser.py:47-55).
    """
    try:
        if compression in (1, 3):
            raw = zlib.decompress(blob)
        else:
            raw = bytes(blob)
        n = len(raw) // 8
        return np.asarray(struct.unpack(f"<{n}d", raw[: n * 8]))
    except Exception as e:  # corrupt blob: mirror reference's skip-with-warning
        print(f"Error decompressing data: {e}")
        return None


class SqMassLoader:
    """Reader for one sqMass file. ``load_all_data()`` then use the
    ``ms1_data`` / ``ms2_data`` frames and extraction helpers."""

    def __init__(self, input_file: str):
        self.input_file = input_file
        self.conn = sqlite3.connect(input_file)
        self.iso_win_info: Optional[pd.DataFrame] = None
        self.spec_id_iso_map: Optional[pd.DataFrame] = None
        self.ms1_data: Optional[pd.DataFrame] = None
        self.ms2_data: Optional[pd.DataFrame] = None

    # -- SQL layer ----------------------------------------------------- #

    def load_isolation_window_info(self) -> pd.DataFrame:
        query = """
        SELECT DISTINCT
        ISOLATION_TARGET,
        ISOLATION_LOWER,
        ISOLATION_UPPER
        FROM PRECURSOR
        INNER JOIN SPECTRUM ON SPECTRUM.ID = PRECURSOR.SPECTRUM_ID
        INNER JOIN DATA ON DATA.SPECTRUM_ID = SPECTRUM.ID
        WHERE PRECURSOR.SPECTRUM_ID IS NOT NULL
        ORDER BY ISOLATION_TARGET
        """
        df = pd.read_sql_query(query, self.conn)
        df["mzStart"] = df["ISOLATION_TARGET"] - df["ISOLATION_LOWER"]
        df["mzEnd"] = df["ISOLATION_TARGET"] + df["ISOLATION_UPPER"]
        self.iso_win_info = df
        return df

    def load_spectrum_isolation_map(self) -> pd.DataFrame:
        query = """
        SELECT
        PRECURSOR.SPECTRUM_ID,
        ISOLATION_TARGET
        FROM PRECURSOR
        INNER JOIN SPECTRUM ON SPECTRUM.ID = PRECURSOR.SPECTRUM_ID
        WHERE PRECURSOR.SPECTRUM_ID IS NOT NULL
        ORDER BY ISOLATION_TARGET
        """
        self.spec_id_iso_map = pd.read_sql_query(query, self.conn)
        return self.spec_id_iso_map

    def load_ms_data(self, ms_level: int) -> pd.DataFrame:
        """Long-form (SPECTRUM_ID, NATIVE_ID, RETENTION_TIME, mz, intensity).

        Blob decoding goes through the native batch decoder
        (:mod:`dquartic_tpu_torch.native`) when available — all spectra of a
        level decompress in parallel C++ threads — with a pure-Python
        fallback."""
        query = f"""
        SELECT SPECTRUM_ID, NATIVE_ID, RETENTION_TIME, COMPRESSION, DATA_TYPE, DATA
        FROM DATA
        INNER JOIN SPECTRUM ON SPECTRUM.ID = DATA.SPECTRUM_ID
        WHERE MSLEVEL=={ms_level}
        """
        raw = pd.read_sql_query(query, self.conn)

        from ..native import decode_batch

        arrays = decode_batch(
            [row.DATA for row in raw.itertuples(index=False)],
            [int(row.COMPRESSION) for row in raw.itertuples(index=False)],
        )

        # DATA_TYPE: 0 = mz array, 1 = intensity array
        per_spec = {}
        for row, arr in zip(raw.itertuples(index=False), arrays):
            if arr is None:
                print("Error decompressing data: corrupt blob skipped")
                continue
            entry = per_spec.setdefault(
                row.SPECTRUM_ID,
                {"NATIVE_ID": row.NATIVE_ID, "RETENTION_TIME": row.RETENTION_TIME},
            )
            entry["mz" if row.DATA_TYPE == 0 else "intensity"] = arr

        frames = []
        for sid, entry in per_spec.items():
            mz = entry.get("mz")
            inten = entry.get("intensity")
            if mz is None or inten is None or len(mz) != len(inten):
                continue
            frames.append(
                pd.DataFrame(
                    {
                        "SPECTRUM_ID": sid,
                        "NATIVE_ID": entry["NATIVE_ID"],
                        "RETENTION_TIME": entry["RETENTION_TIME"],
                        "mz": mz,
                        "intensity": inten,
                    }
                )
            )
        if not frames:
            return pd.DataFrame(
                columns=["SPECTRUM_ID", "NATIVE_ID", "RETENTION_TIME", "mz", "intensity"]
            )
        return pd.concat(frames, ignore_index=True)

    def load_all_data(self) -> None:
        self.load_isolation_window_info()
        self.load_spectrum_isolation_map()
        self.ms1_data = self.load_ms_data(1)
        self.ms2_data = self.load_ms_data(2)

    # -- binning ------------------------------------------------------- #

    @staticmethod
    def bin_fixed_count(df: pd.DataFrame, num_bins: int) -> pd.DataFrame:
        """Assign fixed-count m/z bins (raw_data_parser.py:270-278)."""
        mz = df["mz"].to_numpy()
        edges = np.linspace(mz.min(), mz.max(), num_bins)
        bins = pd.cut(mz, bins=edges, labels=False)
        out = df.copy()
        out["mz_bin"] = bins
        return out

    @staticmethod
    def bin_ppm(df: pd.DataFrame, ppm: int = 50) -> pd.DataFrame:
        """Assign ppm-width m/z bins (raw_data_parser.py:259-268)."""
        mz = df["mz"].to_numpy()
        ref = mz.min()
        edges = ref * (1 + np.arange(0, len(mz) + 1) * ppm / 1e6)
        bins = pd.cut(mz, bins=edges, labels=False)
        out = df.copy()
        out["mz_bin"] = bins
        return out

    @staticmethod
    def _rebin_and_pad(df: pd.DataFrame, num_bins: int, mslevel: int) -> pd.DataFrame:
        """Mean-m/z relabel per bin + right padding to ``num_bins`` distinct
        m/z values (raw_data_parser.py:119-158)."""
        df = df.dropna(subset=["mz_bin"])
        avg = df.groupby("mz_bin")["mz"].mean().rename("average_mz")
        df = df.join(avg, on="mz_bin")
        df = df.rename(columns={"mz": "mz_org", "average_mz": "mz"})

        unique_mzs = np.sort(df["mz"].unique())
        unique_rt = df["RETENTION_TIME"].unique()
        if 1 < len(unique_mzs) < num_bins:
            step = unique_mzs[1] - unique_mzs[0]
            n_pad = num_bins - len(unique_mzs)
            pad_mz = unique_mzs[-1] + step * (np.arange(n_pad) + 1)
            pad = pd.DataFrame(
                {
                    "SPECTRUM_ID": -1,
                    "NATIVE_ID": "padding_right",
                    "RETENTION_TIME": np.repeat(unique_rt, n_pad),
                    "mz_org": np.tile(pad_mz, len(unique_rt)),
                    "intensity": 0.0,
                    "mslevel": mslevel,
                    "mz_bin": -1.0,
                    "mz": np.tile(pad_mz, len(unique_rt)),
                }
            )
            df = pd.concat([df, pad], ignore_index=True)
        return df

    # -- slice extraction ---------------------------------------------- #

    def extract_ms1_slice(
        self,
        tgt_mz_frame,
        ppm_tol: int = 10,
        bin_mz: bool = True,
        num_bins: int = 150,
    ) -> pd.DataFrame:
        """MS1 signal within the isolation window's precursor m/z range
        (raw_data_parser.py:94-159)."""
        del ppm_tol  # dead code in the reference; window bounds win
        lower, upper = float(tgt_mz_frame["mzStart"]), float(tgt_mz_frame["mzEnd"])
        out = self.ms1_data[
            (self.ms1_data["mz"] >= lower) & (self.ms1_data["mz"] <= upper)
        ].copy()
        out["mslevel"] = 1
        if bin_mz and len(out):
            out = self.bin_fixed_count(out, num_bins)
            out = self._rebin_and_pad(out, num_bins, mslevel=1)
        return out

    def extract_ms2_slice(
        self, tgt_mz_frame, bin_mz: bool = True, num_bins: int = 30_000
    ) -> pd.DataFrame:
        """All MS2 spectra of one isolation window
        (raw_data_parser.py:162-218)."""
        target = float(tgt_mz_frame["ISOLATION_TARGET"])
        ids = self.spec_id_iso_map[
            self.spec_id_iso_map["ISOLATION_TARGET"] == target
        ]["SPECTRUM_ID"].to_numpy()
        out = self.ms2_data[self.ms2_data["SPECTRUM_ID"].isin(ids)].copy()
        out["mslevel"] = 2
        if bin_mz and len(out):
            out = self.bin_fixed_count(out, num_bins)
            out = self._rebin_and_pad(out, num_bins, mslevel=2)
        return out
