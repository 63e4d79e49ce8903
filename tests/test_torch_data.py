"""The port's data path against the JAX package: the pair dataset and its
batches (NPY and parquet), the prefetcher, the native sqMass decoder, the
sqMass reader and the slice generator. The same files and seeds go to
both packages; arrays, pair indices, frames and tables must be equal
bitwise."""

import os
import struct
import subprocess
import sys
import threading
import zlib

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import torch

from dquartic_tpu.data import DIAMSDataset as JaxDIAMSDataset
from dquartic_tpu.data import PairBatches as JaxPairBatches
from dquartic_tpu.data.slices import generate_data_slices as jax_generate_data_slices
from dquartic_tpu.data.sqmass import SqMassLoader as JaxSqMassLoader
from dquartic_tpu.native import decode_batch as jax_decode_batch
from dquartic_tpu_torch.data import DIAMSDataset, PairBatches, prefetch_iterator
from dquartic_tpu_torch.native import decode_batch, decode_one, native_available
from dquartic_tpu_torch.native.decode import _py_decode_one
from test_dataset import _write_parquet
from test_sqmass_slices import sqmass_file  # noqa: F401  (fixture)


def _npy(tmp_path, n=7, rt=4, mz=16):
    rng = np.random.default_rng(3)
    np.save(tmp_path / "ms2.npy", rng.uniform(0, 10, (n, rt, mz)).astype(np.float32))
    np.save(tmp_path / "ms1.npy", rng.uniform(0, 5, (n, rt)).astype(np.float32))
    return dict(ms2_file=str(tmp_path / "ms2.npy"), ms1_file=str(tmp_path / "ms1.npy"))


def _sources(tmp_path, backend):
    if backend == "npy":
        return _npy(tmp_path)
    _write_parquet(tmp_path, n=9)
    return dict(parquet_directory=str(tmp_path))


@pytest.mark.parametrize("backend,kwargs", [
    ("npy", {}), ("npy", {"normalize": None, "seed": 5}),
    ("parquet", {}), ("parquet", {"streaming": False, "seed": 2}),
    ("parquet", {"shuffle_buffer": 4, "ms1_norm_from_first": False}),
])
def test_pair_batches_match_jax(tmp_path, backend, kwargs):
    """Two epochs of PairBatches (batch 2) with reset_epoch between them:
    the same pair indices and bitwise equal arrays as the JAX dataset."""
    src = _sources(tmp_path, backend)
    port, ref = DIAMSDataset(**src, **kwargs), JaxDIAMSDataset(**src, **kwargs)
    pb, jpb = PairBatches(port, batch_size=2), JaxPairBatches(ref, batch_size=2)
    assert len(pb) == len(jpb) > 0
    for _ in range(2):
        pb.reset_epoch()
        jpb.reset_epoch()
        for a, b in zip(pb, jpb, strict=True):
            assert port.last_indices == ref.last_indices
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
        assert port.used_pairs == ref.used_pairs


def _batches(n, fail_at=None):
    rng = np.random.default_rng(0)
    out = [{"ms2_1": rng.uniform(size=(1, 4, 8)).astype(np.float32),
            "ms1_1": rng.uniform(size=(1, 4)).astype(np.float32)} for _ in range(n)]

    class Epoch:
        resets = 0

        def __len__(self):
            return n

        def reset_epoch(self):
            Epoch.resets += 1

        def __iter__(self):
            for i, b in enumerate(out):
                if i == fail_at:
                    raise OSError("disk gone")
                yield b

    return out, Epoch()


def test_prefetch_iterator_on_the_cpu():
    """The same batches as tensors, again on a second pass (each pass its
    own producer thread), reset_epoch passed through, a producer's error
    raised at the consumer, and a consumer that stops early ends the
    producer."""
    ref, inner = _batches(5)
    it = prefetch_iterator(inner, "cpu", size=2)
    assert len(it) == 5
    for _ in range(2):
        it.reset_epoch()
        got = list(it)
        assert len(got) == 5
        for g, r in zip(got, ref):
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
            for k in r:
                np.testing.assert_array_equal(g[k].numpy(), r[k])
    assert type(inner).resets == 2

    _, failing = _batches(5, fail_at=3)
    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for b in prefetch_iterator(failing, "cpu", size=1):
            seen.append(b)
    assert len(seen) == 3

    before = threading.active_count()
    for i, _ in enumerate(iter(prefetch_iterator(inner, "cpu", size=1))):
        if i == 1:
            break
    assert threading.active_count() == before


def _blob(values, compress=True):
    raw = struct.pack(f"<{len(values)}d", *values)
    return zlib.compress(raw) if compress else raw


def test_native_decode_matches_jax_and_python():
    """The port's copy of the decoder builds, and decodes like the JAX
    package's and like its own Python fallback, corrupt blobs included."""
    assert native_available()
    rng = np.random.default_rng(1)
    vals = [rng.normal(size=n) for n in (0, 1, 17, 1000, 5000)]
    blobs = [_blob(v, compress=i % 2 == 0) for i, v in enumerate(vals)]
    comps = [1 if i % 2 == 0 else 0 for i in range(len(vals))]
    got, ref = decode_batch(blobs, comps), jax_decode_batch(blobs, comps)
    for g, r, v, b, c in zip(got, ref, vals, blobs, comps):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, v)
        np.testing.assert_array_equal(g, _py_decode_one(b, c))
        np.testing.assert_array_equal(decode_one(b, c), v)
    bad = decode_batch([blobs[4], b"not zlib"], [1, 1])
    assert bad[1] is None and jax_decode_batch([blobs[4], b"not zlib"], [1, 1])[1] is None
    np.testing.assert_array_equal(bad[0], vals[4])


def test_sqmass_loader_and_slices_match_jax(sqmass_file, tmp_path):  # noqa: F811
    """The synthetic sqMass file of tests/test_sqmass_slices.py: the
    reader's frames and slices, and the generated parquet tables, equal to
    the JAX package's."""
    from dquartic_tpu_torch.data.slices import generate_data_slices
    from dquartic_tpu_torch.data.sqmass import SqMassLoader

    port, ref = SqMassLoader(sqmass_file), JaxSqMassLoader(sqmass_file)
    port.load_all_data()
    ref.load_all_data()
    for name in ("iso_win_info", "spec_id_iso_map", "ms1_data", "ms2_data"):
        pd.testing.assert_frame_equal(getattr(port, name), getattr(ref, name))
    iso, jiso = port.iso_win_info.iloc[0], ref.iso_win_info.iloc[0]
    pd.testing.assert_frame_equal(port.extract_ms1_slice(iso, 10, True, num_bins=8),
                                  ref.extract_ms1_slice(jiso, 10, True, num_bins=8))
    pd.testing.assert_frame_equal(port.extract_ms2_slice(iso, True, num_bins=16),
                                  ref.extract_ms2_slice(jiso, True, num_bins=16))

    kw = dict(isolation_window_index=0, window_size=4, sliding_step=2, ms1_fixed_mz_size=8,
              ms2_fixed_mz_size=16)
    n = generate_data_slices(sqmass_file, str(tmp_path / "port.parquet"), **kw)
    assert n == jax_generate_data_slices(sqmass_file, str(tmp_path / "jax.parquet"), **kw) > 0
    a, b = pq.read_table(tmp_path / "port.parquet"), pq.read_table(tmp_path / "jax.parquet")
    assert a.schema == b.schema and a.equals(b)


def test_cli_and_data_import_without_pandas_and_pyarrow():
    """The CLI, the data package and the builder load with pandas and
    pyarrow hidden (a CUDA host may lack them), and import nothing of JAX
    or the JAX package."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'pyarrow', 'pyarrow.parquet'): sys.modules[m] = None\n"
        "import dquartic_tpu_torch.cli, dquartic_tpu_torch.data, dquartic_tpu_torch.utils.builder\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'msgpack', 'optax', 'dquartic_tpu')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr
