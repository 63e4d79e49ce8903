"""Nothing the benchmark runs loads JAX, flax, optax or the JAX package, and
the reference loads nothing of the program."""

import os
import re
import subprocess
import sys

from cb_helpers import ROOT

HERE = os.path.join(ROOT, "cuda_bench")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py"))
    code = ("import cuda_bench.run, cuda_bench.modes.sample, cuda_bench.modes.train\n"
            "import dquartic_tpu_torch.utils.builder, dquartic_tpu_torch.infer.sampler\n"
            "import importlib.util, os\n"
            f"for r in {readers!r}:\n"
            "    p = os.path.join('cuda_bench', 'metrics', r + '.py')\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    loaded = _loaded(code)
    assert "dquartic_tpu_torch" in loaded  # a top-level name that begins with the JAX package's
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "dquartic_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import cuda_bench.reference.unet1d, cuda_bench.reference.ddim, "
                     "cuda_bench.roofline.model, cuda_bench.traffic.generator, cuda_bench.weights")
    assert not loaded & {"dquartic_tpu_torch", "jax", "jaxlib", "flax", "optax", "dquartic_tpu"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from cuda_bench import harness

    monkeypatch.setitem(sys.modules, "dquartic_tpu_torch_fake", sys)
    assert "dquartic_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dquartic_tpu.core", sys)
    assert "dquartic_tpu" in harness.forbidden_modules()


def test_no_file_reads_the_jax_benchmark():
    pat = re.compile(r"bench\.py|BENCH_r|BENCH_NOTES|MULTICHIP_r|BASELINE|chip_smoke|import jax|"
                     r"from jax|import flax|import optax|(import|from)\s+dquartic_tpu\b(?!_torch)")
    for d, _, files in os.walk(HERE):
        if "tests" in d.split(os.sep) or "_out" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith((".py", ".json")):
                text = open(os.path.join(d, f)).read()
                assert not pat.search(text), (f, pat.search(text).group(0))
