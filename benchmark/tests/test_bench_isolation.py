"""What a run loads: nothing of JAX or of the JAX package anywhere, and the
reference nothing of the program. Each check imports in a fresh
interpreter and lists the top-level names loaded."""
import json
import subprocess
import sys

import pytest

from benchmark.harness import runner
from benchmark.harness.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dsdiff_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _loaded(
        "import runpy, sys; sys.argv = ['run.py', '--help']\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.harness import check, program, runner\n"
        "import dsdiff_torch.train.trainer")
    assert "dsdiff_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.models as m, "
                     "benchmark.reference.diffusion, benchmark.reference.optim, "
                     "benchmark.reference.flops, json\n"
                     "for c in json.load(open('BENCHMARK.json'))['configs']:\n"
                     "    m.denoiser(json.load(open(c['file']))['model'])")
    assert not loaded & (FORBIDDEN | {"dsdiff_torch"})


def test_the_check_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.forbidden_loaded() == ["jax"]


@pytest.mark.parametrize("name", ["jaxtyping", "flaxen", "dsdiff_torch"])
def test_names_compared_whole(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name not in runner.forbidden_loaded()


def test_run_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship-serve-b8",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
