"""What the benchmark loads: never JAX or the JAX package in a run, and
nothing of the port in the reference. Each check runs in a fresh
interpreter, so its ``sys.modules`` holds only what it loaded."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "mirage_tpu")


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
             "HOME": str(ROOT / "build"), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mode", ["infer", "train", "tune"])
def test_a_run_loads_no_jax(mode):
    code = (
        "import json\n"
        "from benchmark import run, control\n"
        "from benchmark.tests import conftest\n"
        "tiny = conftest._tiny()\n"
        f"cfg, tr = tiny[{mode!r}]\n"
        f"r = run.run_cell(conftest.cell_of({mode!r}), 5, 1.0, True, "
        "device='cpu', cfg=cfg, traffic=tr, bench=conftest.bench(), "
        f"cell=conftest.tiny_cell({mode!r}))\n"
        "assert r['correct'], r\n")
    loaded = _loaded(code)
    assert "mirage_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import benchmark.reference.mirage, "
                     "benchmark.reference.train, benchmark.reference.seg, "
                     "benchmark.reference.weights, "
                     "benchmark.reference.numerics")
    assert "torch" in loaded
    assert not loaded & {"mirage_tpu_torch", *FORBIDDEN}


def test_run_names_what_it_found():
    from benchmark import run

    assert run.FORBIDDEN == FORBIDDEN
    sys.modules.setdefault("jaxlib", type(sys)("jaxlib"))
    try:
        assert "jaxlib" in run.loaded_forbidden()
    finally:
        del sys.modules["jaxlib"]
