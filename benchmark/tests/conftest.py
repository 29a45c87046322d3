"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``card`` marker and skip inside the
test when none is present; run them on the card with
``python -m pytest benchmark/tests -m card``.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


def _load(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


TINY_MODEL = {"dim_tokens": 64, "depth": 2, "num_heads": 2}


def _tiny():
    """cell name -> (configuration, traffic) cut to a CPU test's size: the
    dev model's widths, small volumes and batches; the same paths."""
    large = _load("benchmark/configs/mirage_large.json")
    base = _load("benchmark/configs/mirage_base.json")
    out = {}
    cfg = {**large, "model": "miragepre_tiny", **TINY_MODEL,
           "decoder": {"dim": 32, "depth": 1, "num_heads": 2,
                       "mlp_ratio": 4}}
    tr = _load("benchmark/traffic/infer_volumes.json")
    tr.update(volume_sizes=[2, 3], per_cycle=1, pool_per_size=1,
              check={"per_size": 1, "cycles": 1, "rows": 2})
    out["infer"] = (cfg, tr)
    cfg = {**base, "model": "miragepre_tiny", **TINY_MODEL,
           "decoder": cfg["decoder"]}
    tr = _load("benchmark/traffic/pretrain_b256.json")
    tr["cli"] = {**tr["cli"], "batch_size": 4, "num_encoded_tokens": 16}
    tr.update(pool=3, check={"rows": 2})
    out["train"] = (cfg, tr)
    # the seg CLI builds the dev size at its own widths (192, 3, 4)
    cfg = {**base, "dim_tokens": 192, "depth": 3, "num_heads": 4,
           "seg": {**base["seg"], "model": "miragelight_tiny",
                   "image": 256}}
    tr = _load("benchmark/traffic/segtune_1024.json")
    tr["cli"] = {**tr["cli"], "batch_size": 2, "input_size": 256}
    tr["pool"] = 3
    out["tune"] = (cfg, tr)
    return out


# limits for the dev widths on the CPU, where bf16 rounds otherwise than
# on the card: above the program's readings at the tests' seeds, below the
# control's (test_benchmark_control.py)
TINY_LIMITS = {"infer": {"worst_image_rel_l2": 0.04},
               "train": {"loss_gap": 0.003, "grad_gap": 0.02,
                         "change_gap": 0.03},
               "tune": {"loss_gap": 0.0006, "grad_gap": 0.007,
                        "change_gap": 0.015}}


@pytest.fixture
def tiny():
    return _tiny()


def tiny_cell(mode):
    return {"limits": TINY_LIMITS[mode]}


# the segmentation cell's entry, which BENCHMARK.json leaves out (PERF.md,
# Open questions: its runs spread wider than a bound can hold); its files
# are kept, and these tests run it
SEG = {"name": "mirage_base.segtune_1024", "config": "mirage_base",
       "traffic": "segtune_1024", "chips": 1, "why": "segmentation tuning"}
SEG_METRICS = [{"name": "tune_images_per_s", "unit": "images/s",
                "better": "higher", "bound": 0.25, "source": "host_clock",
                "workloads": [SEG["name"]]}]


def bench():
    """BENCHMARK.json with the segmentation cell's entries added."""
    b = _load("BENCHMARK.json")
    if SEG["name"] not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append(SEG)
        b["end_to_end"] += SEG_METRICS
    return b


def cell_of(mode):
    """A cell whose traffic is of ``mode``."""
    for w in bench()["workloads"]:
        if _load(f"benchmark/traffic/{w['traffic']}.json")["mode"] == mode:
            return w["name"]
    return None
