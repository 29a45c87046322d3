"""The control fails the check: the reference computed with fp8 products
(the precision below the configurations' bf16) put in the program's place
reads above a limit of the cell, at the dev widths here and, on a card,
at each cell's own size on three seeds."""

import pytest
import torch

from benchmark import control, run
from benchmark.tests.conftest import TINY_LIMITS, bench, cell_of


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("mode", ["infer", "train", "tune"])
def test_control_fails_at_the_dev_size(tiny, mode):
    cfg, traffic = tiny[mode]
    readings = control.readings(cell_of(mode), 424242, "fp8", device="cpu",
                                cfg=cfg, traffic=traffic, bench=bench())
    assert _fails(readings, TINY_LIMITS[mode]), readings


@pytest.mark.card
@pytest.mark.parametrize("workload", [
    w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")[
        "workloads"]])
def test_control_fails_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (901, 902, 903):
        readings = control.readings(workload, seed, "fp8")
        limits = run.cell_spec(workload)[4]["limits"]
        assert _fails(readings, limits), (seed, readings)
