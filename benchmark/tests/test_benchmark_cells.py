"""Every cell's path end to end on the CPU at the dev model's widths, with
the port's plain versions: the run builds, warms up, measures, and its
check against the plain reference comes out correct."""

import pytest

from benchmark import run
from benchmark.tests.conftest import bench, cell_of, tiny_cell


@pytest.mark.parametrize("mode", ["infer", "train", "tune"])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_is_correct(tiny, mode, traced):
    cfg, traffic = tiny[mode]
    result = run.run_cell(cell_of(mode), 1234567 + 2 ** 31, 1.0, traced,
                          device="cpu", cfg=cfg, traffic=traffic,
                          bench=bench(),
                          cell=tiny_cell(mode))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    e2e = {m["name"] for m in run.cell_metrics(bench(), cell_of(mode),
                                                False)}
    if not traced:
        # every end-to-end metric of the cell, with no device metric from
        # a CPU run
        assert set(result["metrics"]) == e2e
        assert result["metrics"]["setup_s"]["value"] > 0
    else:
        assert "mfu." + mode not in result["metrics"]
        assert result["device"]["window_s"] > 0
