"""BENCHMARK.json against the benchmark's contract, and the files it names:
every cell, configuration, traffic mix and metric found by name."""

import importlib
import json
import re

from benchmark import run
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert all(_text(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_metrics():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
        # found by name: the traffic, its driver, the cell's limits
        traffic = run.load_json(ROOT / f"benchmark/traffic/{w['traffic']}"
                                f".json")
        importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
        assert run.load_json(ROOT / f"benchmark/cells/{w['name']}.json")[
            "limits"]
    metrics = b["end_to_end"] + b["per_layer"]
    mnames = [m["name"] for m in metrics]
    assert len(set(mnames)) == len(mnames)
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else 1
        run.reader(m["name"])  # every metric has its reader
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _text(m["layer"]) and m["moves"] in e2e
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
        # every cell that reports the metric reports what it moves
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = run.cell_metrics(b, cell, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2 and run.cell_metrics(b, cell, True)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in bench()["per_layer"]}
    assert layers <= {"entry", "host dispatch", "kernels", "device"}
