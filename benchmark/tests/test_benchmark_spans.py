"""The readers of the program's spans and launch counter
(``metrics/self_ms.py``, ``metrics/port_launches.py``) on spans recorded
under a CPU profiler, and their entries in BENCHMARK.json."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.tests.conftest import ROOT
from mirage_tpu_torch.utils import profiling
from mirage_tpu_torch.utils.profiling import annotate

GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
       "memory_peak_bytes": 1}
FACTS = {"window_s": 2.0, "busy_s": 1.5, "kernels": 600,
         "dispatch_ms": 7.5, "device_ops": [], "idle_gaps": []}
TRAIN = {"mode": "train", "calls": 2, "trace": FACTS, "device": GPU}
INFER = {**TRAIN, "mode": "infer"}
TRAIN_PARTS = ("step", "forward", "encoder", "decoders", "loss", "backward",
               "optimizer")
INFER_PARTS = ("request", "inputs", "forward", "encoder", "decoders")


@pytest.fixture
def recorded(monkeypatch):
    """Two steps' spans recorded under a CPU profiler, with launches
    counted to them, the clock stepped 1 ms a reading."""
    clock = iter(range(0, 10 ** 9, 10 ** 6))
    monkeypatch.setattr(profiling, "time",
                        type("T", (), {"time_ns": lambda: next(clock)}))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with annotate("mirage.step"):
                with annotate("mirage.forward"):
                    with annotate("mirage.encoder"):
                        for _ in range(3):
                            profiling.launched()
                    with annotate("mirage.decoders"):
                        profiling.launched()
                with annotate("mirage.loss"):
                    pass
                with annotate("mirage.backward"):
                    for _ in range(4):
                        profiling.launched()
                with annotate("mirage.optimizer"):
                    pass
    yield profiling.summary()
    profiling.reset()


def test_self_ms_and_port_launches_read_the_summary(recorded):
    # a leaf lasts 1 ms; the forward 5 (two leaves, three steps of the
    # clock its own), the step 13 (the forward, three leaves, five its own)
    want = {"step": 5.0, "forward": 3.0, "encoder": 1.0, "decoders": 1.0,
            "loss": 1.0, "backward": 1.0, "optimizer": 1.0}
    for part, ms in want.items():
        assert run.reader(f"self_ms.train_{part}")(TRAIN) == pytest.approx(
            ms), part
    assert sum(r["self_ms"] for r in recorded.values()) == \
        recorded["mirage.step"]["total_ms"] == 26.0
    assert run.reader("port_launches.train")(TRAIN) == 8.0


@pytest.mark.parametrize("name,rec", [
    ("self_ms.train_step", {**TRAIN, "device": {**GPU, "platform": "cpu"}}),
    ("port_launches.train", {**TRAIN, "device": {**GPU, "platform": "cpu"}}),
    ("self_ms.infer_request", TRAIN),     # another mode's cell
    ("self_ms.train_step", INFER),
    ("port_launches.infer", TRAIN),
    ("port_launches.train", INFER),
    ("self_ms.infer_request", INFER),     # no mirage.request recorded
    ("self_ms.train_inputs", TRAIN),      # a span the step does not have
    ("self_ms.train_step", {**TRAIN, "trace": None}),  # untraced
])
def test_readers_find_nothing(recorded, name, rec):
    assert run.reader(name)(rec) is None


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    """An older program's profiling module has no summary: nothing, and
    no error."""
    monkeypatch.delattr(profiling, "summary")
    assert run.reader("self_ms.train_step")(TRAIN) is None
    assert run.reader("port_launches.infer")(INFER) is None


def test_every_span_metric_has_its_entry_reader_and_cells():
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    train = [c for c in cells if c.endswith(".pretrain_b256")]
    names = ([f"self_ms.train_{p}" for p in TRAIN_PARTS]
             + [f"self_ms.infer_{p}" for p in INFER_PARTS]
             + ["port_launches.train", "port_launches.infer"])
    for name in names:
        m = entries[name]
        run.reader(name)
        mode = name.split(".")[1].split("_")[0]
        assert m["workloads"] == (
            train if mode == "train" else ["mirage_large.infer_volumes"])
        assert m["moves"] == ("train_images_per_s" if mode == "train"
                              else "infer_request_p95_ms")
        assert m["layer"] == "host dispatch" and m["better"] == "lower"
        assert (m["source"], m["unit"]) == (
            ("program_span", "ms") if name.startswith("self_ms")
            else ("program_counter", "count"))
