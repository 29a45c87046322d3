"""Each metric reader on a small recorded profile, and the trace's
reduction on recorded events."""

import pytest

from benchmark import peaks, run, trace

GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
       "memory_peak_bytes": 1}
FACTS = {"window_s": 2.0, "busy_s": 1.5, "kernels": 600,
         "dispatch_ms": 7.5, "device_ops": [], "idle_gaps": []}
INFER = {"mode": "infer", "setup_s": 12.5, "window_s": 2.0, "units": 400,
         "calls": 4, "latencies_ms": [float(x) for x in range(1, 101)],
         "flops": 989e12, "least_s": 0.75, "peak_window_bytes": 2 ** 31,
         "trace": FACTS, "device": GPU}
TRAIN = {**INFER, "mode": "train", "latencies_ms": []}


@pytest.mark.parametrize("name,rec,want", [
    ("setup_s", INFER, 12.5),
    ("infer_images_per_s", INFER, 200.0),
    ("infer_request_p95_ms", INFER, 95.05),
    ("train_images_per_s", TRAIN, 200.0),
    ("tune_images_per_s", {**TRAIN, "mode": "tune"}, 200.0),
    ("mfu.infer", INFER, 50.0),
    ("kernel_roofline.infer", INFER, 50.0),
    ("idle_pct.infer", INFER, 25.0),
    ("dispatch_ms.infer", INFER, 7.5),
    ("kernels_per_step.infer", INFER, 150.0),
    ("mfu.train", TRAIN, 50.0),
    ("peak_mem_gib.train", TRAIN, 2.0),
])
def test_reader(name, rec, want):
    assert run.reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name,rec", [
    ("infer_images_per_s", TRAIN),        # another mode's cell
    ("mfu.train", INFER),
    ("kernel_roofline.infer", {**INFER, "trace": None}),  # untraced run
    ("mfu.infer", {**INFER, "device": {**GPU, "platform": "cpu"}}),
])
def test_reader_finds_nothing(name, rec):
    assert run.reader(name)(rec) is None


class Event:
    def __init__(self, name, start, dur, device="CPU", annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType." + self._dev

    def is_user_annotation(self):
        return self._ann


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_reduce_recorded_trace():
    ms = 1_000_000
    events = [
        Event("gemm", 10 * ms, 30 * ms, "CUDA"),
        Event("ln", 30 * ms, 20 * ms, "CUDA"),        # overlaps gemm
        Event("Memcpy HtoD", 70 * ms, 10 * ms, "CUDA"),
        Event("gemm", 95 * ms, 20 * ms, "CUDA"),       # cut at the window
        Event("bench.call", 0, 100 * ms, "CUDA", annotation=True),
        Event("cudaLaunchKernel", 9 * ms, 1 * ms),
        Event("cudaStreamSynchronize", 52 * ms, 16 * ms),
        Event("aten::mm", 0, 5 * ms),                   # not a CUDA call
    ]
    facts = trace.reduce(Prof(events), (0, 100 * ms),
                         [(0, 40 * ms), (40 * ms, 80 * ms)])
    assert facts["window_s"] == pytest.approx(0.1)
    # [10, 50) + [70, 80) + [95, 100)
    assert facts["busy_s"] == pytest.approx(0.055)
    assert facts["kernels"] == 3
    # the second call spent 16 ms blocked in a synchronize
    assert facts["dispatch_ms"] == pytest.approx((40 + 24) / 2)
    assert facts["device_ops"][0] == ["gemm", pytest.approx(0.035)]
    gaps = facts["idle_gaps"]
    assert gaps[0] == ["host in cudaStreamSynchronize", pytest.approx(0.02)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert len(gaps) == 3 and sum(g[1] for g in gaps) == pytest.approx(0.045)


def test_reduce_refuses_another_clock():
    events = [Event("gemm", 10 ** 6, 10, "CUDA")]
    with pytest.raises(RuntimeError):
        trace.reduce(Prof(events), (10 ** 9, 2 * 10 ** 9), [])


def test_mfu_against_the_peak():
    rec = {**INFER, "flops": peaks.PEAK_BF16_FLOPS, "window_s": 1.0}
    assert run.reader("mfu.infer")(rec) == pytest.approx(100.0)
