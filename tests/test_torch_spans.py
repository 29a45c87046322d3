"""The port's spans and launch counter (``mirage_tpu_torch/utils/
profiling.py``) on the CPU at the dev widths: nothing recorded and nothing
allocated without a profiler; under one, the pretraining step's and the
wrapper call's span trees, their self times, the launches counted toward
the innermost span, results bit-equal with spans on and off, and
``trace``'s ``spans.json``."""

import contextlib
import itertools
import json
import threading
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mirage_tpu_torch.api.wrapper import MIRAGEWrapper, build_model
from mirage_tpu_torch.ops import _build, runtime
from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
from mirage_tpu_torch.train.steps import (init_train_state,
                                          make_pretrain_loss, make_train_step)
from mirage_tpu_torch.utils import profiling
from mirage_tpu_torch.utils.profiling import annotate

DOMAINS = ["bscan", "slo", "bscanlayermap"]
ARGS = dict(model="miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
            out_domains=DOMAINS, dim_tokens=64, depth=2, num_heads=2,
            decoder_dim=32, decoder_depth=1, decoder_num_heads=2)
# 64² at patch 8 for every task: 64 tokens each
GEOMETRY = {t: ((64, 64), (8, 8)) for t in DOMAINS}
CONF = {"bscan": {"loss": "mse", "patch_size": 8},
        "slo": {"loss": "mse", "patch_size": 8},
        "bscanlayermap": {"loss": "ce", "patch_size": 8}}
VISIBLE = 24
STEP_TREE = [("mirage.step", None), ("mirage.forward", "mirage.step"),
             ("mirage.encoder", "mirage.forward"),
             ("mirage.decoders", "mirage.forward"),
             ("mirage.loss", "mirage.step"),
             ("mirage.backward", "mirage.step"),
             ("mirage.optimizer", "mirage.step")]
REQUEST_TREE = [("mirage.request", None), ("mirage.inputs", "mirage.request"),
                ("mirage.forward", "mirage.request"),
                ("mirage.encoder", "mirage.forward"),
                ("mirage.decoders", "mirage.forward")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Bit-equal reruns and the suite's shared cores: one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(spans):
    """[(name, parent's name)] in opening order."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans]


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    x = {"bscan": torch.from_numpy(rng.random((b, 1, 64, 64),
                                              dtype=np.float32)),
         "slo": torch.from_numpy(rng.random((b, 1, 64, 64),
                                            dtype=np.float32)),
         "bscanlayermap": torch.from_numpy(
             rng.integers(0, 13, (b, 64, 64)).astype(np.int64))}
    return x


def _step(seed=0):
    """A tiny pretraining step: (state, step_fn)."""
    model = build_model("miragepre_tiny", ARGS, DOMAINS, geometry=GEOMETRY,
                        generator=torch.Generator().manual_seed(seed))
    opt = GroupedOptimizer(OptimizerConfig(clip_grad=1.0))
    state = init_train_state(model, opt)
    return state, make_train_step(make_pretrain_loss(model, CONF, VISIBLE),
                                  opt)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny checkpoint at 128², patch 8 (256 tokens a task, the layer
    map's 128² at patch 8 alike)."""
    model = build_model("miragepre_tiny", ARGS, DOMAINS, 128, 8,
                        generator=torch.Generator().manual_seed(1))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"model": model.state_dict(), "args": ARGS}, path)
    return str(path)


@pytest.fixture(scope="module")
def wrapper(ckpt):
    return MIRAGEWrapper(input_size=128, patch_size=8, weights=ckpt,
                         device="cpu")


def _bscans(b=2):
    return {"bscan": np.random.default_rng(2).random(
        (b, 1, 128, 128), dtype=np.float32)}


# ------------------------------------------------------------ recording off

def test_without_a_profiler_nothing_is_recorded(wrapper):
    """A step and a wrapper call record nothing, and ``annotate`` returns
    one shared no-op whatever the name."""
    assert annotate("mirage.step") is annotate("mirage.request")
    state, step = _step()
    step(state, _batch(0), torch.Generator().manual_seed(0), 1e-3)
    wrapper(_bscans())
    wrapper.features(_bscans())
    assert profiling.records() == [] and profiling.summary() == {}
    assert profiling._open == []


def test_annotate_off_allocates_nothing_and_reads_no_clock(monkeypatch):
    """With no profiler active, a span reads no clock, opens no
    ``record_function`` and allocates no more than the bare no-op."""
    def refuse(*args):
        raise AssertionError("called with recording off")

    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=refuse))
    monkeypatch.setattr(profiling, "record_function", refuse)
    bare = contextlib.nullcontext()

    def spans(n):
        for _ in itertools.repeat(None, n):
            with annotate("mirage.step"):
                with annotate("mirage.forward"):
                    pass

    def noops(n):
        for _ in itertools.repeat(None, n):
            with bare:
                with bare:
                    pass

    def traced(fn):
        fn(3)
        tracemalloc.start()
        try:
            fn(3)
            tracemalloc.reset_peak()
            fn(1000)
            return tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()

    assert traced(spans) == traced(noops)
    assert profiling.records() == []


# ------------------------------------------------------------- the trees

def test_step_records_the_tree_once():
    """One step under a CPU profiler: exactly the step's tree, one call id,
    one root, and self times that sum to the root's duration."""
    state, step = _step()
    with _profiler():
        step(state, _batch(0), torch.Generator().manual_seed(0), 1e-3)
    spans = profiling.records()
    assert _tree(spans) == STEP_TREE
    assert {s.call for s in spans} == {spans[0].call}
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert all(s.end_ns >= s.start_ns for s in spans)
    rows = profiling.summary()
    assert rows["mirage.step"]["calls"] == 1
    assert set(rows) == {name for name, _ in STEP_TREE}
    total = sum(r["self_ms"] for r in rows.values())
    assert total == pytest.approx(rows["mirage.step"]["total_ms"],
                                  rel=1e-9)
    assert all(r["self_ms"] >= 0 for r in rows.values())
    assert rows["mirage.forward"]["total_ms"] == pytest.approx(
        rows["mirage.forward"]["self_ms"] + rows["mirage.encoder"]["total_ms"]
        + rows["mirage.decoders"]["total_ms"], rel=1e-9)


def test_steps_get_a_call_id_each():
    state, step = _step()
    with _profiler():
        for it in range(2):
            step(state, _batch(it), torch.Generator().manual_seed(it), 1e-3)
    spans = profiling.records()
    assert _tree(spans) == STEP_TREE * 2
    assert len({s.call for s in spans[:7]}) == 1
    assert {s.call for s in spans[7:]}.isdisjoint({spans[0].call})
    assert profiling.summary()["mirage.step"]["calls"] == 2


@pytest.mark.parametrize("entry,tree", [
    ("call", REQUEST_TREE),
    ("features", REQUEST_TREE[:4]),
])
def test_wrapper_request_records_its_tree(wrapper, entry, tree):
    """A wrapper call: mirage.request over mirage.inputs and the model's
    mirage.forward (encoder, decoders); ``features`` has no decoders."""
    fn = wrapper if entry == "call" else wrapper.features
    with _profiler():
        fn(_bscans())
    spans = profiling.records()
    assert _tree(spans) == tree
    assert len({s.call for s in spans}) == 1
    rows = profiling.summary()
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(
        rows["mirage.request"]["total_ms"], rel=1e-9)


@pytest.mark.parametrize("entry", ["call", "features"])
def test_mesh_request_adopts_the_replicas_spans(ckpt, entry):
    """On a two-replica mesh each replica's mirage.forward, opened on its
    own thread, is a child of the request in its call; the request's self
    time is what neither mirage.inputs nor the replicas cover, and the
    self times add up to the request plus the time the replicas
    overlap."""
    mesh = MIRAGEWrapper(input_size=128, patch_size=8, weights=ckpt,
                         device="cpu", mesh={"data": 2})
    try:
        fn = mesh if entry == "call" else mesh.features
        with _profiler():
            fn(_bscans(4))
    finally:
        mesh.close()
    spans = profiling.records()
    tree = REQUEST_TREE if entry == "call" else REQUEST_TREE[:4]
    assert sorted(_tree(spans)) == sorted(tree[:2] + tree[2:] * 2)
    assert len({s.call for s in spans}) == 1
    request = spans[0]
    forwards = [s for s in spans if s.name == "mirage.forward"]
    assert len({s.thread for s in forwards} | {request.thread}) == 3
    for f in forwards:  # the encoder and decoders on the replica's thread
        assert {s.thread for s in spans if s.parent == f.index} == {f.thread}

    def union(group):
        ends, ns = request.start_ns, 0
        for s in sorted(group, key=lambda s: s.start_ns):
            lo, hi = max(s.start_ns, ends), s.end_ns
            if hi > lo:
                ns, ends = ns + hi - lo, hi
        return ns

    rows = profiling.summary()
    kids = [s for s in spans if s.parent == request.index]
    assert rows["mirage.request"]["self_ms"] == pytest.approx(
        (request.end_ns - request.start_ns - union(kids)) / 1e6, rel=1e-9)
    overlap = sum(f.end_ns - f.start_ns for f in forwards) - union(forwards)
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(
        (request.end_ns - request.start_ns + overlap) / 1e6, rel=1e-9)
    assert all(r["self_ms"] >= 0 for r in rows.values())


def test_adopt_none_adopts_nothing():
    with _profiler():
        with profiling.adopt(None):
            assert profiling.current() is None
            with annotate("mirage.request") as span:
                assert profiling.current() is span
        assert profiling.current() is None
    assert profiling.records()[0].parent == -1


def test_spans_leave_the_step_bit_equal():
    """Loss, gradients (the first moments) and parameters of a step are
    the same bits with spans recorded and without."""
    out = []
    for traced in (False, True):
        state, step = _step(seed=4)
        with (_profiler() if traced else contextlib.nullcontext()):
            _, metrics = step(state, _batch(5),
                              torch.Generator().manual_seed(6), 1e-3)
        out.append((metrics, state))
    (m0, s0), (m1, s1) = out
    assert profiling.summary()["mirage.step"]["calls"] == 1
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for kind in ("mu", "nu"):
        for n, v in s0["opt"][kind].items():
            assert torch.equal(v, s1["opt"][kind][n]), (kind, n)
    for n, p in s0["params"].items():
        assert torch.equal(p, s1["params"][n]), n


# ----------------------------------------------------------- the counter

@pytest.fixture
def launches(monkeypatch):
    """``runtime._launch`` with the C entries and ``torch.cuda`` stubbed
    (as tests/test_torch_serve_mesh.py stubs them): a function that makes
    one launch."""
    class Stream:
        cuda_stream = 1000

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: 0)
    like = SimpleNamespace(device=torch.device("cuda", 0))
    return lambda: runtime._launch("gemm", like, 7)


def test_launches_count_toward_the_innermost_span(launches):
    """On the launching thread's innermost span; from a thread with no span
    open, on the innermost span open in the process; a thread's own span
    takes its own launches."""
    def own():
        with annotate("mirage.inputs"):
            launches()

    with _profiler():
        with annotate("mirage.step"):
            launches()
            with annotate("mirage.backward"):
                launches()
                for target in (launches, launches, own):
                    t = threading.Thread(target=target)
                    t.start()
                    t.join()
            launches()
    rows = profiling.summary()
    assert rows["mirage.step"]["launches"] == 2
    assert rows["mirage.backward"]["launches"] == 3
    assert rows["mirage.inputs"]["launches"] == 1
    spans = profiling.records()
    inputs = [s for s in spans if s.name == "mirage.inputs"][0]
    assert inputs.parent == -1 and inputs.thread != spans[0].thread


def test_launch_counts_are_exact_from_many_threads():
    """Sixteen threads with no span of their own count toward the span
    open in the process at once, switching every microsecond: no launch
    is lost."""
    import sys

    start = threading.Barrier(16)

    def launch_many():
        start.wait(timeout=60)
        for _ in range(2000):
            profiling.launched()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            with annotate("mirage.backward"):
                threads = [threading.Thread(target=launch_many)
                           for _ in range(16)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert profiling.summary()["mirage.backward"]["launches"] == 16 * 2000


def test_nothing_is_counted_with_recording_off(launches):
    with annotate("mirage.step"):
        launches()
    launches()
    assert profiling.records() == [] and profiling._open == []
    with _profiler():
        launches()  # no span open: counted nowhere
    assert profiling.summary() == {}


def test_the_record_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    with _profiler():
        for _ in range(2):
            with annotate("mirage.step"):
                with annotate("mirage.forward"):
                    pass
    assert [s.name for s in profiling.records()] == [
        "mirage.step", "mirage.forward", "mirage.step"]
    assert profiling.dropped() == 1 and profiling._open == []
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_trace_writes_the_spans_summary(tmp_path):
    """``trace`` clears the records, writes the profiler's trace and
    spans.json, the summary of the spans recorded in the block."""
    with _profiler():
        with annotate("mirage.request"):
            pass
    state, step = _step()
    with profiling.trace(str(tmp_path)):
        step(state, _batch(0), torch.Generator().manual_seed(0), 1e-3)
    got = json.loads((tmp_path / "spans.json").read_text())
    assert got["dropped"] == 0
    assert got["spans"] == json.loads(json.dumps(profiling.summary()))
    assert set(got["spans"]) == {name for name, _ in STEP_TREE}
    assert any(p.name.endswith(".json") and p.name != "spans.json"
               for p in tmp_path.iterdir())


def test_pretraining_cli_profile_dir_writes_the_spans(tmp_path):
    """``--profile_dir``: the first epoch's trace and spans.json, with the
    loader's wait and copy (mirage.data) beside each step's tree."""
    from mirage_tpu_torch.cli import run_pretraining as cli

    rng = np.random.default_rng(0)
    for task in DOMAINS:
        (tmp_path / "data" / task).mkdir(parents=True)
        for i in range(4):
            arr = rng.integers(0, 13 if task == "bscanlayermap" else 255,
                               (72, 72)).astype(np.uint8)
            np.save(tmp_path / "data" / task / f"s{i}.npy", arr)
    cli.main(["--in_domains", "bscan-slo-bscanlayermap",
              "--out_domains", "bscan-slo-bscanlayermap",
              "--model", "miragepre_tiny", "--decoder_dim", "32",
              "--decoder_depth", "1", "--decoder_num_heads", "2",
              "--input_size", "64", "--patch_size", "8",
              "--num_encoded_tokens", "24", "--batch_size", "4",
              "--num_workers", "0", "--dtype", "float32", "--epochs", "2",
              "--warmup_epochs", "1", "--data_path", str(tmp_path / "data"),
              "--output_dir", str(tmp_path / "out"), "--device", "cpu",
              "--profile_dir", str(tmp_path / "prof")])
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    rows = got["spans"]
    assert set(rows) >= {name for name, _ in STEP_TREE} | {"mirage.data"}
    assert rows["mirage.step"]["calls"] == 1  # the first epoch only
    assert rows["mirage.data"]["calls"] >= 1 and "train_step" not in rows


def test_pretraining_cli_fetches_as_a_capped_epoch_does():
    """``_on_device`` yields the first ``steps`` batches, each copied, and
    fetches one more to end, as the epoch's loop always has; a loader
    that runs out first ends it."""
    from mirage_tpu_torch.cli import run_pretraining as cli

    fetched = []

    def loader(n):
        for i in range(n):
            fetched.append(i)
            yield {"bscan": torch.full((1, 1, 2, 2), float(i))}, None, None

    for n, steps, want in ((5, 2, 3), (2, 2, 2), (2, 4, 2)):
        fetched.clear()
        with _profiler():
            got = [b["bscan"][0, 0, 0, 0].item() for _, b in cli._on_device(
                loader(n), steps, torch.device("cpu"), ["bscan"])]
        assert got == list(range(min(n, steps))) and len(fetched) == want
        assert profiling.summary()["mirage.data"]["calls"] == \
            min(n, steps) + 1
        profiling.reset()


def test_chip_smoke_counts_no_annotation_as_a_kernel():
    """chip_smoke.py's device events leave out the user annotations that
    the profiler mirrors on the device for the port's spans."""
    import chip_smoke
    from torch.autograd import DeviceType

    def event(name, start, end, device=DeviceType.CUDA, note=False):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=note,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    prof = SimpleNamespace(events=lambda: [
        event("mirage.step", 0, 100, note=True),
        event("gemm_bf16_pingpong", 10, 20),
        event("mirage.step", 0, 100, device=DeviceType.CPU, note=True),
        event("aten::add", 1, 2, device=DeviceType.CPU),
        event("elementwise_kernel", 30, 35)])
    assert chip_smoke.device_kernels(prof) == [
        (10, 20, "gemm_bf16_pingpong"), (30, 35, "elementwise_kernel")]


def test_span_names_are_not_taken_for_cuda_calls():
    """Every span name is mirage.<part>: never cuda... or cu<Capital>, which
    trace readers take for CUDA runtime calls."""
    names = {n for n, _ in STEP_TREE + REQUEST_TREE} | {"mirage.data"}
    for n in names:
        assert n.startswith("mirage.")
        assert not (n.startswith("cuda") or (n.startswith("cu")
                                             and n[2:3].isupper()))
