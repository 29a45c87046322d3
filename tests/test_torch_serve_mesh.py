"""Multi-device serving on the port: the wrapper's ``mesh=`` against the
JAX package's ``MIRAGEWrapper(mesh=make_mesh(...))`` and the port's single
wrapper (tests/test_parallel.py's checkpoint, batches 8, 3 and 1,
``features()``, at those tests' 2e-4 / 1e-4), ``cli/serve.py --mesh``,
the kernel launcher's device and stream (``ops/runtime.py:_launch``, with
``torch.cuda`` and the library stubbed), the CUDA sources' launch state,
which is kept per device, and the ops' launch counts, which the replicas'
threads bump under one lock.

On the CPU every mesh position is the CPU: eight replicas, eight threads.
"""

import re
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mirage_tpu.api.wrapper import MIRAGEWrapper as JaxWrapper
from mirage_tpu.parallel.mesh import make_mesh
from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
from mirage_tpu_torch.parallel.mesh import make_serve_mesh, parse_mesh

AXES = {"data": 2, "fsdp": 2, "tensor": 2}
DOMAINS = ["bscan", "slo", "bscanlayermap"]
ATOL, RTOL = 2e-4, 1e-4  # tests/test_parallel.py's multichip wrapper bars
CSRC = Path(__file__).resolve().parents[1] / "mirage_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/test_parallel.py:test_wrapper_multichip_inference's tiny
    checkpoint in the reference format."""
    from mirage_tpu.adapters import PatchedInputAdapter, SemSegInputAdapter
    from mirage_tpu.adapters.spatial_output import SpatialOutputAdapter
    from mirage_tpu.api.convert import params_to_torch
    from mirage_tpu.models.mirage import MIRAGEModel as Core

    ins = {"bscan": PatchedInputAdapter(num_channels=1,
                                        patch_size_full=(32, 32),
                                        image_size=512),
           "slo": PatchedInputAdapter(num_channels=1,
                                      patch_size_full=(32, 32),
                                      image_size=512),
           "bscanlayermap": SemSegInputAdapter(num_classes=13,
                                               patch_size_full=(8, 8),
                                               image_size=128)}
    outs = {d: SpatialOutputAdapter(
        num_channels=13 if d == "bscanlayermap" else 1,
        patch_size_full=(8, 8) if d == "bscanlayermap" else (32, 32),
        dim_tokens=64, depth=1, num_heads=4, task=d,
        context_tasks=tuple(DOMAINS),
        image_size=(128, 128) if d == "bscanlayermap" else (512, 512))
        for d in DOMAINS}
    core = Core(input_adapters=ins, output_adapters=outs, dim_tokens=192,
                depth=3, num_heads=4)
    params = core.init_params(jax.random.PRNGKey(0))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in params_to_torch(params, core).items()}
    args = SimpleNamespace(model="miragepre_tiny", num_global_tokens=1,
                           drop_path=0.0, in_domains=DOMAINS,
                           out_domains=DOMAINS, decoder_dim=64,
                           decoder_depth=1, decoder_num_heads=4,
                           decoder_use_task_queries=True,
                           decoder_use_xattn=True)
    path = tmp_path_factory.mktemp("serve_mesh") / "mirage-tiny.pth"
    torch.save({"model": sd, "args": args}, path)
    return str(path)


@pytest.fixture(scope="module")
def wrappers(ckpt):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    port = MIRAGEWrapper(weights=ckpt, device="cpu", mesh=dict(AXES))
    single = MIRAGEWrapper(weights=ckpt, device="cpu")
    jax_mesh = JaxWrapper(weights=ckpt, mesh=make_mesh(dict(AXES)))
    yield port, single, jax_mesh
    port.close()
    torch.set_num_threads(prev)


def _batch(b, both=False):
    rng = np.random.default_rng(b)
    x = {"bscan": rng.random((b, 1, 512, 512), np.float32)}
    if both:
        x["bscanlayermap"] = rng.integers(0, 13, (b, 128, 128)).astype(
            np.int32)
    return x


@pytest.mark.parametrize("b", [8, 3, 1])
def test_mesh_wrapper_matches_jax_and_the_single_wrapper(wrappers, b):
    port, single, jax_mesh = wrappers
    x = _batch(b, both=b == 3)
    got = port(x)
    want_single = single(x)
    want_jax = jax_mesh(x)
    assert set(got) == set(DOMAINS)
    for task, v in got.items():
        assert v.shape[0] == b and v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), np.asarray(want_jax[task]),
                                   atol=ATOL, rtol=RTOL, err_msg=task)
        np.testing.assert_allclose(v.numpy(), want_single[task].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=task)


@pytest.mark.parametrize("b", [8, 3, 1])
def test_mesh_features_match_jax_and_the_single_wrapper(wrappers, b):
    port, single, jax_mesh = wrappers
    x = _batch(b)
    got = port.features(x)
    assert got.shape[0] == b
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mesh.features(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), single.features(x).numpy(),
                               atol=ATOL, rtol=RTOL)


def test_mesh_pads_splits_and_keeps_one_replica_a_position(wrappers):
    port, _, _ = wrappers
    assert port._batch_multiple() == 8 == port.mesh.size
    assert len({id(m) for m in port._replicas}) == 8
    p0 = dict(port._replicas[0].named_parameters())
    for m in port._replicas[1:]:
        for n, p in m.named_parameters():
            assert p is not p0[n] and torch.equal(p, p0[n]), n
    shards = port._place_batch({"a": torch.arange(3.0)}, 3)
    assert [s["a"].tolist() for s in shards] == \
        [[0.0], [1.0], [2.0]] + [[0.0]] * 5
    assert port.device_spans() is None  # the CPU has no device clock


def test_serve_mesh_devices():
    mesh = make_serve_mesh({"data": 2, "tensor": 2}, "cpu")
    assert mesh.shape == {"data": 2, "fsdp": 1, "tensor": 2}
    assert mesh.devices == (torch.device("cpu"),) * 4
    two = make_serve_mesh(None, "cpu", devices=["cpu", "cpu"])
    assert two.shape["data"] == 2 and two.size == 2
    with pytest.raises(ValueError, match="unknown serving mesh axis"):
        make_serve_mesh({"pipe": 2}, "cpu")
    with pytest.raises(ValueError, match="!= 3 devices"):
        make_serve_mesh({"data": 2}, "cpu", devices=["cpu"] * 3)


def test_serve_mesh_needs_as_many_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 1"):
        make_serve_mesh({"data": 2}, "cuda")
    # several positions on one card, named explicitly
    mesh = make_serve_mesh({"data": 2}, "cuda", devices=["cuda:0"] * 2)
    assert mesh.devices == (torch.device("cuda", 0),) * 2


def test_serve_cli_mesh_parses_and_serves_through_the_mesh(ckpt,
                                                           monkeypatch):
    """``--mesh`` parses as the JAX command line parses it, the wrapper
    gets that mesh, /healthz names each position's device, and
    make_model_fns runs through the mesh wrapper."""
    from mirage_tpu_torch import serve
    from mirage_tpu_torch.cli import serve as cli

    assert parse_mesh("data=4,fsdp=1,tensor=2") == {"data": 4, "fsdp": 1,
                                                    "tensor": 2}
    made = {}

    class Server:
        def __init__(self, **kw):
            made.update(kw)

        def serve(self, host, port):
            made["batch"] = made["reconstruct_fn"](_batch(3))
            made["features"] = made["features_fn"](_batch(1))

        def close(self):
            made["closed"] = True

    monkeypatch.setattr(serve, "MIRAGEServer", Server)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main(["--weights", ckpt, "--device", "cpu", "--mesh",
                  "data=2,fsdp=1,tensor=2"])
    finally:
        torch.set_num_threads(prev)
    assert made["device"] == ", ".join(["cpu"] * 4)
    assert made["closed"]
    single = MIRAGEWrapper(weights=ckpt, device="cpu")
    reconstruct, features = cli.make_model_fns(single, single.in_domains)
    for task, v in reconstruct(_batch(3)).items():
        np.testing.assert_allclose(made["batch"][task], v, atol=ATOL,
                                   rtol=RTOL, err_msg=task)
    np.testing.assert_allclose(made["features"]["features"],
                               features(_batch(1))["features"], atol=ATOL,
                               rtol=RTOL)


def test_launch_uses_the_tensors_device_and_stream(monkeypatch):
    """_launch makes the operands' device current around the call (when
    another one is) and passes that device's current stream."""
    from mirage_tpu_torch.ops import _build, runtime

    current = {"device": 0}
    calls = []

    class Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    class Device:
        def __init__(self, dev):
            self.index = torch.device(dev).index

        def __enter__(self):
            self.prev, current["device"] = current["device"], self.index

        def __exit__(self, *exc):
            current["device"] = self.prev

    def entry(name):
        def fn(*args):
            calls.append((name, args, current["device"]))
            return 0
        return fn

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(torch.device(dev).index))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["device"])
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "entry", entry)
    for index in (1, 0, 3):
        like = SimpleNamespace(device=torch.device("cuda", index))
        runtime._launch("gemm", like, 7, 8)
    assert calls == [("gemm", (7, 8, 1001), 1), ("gemm", (7, 8, 1000), 0),
                     ("gemm", (7, 8, 1003), 3)]
    assert current["device"] == 0


def test_csrc_keeps_no_process_wide_launch_state():
    """Every shared-memory limit and SM count the launchers cache is kept
    per device (csrc/common.cuh: SmemLimit, set_smem, sm_count)."""
    banned = [r"static\s+bool\s+configured", r"static\s+size_t\s+conf",
              r"static\s+int\s+n\s*=\s*0\s*;", r"configure_once",
              r"static\s+int\s+clusters\["]
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        for pattern in banned:
            assert not re.search(pattern, text), (path.name, pattern)
        for m in re.finditer(r"cudaFuncSetAttribute\(", text):
            assert path.name == "common.cuh", path.name
    common = (CSRC / "common.cuh").read_text()
    assert "size_t bytes[MAX_DEVICES]" in common
    assert "std::lock_guard<std::mutex> lock(launch_state_mutex())" in common
    assert "static std::atomic<int> counts[MAX_DEVICES]" in common


def test_launch_counts_are_exact_from_many_threads(monkeypatch):
    """runtime.launch_counts adds every launch of several threads at once
    to the entry it names (each thread's own slots; the interpreter
    switches threads every microsecond, where a shared count updated
    through a call without a lock loses updates), through _launch with the
    C entries and ``torch.cuda`` stubbed."""
    from mirage_tpu_torch.ops import _build, runtime

    class Stream:
        cuda_stream = 1000

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: 0)
    like = SimpleNamespace(device=torch.device("cuda", 0))
    start = threading.Barrier(8)

    def launch(i):
        name = "attention_bwd" if i % 2 else "gemm"
        start.wait()
        for _ in range(20000):
            runtime._launch(name, like)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(8)]
    before = runtime.launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert runtime.launch_counts() - before == {"gemm": 80000,
                                                "attention_bwd": 80000}


def test_only_launch_calls_the_c_entries():
    """Every launch of a csrc/ entry goes through runtime._launch, so
    launch_counts sees it: no module of the port calls ``_build.entry``
    anywhere else, save runtime.py's occupancy query (a query, not a
    launch)."""
    import ast

    sites = []
    for path in sorted(CSRC.parent.rglob("*.py")):
        tree = ast.parse(path.read_text())
        fns = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)]
        for node in ast.walk(tree):
            func = getattr(node, "func", None)
            if isinstance(node, ast.Call) and "entry" in (
                    getattr(func, "attr", None), getattr(func, "id", None)):
                inner = max((f for f in fns if f.lineno <= node.lineno
                             <= f.end_lineno), key=lambda f: f.lineno,
                            default=None)
                sites.append((path.name, inner and inner.name,
                              ast.unparse(node.args[0])))
    assert sorted(sites) == [
        ("runtime.py", "_launch", "name"), ("runtime.py", "_launch", "name"),
        ("runtime.py", "fused_block_blocks_per_sm",
         "'fused_block_occupancy'")]
