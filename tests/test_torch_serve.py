"""The PyTorch port's serving layer and package boundary.

The server runs the port's wrapper on the CPU (plain PyTorch path) with the
reference weights of tests/golden/example_triplet_tiny.npz.
"""

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mirage_tpu_torch.api.wrapper import MIRAGEWrapper
from mirage_tpu_torch.cli.serve import make_model_fns, warmup
from mirage_tpu_torch.serve import BatchingQueue, MIRAGEServer, pow2_padded

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "example_triplet_tiny.npz"
DOMAINS = ["bscan", "slo", "bscanlayermap"]


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def wrapper(tmp_path_factory):
    golden = np.load(GOLDEN)
    sd = {k[2:]: torch.from_numpy(golden[k].astype(np.float32))
          for k in golden.files if k.startswith("w_")}
    args = dict(model="miragepre_tiny", num_global_tokens=1,
                in_domains=DOMAINS, out_domains=DOMAINS, dim_tokens=192,
                depth=3, num_heads=4, decoder_dim=64, decoder_depth=2,
                decoder_num_heads=4)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"model": sd, "args": args}, path)
    return MIRAGEWrapper(weights=str(path), device="cpu")


def test_http_round_trip_matches_direct_calls(wrapper):
    reconstruct, features = make_model_fns(wrapper, wrapper.in_domains)
    server = MIRAGEServer(reconstruct_fn=pow2_padded(reconstruct),
                          features_fn=pow2_padded(features), max_batch=4,
                          max_wait_ms=50, device="cpu",
                          n_params=wrapper.n_params)
    httpd = server.serve(host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    images = np.random.default_rng(0).random((3, 512, 512), dtype=np.float32)
    try:
        results = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, _post(url + "/v1/reconstruct", {"bscan": images[i]})))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        feats = _post(url + "/v1/features", {"bscan": images[0]})
        health = _get(url + "/healthz")
        stats = _get(url + "/stats")
    finally:
        server.close()
    assert health["status"] == "ok" and health["n_params"] == wrapper.n_params
    assert stats["requests"] == 4
    want = wrapper({"bscan": images[:, None]})
    for i in range(3):
        for task, shape in (("bscan", (1, 512, 512)), ("slo", (1, 512, 512)),
                            ("bscanlayermap", (13, 128, 128))):
            assert results[i][task].shape == shape
            np.testing.assert_allclose(results[i][task],
                                       want[task][i].numpy(), atol=1e-5)
    np.testing.assert_allclose(
        feats["features"],
        wrapper.features({"bscan": images[:1, None]})[0].numpy(), atol=1e-5)


def test_warmup_runs_the_pow2_ladder(wrapper):
    seen = []
    warmup(wrapper, [lambda b: seen.append(b["bscan"].shape[0])], 4)
    assert seen == [4, 2, 1]


def test_batching_queue_coalesces_and_fans_out():
    calls = []

    def model(batch):
        calls.append(batch["x"].shape[0])
        time.sleep(0.01)
        return {"y": batch["x"] * 2.0}

    q = BatchingQueue(model, max_batch=4, max_wait_ms=20)
    results = [None] * 10
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, q.submit({"x": np.full((3,), float(i), np.float32)})))
        for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    q.close()
    for i in range(10):
        np.testing.assert_allclose(results[i]["y"], np.full((3,), 2.0 * i))
    assert sum(calls) == 10 and max(calls) <= 4 and len(calls) < 10


def test_pow2_padded_pads_and_slices():
    seen = []

    def model(batch):
        seen.append(batch["x"].shape[0])
        return {"y": batch["x"] + 1}

    out = pow2_padded(model)({"x": np.ones((3, 2), np.float32)})
    assert seen == [4] and out["y"].shape == (3, 2)


def test_server_needs_a_model_fn():
    with pytest.raises(ValueError):
        MIRAGEServer()


def _is_jax_side(name):
    return name is not None and any(
        name == top or name.startswith(top + ".")
        for top in ("jax", "mirage_tpu"))


def test_chip_smoke_imports_neither_jax_nor_mirage_tpu():
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert "mirage_tpu_torch.api.wrapper" in names
    assert not [n for n in names if _is_jax_side(n)]


def test_chip_smoke_profile_groups_every_port_kernel():
    """Each __global__ kernel under csrc/ (sources and shared headers) has a
    group in chip_smoke.py's profile, so its device time is not counted as
    PyTorch's; a kernel in a namespace is named with it in the profile."""
    import re

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    names = set()
    csrc = ROOT / "mirage_tpu_torch" / "csrc"
    for src in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        for decl in src.read_text().split("__global__")[1:]:
            names.add(re.search(r"\b(?!__launch_bounds__\b)(\w+)\s*\(",
                                decl).group(1))
    assert names == {k.split("::")[-1] for k in chip_smoke.PORT_KERNELS}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA card here: the script exits non-zero and prints no result,
    from the checkout and from a directory that holds only the script."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / script.name).write_text(script.read_text())
        script = tmp_path / script.name
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


# the segmentation slice's modules, which the walk below must reach
SEG_MODULES = ("ops.flash_attention", "nn.conv", "adapters.seg_heads",
               "losses.gdice", "api.fm_configs", "metrics.semseg",
               "data.folder", "data.augment", "data.loader",
               "train.checkpoint", "train.logger", "cli.config",
               "cli.run_seg_tuning")
# the serving slice's modules under MIRAGE_BLOCK_FUSE and its entry points
SERVE_MODULES = ("ops.fused_block", "ops.quant", "cli.infer", "hf")


def test_package_imports_neither_jax_nor_mirage_tpu():
    """Subprocess: this test process has already imported jax. Every module
    of the package, the segmentation and serving slices' included (hf.py
    and cli/infer.py among them)."""
    code = """
import importlib, pkgutil, sys
import mirage_tpu_torch
for m in pkgutil.walk_packages(mirage_tpu_torch.__path__, "mirage_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "mirage_tpu" or n.startswith("mirage_tpu."))
print("BAD", bad)
print("MODS", sorted(n for n in sys.modules if n.startswith("mirage_tpu_torch.")))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    mods = out.stdout.split("MODS", 1)[1]
    for name in SEG_MODULES + SERVE_MODULES:
        assert f"'mirage_tpu_torch.{name}'" in mods, name
