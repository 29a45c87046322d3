"""The port's remaining serving surfaces against the JAX package: the
safetensors reader (ROADMAP queue C, fault 6), ``skimage_resize``, the
inference CLI (``cli/infer.py``), the one-file API (``hf.py``) and the
recorded MIRAGE-Base golden, on the CPU in float32.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mirage_tpu.data.augment import skimage_resize as jax_skimage_resize
from mirage_tpu_torch import hf
from mirage_tpu_torch.api.convert import (SAFETENSORS_DTYPES, load_safetensors,
                                          save_safetensors)
from mirage_tpu_torch.api.wrapper import MIRAGEWrapper, build_model
from mirage_tpu_torch.data.augment import skimage_resize
from mirage_tpu_torch.ops import runtime

ROOT = Path(__file__).resolve().parents[1]
DOMAINS = ["bscan", "slo", "bscanlayermap"]
# a tiny checkpoint: encoder 64 wide (dh 32), decoders 32 wide (dh 16)
TINY_ARGS = dict(model="miragepre_tiny", num_global_tokens=1,
                 in_domains=DOMAINS, out_domains=DOMAINS, dim_tokens=64,
                 depth=2, num_heads=2, decoder_dim=32, decoder_depth=1,
                 decoder_num_heads=2)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A seeded tiny checkpoint as a .pth (with its args) and its state
    dict."""
    model = build_model("miragepre_tiny", TINY_ARGS, DOMAINS, 512, 32,
                        generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"model": sd, "args": TINY_ARGS}, path)
    return path, sd


# ----------------------------------------------------- safetensors (fault 6)

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64, torch.int32])
def test_safetensors_reader_is_bit_equal_to_the_package(tmp_path, dtype):
    """A file written by the ``safetensors`` package, read by the port's
    reader and by hf.py's own: the same tensors, bit for bit."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    ts = {"a.weight": (torch.randn(3, 5, generator=g) * 100).to(dtype),
          "b": (torch.randn(7, generator=g) * 100).to(dtype),
          "empty": torch.zeros(0, 4, dtype=dtype)}
    path = tmp_path / "w.safetensors"
    save_file(ts, str(path))
    for reader in (load_safetensors, hf.load_safetensors):
        got = reader(str(path))
        assert sorted(got) == sorted(ts)
        for k, v in ts.items():
            assert got[k].dtype == dtype and got[k].shape == v.shape
            assert torch.equal(got[k].view(-1).view(torch.uint8),
                               v.view(-1).view(torch.uint8)), k


def test_safetensors_writer_round_trips_through_the_package(tmp_path):
    from safetensors.torch import load_file

    ts = {"x": torch.arange(12, dtype=torch.float32).reshape(3, 4),
          "y": torch.randn(5).to(torch.bfloat16),
          "z": torch.arange(3, dtype=torch.int64)}
    path = tmp_path / "w.safetensors"
    save_safetensors(ts, str(path))
    for got in (load_file(str(path)), load_safetensors(str(path))):
        for k, v in ts.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "w.safetensors"
    save_file({"f8": torch.zeros(4).to(torch.float8_e4m3fn)}, str(path))
    assert "F8_E4M3" not in SAFETENSORS_DTYPES
    with pytest.raises(ValueError, match="F8_E4M3"):
        load_safetensors(str(path))


def test_wrapper_loads_safetensors_like_the_pth(tmp_path):
    """MIRAGEWrapper(weights=....safetensors) takes the repaired reader: the
    same outputs as from the .pth of the same weights (a safetensors file
    carries no args, so the model is named and sized by its defaults)."""
    model = build_model("miragepre_tiny", {}, DOMAINS, 512, 32,
                        generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    st, pth = tmp_path / "m.safetensors", tmp_path / "m.pth"
    save_safetensors(sd, str(st))
    torch.save({"model": sd, "args": {}}, pth)
    x = {"bscan": np.random.default_rng(0).random((1, 1, 512, 512),
                                                  dtype=np.float32)}
    a = MIRAGEWrapper(weights=str(st), model_override="miragepre_tiny",
                      device="cpu")(x)
    b = MIRAGEWrapper(weights=str(pth), model_override="miragepre_tiny",
                      device="cpu")(x)
    for task in DOMAINS:
        assert torch.equal(a[task], b[task]), task


def test_reader_and_hf_import_neither_safetensors_nor_jax(tmp_path, tiny_ckpt):
    """In a fresh process: the port's reader and hf.py read a safetensors
    file without importing safetensors, jax or the JAX package; hf.py
    imports nothing of the port either."""
    _, sd = tiny_ckpt
    save_safetensors(sd, str(tmp_path / "model.safetensors"))
    code = f"""
import sys
from mirage_tpu_torch import hf
from mirage_tpu_torch.api.convert import load_safetensors
sd = load_safetensors({str(tmp_path / "model.safetensors")!r})
hf.MIRAGEWrapper.SIZES["tiny"] = (64, 2, 2)
m = hf.MIRAGEWrapper.from_pretrained({str(tmp_path)!r}, device="cpu",
                                     size="tiny")
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("safetensors", "jax", "mirage_tpu"))
print("BAD", bad, len(sd))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    tree = ast.parse((ROOT / "mirage_tpu_torch" / "hf.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"functools", "json", "os", "sys", "typing", "numpy",
                    "torch", "huggingface_hub"}, mods


# ------------------------------------------------------------ preprocessing

@pytest.mark.parametrize("shape_in,shape_out,order,aa", [
    ((496, 768), (512, 512), 1, True), ((300, 200), (512, 512), 1, None),
    ((200, 150), (128, 128), 0, False), ((1024, 1024), (512, 512), 1, None)])
def test_skimage_resize_equals_jax(shape_in, shape_out, order, aa):
    rng = np.random.default_rng(sum(shape_in))
    img = (rng.random(shape_in) * 255).astype(np.float32)
    if order == 0:
        img = rng.integers(0, 13, shape_in).astype(np.int64)
    np.testing.assert_array_equal(
        skimage_resize(img, shape_out, order=order, anti_aliasing=aa),
        jax_skimage_resize(img, shape_out, order=order, anti_aliasing=aa))


# ----------------------------------------------------------- cli/infer.py

def _subjects(root, rng):
    """Two subjects at raw sizes that are not 512²."""
    for i, (h, w) in enumerate([(496, 768), (300, 400)]):
        d = root / f"s{i}"
        d.mkdir(parents=True)
        np.save(d / "bscan.npy", (rng.random((h, w)) * 255).astype(np.float32))
        np.save(d / "slo.npy", (rng.random((h, h)) * 255).astype(np.uint8))
        np.save(d / "bscanlayermap.npy",
                rng.integers(0, 13, (h // 2, w // 2)).astype(np.uint8))


@pytest.mark.parametrize("features", [False, True])
def test_infer_cli_matches_jax(tmp_path, tiny_ckpt, features):
    """cli/infer.main --device cpu against mirage_tpu.cli.infer.main on the
    same folder and tiny weights: features at 1e-5, PNGs within one level
    (a 1e-5 difference can cross a rounding boundary of the 8-bit output)."""
    from mirage_tpu.cli import infer as jax_infer
    from mirage_tpu_torch.cli import infer

    weights, _ = tiny_ckpt
    _subjects(tmp_path / "port", np.random.default_rng(3))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    flags = ["--weights", str(weights), "--modalities", "bscan,slo"] + (
        ["--features"] if features else [])
    infer.main(flags + ["--image_path", str(tmp_path / "port"),
                        "--device", "cpu"])
    jax_infer.main(flags + ["--image_path", str(tmp_path / "jax")])
    from PIL import Image

    for sub in ("s0", "s1"):
        a, b = tmp_path / "port" / sub, tmp_path / "jax" / sub
        if features:
            got = np.load(a / "__out_features.npy")
            assert got.shape == (1, 513, 64)
            np.testing.assert_allclose(got, np.load(b / "__out_features.npy"),
                                       atol=1e-5, rtol=1e-5)
            continue
        for task in DOMAINS:
            pa = np.asarray(Image.open(a / f"__out_{task}.png"), np.int32)
            pb = np.asarray(Image.open(b / f"__out_{task}.png"), np.int32)
            assert pa.shape == pb.shape
            assert np.abs(pa - pb).max() <= 1, task


def test_infer_to_array_equals_jax(tmp_path):
    from mirage_tpu.cli import infer as jax_infer
    from mirage_tpu_torch.cli import infer

    _subjects(tmp_path, np.random.default_rng(4))
    for mod in DOMAINS:
        got = infer.to_array(tmp_path / "s1" / f"{mod}.npy")
        want = jax_infer.to_array(tmp_path / "s1" / f"{mod}.npy")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ hf.py

@pytest.fixture
def tiny_sizes(monkeypatch):
    from mirage_tpu.hf import MIRAGEWrapper as JaxHF

    monkeypatch.setitem(JaxHF.SIZES, "tiny", (64, 2, 2))
    monkeypatch.setitem(hf.MIRAGEWrapper.SIZES, "tiny", (64, 2, 2))
    return JaxHF


@pytest.mark.parametrize("modalities,input_size", [("bscan-slo", 256),
                                                   ("bscan", 512)])
def test_hf_matches_jax(tiny_sizes, tiny_ckpt, modalities, input_size):
    """hf.MIRAGEWrapper against the JAX one-file API at a tiny size (the
    256² case resizes the checkpoint's 16 × 16 posemb to 8 × 8)."""
    _, sd = tiny_ckpt
    sd_np = {k: v.numpy() for k, v in sd.items()}
    kw = dict(input_size=input_size, patch_size=32, modalities=modalities,
              size="tiny")
    ours = hf.MIRAGEWrapper(device="cpu", **kw).load_state_dict(sd_np)
    theirs = tiny_sizes(**kw).load_state_dict(sd_np)
    rng = np.random.default_rng(5)
    x = {m: rng.random((2, 1, input_size, input_size), dtype=np.float32)
         for m in modalities.split("-")}
    got = ours(x)
    n = len(x) * (input_size // 32) ** 2 + 1
    assert got.shape == (2, n, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs(x)),
                               atol=1e-5, rtol=1e-5)


def test_hf_from_pretrained_reads_a_directory_and_a_pth(tiny_sizes, tiny_ckpt,
                                                        tmp_path):
    """from_pretrained on a directory with model.safetensors (the port's
    reader) and on the .pth agree with each other and with the JAX
    from_pretrained on the same directory."""
    weights, sd = tiny_ckpt
    save_safetensors(sd, str(tmp_path / "model.safetensors"))
    x = {"bscan": np.random.default_rng(6).random((1, 1, 512, 512),
                                                  dtype=np.float32)}
    a = hf.MIRAGEWrapper.from_pretrained(str(tmp_path), size="tiny",
                                         device="cpu")(x)
    b = hf.MIRAGEWrapper.from_pretrained(str(weights), size="tiny",
                                         device="cpu")(x)
    c = tiny_sizes.from_pretrained(str(tmp_path), size="tiny")(x)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5,
                               rtol=1e-5)


def test_hf_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hf.MIRAGEWrapper()


# ------------------------------------------------------ MIRAGE-Base golden

@pytest.fixture(scope="module")
def base_golden(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import BASE_GOLDEN_ARGS, golden_state_dict
    finally:
        sys.path.remove(str(ROOT))

    golden = np.load(ROOT / "tests" / "golden" / "example_triplet_base.npz")
    sd = golden_state_dict(golden)
    path = tmp_path_factory.mktemp("base") / "base_golden.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": BASE_GOLDEN_ARGS}, path)
    return golden, MIRAGEWrapper(weights=str(path), device="cpu")


@pytest.mark.parametrize("switch", ["off", "all"])
def test_recorded_base_golden(base_golden, switch):
    """The port reproduces the reference MIRAGE-Base model's recorded
    outputs (tests/test_fullsize_parity.py:152-185's bar, 1e-4) from the
    seeded full-size weights; under MIRAGE_BLOCK_FUSE=all the 12 encoder
    and 6 decoder blocks take fused_block."""
    golden, wrapper = base_golden
    with runtime.switched({"MIRAGE_BLOCK_FUSE": switch}):
        preds = wrapper({"bscan": golden["in_bscan"]})
    for task in DOMAINS:
        diff = np.abs(preds[task].numpy() - golden[f"pred_{task}"]).max()
        assert diff < 1e-4, (task, float(diff))
