"""The PyTorch port's model (mirage_tpu_torch) against the JAX package.

Weights come from one JAX initialisation and are carried across with
``jax_params_to_state_dict``; inputs are made with numpy. Everything runs on
the CPU in float32, where the port takes its plain PyTorch path; the bar is
the 1e-5 that tests/test_real_weights.py holds the JAX package to.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.api.wrapper import MIRAGEWrapper as JaxWrapper
from mirage_tpu.nn.posemb import build_2d_sincos_posemb as jax_posemb
from mirage_tpu.nn.resize import resize2d as jax_resize2d
from mirage_tpu_torch.adapters.input_adapters import SemSegInputAdapter
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.api.wrapper import MIRAGEWrapper, build_model
from mirage_tpu_torch.models.mirage import model_factory
from mirage_tpu_torch.nn.posemb import build_2d_sincos_posemb
from mirage_tpu_torch.nn.resize import resize2d

GOLDEN = Path(__file__).parent / "golden" / "example_triplet_tiny.npz"
DOMAINS = ["bscan", "slo", "bscanlayermap"]
# tiny sizes: encoder dh 32, decoder dh 16; 256² images at patch 16 give the
# same 16×16 grid as the 128² layer map at patch 8
ARGS = dict(model="miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
            out_domains=DOMAINS, dim_tokens=64, depth=2, num_heads=2,
            decoder_dim=32, decoder_depth=1, decoder_num_heads=2)
SIZE, PATCH = 256, 16
ATOL = 1e-5


@pytest.mark.parametrize("shape_in,shape_out,mode", [
    ((16, 16), (8, 12), "bicubic"), ((14, 14), (16, 16), "bicubic"),
    ((16, 16), (7, 9), "bilinear"), ((8, 8), (12, 12), "bilinear")])
def test_resize_matches_resize2d(shape_in, shape_out, mode):
    x = np.random.default_rng(0).standard_normal(
        (1, 8, *shape_in)).astype(np.float32)
    got = resize2d(torch.from_numpy(x), shape_out, mode=mode).numpy()
    want = np.asarray(jax_resize2d(jnp.asarray(x), shape_out, mode=mode))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("h,w,d", [(16, 16, 192), (4, 6, 64)])
def test_posemb_matches_jax(h, w, d):
    np.testing.assert_allclose(build_2d_sincos_posemb(h, w, d).numpy(),
                               np.asarray(jax_posemb(h, w, d)), atol=1e-6)


@pytest.fixture(scope="module")
def pair_of_wrappers(tmp_path_factory):
    """The same tiny checkpoint in the JAX wrapper and the port's wrapper,
    plus the JAX parameters as numpy."""
    jax_model = JaxWrapper.__new__(JaxWrapper)
    jax_model.in_domains = DOMAINS
    jax_model.out_domains = DOMAINS
    jax_model.input_size = {d: (128, 128) if d == "bscanlayermap"
                            else (SIZE, SIZE) for d in DOMAINS}
    jax_model.patch_size = {d: (8, 8) if d == "bscanlayermap"
                            else (PATCH, PATCH) for d in DOMAINS}
    model = jax_model._build_model("miragepre_tiny", ARGS, jnp.float32,
                                   "auto")
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(3)))
    port_model = build_model("miragepre_tiny", ARGS, DOMAINS, SIZE, PATCH)
    sd = jax_params_to_state_dict(params, port_model)
    port_model.load_state_dict(sd, strict=True)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"model": sd, "args": ARGS}, path)
    jw = JaxWrapper(input_size=SIZE, patch_size=PATCH, weights=str(path))
    tw = MIRAGEWrapper(input_size=SIZE, patch_size=PATCH, weights=str(path),
                       device="cpu")
    return jw, tw, params


def _inputs(seed, tasks):
    rng = np.random.default_rng(seed)
    x = {"bscan": rng.random((2, 1, SIZE, SIZE), dtype=np.float32),
         "slo": rng.random((2, 1, SIZE, SIZE), dtype=np.float32),
         "bscanlayermap": rng.integers(0, 13, (2, 128, 128)).astype(np.int32)}
    return {t: x[t] for t in tasks}


@pytest.mark.parametrize("tasks", [("bscan",), ("bscan", "slo"),
                                   tuple(DOMAINS)])
def test_wrapper_matches_jax_wrapper(pair_of_wrappers, tasks):
    """The whole slice. With every modality present the JAX model takes its
    index (masks_to_indices) path and the port its static concat path."""
    jw, tw, _ = pair_of_wrappers
    x = _inputs(1, tasks)
    want = jw(x)
    got = tw(x)
    for task in DOMAINS:
        np.testing.assert_allclose(got[task].numpy(), np.asarray(want[task]),
                                   atol=ATOL, rtol=ATOL)


def test_three_modality_request_routes_through_flash_attention(
        pair_of_wrappers, monkeypatch):
    """A request with all three modalities (256 + 256 + 256 + 1 = 769
    tokens) matches the JAX wrapper at 1e-5 and takes the JAX package's
    routes above 512 tokens: the encoder's attention and the decoders'
    cross-attention over the 769 context tokens run flash attention (B8),
    not the packed kernels, which hold at most 512 tokens and raised on the
    card (ROADMAP queue C, fault 3)."""
    from mirage_tpu_torch.adapters import spatial_output
    from mirage_tpu_torch.ops import flash_attention as fa

    calls = []
    for mod, name in ((fa, "_flash_fwd"), (spatial_output,
                                           "xattn_half_block")):
        def spy(*a, _orig=getattr(mod, name), _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    jw, tw, _ = pair_of_wrappers
    x = _inputs(5, DOMAINS)
    want = jw(x)
    got = tw(x)
    for task in DOMAINS:
        np.testing.assert_allclose(got[task].numpy(), np.asarray(want[task]),
                                   atol=ATOL, rtol=ATOL)
    # 2 encoder layers + 3 decoders' cross-attention
    assert calls == ["_flash_fwd"] * (ARGS["depth"] + len(DOMAINS))


def test_features_match_jax(pair_of_wrappers):
    jw, tw, _ = pair_of_wrappers
    x = _inputs(2, ("bscan", "slo"))
    np.testing.assert_allclose(tw.features(x).numpy(),
                               np.asarray(jw.features(x)), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("task", DOMAINS)
def test_input_adapters_match_jax(pair_of_wrappers, task):
    jw, tw, params = pair_of_wrappers
    x = _inputs(4, DOMAINS)[task]
    want = jw.model.input_adapters[task](params["input_adapters"][task],
                                         jnp.asarray(x))
    got = tw.model.input_adapters[task](torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("absent", [("slo", "bscanlayermap"), ("slo",)])
def test_spatial_output_adapter_matches_jax(pair_of_wrappers, absent):
    jw, tw, params = pair_of_wrappers
    x = _inputs(5, DOMAINS)
    n_vis = 256 * (3 - len(absent)) + 1
    enc = np.random.default_rng(6).standard_normal(
        (2, n_vis, ARGS["dim_tokens"])).astype(np.float32)
    info_j = jw.model.generate_input_info(
        {k: jnp.asarray(v) for k, v in x.items()})
    info_t = tw.model.generate_input_info(
        {k: torch.from_numpy(v) for k, v in x.items()})
    assert info_j == info_t
    want = jw.model.output_adapters["bscan"](
        params["output_adapters"]["bscan"], jnp.asarray(enc), info_j, None,
        None, absent_tasks=absent)
    got = tw.model.output_adapters["bscan"](torch.from_numpy(enc), info_t,
                                            absent)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


def test_recorded_tiny_golden(tmp_path):
    """The port reproduces the reference torch model's recorded outputs, the
    assertion of tests/test_real_weights.py:test_recorded_tiny_golden."""
    golden = np.load(GOLDEN)
    sd = {k[2:]: torch.from_numpy(golden[k].astype(np.float32))
          for k in golden.files if k.startswith("w_")}
    args = dict(model="miragepre_tiny", num_global_tokens=1,
                in_domains=DOMAINS, out_domains=DOMAINS, dim_tokens=192,
                depth=3, num_heads=4, decoder_dim=64, decoder_depth=2,
                decoder_num_heads=4)
    path = tmp_path / "tiny_golden.pth"
    torch.save({"model": sd, "args": args}, path)
    preds = MIRAGEWrapper(weights=str(path), device="cpu")(
        {"bscan": golden["in_bscan"]})
    for task in DOMAINS:
        diff = np.abs(preds[task].numpy() - golden[f"pred_{task}"]).max()
        assert diff < 1e-5, (task, float(diff))


def test_registry_builds_every_preset_and_seeds_reproducibly():
    assert sorted(model_factory) == sorted(
        f"{k}_{s}" for k in ("miragepre", "miragelight")
        for s in ("base", "large", "tiny"))

    def tiny(seed):
        return build_model("miragepre_tiny", ARGS, DOMAINS, SIZE, PATCH,
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = tiny(0), tiny(0), tiny(1)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.encoder[0].attn.qkv.weight,
                           c.encoder[0].attn.qkv.weight)
    out = a(_tokens_input(), absent_tasks=("slo", "bscanlayermap"))
    assert out["bscanlayermap"].shape == (2, 13, 128, 128)
    assert all(torch.isfinite(v).all() for v in out.values())


def _tokens_input():
    return {k: torch.from_numpy(v)
            for k, v in _inputs(7, DOMAINS).items()}


@pytest.mark.parametrize("kw", [{"emb_padding_idx": 0},
                                {"interpolate_class_emb": True}])
def test_semseg_options_not_ported_raise(kw):
    with pytest.raises(NotImplementedError):
        SemSegInputAdapter(num_classes=13, **kw)


def test_wrapper_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MIRAGEWrapper(weights=str(GOLDEN))
