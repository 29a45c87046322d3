"""The PyTorch port's segmentation-tuning slice (mirage_tpu_torch) against
the JAX package: flash attention (B8) and the stash MLP pair (B9), the
convolutions, the ConvNeXt head, the losses, the checkpoint surgery, the
metrics, the block routes above 512 tokens, the light forward, one whole
seg tuning step and the command line.

Everything runs on the CPU in float32, where each op takes its plain
PyTorch version; the JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them. Inputs are made with numpy; weights come
from one JAX initialisation carried across with jax_params_to_state_dict.
Tolerances: 1e-5 where the two compute the same float32 math in another
order; 1e-4 relative L2 for the gradients of a whole step (sums over
every pixel of the head).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.adapters import ConvNeXtAdapter as JaxConvNeXt
from mirage_tpu.adapters import PatchedInputAdapter as JaxPatched
from mirage_tpu.models.mirage import MIRAGEModel as JaxModel
from mirage_tpu_torch.adapters.input_adapters import PatchedInputAdapter
from mirage_tpu_torch.adapters.seg_heads import ConvNeXtAdapter
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.models.mirage import MIRAGEModel
from mirage_tpu_torch.ops import flash_attention as fa
from mirage_tpu_torch.ops import fused_mlp as fm

ATOL = 1e-5
CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "seg_200e_convnext.yaml"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------ B8

@pytest.mark.parametrize("b,h,nq,nk,dh", [(1, 2, 1025, 1025, 64),
                                          (1, 2, 256, 600, 32)])
def test_flash_attention_plain_matches_jax_kernel(b, h, nq, nk, dh):
    """B8's plain forward and backward against the Pallas kernels run in
    interpret mode (flash_attention.py:_flash_fwd, _flash_bwd), over
    (B, H, N, dh) tensors: the 1025-token encoder and a 256 × 600 cross
    shape, keys padded to 128 and masked in the kernel."""
    from mirage_tpu.ops.flash_attention import (flash_attention,
                                                flash_attention_bwd_interpret)

    rng = np.random.default_rng(nq + nk + dh)
    q, do = (rng.standard_normal((b, h, nq, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32)
            for _ in range(2))
    scale = dh ** -0.5
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, interpret=True)
    got = fa.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    want_g = flash_attention_bwd_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        scale)
    got_g = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(do), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("cross", [False, True])
def test_flash_attention_op_packed_layouts_and_autograd(cross):
    """The op on a packed qkv (self) or queries + packed kv (cross): its
    forward equals the plain math on split heads, and its backward (the
    autograd Function) equals torch.autograd through that math."""
    rng = np.random.default_rng(11 + cross)
    b, h, dh, nq, nk = 2, 2, 16, 40, 70 if cross else 40
    d = h * dh
    if cross:
        q_src = _t(rng.standard_normal((b, nq, d)).astype(np.float32))
        kv_src = _t(rng.standard_normal((b, nk, 2 * d)).astype(np.float32))
        q, k, v = q_src, kv_src[..., :d], kv_src[..., d:]
    else:
        q_src = _t(rng.standard_normal((b, nq, 3 * d)).astype(np.float32))
        kv_src = None
        q, k, v = q_src[..., :d], q_src[..., d:2 * d], q_src[..., 2 * d:]
    srcs = [t.double().requires_grad_() for t in (q_src, kv_src)
            if t is not None]

    def split(t):
        return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

    def plain(*s):
        if cross:
            qq, kk, vv = s[0], s[1][..., :d], s[1][..., d:]
        else:
            qq, kk, vv = s[0][..., :d], s[0][..., d:2 * d], s[0][..., 2 * d:]
        o = torch.softmax(split(qq) @ split(kk).transpose(-1, -2)
                          * dh ** -0.5, -1) @ split(vv)
        return o.transpose(1, 2).reshape(b, nq, d)

    out = fa.flash_attention(*srcs, num_heads=h, scale=dh ** -0.5) \
        if cross else fa.flash_attention(srcs[0], num_heads=h,
                                         scale=dh ** -0.5)
    want = plain(*srcs)
    torch.testing.assert_close(out, want, atol=1e-10, rtol=1e-10)
    dy = torch.randn(out.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    got_g = torch.autograd.grad(out, srcs, dy)
    want_g = torch.autograd.grad(want, srcs, dy)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10)
    assert q.shape[1] == nq and k.shape[1] == v.shape[1] == nk


# ------------------------------------------------------------------ B9

def _mlp_params(rng, d, hd):
    f = np.float32
    return {"g": (1 + 0.1 * rng.standard_normal(d)).astype(f),
            "be": (0.05 * rng.standard_normal(d)).astype(f),
            "w1": (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
            "b1": (0.02 * rng.standard_normal(hd)).astype(f),
            "w2": (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(f),
            "b2": (0.02 * rng.standard_normal(d)).astype(f)}


def test_stash_pair_plain_matches_jax_kernels():
    """B9's plain forward (out, act, GELU′) and backward (dx and every
    parameter grad) against _mlp_block_fwd_stash and _mlp_block_bwd_stash
    in interpret mode at the head's width, (2048, 384) -> 1536, on
    zero-mean inputs (the Pallas kernels' one-pass LN variance is exact
    there, ROADMAP queue C fault 2)."""
    from mirage_tpu.ops.fused_mlp import (_mlp_block_bwd_stash,
                                          _mlp_block_fwd_stash)

    rng = np.random.default_rng(5)
    m, d, hd = 2048, 384, 1536
    p = _mlp_params(rng, d, hd)
    x = rng.standard_normal((m, d)).astype(np.float32)
    dy = (0.1 * rng.standard_normal((m, d))).astype(np.float32)
    want = _mlp_block_fwd_stash(jnp.asarray(x), p["g"], p["be"], p["w1"],
                                p["b1"], p["w2"], p["b2"], interpret=True)
    got = fm.mlp_block_fwd_stash_ref(_t(x), _t(p["g"]), _t(p["be"]),
                                     _t(p["w1"].T), _t(p["b1"]),
                                     _t(p["w2"].T), _t(p["b2"]))
    for name, g, w in zip(("out", "act", "dgelu"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    act, dg = np.array(want[1]), np.array(want[2])
    want_g = _mlp_block_bwd_stash(jnp.asarray(x), jnp.asarray(dy),
                                  jnp.asarray(act), jnp.asarray(dg), p["g"],
                                  p["be"], p["w1"], p["w2"], interpret=True)
    got_g = fm.mlp_block_bwd_stash_ref(_t(x), _t(dy), _t(act), _t(dg),
                                       _t(p["g"]), _t(p["be"]),
                                       _t(p["w1"].T), _t(p["w2"].T))
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, g, w in zip(names, got_g, want_g):
        w = np.asarray(w)
        w = w.T if name in ("dw1", "dw2") else w.reshape(np.shape(_np(g)))
        np.testing.assert_allclose(_np(g), w, atol=ATOL, err_msg=name)


def test_stash_pair_autograd_matches_the_recompute_backward():
    """mlp_block(stash=True) under autograd takes the stash pair (its
    counter-free plain versions on the CPU) and gives the gradients of the
    recompute route, B5; without a gradient it is B2's forward."""
    rng = np.random.default_rng(6)
    m, d, hd = 1024, 384, 1536
    p = _mlp_params(rng, d, hd)
    args = [_t(a).double() for a in (
        rng.standard_normal((m, d)).astype(np.float32), p["g"], p["be"],
        p["w1"].T, p["b1"], p["w2"].T, p["b2"])]
    for a in args:
        a.requires_grad_()
    dy = torch.randn(m, d, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    assert fm.stash_route(args[0], hd) == "2d"
    got = torch.autograd.grad(fm.mlp_block(*args, stash=True), args, dy)
    want = torch.autograd.grad(fm.mlp_block(*args), args, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-9, rtol=1e-9)
    with torch.no_grad():
        torch.testing.assert_close(fm.mlp_block(*args, stash=True),
                                   fm.mlp_block_ref(*args))


@pytest.mark.parametrize("shape,hdim", [
    ((131072, 384), 1536), ((131071, 384), 1536), ((65536, 256), 1024),
    ((256, 99, 768), 3072), ((64, 257, 768), 3072), ((256, 256, 256), 1024),
    ((65536, 384), 1536), ((2048, 384), 1536), ((9216, 384), 1536)])
def test_stash_route_matches_jax(shape, hdim):
    """The port stashes exactly where the JAX package does: the shapes of
    tests/test_flash_attention.py:400-420 and the seg shapes here."""
    from mirage_tpu.ops.fused_mlp import _stash_route

    want = _stash_route(jax.ShapeDtypeStruct(shape, jnp.bfloat16), hdim)
    assert fm.stash_route(torch.empty(shape, device="meta"), hdim) == want


# ------------------------------------------------------------ conv, head

@pytest.mark.parametrize("k,groups,pad", [(7, 16, 3), (1, 1, 0), (3, 2, 1)])
def test_conv2d_nhwc_matches_jax(k, groups, pad):
    from mirage_tpu.nn.conv import conv2d_nhwc as jax_conv

    from mirage_tpu_torch.nn.conv import conv2d, conv2d_nhwc

    rng = np.random.default_rng(k + groups)
    c_in, c_out = 16, 16 if groups > 1 else 8
    x = rng.standard_normal((2, 12, 10, c_in)).astype(np.float32)
    w = rng.standard_normal((c_out, c_in // groups, k, k)).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    want = jax_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), padding=pad, groups=groups)
    got = conv2d_nhwc(_t(x), _t(w), _t(b), padding=pad, groups=groups)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    nchw = conv2d(_t(x).permute(0, 3, 1, 2), _t(w), _t(b), padding=pad,
                  groups=groups)
    np.testing.assert_allclose(_np(nchw.permute(0, 2, 3, 1)),
                               np.asarray(want), atol=ATOL)


# tiny seg model: 64 wide, 2 layers, 2 heads; a 1024² B-scan at patch 32 is
# 1024 + 1 tokens; the ConvNeXt head at embed_dim 256 (16 channels), depth 2
TINY = dict(dim_tokens=64, depth=2, num_heads=2, num_global_tokens=1)


def _models(size, embed_dim, depth, num_classes=4, seed=3, drop_path=0.0):
    """The same seg model in both packages and the JAX parameters."""
    jmodel = JaxModel(
        input_adapters={"bscan": JaxPatched(num_channels=1,
                                            patch_size_full=32,
                                            image_size=size)},
        output_adapters={"semseg": JaxConvNeXt(
            num_classes=num_classes, embed_dim=embed_dim, depth=depth,
            patch_size=32, task="semseg", image_size=(size, size))},
        mlp_ratio=4.0, qkv_bias=True, drop_path_rate=drop_path, **TINY)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    port = MIRAGEModel(
        {"bscan": PatchedInputAdapter(1, patch_size_full=32,
                                      image_size=size)},
        {"semseg": ConvNeXtAdapter(num_classes, embed_dim=embed_dim,
                                   depth=depth, patch_size=32, task="semseg",
                                   image_size=size)},
        drop_path_rate=drop_path, **TINY)
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    return jmodel, params, port


@pytest.fixture(scope="module")
def seg1025():
    return _models(1024, 256, 2)


def test_convnext_adapter_matches_jax(seg1025):
    """The head alone on the same encoder tokens: adapt_tokens, proj_dec,
    the channels-last ConvNeXt blocks (the MLP half with its residual taken
    back out), the 1×1 conv and the bilinear upsampling."""
    jmodel, params, port = seg1025
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((2, 1025, 64)).astype(np.float32)
    info = port.generate_input_info({"bscan": torch.zeros(2, 1, 1024, 1024)})
    want = jmodel.output_adapters["semseg"](
        params["output_adapters"]["semseg"], jnp.asarray(tokens), info)
    with torch.no_grad():
        got = port.output_adapters["semseg"](_t(tokens), info)
    assert got.shape == (2, 4, 1024, 1024)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_forward_light_with_the_head_matches_jax(seg1025):
    """The light forward at 1025 tokens: the encoder on route (b) (flash
    attention, then the fused MLP half), then the ConvNeXt head."""
    jmodel, params, port = seg1025
    x = np.random.default_rng(8).random((1, 1, 1024, 1024), dtype=np.float32)
    want = jmodel.forward_light(params, {"bscan": jnp.asarray(x)})["semseg"]
    with torch.no_grad():
        got = port.forward_light({"bscan": _t(x)})["semseg"]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------ the routes

@pytest.mark.parametrize("deterministic,rate,grad_free,route", [
    (True, 0.0, False, ["flash", "mlp_block"]),
    (False, 0.0, False, ["flash", "mlp_block"]),
    (False, "traced", False, ["flash", "mlp_plain"]),
    (False, "traced", True, ["flash", "mlp_block residual=False"])])
def test_block_routes_at_600_tokens(monkeypatch, deterministic, rate,
                                    grad_free, route):
    """mirage_tpu/nn/block.py:block_apply above 512 tokens: LN → flash
    attention (B8) → x + drop_path(h), then the MLP half as mlp_block when
    deterministic or the rate is statically zero, mlp_block(residual=False)
    + drop-path when grad-free, and LN + the plain MLP + drop-path
    otherwise. A rate given as a 0-d tensor (the encoder's per-layer rates)
    is never statically zero, even at 0.0. Deterministic, the block equals
    the JAX block at 1e-5."""
    from mirage_tpu.nn.block import block_apply

    from mirage_tpu_torch.nn import block as block_mod

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name if k.get("residual", True)
                         else f"{name} residual=False")
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention",
                        spy("flash", fa.flash_attention))
    monkeypatch.setattr(block_mod, "mlp_block",
                        spy("mlp_block", block_mod.mlp_block))
    monkeypatch.setattr(block_mod, "mlp_block_ref",
                        spy("mlp_plain", block_mod.mlp_block_ref))
    monkeypatch.setattr(block_mod, "attn_half_block",
                        spy("attn_half", block_mod.attn_half_block))
    rng = np.random.default_rng(9)
    blk = block_mod.Block(64, 2, qkv_bias=True)
    sd = {k: _t((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
          for k, v in blk.state_dict().items()}
    blk.load_state_dict(sd)
    x = rng.standard_normal((1, 600, 64)).astype(np.float32)
    r = torch.tensor(0.0) if rate == "traced" else rate
    out = blk(_t(x), deterministic, r, torch.Generator().manual_seed(0),
              grad_free)
    assert calls == [c if c != "mlp_plain" else "mlp_plain residual=False"
                     for c in route]
    if deterministic:
        jp = {"norm1": {"scale": sd["norm1.weight"].numpy(),
                        "bias": sd["norm1.bias"].numpy()},
              "norm2": {"scale": sd["norm2.weight"].numpy(),
                        "bias": sd["norm2.bias"].numpy()},
              "attn": {n: {"w": sd[f"attn.{n}.weight"].numpy().T,
                           "b": sd[f"attn.{n}.bias"].numpy()}
                       for n in ("qkv", "proj")},
              "mlp": {n: {"w": sd[f"mlp.{n}.weight"].numpy().T,
                          "b": sd[f"mlp.{n}.bias"].numpy()}
                      for n in ("fc1", "fc2")}}
        want = block_apply(jp, jnp.asarray(x), 2)
        np.testing.assert_allclose(_np(out), np.asarray(want), atol=ATOL)


def test_encoder_threads_tensor_rates_only_when_nonzero():
    from mirage_tpu_torch.models.encoder import drop_path_rates

    assert drop_path_rates(0.0, 3) == [0.0, 0.0, 0.0]
    rates = drop_path_rates(0.1, 3)
    assert all(torch.is_tensor(r) for r in rates)
    np.testing.assert_allclose([float(r) for r in rates], [0.0, 0.05, 0.1])


# ------------------------------------------------------------ losses

def _logits_and_labels(seed, b=2, c=5, h=9, w=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, c, h, w)).astype(np.float32)
    labels = rng.integers(0, c - 1, (b, h, w))  # the last class is empty
    labels[0, 0, :3] = 255
    return logits, labels


@pytest.mark.parametrize("loss", ["ce", "ce_ignore", "gdice", "ce_gdice"])
def test_seg_losses_match_jax(loss):
    """CE (mean, and ignoring a label), Generalized Dice (an empty class
    takes the sample's largest finite weight; labels outside the classes
    count in no class) and CE + GDice."""
    from mirage_tpu.losses import gdice as jg

    from mirage_tpu_torch.losses import gdice as tg

    logits, labels = _logits_and_labels(len(loss))
    if loss in ("gdice", "ce_gdice"):
        labels = np.where(labels == 255, 0, labels)
    fns = {"ce": ({}, "cross_entropy_loss"),
           "ce_ignore": ({"ignore_index": 255}, "cross_entropy_loss"),
           "gdice": ({}, "generalized_dice_loss"),
           "ce_gdice": ({}, "ce_gdice_loss")}
    kw, name = fns[loss]
    want = getattr(jg, name)(jnp.asarray(logits), jnp.asarray(labels), **kw)
    got = getattr(tg, name)(_t(logits), _t(labels), **kw)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=ATOL)


# ------------------------------------------------- checkpoints, metrics

def test_seg_checkpoint_surgery_and_posemb_resize_match_jax():
    """A pretraining state dict made ready for tuning at 1024²: bscanlayermap
    renamed, the class embedding padded, the decoders dropped, and the
    16×16 position embedding resized bicubically to 32×32."""
    from mirage_tpu.api import convert as jc

    from mirage_tpu_torch.api import convert as tc

    rng = np.random.default_rng(10)
    sd = {"input_adapters.bscan.pos_emb":
          rng.standard_normal((1, 8, 16, 16)).astype(np.float32),
          "input_adapters.bscanlayermap.class_emb.weight":
          rng.standard_normal((13, 4)).astype(np.float32),
          "output_adapters.bscan.out_proj.weight": np.zeros((2, 2), np.float32),
          "encoder.0.norm1.weight": np.ones(8, np.float32)}
    want = jc.seg_checkpoint_surgery(sd)
    got = tc.seg_checkpoint_surgery({k: _t(v) for k, v in sd.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])

    class _Jax:  # the JAX converter reads model.input_adapters
        input_adapters = {"bscan": JaxPatched(num_channels=1,
                                              patch_size_full=32,
                                              image_size=1024)}

    port = MIRAGEModel({"bscan": PatchedInputAdapter(
        1, patch_size_full=32, image_size=1024)}, None, dim_tokens=8,
        depth=1, num_heads=1)
    want = jc.interpolate_pos_embed_sd(sd, _Jax)
    got = tc.interpolate_pos_embed_sd({k: _t(v) for k, v in sd.items()},
                                      port)
    key = "input_adapters.bscan.pos_emb"
    assert tuple(got[key].shape) == (1, 8, 32, 32)
    np.testing.assert_allclose(np.asarray(got[key]), want[key], atol=ATOL)


def test_overlay_state_dict_loads_what_matches():
    from mirage_tpu_torch.api.convert import overlay_state_dict

    model = MIRAGEModel({"bscan": PatchedInputAdapter(
        1, patch_size_full=32, image_size=64)}, None, dim_tokens=8, depth=1,
        num_heads=1, generator=torch.Generator().manual_seed(0))
    w = torch.full((24, 8), 0.5)
    missing = overlay_state_dict(model, {"encoder.0.attn.qkv.weight": w,
                                         "output_adapters.x.w": w})
    assert torch.equal(model.encoder[0].attn.qkv.weight, w)
    assert "encoder.0.attn.qkv.weight" not in missing
    assert "global_tokens" in missing
    with pytest.raises(ValueError, match="shape"):
        overlay_state_dict(model, {"global_tokens": torch.zeros(1, 2, 8)})


def test_seg_metric_accumulator_matches_jax():
    from mirage_tpu.metrics.semseg import SegMetricAccumulator as JaxAcc

    from mirage_tpu_torch.metrics.semseg import SegMetricAccumulator

    rng = np.random.default_rng(12)
    got, want = SegMetricAccumulator(6, 255), JaxAcc(6, 255)
    for _ in range(3):
        pred = rng.integers(0, 6, (2, 17, 13))
        gt = rng.integers(0, 5, (2, 17, 13))
        gt[0, :2] = 255
        got.update(pred, gt)
        want.update(pred, gt)
    for g, w in zip(got.compute(["mIoU", "mDice"]),
                    want.compute(["mIoU", "mDice"])):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------- one whole step

def test_seg_step_matches_jax():
    """One segmentation tuning step in float32 against the JAX step: the
    reference freeze (encoder blocks frozen, the input adapter and global
    tokens trained through them), layer decay 0.75, AdamW, drop-path 0, a
    768² B-scan (577 tokens: flash attention) and the ConvNeXt head at 384
    channels (the stash pair, B9). The loss to 1e-5, every trainable
    gradient to a relative L2 error of 1e-4, every updated parameter to
    1e-5."""
    from mirage_tpu.losses import ce_gdice_loss as jax_loss
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg
    from mirage_tpu.train.steps import init_train_state as jax_init
    from mirage_tpu.train.steps import make_train_step as jax_step

    from mirage_tpu_torch.losses.gdice import ce_gdice_loss
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_seg_loss,
                                              make_train_step)

    jmodel, params, port = _models(768, 6144, 1, seed=4)
    rng = np.random.default_rng(13)
    batch = {"bscan": rng.random((1, 1, 768, 768), dtype=np.float32),
             "semseg": rng.integers(0, 4, (1, 768, 768)).astype(np.int32)}
    kw = dict(opt="adamw", betas=(0.9, 0.999), weight_decay=0.05,
              layer_decay=0.75, num_layers=TINY["depth"], freeze_encoder=True)
    jopt = JaxOpt(JaxCfg(**kw))

    def jloss(p, b, r):
        preds = jmodel.forward_light(p, {"bscan": b["bscan"]},
                                     deterministic=False, rng=r)
        return jax_loss(preds["semseg"].astype(jnp.float32), b["semseg"]), {}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: jloss(jopt.stop_frozen(p), jbatch, jax.random.PRNGKey(0)),
        has_aux=True)(params)
    opt = GroupedOptimizer(OptimizerConfig(**kw))
    state = init_train_state(port, opt)
    loss_fn = make_seg_loss(port, ce_gdice_loss, ["bscan"])
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, _ = loss_fn(tbatch)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    names = [n for n, p in state["params"].items() if p.requires_grad]
    assert "output_adapters.semseg.blocks.0.pwconv1.weight" in names
    assert "input_adapters.bscan.proj.weight" in names
    assert not any(n.startswith("encoder.") for n in names)
    grads = torch.autograd.grad(loss, [state["params"][n] for n in names])
    want_g = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_g), port)
    for n, g in zip(names, grads):
        err = ((g - want_g[n]).norm() / want_g[n].norm()).item()
        assert err <= 1e-4, (n, err)

    jstate, _ = jax_step(jloss, jopt, donate=False)(
        jax_init(params, jopt), jbatch, jax.random.PRNGKey(0), 1e-4, 1.0)
    state, metrics = make_train_step(loss_fn, opt)(
        state, tbatch, torch.Generator().manual_seed(0), 1e-4)
    assert int(state["step"]) == 1 and torch.isfinite(metrics["grad_norm"])
    want_p = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), port)
    for n, p in state["params"].items():
        np.testing.assert_allclose(_np(p), want_p[n].numpy(), atol=ATOL,
                                   err_msg=n)


# ---------------------------------------------------- the command line

def _seg_dataset(root, rng, size=80):
    for split, n in (("train", 4), ("val", 2)):
        for task in ("bscan", "semseg"):
            (root / split / task).mkdir(parents=True)
        for i in range(n):
            np.save(root / split / "bscan" / f"s{i}.npy",
                    rng.random((size, size), dtype=np.float32))
            lab = np.repeat((np.arange(size) * 8 // size)[:, None], size, 1)
            np.save(root / split / "semseg" / f"s{i}.npy",
                    lab.astype(np.uint8))
    (root / "INFO.json").write_text(json.dumps(
        {str(k): {"label": "background" if k == 0 else f"c{k}", "value": k}
         for k in range(8)}))


@pytest.mark.parametrize("fia", [False, True])
def test_run_seg_tuning_cli_on_the_cpu(tmp_path, fia):
    """The entry point with the canonical config on a tiny .npy dataset:
    one epoch of 2 steps, a validation pass, checkpoint-best, a finite loss
    in log.txt; a second run skips the finished training. ``fia``: the
    --freeze_input_adapters fast path (the encoder and input adapters
    frozen, the encoder run grad-free and its output detached)."""
    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.cli import run_seg_tuning

    rng = np.random.default_rng(14)
    _seg_dataset(tmp_path / "AROI", rng)
    domains = ["bscan", "slo", "bscanlayermap"]
    args = dict(model="miragepre_tiny", in_domains=domains,
                out_domains=["bscan"], decoder_dim=32, decoder_depth=1,
                decoder_num_heads=2)
    weights = tmp_path / "mirage-base_tiny.pth"
    torch.save({"model": build_model(
        "miragepre_tiny", args, domains, 64, 8,
        generator=torch.Generator().manual_seed(0)).state_dict(),
        "args": args}, weights)
    argv = ["-c", str(CONFIG), "--data_path",
            str(tmp_path / "AROI"), "--weights", str(weights),
            "--model_override", "miragepre_tiny", "--input_size", "64",
            "--patch_size", "8", "--batch_size", "2", "--dtype", "float32",
            "--output_dir", str(tmp_path / "out"), "--num_workers", "0",
            "--epochs", "1", "--max_steps_per_epoch", "2", "--device", "cpu"]
    argv += ["--freeze_input_adapters"] if fia else []
    out = run_seg_tuning.main(argv)
    run_dir = tmp_path / "out" / "v1" / "AROI" / (
        "mirage-base_tiny_frozen" + ("_fia" if fia else "")
        + "_convnext_CEGDice_minmax")
    assert out["output_dir"] == str(run_dir)
    assert (run_dir / "checkpoint-best").is_dir()
    assert (run_dir / "checkpoint-0").is_dir()
    rows = [json.loads(line) for line in open(run_dir / "log.txt")]
    assert np.isfinite(rows[-1]["train/loss"])
    assert 0.0 < rows[-1]["val/mean_iou"] <= 1.0
    assert run_seg_tuning.main(argv) is None  # already trained: skipped


def test_run_seg_tuning_defaults_to_cuda(tmp_path, monkeypatch):
    from mirage_tpu_torch.cli import run_seg_tuning

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _seg_dataset(tmp_path / "AROI", np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_seg_tuning.main(["--data_path", str(tmp_path / "AROI"),
                             "--weights", "mirage-base.pth",
                             "--output_dir", str(tmp_path / "out")])


# csrc/gemm_stash.cu's plan at the stash forward's fc1 shapes: B9's
# ConvNeXt head (65536, 384) -> 1536, B9′'s pretraining rows (25344, 768)
# -> 3072, the card tests' ragged cuts of both, and a product of fewer
# tiles than SMs
@pytest.mark.parametrize("m,n,k", [(65536, 1536, 384), (25344, 3072, 768),
                                   (8000, 1536, 384), (4100, 1000, 384),
                                   (33, 192, 64)])
def test_gemm_stash_plan_covers_every_tile_once(m, n, k):
    """A persistent grid of at most one CTA per SM whose tiles (b, b + grid,
    ...) cover the 64 × 256 tiling once, within a CTA's shared memory; the
    two consumers take each CTA's tiles in turn."""
    from mirage_tpu_torch.ops.block_attention import SMEM_PER_BLOCK

    plan = fm.gemm_stash_plan(m, n, k, sms=132)
    assert plan.tiles == -(-m // 64) * -(-n // 256)
    assert plan.grid == min(132, plan.tiles)
    owned = sorted(t for b in range(plan.grid)
                   for t in range(b, plan.tiles, plan.grid))
    assert owned == list(range(plan.tiles))
    assert max(len(range(b, plan.tiles, plan.grid))
               for b in range(plan.grid)) == plan.tiles_per_cta
    assert plan.ktiles == -(-k // 64) and plan.smem_bytes <= SMEM_PER_BLOCK


def test_gemm_stash_plan_raises_for_an_empty_product():
    with pytest.raises(ValueError, match="empty product"):
        fm.gemm_stash_plan(0, 1536, 384, sms=132)


# ------------------------------------- the linear, Segmenter and DPT heads

HEAD_TINY = dict(dim_tokens=32, depth=4, num_heads=2, num_global_tokens=1)


def _heads(kind, size=64, patch=8, num_classes=5, use_bn=False):
    """(JAX head, port head) of one kind at the tiny size, configured
    alike; DPT reads layers 0-3 of the 4-layer encoder."""
    from mirage_tpu.adapters import DPTOutputAdapter as JaxDPT
    from mirage_tpu.adapters import LinearSegAdapter as JaxLinear
    from mirage_tpu.adapters import \
        SegmenterMaskTransformerAdapter as JaxSegmenter

    from mirage_tpu_torch.adapters import seg_heads as sh

    common = dict(num_classes=num_classes, patch_size=patch, task="semseg",
                  image_size=(size, size))
    if kind == "linear":
        return JaxLinear(**common), sh.LinearSegAdapter(**common)
    if kind == "segmenter":
        kw = dict(embed_dim=32, num_heads=2, depth=2, **common)
        return JaxSegmenter(**kw), sh.SegmenterMaskTransformerAdapter(**kw)
    kw = dict(hooks=(0, 1, 2, 3), layer_dims=(8, 12, 16, 24), feature_dim=16,
              use_bn=use_bn, **common)
    if kind == "dpt_regression":
        kw["head_type"] = "regression"
    if not use_bn:
        return JaxDPT(**kw), sh.DPTOutputAdapter(**kw)

    class Jax(JaxDPT):
        def __call__(self, *a, **k):
            return super().__call__(*a, training=True, **k)

    class Port(sh.DPTOutputAdapter):
        def forward(self, *a, **k):
            return super().forward(*a, training=True, **k)

    import dataclasses
    return dataclasses.dataclass(frozen=True)(Jax)(**kw), Port(**kw)


def _head_models(kind, seed=21, use_bn=False, drop_path=0.0):
    """The tiny model with one head in both packages and the JAX
    parameters. The Segmenter's class embeddings are drawn at std 1, not
    the init's 0.02: at 0.02 the five class scores of a patch differ by
    ~3e-3, and mask_norm's LN over them magnifies float32 rounding 300-fold.
    With use_bn (DPT in training mode, subclasses that pass training=True,
    which the JAX model never does) the batch norms start away from their
    identity init."""
    jhead, phead = _heads(kind, use_bn=use_bn)
    jmodel = JaxModel(
        input_adapters={"bscan": JaxPatched(num_channels=1,
                                            patch_size_full=8,
                                            image_size=64)},
        output_adapters={"semseg": jhead}, mlp_ratio=4.0, qkv_bias=True,
        drop_path_rate=drop_path, **HEAD_TINY)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    if use_bn:  # batch norm away from its identity init
        rng = np.random.default_rng(seed)

        def perturb(tree):
            if isinstance(tree, dict):
                if set(tree) == {"scale", "bias", "mean", "var"}:
                    return {k: (v + 0.1 * rng.standard_normal(v.shape)
                                ).astype(np.float32) if k != "var"
                            else (v + rng.random(v.shape)).astype(np.float32)
                            for k, v in tree.items()}
                return {k: perturb(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [perturb(v) for v in tree]
            return tree

        params = perturb(params)
    if kind == "segmenter":
        head = params["output_adapters"]["semseg"]
        head["cls_emb"] = head["cls_emb"] * 50.0
    port = MIRAGEModel(
        {"bscan": PatchedInputAdapter(1, patch_size_full=8, image_size=64)},
        {"semseg": phead}, drop_path_rate=drop_path, **HEAD_TINY)
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    return jmodel, params, port


HEAD_CASES = [("linear", False), ("segmenter", False), ("dpt", False),
              ("dpt", True)]


@pytest.mark.parametrize("kind,use_bn",
                         HEAD_CASES + [("dpt_regression", False)])
def test_head_forward_matches_jax(kind, use_bn):
    """The light forward through each head (DPT on every layer's tokens,
    return_all_layers; with batch norm in training mode; DPT's regression
    head too) at 1e-5."""
    jmodel, params, port = _head_models(kind, use_bn=use_bn)
    x = np.random.default_rng(22).random((2, 1, 64, 64), dtype=np.float32)
    every = kind.startswith("dpt")
    want = jax.jit(lambda p, x: jmodel.forward_light(
        p, {"bscan": x}, return_all_layers=every)["semseg"])(
            params, jnp.asarray(x))
    with torch.no_grad():
        got = port.forward_light({"bscan": _t(x)},
                                 return_all_layers=every)["semseg"]
    # DPT predicts at 16 / patch times the image size (2 × the finest scale)
    side = 128 if every else 64
    assert got.shape == (2, 5, side, side)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind,use_bn", HEAD_CASES)
def test_head_step_matches_jax(kind, use_bn):
    """One float32 seg tuning step with each head against the JAX step, as
    test_seg_step_matches_jax: the reference freeze, layer decay 0.75,
    AdamW, CE + GDice (DPT's logits resized to the labels), no random draw
    (the JAX forward deterministic, the port's without a generator: the
    Segmenter's drop-path 0.1 and DPT's dropout stay off). The loss to
    1e-5, every trainable gradient to a relative L2 error of 1e-4, every
    updated parameter to 1e-5."""
    from mirage_tpu.losses import ce_gdice_loss as jax_loss
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg

    from mirage_tpu_torch.losses.gdice import ce_gdice_loss
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_seg_loss,
                                              make_train_step)

    jmodel, params, port = _head_models(kind, use_bn=use_bn)
    every = kind == "dpt"
    rng = np.random.default_rng(23)
    batch = {"bscan": rng.random((2, 1, 64, 64), dtype=np.float32),
             "semseg": rng.integers(0, 5, (2, 64, 64)).astype(np.int32)}
    kw = dict(opt="adamw", betas=(0.9, 0.999), weight_decay=0.05,
              layer_decay=0.75, num_layers=HEAD_TINY["depth"],
              freeze_encoder=True)
    jopt = JaxOpt(JaxCfg(**kw))

    def jloss(p, b):
        preds = jmodel.forward_light(p, {"bscan": b["bscan"]},
                                     return_all_layers=every)
        logits = preds["semseg"].astype(jnp.float32)
        if logits.shape[-2:] != b["semseg"].shape[-2:]:
            from mirage_tpu.nn.resize import resize2d as jax_resize

            logits = jax_resize(logits, b["semseg"].shape[-2:],
                                mode="bilinear")
        return jax_loss(logits, b["semseg"]), {}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the JAX step's value_and_grad and update (train/steps.py:121-130),
    # the gradients compiled once
    (want_loss, _), jax_g = jax.jit(jax.value_and_grad(
        lambda p: jloss(jopt.stop_frozen(p), jbatch), has_aux=True))(params)
    opt = GroupedOptimizer(OptimizerConfig(**kw))
    state = init_train_state(port, opt)
    loss_fn = make_seg_loss(port, ce_gdice_loss, ["bscan"],
                            return_all_layers=every)
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, _ = loss_fn(tbatch)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    names = [n for n, p in state["params"].items() if p.requires_grad]
    assert any(n.startswith("output_adapters.semseg.") for n in names)
    assert not any(n.startswith("encoder.") for n in names)
    # DPT's coarsest fusion block has no skip input: its first RCU is
    # unused (no gradient here, zeros in JAX)
    grads = torch.autograd.grad(loss, [state["params"][n] for n in names],
                                allow_unused=True)
    want_g = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_g), port)
    for n, g in zip(names, grads):
        if g is None:
            assert "refinenet4.resConfUnit1" in n and not want_g[n].any(), n
            continue
        err = ((g - want_g[n]).norm() / want_g[n].norm()).item()
        assert err <= 1e-4, (n, err)
    new_params, _, _ = jax.jit(lambda g, p: jopt.update(
        g, jopt.init(p), p, 1e-4, 1.0))(jax_g, params)
    state, _ = make_train_step(loss_fn, opt)(state, tbatch, None, 1e-4)
    want_p = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, new_params), port)
    for n, p in state["params"].items():
        got, want = _np(p), want_p[n].numpy()
        if n.endswith("attn.qkv.bias"):
            # the key bias: softmax is invariant to it, so its gradient is
            # float32 rounding noise, which AdamW's first step normalises
            # to ±lr; the query and value biases are held
            third = got.shape[0] // 3
            got, want = (np.delete(a, np.s_[third:2 * third])
                         for a in (got, want))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("kind,use_bn",
                         HEAD_CASES + [("dpt_regression", False)])
def test_head_keys_round_trip_through_params_from_torch(kind, use_bn):
    """The port's state dict is the reference namespace each JAX head's
    params_from_torch reads: JAX params -> the port's keys -> JAX params,
    leaf for leaf."""
    jmodel, params, port = _head_models(kind, use_bn=use_bn)
    sd = {k[len("output_adapters.semseg."):]: v.numpy()
          for k, v in port.state_dict().items()
          if k.startswith("output_adapters.semseg.")}
    back = jmodel.output_adapters["semseg"].params_from_torch(
        {f"h.{k}": v for k, v in sd.items()}, "h")
    want = params["output_adapters"]["semseg"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf,
                                      err_msg=str(path))


@pytest.mark.parametrize("stride,pad,k", [(4, 0, 4), (2, 0, 2), (2, 1, 3)])
def test_conv_transpose2d_matches_jax(stride, pad, k):
    from mirage_tpu.nn.conv import conv_transpose2d as jax_convt

    from mirage_tpu_torch.nn.conv import conv_transpose2d

    rng = np.random.default_rng(stride + k)
    x = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)
    w = rng.standard_normal((6, 4, k, k)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jax_convt({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=pad)
    got = conv_transpose2d(_t(x), _t(w), _t(b), stride=stride, padding=pad)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm2d_matches_jax_with_its_running_statistics(training):
    """y and the running statistics the JAX function returns (momentum
    0.1, the unbiased batch variance, eps 1e-5); the module takes the new
    statistics into its buffers in training and keeps them otherwise."""
    from mirage_tpu.nn.conv import batch_norm2d as jax_bn

    from mirage_tpu_torch.nn.conv import BatchNorm2d, batch_norm2d

    rng = np.random.default_rng(24)
    x = (3 + 2 * rng.standard_normal((3, 4, 5, 6))).astype(np.float32)
    p = {"scale": rng.random(4).astype(np.float32) + 0.5,
         "bias": rng.standard_normal(4).astype(np.float32),
         "mean": rng.standard_normal(4).astype(np.float32),
         "var": rng.random(4).astype(np.float32) + 0.5}
    want, stats = jax_bn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), training=training)
    got, mean, var = batch_norm2d(_t(x), _t(p["scale"]), _t(p["bias"]),
                                  _t(p["mean"]), _t(p["var"]),
                                  training=training)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(mean), np.asarray(stats["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(_np(var), np.asarray(stats["var"]), atol=1e-6)
    bn = BatchNorm2d(4)
    bn.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                        "running_mean": _t(p["mean"]),
                        "running_var": _t(p["var"])})
    with torch.no_grad():
        np.testing.assert_allclose(_np(bn(_t(x), training)),
                                   np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(bn.running_var), np.asarray(stats["var"]),
                               atol=1e-6)


@pytest.mark.parametrize("interpolate", [False, True])
def test_semseg_input_domain_matches_jax(interpolate):
    """semseg as an input domain (fm.domain_conf(): 4 classes, stride 4,
    padding index 4, so 5 embedding rows) beside the B-scan: the encoder
    tokens of the light forward, with the class embedding looked up and
    patch-projected, or (interpolate_class_emb) bilinearly downsampled and
    projected 1×1; a fresh port model starts with the padding row zero."""
    from mirage_tpu.adapters import SemSegInputAdapter as JaxSemSeg

    from mirage_tpu_torch.adapters.input_adapters import SemSegInputAdapter

    kw = dict(num_classes=4, stride_level=4, patch_size_full=8,
              image_size=64, dim_class_emb=16, emb_padding_idx=4,
              interpolate_class_emb=interpolate)
    jmodel = JaxModel(
        input_adapters={"bscan": JaxPatched(num_channels=1,
                                            patch_size_full=8,
                                            image_size=64),
                        "semseg": JaxSemSeg(**kw)},
        output_adapters=None, mlp_ratio=4.0, qkv_bias=True, **HEAD_TINY)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(25)))
    assert not params["input_adapters"]["semseg"]["class_emb"][4].any()
    port = MIRAGEModel(
        {"bscan": PatchedInputAdapter(1, patch_size_full=8, image_size=64),
         "semseg": SemSegInputAdapter(**kw)}, None, **HEAD_TINY)
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    rng = np.random.default_rng(26)
    x = {"bscan": rng.random((2, 1, 64, 64), dtype=np.float32),
         "semseg": rng.integers(0, 5, (2, 16, 16)).astype(np.int32)}
    want = jmodel.forward_light(params, {k: jnp.asarray(v)
                                         for k, v in x.items()})
    with torch.no_grad():
        got = port.forward_light({k: _t(v) for k, v in x.items()})
    assert got.shape == (2, 64 + 64 + 1, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    fresh = MIRAGEModel({"semseg": SemSegInputAdapter(**kw)}, None,
                        generator=torch.Generator().manual_seed(0),
                        **HEAD_TINY)
    emb = fresh.input_adapters["semseg"].class_emb.weight
    assert emb.shape == (5, 16) and not emb[4].any() and emb[:4].all()


@pytest.mark.parametrize("head", ["linear", "segmenter", "dpt"])
def test_run_seg_tuning_cli_with_each_head(tmp_path, monkeypatch, head):
    """The entry point with --output_adapter linear, segmenter (768 wide,
    12 heads) and dpt (hooks 2, 5, 8, 11: a 12-layer tiny encoder, the
    model_override preset miragepre_tiny12 added for the test): one epoch
    of 2 steps, the validation pass with its input | prediction | GT
    panel, checkpoint-best, a finite loss, the test pass with the best
    checkpoint (--test_data_path) exporting a PNG per sample, then --test
    alone (--remat set, which changes nothing at this size) scoring the
    same."""
    from mirage_tpu_torch.cli import run_seg_tuning
    from mirage_tpu_torch.models import mirage

    monkeypatch.setitem(mirage.model_factory, "miragepre_tiny12",
                        mirage._preset(dict(dim_tokens=32, depth=12,
                                            num_heads=2)))
    rng = np.random.default_rng(15)
    _seg_dataset(tmp_path / "AROI", rng, size=64)
    (tmp_path / "AROI" / "test").mkdir()
    for task in ("bscan", "semseg"):
        shutil.copytree(tmp_path / "AROI" / "val" / task,
                        tmp_path / "AROI" / "test" / task)
    weights = tmp_path / "mirage-base_tiny.pth"
    torch.save({"model": {}}, weights)
    argv = ["-c", str(CONFIG), "--data_path", str(tmp_path / "AROI"),
            "--weights", str(weights), "--model_override",
            "miragepre_tiny12" if head == "dpt" else "miragepre_tiny",
            "--input_size", "64", "--patch_size", "8", "--batch_size", "2",
            "--dtype", "float32", "--output_dir", str(tmp_path / "out"),
            "--num_workers", "0", "--epochs", "1",
            "--max_steps_per_epoch", "2", "--device", "cpu",
            "--output_adapter", head]
    out = run_seg_tuning.main(argv + ["--test_data_path",
                                      str(tmp_path / "AROI" / "test")])
    run_dir = Path(out["output_dir"])
    assert run_dir.name == f"mirage-base_tiny_frozen_{head}_CEGDice_minmax"
    assert (run_dir / "checkpoint-best").is_dir()
    assert np.isfinite(out["last_epoch"]["train/loss"])
    assert 0.0 <= out["test"]["mean_iou"] <= 1.0
    assert sorted(p.name for p in (run_dir / "preds").iterdir()) == \
        ["s0.png", "s1.png"]
    assert (run_dir / "val_images" / "e0000_val.png").is_file()
    stats = run_seg_tuning.main(argv + ["--test", "--remat"])
    assert stats["mean_iou"] == out["test"]["mean_iou"]


def test_dpt_is_refused_beyond_vit_b(tmp_path):
    from mirage_tpu_torch.cli import run_seg_tuning

    _seg_dataset(tmp_path / "AROI", np.random.default_rng(0), size=64)
    with pytest.raises(NotImplementedError, match="ViT-B only"):
        run_seg_tuning.main(["--data_path", str(tmp_path / "AROI"),
                             "--weights", "mirage-large.pth",
                             "--output_dir", str(tmp_path / "out"),
                             "--output_adapter", "dpt", "--device", "cpu"])


def test_masked_forward_returns_every_layer_like_jax():
    """return_all_layers on the masked forward (mirage_tpu/models/
    mirage.py:277-290), every token visible through explicit task masks:
    each block's output without the global token as a (B, D, gh, gw)
    map."""
    jmodel = JaxModel(
        input_adapters={"bscan": JaxPatched(num_channels=1,
                                            patch_size_full=8,
                                            image_size=64)},
        output_adapters=None, mlp_ratio=4.0, qkv_bias=True, **HEAD_TINY)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(27)))
    port = MIRAGEModel(
        {"bscan": PatchedInputAdapter(1, patch_size_full=8, image_size=64)},
        None, **HEAD_TINY)
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    x = np.random.default_rng(28).random((2, 1, 64, 64), dtype=np.float32)
    masks = np.zeros((2, 64), np.int32)
    want = jmodel(params, {"bscan": jnp.asarray(x)},
                  task_masks={"bscan": jnp.asarray(masks)}, num_visible=64,
                  return_all_layers=True)
    with torch.no_grad():
        got = port({"bscan": _t(x)}, task_masks={"bscan": _t(masks)},
                   num_visible=64, return_all_layers=True)
    assert sorted(got) == sorted(want) == [f"layer_{i}" for i in range(4)]
    for k in want:
        assert got[k].shape == (2, 32, 8, 8)
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
