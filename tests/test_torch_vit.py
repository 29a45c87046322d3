"""The PyTorch port's baseline ViT classifiers (mirage_tpu_torch.models.vit)
against the JAX package: the forward with each pool at 5, 10 and 197
tokens, one full fine-tune step against the JAX model's smoothed CE under
jax.value_and_grad and the JAX optimizer, one linear-probe step, the routes
the steps and the eval forward take, the position-embedding resize, timm-
keyed checkpoints, the registry and the command line.

Everything runs on the CPU in float32 at a narrow width (64 wide, 2
layers, 4 heads, patch 16), where each op takes its plain PyTorch
version; weights come from the JAX init, carried across with
jax_params_to_state_dict. Tolerances: 1e-5 where both packages compute
the same float32 math in another order, 1e-4 relative L2 for a whole
step's gradients, 1e-4 against F.interpolate (float32 against its own
bicubic kernel).

The JAX package cannot train a baseline (queue C fault 9, pinned by
test_jax_baseline_train_path_faults), so the step is held to the JAX model
function and the JAX optimizer composed here.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu_torch.api import convert
from mirage_tpu_torch.models import vit as port_vit

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(patch_size=16, in_chans=3, embed_dim=64, depth=2, num_heads=4)
CLASSES = 5
ATOL = 1e-5
# the JAX optimizer's names of what the port's probe freezes (its pytree
# holds the blocks under 'encoder', the port's state dict under 'blocks')
JAX_PROBE_FROZEN = ("cls_token", "pos_embed", "patch_embed", "encoder", "norm")
OPT = dict(opt="adamw", betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The narrow models run no faster on more threads, and the suite runs
    several test processes on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(pool, img, seed=0, classes=CLASSES):
    """The JAX ViT, its parameters, and the port's ViT with the same
    weights."""
    from mirage_tpu.models.vit import VisionTransformer as JaxViT

    jvit = JaxViT(num_classes=classes, img_size=img, pool=pool, **NARROW)
    jparams = jvit.init_params(jax.random.PRNGKey(seed))
    port = port_vit.VisionTransformer(num_classes=classes, img_size=img,
                                      pool=pool, device="cpu", **NARROW)
    port.load_state_dict(convert.jax_params_to_state_dict(
        _tree_np(jparams), port), strict=True)
    return jvit, jparams, port


def _narrow_factory(num_classes, **kwargs):
    return port_vit.VisionTransformer(num_classes=num_classes, **NARROW,
                                      **kwargs)


def _timm_checkpoint(path, img, seed, classes=CLASSES):
    """A timm-keyed narrow ViT checkpoint from the JAX init, written by the
    port's safetensors writer; returns its state dict."""
    _, _, port = _pair("cls", img, seed, classes)
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    if str(path).endswith(".pth"):
        torch.save(sd, path)
    else:
        convert.save_safetensors(sd, str(path))
    return sd


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("pool", ["global", "cls", "token_mix"])
@pytest.mark.parametrize("img,tokens", [(32, 5), (48, 10), (224, 197)])
def test_vit_forward_matches_jax(pool, img, tokens):
    """The eval forward, and the training forward at drop-path 0 (another
    route above 128 tokens), against the JAX ViT; the state dict holds
    timm's keys, and token_mix's head is twice as wide."""
    jvit, jparams, port = _pair(pool, img)
    assert port.num_patches + 1 == tokens
    keys = set(port.state_dict())
    assert {"cls_token", "pos_embed", "patch_embed.proj.weight",
            "blocks.1.attn.qkv.weight", "blocks.0.mlp.fc2.bias",
            "norm.weight", "head.bias"} <= keys
    assert port.patch_embed.proj.weight.shape == (64, 3, 16, 16)
    assert port.head.weight.shape[1] == (128 if pool == "token_mix" else 64)
    x = np.random.default_rng(tokens).random((3, 3, img, img),
                                             dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvit(p, x))(jparams, x))
    with torch.no_grad():
        got = port(_t(x))
        train = port(_t(x), deterministic=False,
                     generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.float32 and got.shape == (3, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(train.numpy(), want, atol=ATOL, rtol=ATOL)


def test_vit_presets_and_refusals():
    """The two presets' widths (built on the meta device: no memory), the
    refused pool and dropout."""
    for name, (d, depth, heads) in {"vit_base_patch16": (768, 12, 12),
                                    "vit_large_patch16": (1024, 24, 16)
                                    }.items():
        with torch.device("meta"):
            m = port_vit.vit_factory[name](num_classes=3, device="meta")
        assert (m.embed_dim, m.depth, m.num_heads, m.patch_size,
                m.num_patches) == (d, depth, heads, 16, 196)
        assert len(m.blocks) == depth and m.pos_embed.shape == (1, 197, d)
    with pytest.raises(ValueError, match="pool"):
        _narrow_factory(3, pool="mean", device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        _narrow_factory(3, drop_rate=0.1, device="cpu")


# ------------------------------------------------------------ train steps

def _batch(img, seed, b=3):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((b, 3, img, img), dtype=np.float32),
            "targets": rng.integers(0, CLASSES, b).astype(np.int64),
            "weights": np.array([1.0] * (b - 1) + [0.0], np.float32)}


def _jax_step(jvit, jparams, batch, frozen, lr):
    """The JAX model's smoothed CE (sum form over a zero-weight padding
    row) under jax.value_and_grad, and the JAX optimizer's update."""
    from mirage_tpu.losses.gdice import cross_entropy_loss as jax_ce
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg

    jopt = JaxOpt(JaxCfg(frozen_paths=frozen, **OPT))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        logits = jvit(jopt.stop_frozen(params), jbatch["images"],
                      deterministic=False, rng=jax.random.PRNGKey(0))
        s, w = jax_ce(logits[..., None, None],
                      jbatch["targets"][..., None, None],
                      label_smoothing=0.1, weights=jbatch["weights"],
                      normalize=False)
        return s / jnp.maximum(w, 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    new, _, _ = jopt.update(grads, jopt.init(jparams), jparams, lr)
    trainable = jopt.meta(jparams)["trainable"]
    return loss, grads, new, trainable


def _port_step(port, batch, linear_probing, lr):
    from mirage_tpu_torch.api.fm_configs import ViTBaseClsFM
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_cls_loss,
                                              make_train_step)

    fm = ViTBaseClsFM(linear_probing=linear_probing)
    opt = GroupedOptimizer(OptimizerConfig(frozen_paths=fm.frozen_paths(),
                                           **OPT))
    state = init_train_state(port, opt)
    loss_fn = make_cls_loss(port, 0.1, frozen_encoder=linear_probing)
    tbatch = {k: _t(v) for k, v in batch.items()}
    names = [n for n, p in state["params"].items() if p.requires_grad]
    loss, aux = loss_fn(tbatch)
    grads = torch.autograd.grad(loss, [state["params"][n] for n in names])
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    state, metrics = make_train_step(loss_fn, opt)(
        state, tbatch, torch.Generator().manual_seed(0), lr)
    return loss, dict(zip(names, grads)), before, state, metrics


@pytest.mark.parametrize("pool,img", [("cls", 224), ("token_mix", 48)])
def test_vit_full_finetune_step_matches_jax(pool, img):
    """One full fine-tune step at 197 tokens (route (b): B6 + B2/B5 on the
    card) and at 10 (the fused halves, B1/B4 + B2/B5): the loss to 1e-5,
    every gradient to rel-L2 1e-4, the updated parameters to 1e-5; every
    parameter trains (cls_token and pos_embed too, as in the JAX
    optimizer, which freezes only leaves named pos_emb)."""
    jvit, jparams, port = _pair(pool, img, seed=1)
    batch = _batch(img, 2)
    want_loss, want_g, want_p, trainable = _jax_step(jvit, jparams, batch,
                                                     (), 1e-5)
    loss, grads, before, state, metrics = _port_step(port, batch, False, 1e-5)
    assert all(jax.tree_util.tree_leaves(trainable))
    assert sorted(grads) == sorted(port.state_dict())
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    want_g = convert.jax_params_to_state_dict(_tree_np(want_g), port)
    for n, g in grads.items():
        err = ((g - want_g[n]).norm() / want_g[n].norm()).item()
        assert err <= 1e-4, (n, err)
    assert metrics["logits"].shape == (3, CLASSES)
    want_p = convert.jax_params_to_state_dict(_tree_np(want_p), port)
    for n, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=n)
        assert not torch.equal(p, before[n]), n


def test_vit_linear_probe_step_changes_only_the_head():
    """The linear probe at 197 tokens: the config freezes every name but
    the head, the encoder runs grad-free, and one step changes head.* alone;
    its loss, head gradients and update match the JAX model and optimizer
    with the same leaves frozen."""
    from mirage_tpu_torch.api.fm_configs import ViTBaseClsFM, ViTLargeClsFM

    assert ViTLargeClsFM(True).frozen_paths() == \
        ("cls_token", "pos_embed", "patch_embed", "blocks", "norm")
    assert ViTBaseClsFM(False).frozen_paths() == ()
    jvit, jparams, port = _pair("global", 224, seed=3)
    batch = _batch(224, 4)
    want_loss, want_g, want_p, trainable = _jax_step(
        jvit, jparams, batch, JAX_PROBE_FROZEN, 1e-3)
    assert [k for k, v in trainable.items()
            if all(jax.tree_util.tree_leaves(v))] == ["head"]
    loss, grads, before, state, _ = _port_step(port, batch, True, 1e-3)
    assert sorted(grads) == ["head.bias", "head.weight"]
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    want_g = convert.jax_params_to_state_dict(_tree_np(want_g), port)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), atol=ATOL,
                                   rtol=1e-4, err_msg=n)
    want_p = convert.jax_params_to_state_dict(_tree_np(want_p), port)
    changed = sorted(n for n, p in state["params"].items()
                     if not torch.equal(p, before[n]))
    assert changed == ["head.bias", "head.weight"]
    for n, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=n)


def test_vit_step_routes(monkeypatch):
    """At 197 tokens the full fine-tune step runs B6 and B2 forward and
    their backwards (B5 under the default switches), the linear probe and
    the eval forward the fused halves B1 + B2 with no backward: the routes
    chip_smoke.py's launch counts assume."""
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_mlp as fm

    calls = []
    for mod, name in ((fm, "_mlp_fwd"), (fm, "_mlp_bwd"),
                      (fm, "_mlp_bwd_acc"), (ba, "_block_attn_fwd"),
                      (ba, "_block_attn_bwd"), (ba, "_attn_half_fwd"),
                      (ba, "_attn_half_bwd")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    batch = _batch(224, 5, b=8)  # at batch 3 the MLP backward takes B7
    for probe, want in ((False, ["_block_attn_fwd", "_mlp_fwd"] * 2
                         + ["_mlp_bwd", "_block_attn_bwd"] * 2),
                        (True, ["_attn_half_fwd", "_mlp_fwd"] * 2)):
        _, _, port = _pair("cls", 224, seed=6)
        calls.clear()
        _port_step(port, batch, probe, 1e-5)
        # the step's loss runs twice: once for the grads, once in the step
        assert calls == want * 2, (probe, calls)
    calls.clear()
    with torch.no_grad():
        port(_t(batch["images"]))
    assert calls == ["_attn_half_fwd", "_mlp_fwd"] * 2


def test_jax_baseline_train_path_faults():
    """Queue C fault 9, pinned on the JAX package as it stands: its CLI's
    loss calls the baseline's apply with frozen_encoder, which
    _BaselineViTCls.apply lacks (a TypeError at the first step), and its
    linear probe's frozen_paths ("model", "norm") freeze only the final
    norm of the ViT pytree: 18 of 20 leaves stay trainable."""
    from mirage_tpu.api.fm_configs import _BaselineViTCls
    from mirage_tpu.models.vit import VisionTransformer as JaxViT
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg

    jvit = JaxViT(num_classes=3, img_size=32, **NARROW)
    params = jvit.init_params(jax.random.PRNGKey(0))
    cls = _BaselineViTCls(jvit, params)
    x = jnp.zeros((1, 3, 32, 32), jnp.float32)
    with pytest.raises(TypeError, match="frozen_encoder"):
        cls.apply(params, x, deterministic=False, rng=jax.random.PRNGKey(0),
                  frozen_encoder=True)
    trainable = jax.tree_util.tree_leaves(JaxOpt(JaxCfg(
        frozen_paths=("model", "norm"), **OPT)).meta(params)["trainable"])
    assert (sum(trainable), len(trainable)) == (18, 20)


# -------------------------------------------------------- checkpoints

@pytest.mark.parametrize("orig,new", [(14, 32), (14, 7), (2, 3)])
def test_interpolate_vit_pos_embed_matches_jax_and_torch(orig, new):
    """Against the JAX function (1e-5) and F.interpolate bicubic,
    align_corners=False (1e-4); the cls token kept; the identity at the
    same grid; a non-square count refused."""
    import torch.nn.functional as F

    from mirage_tpu.api.convert import interpolate_vit_pos_embed as jax_fn

    d = 32
    arr = np.random.default_rng(orig * new).standard_normal(
        (1, 1 + orig * orig, d)).astype(np.float32)
    got = convert.interpolate_vit_pos_embed(arr, new)
    assert got.shape == (1, 1 + new * new, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_fn(arr, new), atol=1e-5, rtol=1e-5)
    grid = torch.from_numpy(arr[:, 1:]).reshape(1, orig, orig, d)
    want = F.interpolate(grid.permute(0, 3, 1, 2), size=(new, new),
                         mode="bicubic", align_corners=False)
    want = want.permute(0, 2, 3, 1).reshape(1, -1, d).numpy()
    np.testing.assert_array_equal(got[:, :1], arr[:, :1])
    np.testing.assert_allclose(got[:, 1:], want, atol=1e-4)
    np.testing.assert_array_equal(convert.interpolate_vit_pos_embed(arr, orig),
                                  arr)
    with pytest.raises(ValueError, match="not square"):
        convert.interpolate_vit_pos_embed(arr[:, :-1], new)


@pytest.mark.parametrize("suffix", [".safetensors", ".pth"])
@pytest.mark.parametrize("size,classes", [(224, CLASSES), (224, 3),
                                          (512, 3)])
def test_baseline_loads_a_timm_checkpoint(tmp_path, monkeypatch, suffix,
                                          size, classes):
    """A timm-keyed 224-grid checkpoint through ViTBaseClsFM.build_model:
    every tensor loaded as it is, the head kept fresh when the class counts
    differ, pos_embed resized to 512's 32² grid; the loaded model's forward
    against the JAX ViT on the JAX package's own load of the same file
    (params_from_torch, its head and pos_embed rules)."""
    from mirage_tpu.api.fm_configs import BaselineViTClsFM as JaxFM
    from mirage_tpu.models import vit as jax_vit
    from mirage_tpu_torch.api.fm_configs import ViTBaseClsFM

    monkeypatch.setitem(port_vit.vit_factory, "vit_base_patch16",
                        _narrow_factory)
    monkeypatch.setitem(jax_vit.vit_factory, "vit_base_patch16",
                        lambda num_classes, **kw: jax_vit.VisionTransformer(
                            num_classes=num_classes, **NARROW, **kw))
    path = tmp_path / f"vit_base_ckpt{suffix}"
    sd = _timm_checkpoint(path, 224, seed=7)
    fm = ViTBaseClsFM(linear_probing=False)
    fresh = _narrow_factory(classes, img_size=size, pool="global",
                            device="cpu").state_dict()
    model = fm.build_model(num_classes=classes, pool="global",
                           weights=str(path), input_size=size, device="cpu")
    got = model.state_dict()
    assert got["pos_embed"].shape == (1, 1 + (size // 16) ** 2, 64)
    for k, v in got.items():
        if k.startswith("head."):
            want = sd[k] if classes == CLASSES else fresh[k]
        elif k == "pos_embed":
            want = torch.from_numpy(convert.interpolate_vit_pos_embed(
                sd[k], size // 16))
        else:
            want = sd[k]
        assert torch.equal(v, want), k
    if suffix == ".pth":  # the JAX package reads .pth through torch
        jfm = JaxFM(linear_probing=False)
        jcls = jfm.build_model(num_classes=classes, pool="global",
                               weights=str(path), input_size=size,
                               patch_size=16)
        if classes != CLASSES:  # each keeps its own fresh head: JAX's here
            with torch.no_grad():
                model.head.weight.copy_(_t(np.asarray(
                    jcls.params["head"]["w"]).T))
                model.head.bias.copy_(_t(np.asarray(jcls.params["head"]["b"])))
        x = np.random.default_rng(size).random((2, 3, size, size),
                                               dtype=np.float32)
        with torch.no_grad():
            out = model(_t(x)).numpy()
        np.testing.assert_allclose(out, np.asarray(jcls.apply(jcls.params, x)),
                                   atol=ATOL, rtol=ATOL)


def test_baseline_partial_checkpoint_keeps_fresh_weights(tmp_path,
                                                         monkeypatch, capsys):
    """A checkpoint missing a block's key, or holding a tensor of another
    width, prints the JAX package's message and leaves the fresh weights;
    an absent file too (without a message); --model_override is refused."""
    from mirage_tpu_torch.api.fm_configs import ViTLargeClsFM

    monkeypatch.setitem(port_vit.vit_factory, "vit_large_patch16",
                        _narrow_factory)
    sd = _timm_checkpoint(tmp_path / "full.pth", 224, seed=8)
    fresh = _narrow_factory(CLASSES, pool="cls", device="cpu").state_dict()
    fm = ViTLargeClsFM()
    bad_width = dict(sd, **{"norm.weight": torch.ones(32)})
    partial = {k: v for k, v in sd.items() if k != "blocks.1.mlp.fc1.bias"}
    for name, bad in (("partial", partial), ("width", bad_width)):
        path = tmp_path / f"vit_large_{name}.safetensors"
        convert.save_safetensors(bad, str(path))
        model = fm.build_model(num_classes=CLASSES, pool="cls",
                               weights=str(path), device="cpu")
        assert ">> baseline ViT: partial/absent weights (" in \
            capsys.readouterr().out
        for k, v in model.state_dict().items():
            assert torch.equal(v, fresh[k]), (name, k)
    model = fm.build_model(num_classes=CLASSES, pool="cls",
                           weights=str(tmp_path / "vit_large_none.pth"),
                           device="cpu")
    assert capsys.readouterr().out == ""
    assert all(torch.equal(v, fresh[k]) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="model_override"):
        fm.build_model(num_classes=3, pool="cls", weights="", device="cpu",
                       model_override="miragepre_tiny")


def test_pick_fm_on_baseline_names():
    """vit_base / vit_large names pick the baselines (224², ImageNet
    normalisation, the lr of each mode), in the JAX registry's order."""
    from mirage_tpu.api.fm_configs import cls_fm_factory as jax_factory
    from mirage_tpu.api.fm_configs import pick_fm as jax_pick
    from mirage_tpu_torch.api.fm_configs import cls_fm_factory, pick_fm

    assert list(cls_fm_factory) == list(jax_factory)
    for name, cls in (("/w/vit_base_patch16_224.pth", "ViTBaseClsFM"),
                      ("/w/ViT_Large_x.safetensors", "ViTLargeClsFM"),
                      ("MIRAGE-Base.pth", "MIRAGEBaseClsFM")):
        for probe in (True, False):
            fm, jfm = (pick_fm(cls_fm_factory, name, linear_probing=probe),
                       jax_pick(jax_factory, name, linear_probing=probe))
            assert type(fm).__name__ == type(jfm).__name__ == cls
            assert (fm.norm, fm.default_input_size, fm.lr) == \
                (jfm.norm, jfm.default_input_size, jfm.lr)
    fm = pick_fm(cls_fm_factory, "vit_large.pth")
    assert (fm.norm, fm.default_input_size) == ("imagenet", 224)
    assert fm.build_transform(train=False, input_size=32)(
        np.zeros((40, 56), np.uint8), np.random.default_rng(0)).shape == \
        (3, 32, 32)


# ------------------------------------------------------- the command line

def _class_folder(root, rng):
    """Three classes of non-square uint8 .npy B-scans: 4 train, 2 val and 1
    test image each."""
    for split, n in (("train", 4), ("val", 2), ("test", 1)):
        for c in ("AMD", "DME", "NORMAL"):
            d = root / "OCTX" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                np.save(d / f"{c}_{i}.npy",
                        (rng.random((40, 56)) * 255).astype(np.uint8))


def _cli_argv(tmp_path, weights, size=32):
    return ["--data_root", str(tmp_path / "data"), "--data_set", "OCTX",
            "--weights", str(weights), "--input_size", str(size),
            "--batch_size", "4", "--pool", "cls", "--dtype", "float32",
            "--epochs", "2", "--max_steps_per_epoch", "2", "--num_workers",
            "0", "--output_dir", str(tmp_path / "out"), "--device", "cpu"]


def test_run_cls_tuning_cli_with_a_baseline(tmp_path, monkeypatch):
    """ViT-L (narrowed) from a timm-keyed checkpoint named vit_large through
    the entry point: two epochs of two steps, checkpoint-best, the three
    CSVs, --eval from the best checkpoint and --save_predictions; then a
    linear probe whose best checkpoint differs from the start only in the
    head."""
    from mirage_tpu_torch.cli import run_cls_tuning

    monkeypatch.setitem(port_vit.vit_factory, "vit_large_patch16",
                        _narrow_factory)
    _class_folder(tmp_path / "data", np.random.default_rng(16))
    weights = tmp_path / "vit_large_tiny.safetensors"
    sd = _timm_checkpoint(weights, 224, seed=9, classes=1000)
    argv = _cli_argv(tmp_path, weights)
    stats = run_cls_tuning.main(argv)
    run = next((tmp_path / "out" / "v1" / "0" / "OCTX").iterdir())
    assert run.name.startswith("ViTLargeClsFM_finetune_")
    assert (run / "checkpoint-best").is_dir()
    rows = (run / "train_eval.csv").read_text().splitlines()
    assert rows[0] == "Epoch,Loss,BAcc,F1-score" and len(rows) == 3
    assert all(np.isfinite(float(r.split(",")[1])) for r in rows[1:])
    assert len((run / "valid_eval.csv").read_text().splitlines()) == 3
    assert stats["epoch"] == "Best" and 0.0 <= stats["bacc"] <= 1.0
    assert run_cls_tuning.main(argv + ["--eval"])["bacc"] == stats["bacc"]
    assert run_cls_tuning.main(argv + ["--save_predictions"]) is None
    with np.load(run / "predictions.npz") as z:
        assert z["prediction_list"].shape == (3, 3)

    run_cls_tuning.main(argv + ["--linear_probing", "--epochs", "1"])
    probe = next(p for p in (tmp_path / "out" / "v1" / "0" / "OCTX").iterdir()
                 if p.name.startswith("ViTLargeClsFM_linear_"))
    best = torch.load(probe / "checkpoint-best" / "checkpoint.pth",
                      weights_only=False)["params"]
    start = dict(sd, pos_embed=torch.from_numpy(
        convert.interpolate_vit_pos_embed(sd["pos_embed"], 2)))
    for k, v in best.items():
        assert torch.equal(v, start[k]) == (not k.startswith("head.")), k


def test_vit_modules_import_neither_jax_nor_mirage_tpu(tmp_path):
    """In a fresh interpreter the ViT, the extended api modules and the cls
    entry point import neither JAX nor the JAX package, and a narrow ViT
    runs its forward on the CPU; the default device is the card, which
    raises without one."""
    code = (
        "import sys, torch\n"
        "from mirage_tpu_torch.models.vit import VisionTransformer\n"
        "from mirage_tpu_torch.api import convert, fm_configs\n"
        "from mirage_tpu_torch.cli import run_cls_tuning\n"
        f"m = VisionTransformer(3, img_size=32, device='cpu', **{NARROW!r})\n"
        "assert m(torch.zeros(2, 3, 32, 32)).shape == (2, 3)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'mirage_tpu', 'safetensors')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    VisionTransformer(3, img_size=32)\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e)\n"
        "else:\n"
        "    raise AssertionError('the default device did not raise')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
