"""The PyTorch port's classification-tuning slice (mirage_tpu_torch) against
the JAX package: the metrics, the transforms, the class folder, early
stopping, the loss, the cls model's three poolers, one full fine-tune step
and one linear-probe step, the optimizer with the fused AdamW update (B11)
off and on, B11's and the accumulating backwards' (B7) plain versions
against the interpreted Pallas kernels, the routes the step takes under the
switches, and the command line.

Everything runs on the CPU in float32, where each op takes its plain
PyTorch version. Inputs are made with numpy; weights come from one
checkpoint that both packages load, the head carried across with
jax_params_to_state_dict. Tolerances: 1e-12 for the metrics (the same
float64 arithmetic as sklearn, summed in another order), bit-equality for
the transforms (the same numpy and scipy calls), 1e-5 where both compute
the same float32 math in another order, 1e-4 relative L2 for the gradients
of a whole step, rtol 1e-6 for the optimizer (elementwise float32), and the
atol 5e-4 / rtol 1e-3 tests/test_flash_attention.py holds the Pallas
backwards to.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.api.wrapper import build_model
from mirage_tpu_torch.ops import runtime

ROOT = Path(__file__).resolve().parents[1]
DOMAINS = ["bscan", "slo", "bscanlayermap"]
# tiny widths; 128² at patch 8 gives 256 + 1 tokens, the classification
# encoder's length (above 128: the unfused attention half, B6 + B2/B5)
ARGS = dict(model="miragepre_tiny", in_domains=DOMAINS, out_domains=["bscan"],
            dim_tokens=64, depth=2, num_heads=2, decoder_dim=32,
            decoder_depth=1, decoder_num_heads=2)
SIZE, PATCH, CLASSES = 128, 8, 4
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A tiny three-modality pretraining checkpoint named as MIRAGE-Base."""
    path = tmp_path_factory.mktemp("cls") / "mirage-base_tiny.pth"
    torch.save({"model": build_model(
        "miragepre_tiny", ARGS, DOMAINS, SIZE, PATCH,
        generator=torch.Generator().manual_seed(3)).state_dict(),
        "args": ARGS}, path)
    return str(path)


def _models(weights, pool):
    """The JAX and the port's cls model with the same weights."""
    from mirage_tpu.api.cls import miragecls_factory as jax_factory
    from mirage_tpu_torch.api.cls import miragecls_factory

    kw = dict(num_classes=CLASSES, input_size=SIZE, patch_size=PATCH,
              weights=weights, model_override="miragepre_tiny")
    jcls = jax_factory[pool](**kw)
    port = miragecls_factory[pool](device="cpu", **kw)
    port.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jcls.params), port), strict=True)
    return jcls, port


# ---------------------------------------------------------------- metrics

def _scores(rng, n, c, levels):
    """Scores on a coarse grid (ties within and across classes), rows
    normalised, every class present in the labels."""
    p = np.round(rng.random((n, c)) * levels) / levels + 1e-3
    p = (p / p.sum(1, keepdims=True)).astype(np.float32)
    y = np.concatenate([np.arange(c), rng.integers(0, c, n - c)])
    return rng.permutation(y), p


@pytest.mark.parametrize("c", [2, 4, 7])
@pytest.mark.parametrize("levels", [3, 1000])
def test_cls_metrics_match_sklearn(c, levels):
    from mirage_tpu.metrics.classification import \
        compute_cls_metrics as jax_metrics
    from mirage_tpu_torch.metrics.classification import compute_cls_metrics

    y, p = _scores(np.random.default_rng(c * levels), 61, c, levels)
    got = compute_cls_metrics(y, p, loss=0.5, epoch=3)
    want = jax_metrics(y, p, loss=0.5, epoch=3)
    assert list(got) == list(want)
    for k in ("bacc", "auroc", "ap", "f1", "mcc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert (got["epoch"], got["loss"]) == (3, 0.5)


@pytest.mark.filterwarnings("ignore")
def test_cls_metrics_absent_class_and_bad_label():
    """A class absent from the labels weighs nothing (its AUROC and AP are
    undefined; sklearn warns and gives NaN or 0, not an error), and a lone
    class makes the AUROC NaN; a label outside the scores' classes
    raises in both packages."""
    from mirage_tpu.metrics.classification import \
        compute_cls_metrics as jax_metrics
    from mirage_tpu_torch.metrics.classification import compute_cls_metrics

    rng = np.random.default_rng(5)
    p = rng.random((20, 3)).astype(np.float32)
    for y in (rng.integers(0, 2, 20), np.zeros(20, np.int64)):
        got, want = compute_cls_metrics(y, p), jax_metrics(y, p)
        for k in ("bacc", "auroc", "ap", "f1", "mcc"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    y = np.array([0, 1, 3] * 5)
    for fn in (compute_cls_metrics, jax_metrics):
        with pytest.raises(IndexError):
            fn(y, p[:15])


def test_train_epoch_metrics_match_sklearn():
    from sklearn.metrics import balanced_accuracy_score, f1_score

    from mirage_tpu_torch.metrics.classification import (balanced_accuracy,
                                                         weighted_f1)

    rng = np.random.default_rng(6)
    y, yh = rng.integers(0, 5, 40), rng.integers(0, 6, 40)
    with pytest.warns(UserWarning):
        want_b = balanced_accuracy_score(y, yh)
    np.testing.assert_allclose(balanced_accuracy(y, yh), want_b, atol=1e-12)
    np.testing.assert_allclose(
        weighted_f1(y, yh),
        f1_score(y, yh, average="weighted", zero_division=0.0), atol=1e-12)


# ------------------------------------------------------------- transforms

def _assert_cls_transform_bit_equal(train, fill, norm):
    from mirage_tpu.data.augment import ClsTransform as JaxTransform
    from mirage_tpu_torch.data.augment import ClsTransform

    rng = np.random.default_rng(7)
    for img in ((rng.random((70, 90)) * 255).astype(np.uint8),
                rng.random((50, 40, 3)).astype(np.float32)):
        for seed in range(4):
            kw = dict(input_size=48, train=train, norm=norm, fill=fill)
            got = ClsTransform(**kw)(img, np.random.default_rng(seed))
            want = JaxTransform(**kw)(img, np.random.default_rng(seed))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fill,norm", [(0.0, "minmax"), (1.0, "minmax"),
                                       (0.5, "minmax"), (0.0, "imagenet")])
def test_cls_transform_is_bit_equal(monkeypatch, train, fill, norm):
    """One Generator seed, the same image in both packages: the port's
    plain path (resize_np_ref, affine_warp_ref) against the JAX package
    with its C++ library patched off (its numpy/scipy path)."""
    from mirage_tpu.utils import native
    from mirage_tpu_torch.data import augment

    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(augment, "resize_np", augment.resize_np_ref)
    monkeypatch.setattr(augment, "affine_warp", augment.affine_warp_ref)
    _assert_cls_transform_bit_equal(train, fill, norm)


@pytest.mark.parametrize("train", [False, True])
def test_cls_transform_with_the_library_is_bit_equal(monkeypatch, tmp_path,
                                                     train):
    """The port through its host library against the JAX package through
    its own, native/fastops.cpp compiled into a temporary directory."""
    from test_torch_fastops import jax_fastops

    from mirage_tpu.utils import native

    lib = jax_fastops(tmp_path)
    monkeypatch.setattr(native, "_load", lambda: lib)
    for fill, norm in ((0.5, "minmax"), (0.0, "imagenet")):
        _assert_cls_transform_bit_equal(train, fill, norm)


def test_cls_norms_match_jax():
    from mirage_tpu.data.augment import minmax_norm as jax_minmax
    from mirage_tpu.data.augment import naive_norm as jax_naive
    from mirage_tpu.data.augment import to_rgb as jax_rgb
    from mirage_tpu_torch.data.augment import minmax_norm, naive_norm, to_rgb

    rng = np.random.default_rng(18)
    for img in (rng.random((1, 9, 7)), rng.random((9, 7)) * 255,
                rng.random((2, 9, 7)) * 60000):
        np.testing.assert_array_equal(naive_norm(img), jax_naive(img))
        np.testing.assert_array_equal(to_rgb(img), jax_rgb(img))
        np.testing.assert_array_equal(minmax_norm(img[None]),
                                      jax_minmax(img[None]))
        np.testing.assert_array_equal(minmax_norm(img, per_channel=False),
                                      jax_minmax(img, per_channel=False))


# -------------------------------------------------- small host modules

def test_image_folder_and_early_stopping_match_jax(tmp_path):
    from mirage_tpu.data.folder import ImageFolder as JaxFolder
    from mirage_tpu.train.early_stop import EarlyStopping as JaxEarly
    from mirage_tpu_torch.data.folder import ImageFolder
    from mirage_tpu_torch.train.early_stop import EarlyStopping

    rng = np.random.default_rng(8)
    for c, n in (("NORMAL", 3), ("AMD", 2), ("DME", 1)):
        (tmp_path / c / "sub").mkdir(parents=True)
        for i in range(n):
            np.save(tmp_path / c / ("sub" if i else "") / f"{c}{i}.npy",
                    rng.random((6, 5)))
    (tmp_path / "NORMAL" / "notes.txt").write_text("not an image")
    got, want = ImageFolder(str(tmp_path)), JaxFolder(str(tmp_path))
    assert got.classes == want.classes and got.num_classes == 3
    assert got.paths == want.paths
    np.testing.assert_array_equal(got.targets, want.targets)
    for i in range(len(got)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]

    seq = [(0.5, 1.0), (0.6, 0.9), (0.6, 0.8), (0.6, 0.95), (0.55, 0.7),
           (0.6, 0.8), (0.7, 1.2), (0.65, 0.5), (0.6, 0.4), (0.7, 1.1),
           (0.7, 1.3)]
    for kw in (dict(patience=2, delta=0.0, greater_is_better=True,
                    greater_is_better_two=False, start_from=3),
               dict(patience=3, delta=0.05, delta_two=0.1)):
        a, b = EarlyStopping(**kw), JaxEarly(**kw)
        for epoch, (v, v2) in enumerate(seq):
            assert a(v, v2, epoch) == b(v, v2, epoch)
            assert (a.counter, a.early_stop, a.best_value) == \
                (b.counter, b.early_stop, b.best_value)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_cross_entropy_matches_jax(smoothing, weighted, normalize):
    from mirage_tpu.losses.gdice import cross_entropy_loss as jax_ce
    from mirage_tpu_torch.losses.gdice import cross_entropy_loss

    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 5, 1, 1)).astype(np.float32) * 3
    target = rng.integers(0, 5, (6, 1, 1)).astype(np.int32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    got = cross_entropy_loss(_t(logits), _t(target), label_smoothing=smoothing,
                             weights=None if w is None else _t(w),
                             normalize=normalize)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(target),
                  label_smoothing=smoothing,
                  weights=None if w is None else jnp.asarray(w),
                  normalize=normalize)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.item(), float(wv), rtol=1e-6, atol=1e-6)


def test_schedule_and_args_hash_match_jax():
    from mirage_tpu.cli.config import args_hash as jax_hash
    from mirage_tpu.train.schedules import adjust_learning_rate as jax_lr
    from mirage_tpu_torch.cli.config import args_hash
    from mirage_tpu_torch.train.schedules import adjust_learning_rate

    for e in (0.0, 2.5, 5.0, 17.25, 49.9):
        assert adjust_learning_rate(1e-5, 1e-6, e, 50, 5) == \
            jax_lr(1e-5, 1e-6, e, 50, 5)
    ns = argparse.Namespace(lr=1e-5, pool="global", fill=0.5, weights="w.pth",
                            output_dir="x", device="cuda")
    assert args_hash(ns) == jax_hash(ns)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("pool", ["global", "cls", "token_mix"])
def test_cls_forward_matches_jax(weights, pool):
    jcls, port = _models(weights, pool)
    x = np.random.default_rng(10).random((2, 1, SIZE, SIZE), np.float32)
    want = np.asarray(jcls(x))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_cls_checkpoint_round_trip(weights, tmp_path):
    """A reference-layout cls checkpoint (model.*, norm.*, head.*) loads
    into the port and into the JAX package alike; the port's wrapper takes
    the bscan adapter out of a three-modality checkpoint (ROADMAP queue C,
    fault 4)."""
    from mirage_tpu.api.cls import miragecls_factory as jax_factory
    from mirage_tpu_torch.api.cls import miragecls_factory

    _, port = _models(weights, "token_mix")
    path = tmp_path / "cls.pth"
    torch.save({"model": port.state_dict()}, path)
    kw = dict(num_classes=CLASSES, input_size=SIZE, patch_size=PATCH,
              weights=weights, model_override="miragepre_tiny")
    other = miragecls_factory["token_mix"](
        device="cpu", head_generator=torch.Generator().manual_seed(1), **kw)
    assert set(other.state_dict()) == set(port.state_dict())
    assert not any(k.startswith("model.input_adapters.slo")
                   for k in other.state_dict())
    other.load_cls_checkpoint(str(path))
    jcls = jax_factory["token_mix"](**kw).load_cls_checkpoint(str(path))
    x = np.random.default_rng(11).random((1, 1, SIZE, SIZE), np.float32)
    with torch.no_grad():
        got = other(_t(x)).numpy()
        assert np.array_equal(got, port(_t(x)).numpy())
    np.testing.assert_allclose(got, np.asarray(jcls(x)), atol=ATOL, rtol=ATOL)


# ------------------------------------------------------------ train steps

def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((b, 1, SIZE, SIZE), dtype=np.float32),
            "targets": rng.integers(0, CLASSES, b).astype(np.int64),
            "weights": np.array([1.0] * (b - 1) + [0.0], np.float32)}


def _jax_loss(jcls, jopt, linear_probing):
    from mirage_tpu.losses.gdice import cross_entropy_loss as jax_ce

    def loss_fn(params, batch):
        logits = jcls.apply(jopt.stop_frozen(params), batch["images"],
                            deterministic=False, rng=jax.random.PRNGKey(0),
                            frozen_encoder=linear_probing)
        s, w = jax_ce(logits[..., None, None],
                      batch["targets"][..., None, None],
                      label_smoothing=0.1, weights=batch["weights"],
                      normalize=False)
        return s / jnp.maximum(w, 1.0)
    return loss_fn


@pytest.mark.parametrize("linear_probing", [False, True])
def test_cls_step_matches_jax(weights, linear_probing):
    """One full fine-tune step (loss to 1e-5, every trainable grad to rel-L2
    1e-4, the update to 1e-5) and one linear-probe step (the head alone
    changes, as in the JAX step) with a zero-weight padding row."""
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_cls_loss,
                                              make_train_step)

    jcls, port = _models(weights, "global")
    kw = dict(opt="adamw", betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
              frozen_paths=("model", "norm") if linear_probing else ())
    jopt = JaxOpt(JaxCfg(**kw))
    batch = _batch(12)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = _jax_loss(jcls, jopt, linear_probing)
    want_loss, want_g = jax.value_and_grad(jloss)(jcls.params, jbatch)
    lr = 1e-3 if linear_probing else 1e-5
    jparams, _, _ = jopt.update(want_g, jopt.init(jcls.params), jcls.params,
                                lr)

    opt = GroupedOptimizer(OptimizerConfig(**kw))
    state = init_train_state(port, opt)
    loss_fn = make_cls_loss(port, 0.1, frozen_encoder=linear_probing)
    tbatch = {k: _t(v) for k, v in batch.items()}
    names = [n for n, p in state["params"].items() if p.requires_grad]
    if linear_probing:
        assert names == ["head.weight", "head.bias"]
    else:
        assert "model.encoder.1.mlp.fc1.weight" in names \
            and "model.input_adapters.bscan.pos_emb" not in names
    loss, aux = loss_fn(tbatch)
    assert aux["logits"].shape == (3, CLASSES)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL,
                               rtol=ATOL)
    grads = torch.autograd.grad(loss, [state["params"][n] for n in names])
    want_g = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_g), port)
    for n, g in zip(names, grads):
        err = ((g - want_g[n]).norm() / want_g[n].norm()).item()
        assert err <= 1e-4, (n, err)

    before = {n: p.detach().clone() for n, p in state["params"].items()}
    state, metrics = make_train_step(loss_fn, opt)(
        state, tbatch, torch.Generator().manual_seed(0), lr)
    assert metrics["logits"].shape == (3, CLASSES)
    want_p = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams), port)
    for n, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=n)
        assert torch.equal(p, before[n]) == (n not in names), n


def test_cls_step_routes(weights, monkeypatch):
    """The full fine-tune step at 257 tokens runs B6, B2 and B5 under the
    default switches; with MIRAGE_MLP_BWD=accumulate and
    MIRAGE_OPT_KERNEL=on its MLP backwards take B7 and its large leaves
    B11 (the leaf minimum lowered so that the tiny leaves count)."""
    from mirage_tpu_torch.ops import block_attention as ba
    from mirage_tpu_torch.ops import fused_adamw as fa
    from mirage_tpu_torch.ops import fused_mlp as fm
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import (init_train_state, make_cls_loss,
                                              make_train_step)

    calls = []
    for mod, name in ((fm, "_mlp_fwd"), (fm, "_mlp_bwd"),
                      (fm, "_mlp_bwd_acc"), (ba, "_block_attn_fwd"),
                      (ba, "_block_attn_bwd"), (ba, "_attn_half_fwd")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(fa, "MIN_ELEMS", 8192)
    _, port = _models(weights, "global")
    opt = GroupedOptimizer(OptimizerConfig(opt="adamw", betas=(0.9, 0.999),
                                           weight_decay=1e-2))
    state = init_train_state(port, opt)
    step = make_train_step(make_cls_loss(port), opt)
    # at batch 8 the JAX package's default backward flattens the 8 × 257
    # rows (B5); at batch 3 neither 771 rows nor 3 × 272 padded ones admit
    # a block and it runs its per-element accumulating kernel (B7)
    batch = {k: _t(v) for k, v in _batch(13, b=8).items()}
    assert fm.takes_accumulating_bwd(torch.empty(3, SIZE ** 2 // PATCH ** 2
                                                 + 1, 64), 256)
    want_routed = sum(1 for n, p in state["params"].items()
                      if p.requires_grad and p.numel() >= 8192
                      and "pos_emb" not in n)
    for switches, bwd, routed in (
            ({}, "_mlp_bwd", 0),
            ({"MIRAGE_MLP_BWD": "accumulate", "MIRAGE_OPT_KERNEL": "on"},
             "_mlp_bwd_acc", want_routed)):
        calls.clear()
        with runtime.switched(switches):
            step(state, batch, None, 1e-5)
        assert sorted(set(calls)) == sorted(
            {"_mlp_fwd", bwd, "_block_attn_fwd", "_block_attn_bwd"})
        assert calls.count(bwd) == calls.count("_mlp_fwd") == 2
        assert fa.fused_adamw.last_routed_count == routed
    assert want_routed == 6  # per layer qkv, fc1 and fc2 (≥ 8192 elements)
    with torch.no_grad():  # eval forwards: the fused halves B1 + B2
        calls.clear()
        port(batch["images"])
    assert calls == ["_attn_half_fwd", "_mlp_fwd"] * 2


@pytest.mark.parametrize("b,n,d", [(64, 257, 768), (256, 99, 768),
                                   (3, 33, 48), (3, 257, 64), (8, 257, 64),
                                   (64, 33, 32)])
def test_unaligned_backward_routes_match_jax(b, n, d):
    """_route_unaligned_bwd, copied from the JAX package, with the
    accumulating kernel's and the de-fused kernel's coefficients."""
    from mirage_tpu.ops.fused_mlp import _DEFUSED_ROW_UNIT
    from mirage_tpu.ops.fused_mlp import _route_unaligned_bwd as jax_route
    from mirage_tpu_torch.ops import fused_mlp as fm

    for coef in ((18, 12), (_DEFUSED_ROW_UNIT, 4)):
        assert fm._route_unaligned_bwd(b, n, d, 4 * d, *coef) == \
            jax_route(b, n, d, 4 * d, *coef)
    assert fm._DEFUSED_ROW_UNIT == _DEFUSED_ROW_UNIT


# -------------------------------------------------------------- optimizer

def _opt_trees(rng):
    """Leaves above the fused minimum, one of them (300 × 450) not a
    multiple of the TPU kernel's 128 lanes, and a bias that stays on the
    foreach route: as JAX pytree and as port names."""
    shapes = {"a": (512, 512), "b": (300, 450)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["c"] = rng.standard_normal(7).astype(np.float32)
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    jax_tree = lambda t: {"a": {"w": t["a"]}, "b": {"w": t["b"]},  # noqa
                          "c": {"b": t["c"]}}
    port_tree = lambda t: {"a.weight": _t(t["a"]).clone(),  # noqa: E731
                           "b.weight": _t(t["b"]).clone(),
                           "c.bias": _t(t["c"]).clone()}
    return params, grads, jax_tree, port_tree


@pytest.mark.parametrize("switch", ["off", "on"])
@pytest.mark.parametrize("skip", [None, 1e-3])
def test_optimizer_matches_jax_with_the_fused_update(switch, skip):
    """Two updates from the same grads (clipped; with skip=1e-3 both
    skipped) against JAX's opt.update, the JAX kernel route run in
    interpret mode when the switch is on. The port routes the 300 × 450
    leaf too (it drops the TPU's 128-lane gate), JAX does not: the numbers
    agree either way."""
    from mirage_tpu.ops import fused_adamw as jfa
    from mirage_tpu.ops import runtime as jrt
    from mirage_tpu.train.optim import GroupedOptimizer as JaxOpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig

    params, grads, jax_tree, port_tree = _opt_trees(np.random.default_rng(14))
    kw = dict(opt="adamw", betas=(0.9, 0.999), weight_decay=1e-2,
              clip_grad=1.0, skip_grad=skip)
    jopt, topt = JaxOpt(JaxCfg(**kw)), GroupedOptimizer(OptimizerConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, jax_tree(params))
    js = jopt.init(jp)
    tp = port_tree(params)
    ts = topt.init(tp)
    prev = jfa.enabled()
    jfa.reset_routed_count()
    try:
        jfa.set_enabled(switch == "on")
        with jrt.forced("interpret" if switch == "on" else "auto"), \
                runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
            for g, lr in zip(grads, (1e-2, 5e-3)):
                jp, js, jn = jopt.update(
                    jax.tree_util.tree_map(jnp.asarray, jax_tree(g)), js, jp,
                    lr)
                tn = topt.update(port_tree(g), ts, tp, lr)
                np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    finally:
        jfa.set_enabled(prev)
    assert jfa.last_routed_count() == (2 if switch == "on" else 0)
    assert fused_adamw.last_routed_count == (2 if switch == "on" else 0)
    assert int(ts["count"]) == int(js["count"]) == (0 if skip else 2)
    for key, tree in (("p", jp), ("mu", js["mu"]), ("nu", js["nu"])):
        want = {"a.weight": tree["a"]["w"], "b.weight": tree["b"]["w"],
                "c.bias": tree["c"]["b"]}
        got = tp if key == "p" else ts[key]
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key} {n}")


@pytest.mark.parametrize("gscale,keep", [(1.0, 1.0), (0.25, 1.0), (0.5, 0.0)])
def test_fused_adamw_ref_matches_the_interpreted_kernel(gscale, keep):
    """B11's plain version against fused_adamw_leaf run in interpret mode,
    as tests/test_optim.py runs it; keep = 0 passes m, n and p through
    exactly."""
    from mirage_tpu.ops import fused_adamw as jfa
    from mirage_tpu.ops import runtime as jrt
    from mirage_tpu_torch.ops.fused_adamw import fused_adamw_ref

    rng = np.random.default_rng(15)
    g, m, p = (rng.standard_normal((256, 512)).astype(np.float32)
               for _ in range(3))
    n = rng.random((256, 512)).astype(np.float32) * 1e-3
    sc = dict(gscale=np.float32(gscale), lr_eff=np.float32(1e-3),
              wd_eff=np.float32(0.05), c1=np.float32(1 - 0.9 ** 3),
              c2=np.float32(1 - 0.95 ** 3), keep=np.float32(keep))
    with jrt.forced("interpret"):
        want = jfa.fused_adamw_leaf(
            *(jnp.asarray(a) for a in (g, m, n, p)),
            **{k: jnp.asarray(v) for k, v in sc.items()}, b1=0.9, b2=0.95,
            eps=1e-8)
    tm, tn, tp = _t(m).clone(), _t(n).clone(), _t(p).clone()
    fused_adamw_ref(_t(g), tm, tn, tp, gscale=torch.tensor(sc["gscale"]),
                    lr=1e-3, wd=0.05, c1=torch.tensor(sc["c1"]),
                    c2=torch.tensor(sc["c2"]), keep=torch.tensor(keep),
                    b1=0.9, b2=0.95, eps=1e-8)
    for got, w, orig in zip((tm, tn, tp), want, (m, n, p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
        if keep == 0.0:
            np.testing.assert_array_equal(got.numpy(), orig)


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


def _cli_argv(tmp_path, weights):
    return ["--data_root", str(tmp_path / "data"), "--data_set", "OCTX",
            "--weights", weights, "--model_override", "miragepre_tiny",
            "--input_size", str(SIZE), "--patch_size", str(PATCH),
            "--batch_size", "4",
            "--dtype", "float32", "--epochs", "2", "--max_steps_per_epoch",
            "2", "--num_workers", "0", "--output_dir",
            str(tmp_path / "out"), "--device", "cpu"]


def test_run_cls_tuning_cli_on_the_cpu(tmp_path, weights):
    """Two epochs of 2 steps (batch 4, the last batch of 12 images ragged
    only in the uncut run), validation, checkpoint-best, the three CSVs,
    then --eval and --save_predictions from the best checkpoint."""
    from mirage_tpu_torch.cli import run_cls_tuning

    _class_folder(tmp_path / "data", np.random.default_rng(16))
    argv = _cli_argv(tmp_path, weights)
    stats = run_cls_tuning.main(argv)
    runs = list((tmp_path / "out" / "v1" / "0" / "OCTX").iterdir())
    assert len(runs) == 1 and runs[0].name.startswith(
        "MIRAGEBaseClsFM_finetune_")
    run = runs[0]
    assert (run / "checkpoint-best").is_dir()
    rows = (run / "train_eval.csv").read_text().splitlines()
    assert rows[0] == "Epoch,Loss,BAcc,F1-score" and len(rows) == 3
    assert all(np.isfinite(float(r.split(",")[1])) for r in rows[1:])
    val = (run / "valid_eval.csv").read_text().splitlines()
    assert val[0] == "Epoch,Loss,BAcc,AUROC,AP,F1-score,MCC" and len(val) == 3
    assert stats["epoch"] == "Best" and 0.0 <= stats["bacc"] <= 1.0
    again = run_cls_tuning.main(argv + ["--eval"])
    assert again["bacc"] == stats["bacc"]
    assert (run / "test_eval.csv").read_text().splitlines()[0] == val[0]
    assert run_cls_tuning.main(argv + ["--save_predictions"]) is None
    with np.load(run / "predictions.npz") as z:
        assert z["prediction_list"].shape == (3, 3)
        np.testing.assert_allclose(z["prediction_list"].sum(1), 1, atol=1e-6)


def test_run_cls_tuning_imports_neither_sklearn_nor_pandas(tmp_path, weights):
    """The card's machine has neither: the entry point runs without them
    (and without JAX) in a fresh interpreter; its default device is the
    card, which raises without one."""
    _class_folder(tmp_path / "data", np.random.default_rng(17))
    code = (
        "import sys\n"
        "from mirage_tpu_torch.cli import run_cls_tuning as r\n"
        f"argv = {_cli_argv(tmp_path, weights)!r}\n"
        "r.main(argv[:-2] + ['--epochs', '1'] + argv[-2:])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('sklearn', 'pandas', 'jax', 'mirage_tpu')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    r.main(argv[:-2])\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e)\n"
        "else:\n"
        "    raise AssertionError('the default device did not raise')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
