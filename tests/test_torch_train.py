"""The PyTorch port's pretraining slice (mirage_tpu_torch) against the JAX
package: masking, the token-space losses, one whole pretraining step's loss
and gradients, and the optimizer update.

Everything runs on the CPU in float32 (the port's plain PyTorch path). Inputs
are made with numpy; weights come from one JAX initialisation carried across
with ``jax_params_to_state_dict``, which maps the JAX gradients (and optimizer
moments) the same way. Randomness cannot match across frameworks, so the
masked forward takes the same explicit task masks in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.api.wrapper import MIRAGEWrapper as JaxWrapper
from mirage_tpu.losses.masked import masked_ce_loss_tokens as jax_ce
from mirage_tpu.losses.masked import masked_mse_loss_tokens as jax_mse
from mirage_tpu.masking.masking import masks_to_indices as jax_masks_to_indices
from mirage_tpu.masking.masking import onehot_gather_rows, onehot_scatter_rows
from mirage_tpu.train.optim import GroupedOptimizer as JaxOptimizer
from mirage_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.api.wrapper import build_model
from mirage_tpu_torch.losses.masked import (masked_ce_loss_tokens,
                                            masked_mse_loss_tokens)
from mirage_tpu_torch.masking.masking import (gather_rows,
                                              generate_random_masks,
                                              masks_to_indices, sample_gamma,
                                              scatter_rows)
from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
from mirage_tpu_torch.train.schedules import cosine_scheduler
from mirage_tpu_torch.train.steps import (init_train_state,
                                          make_pretrain_loss, make_train_step)

DOMAINS = ["bscan", "slo", "bscanlayermap"]
# tiny widths: encoder dh 32 at 41 tokens (the fused half-block route),
# decoders dh 16 at 256 tokens (the block_attention route of training)
ARGS = dict(model="miragepre_tiny", num_global_tokens=1, in_domains=DOMAINS,
            out_domains=DOMAINS, dim_tokens=64, depth=2, num_heads=2,
            decoder_dim=32, decoder_depth=1, decoder_num_heads=2)
SIZE, PATCH, N_TASK, NUM_VISIBLE = 256, 16, 256, 40
DOMAIN_CONF = {"bscan": {"loss": "mse", "patch_size": 16, "norm_pix": True},
               "slo": {"loss": "mse", "patch_size": 16, "norm_pix": True},
               "bscanlayermap": {"loss": "ce", "patch_size": 8}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def models():
    """The tiny model in both packages with the same weights."""
    jw = JaxWrapper.__new__(JaxWrapper)
    jw.in_domains = jw.out_domains = DOMAINS
    jw.input_size = {d: (128, 128) if d == "bscanlayermap" else (SIZE, SIZE)
                     for d in DOMAINS}
    jw.patch_size = {d: (8, 8) if d == "bscanlayermap" else (PATCH, PATCH)
                     for d in DOMAINS}
    jmodel = jw._build_model("miragepre_tiny", ARGS, jnp.float32, "auto")
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(5)))
    port = build_model("miragepre_tiny", ARGS, DOMAINS, SIZE, PATCH)
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    return jmodel, params, port


def _batch(seed, b=2):
    """Images, labels and explicit masks (1 = masked) with NUM_VISIBLE
    visible tokens per sample, spread at random over the tasks."""
    rng = np.random.default_rng(seed)
    x = {"bscan": rng.random((b, 1, SIZE, SIZE), dtype=np.float32),
         "slo": rng.random((b, 1, SIZE, SIZE), dtype=np.float32),
         "bscanlayermap": rng.integers(0, 13, (b, 128, 128)).astype(np.int32)}
    mask = np.ones((b, 3 * N_TASK), np.int32)
    for i in range(b):
        mask[i, rng.choice(3 * N_TASK, NUM_VISIBLE, replace=False)] = 0
    masks = {t: mask[:, k * N_TASK:(k + 1) * N_TASK]
             for k, t in enumerate(DOMAINS)}
    return x, masks


# ---------------------------------------------------------------- masking

def test_masks_to_indices_matches_jax():
    _, masks = _batch(1, b=4)
    want = jax_masks_to_indices({t: jnp.asarray(m) for t, m in masks.items()},
                                DOMAINS, NUM_VISIBLE)
    got = masks_to_indices({t: _t(m) for t, m in masks.items()}, DOMAINS,
                           NUM_VISIBLE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("uniform", [False, True])
def test_generate_random_masks_invariants(uniform):
    tokens, b, n_enc = [256, 256, 256], 8, 98

    def draw(seed):
        return generate_random_masks(torch.Generator().manual_seed(seed),
                                     tokens, b, n_enc,
                                     sample_tasks_uniformly=uniform)

    masks, ids_keep, ids_restore = draw(0)
    mask_all = torch.cat(masks, 1)
    assert [m.shape for m in masks] == [(b, n) for n in tokens]
    assert ((1 - mask_all).sum(1) == n_enc).all()  # exactly n_enc visible
    assert (torch.gather(mask_all, 1, ids_keep) == 0).all()
    ids_shuffle = torch.argsort(ids_restore, dim=1)  # ids_restore inverts it
    assert torch.equal(torch.gather(ids_shuffle, 1, ids_restore),
                       torch.arange(sum(tokens)).expand(b, -1))
    assert torch.equal(ids_shuffle[:, :n_enc], ids_keep)
    again, other = draw(0), draw(1)
    assert all(torch.equal(a, c) for a, c in zip(again[0], masks))
    assert not torch.equal(torch.cat(other[0], 1), mask_all)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 2.0])
def test_sample_gamma_moments(alpha):
    """Gamma(α, 1) has mean and variance α (20000 draws: 4 % bars, about
    four standard errors at α = 0.5)."""
    g = sample_gamma(torch.full((20000,), alpha),
                     torch.Generator().manual_seed(3))
    assert (g > 0).all()
    assert abs(g.mean().item() - alpha) < 0.04 * alpha + 0.01
    assert abs(g.var().item() - alpha) < 0.1 * alpha


def test_gather_and_scatter_rows_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    ids = np.stack([rng.permutation(9)[:4] for _ in range(2)])
    fill = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        gather_rows(_t(x), _t(ids)).numpy(),
        np.asarray(onehot_gather_rows(jnp.asarray(x), jnp.asarray(ids))))
    vals = x[:, :4]
    np.testing.assert_allclose(
        scatter_rows(_t(vals), _t(ids), 9, _t(fill)).numpy(),
        np.asarray(onehot_scatter_rows(jnp.asarray(vals), jnp.asarray(ids), 9,
                                       jnp.asarray(fill))), atol=1e-6)


# ----------------------------------------------------------------- losses

@pytest.mark.parametrize("norm_pix", [False, True])
@pytest.mark.parametrize("empty", ["none", "one row", "all rows"])
def test_mse_loss_tokens_matches_jax(norm_pix, empty):
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((3, 16, 64)).astype(np.float32)
    target = rng.random((3, 1, 32, 32), dtype=np.float32)
    mask = (rng.random((3, 16)) < 0.5).astype(np.int32)
    mask[1] = 1  # an all-masked row: the loss over all its tokens
    if empty == "one row":
        mask[0] = 0  # no masked token: the row is left out of the mean
    elif empty == "all rows":
        mask[:] = 0  # nothing masked anywhere: the loss is 0
    pred_t = _t(pred).requires_grad_()
    got = masked_mse_loss_tokens(pred_t, _t(target), _t(mask), patch_size=8,
                                 norm_pix=norm_pix)
    want = jax_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                   patch_size=8, norm_pix=norm_pix)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    (grad,) = torch.autograd.grad(got, pred_t)
    assert torch.isfinite(grad).all()  # the safe denominator
    if empty == "all rows":
        assert got.item() == 0.0


def test_ce_loss_tokens_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 16, 13 * 16)).astype(np.float32)
    target = rng.integers(0, 13, (2, 16, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.5).astype(np.int32)
    for m in (mask, np.zeros_like(mask)):
        got = masked_ce_loss_tokens(_t(logits), _t(target), _t(m),
                                    patch_size=4)
        want = jax_ce(jnp.asarray(logits), jnp.asarray(target),
                      jnp.asarray(m), patch_size=4)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------ whole step

def _jax_loss(jmodel, batch, masks):
    def loss_fn(params):
        preds, _ = jmodel(params, batch, mask_inputs=True, task_masks=masks,
                          num_visible=NUM_VISIBLE, deterministic=False,
                          rng=jax.random.PRNGKey(0), pixel_outputs=False)
        losses = {}
        for task, pred in preds.items():
            conf = DOMAIN_CONF[task]
            if conf["loss"] == "ce":
                losses[task] = jax_ce(pred, batch[task], masks[task],
                                      patch_size=conf["patch_size"])
            else:
                losses[task] = jax_mse(pred, batch[task], masks[task],
                                       patch_size=conf["patch_size"],
                                       norm_pix=conf["norm_pix"])
        return sum(losses.values()), losses
    return loss_fn


def test_pretraining_step_matches_jax(models):
    """One masked pretraining forward and backward (explicit masks): the
    loss to 1e-5, every parameter gradient (JAX's mapped through
    jax_params_to_state_dict, as the weights are) to a relative L2 error of
    1e-4 (float32, the same math summed in another order)."""
    jmodel, params, port = models
    x, masks = _batch(7)
    (jloss, jtask), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel, {k: jnp.asarray(v) for k, v in x.items()},
                  {k: jnp.asarray(v) for k, v in masks.items()}),
        has_aux=True))(params)
    loss_fn = make_pretrain_loss(port, DOMAIN_CONF, NUM_VISIBLE)
    loss, task_losses = loss_fn({k: _t(v) for k, v in x.items()},
                                task_masks={k: _t(v) for k, v in masks.items()},
                                num_visible=NUM_VISIBLE)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    for task in DOMAINS:
        np.testing.assert_allclose(task_losses[task].item(),
                                   float(jtask[task]), rtol=1e-5, atol=1e-5)
    named = {n: p for n, p in port.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(named.values()))
    want = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads), port)
    assert "encoder.0.attn.qkv.weight" in named
    for (name, g) in zip(named, grads):
        w = want[name]
        err = ((g - w).norm() / w.norm().clamp_min(1e-12)).item()
        assert err <= 1e-4, (name, err)


def test_train_step_updates_and_reports_on_device(models):
    _, _, port = models
    import copy

    model = copy.deepcopy(port)
    opt = GroupedOptimizer(OptimizerConfig(clip_grad=1.0))
    state = init_train_state(model, opt)
    step = make_train_step(make_pretrain_loss(model, DOMAIN_CONF,
                                              NUM_VISIBLE), opt)
    x, _ = _batch(8)
    before = model.encoder[0].attn.qkv.weight.detach().clone()
    pos = model.input_adapters["bscan"].pos_emb.detach().clone()
    state, metrics = step(state, {k: _t(v) for k, v in x.items()},
                          torch.Generator().manual_seed(0), 1e-3)
    assert set(metrics) == {"loss", "grad_norm"} | {
        f"loss_{t}" for t in DOMAINS}
    assert all(torch.is_tensor(v) and torch.isfinite(v) for v in
               metrics.values())
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    assert not torch.equal(before, model.encoder[0].attn.qkv.weight)
    assert torch.equal(pos, model.input_adapters["bscan"].pos_emb)  # frozen


# -------------------------------------------------------------- optimizer

def _placeholders_to_zeros(tree, params):
    """JAX keeps a scalar in place of a frozen leaf's moments."""
    return jax.tree_util.tree_map(
        lambda m, p: np.zeros_like(p) if np.ndim(m) == 0 and np.ndim(p)
        else np.asarray(m), tree, params)


@pytest.mark.parametrize("opt,skip", [("adamw", None), ("adamw", 1e-3),
                                      ("adam", None), ("sgd", None)])
def test_optimizer_update_matches_jax(models, opt, skip):
    """Two updates from the same injected grads: layer decay, a frozen
    subtree (every "slo" adapter), clipping, and (skip=1e-3) a skipped step
    that must leave the parameters, moments and step count untouched.
    Parameters and moments to 1e-6."""
    _, params, port = models
    kw = dict(opt=opt, betas=(0.9, 0.95), weight_decay=0.05,
              layer_decay=0.75, num_layers=ARGS["depth"],
              frozen_paths=("slo",), clip_grad=1.0, skip_grad=skip)
    jopt, topt = JaxOptimizer(JaxOptimizerConfig(**kw)), \
        GroupedOptimizer(OptimizerConfig(**kw))
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda p: (0.05 * rng.standard_normal(np.shape(p))).astype(
            np.float32), params) for _ in range(2)]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = {n: p.detach().clone() for n, p in port.named_parameters()}
    tstate = topt.init(tparams)
    jupdate = jax.jit(lambda g, st, p, lr: jopt.update(g, st, p, lr,
                                                       allow_kernel=False))
    for k, lr in enumerate((1e-3, 5e-4)):
        jparams, jstate, jnorm = jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads[k]), jstate, jparams,
            lr)
        tnorm = topt.update(jax_params_to_state_dict(grads[k], port), tstate,
                            tparams, lr)
        np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_equal(int(tstate["count"]), int(jstate["count"]))
    want = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams), port)
    for n, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=1e-6,
                                   err_msg=n)
    assert ("input_adapters.slo.proj.weight" not in tstate["mu"]
            and "encoder.0.mlp.fc1.weight" in tstate["mu"])
    for key in ("mu", "nu") if opt != "sgd" else ("mu",):
        want = jax_params_to_state_dict(
            _placeholders_to_zeros(jstate[key], params), port)
        for n, m in tstate[key].items():
            np.testing.assert_allclose(m.numpy(), want[n].numpy(), atol=1e-6,
                                       err_msg=f"{key} {n}")
    if skip is not None:
        assert int(tstate["count"]) == 0
        for n, p in tparams.items():
            assert torch.equal(p, port.state_dict()[n]), n


def test_cosine_scheduler_matches_jax():
    from mirage_tpu.train.schedules import cosine_scheduler as jax_cosine

    args = (1e-4, 0.0, 5, 7)
    np.testing.assert_array_equal(
        cosine_scheduler(*args, warmup_epochs=2, start_warmup_value=1e-6),
        jax_cosine(*args, warmup_epochs=2, start_warmup_value=1e-6))


def test_dropout_and_drop_path():
    """Identities at rate 0 or when deterministic (every driven config);
    otherwise x/keep or 0 from the generator, per element or per sample."""
    from mirage_tpu_torch.nn.layers import drop_path, dropout

    x = torch.randn(6, 5, 4)
    for fn in (dropout, drop_path):
        assert fn(x, 0.3) is x
        assert fn(x, 0.0, deterministic=False,
                  generator=torch.Generator()) is x
        a = fn(x, 0.3, deterministic=False,
               generator=torch.Generator().manual_seed(1))
        b = fn(x, 0.3, deterministic=False,
               generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        kept = a != 0
        torch.testing.assert_close(a[kept], x[kept] / 0.7)
    per_sample = drop_path(x, 0.5, deterministic=False,
                           generator=torch.Generator().manual_seed(2))
    assert all(bool((r == 0).all()) or bool((r != 0).all())
               for r in per_sample)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.3, deterministic=False)


def test_masked_forward_with_random_masks(models):
    """The generator path: exactly num_encoded visible tokens per sample,
    patch tokens per task, and the same masks from the same seed."""
    _, _, port = models
    x, _ = _batch(3)
    x = {k: _t(v) for k, v in x.items()}
    with torch.no_grad():
        preds, masks = port(x, num_encoded_tokens=NUM_VISIBLE,
                            generator=torch.Generator().manual_seed(0),
                            deterministic=False, pixel_outputs=False)
        _, again = port(x, num_encoded_tokens=NUM_VISIBLE,
                        generator=torch.Generator().manual_seed(0),
                        deterministic=False, pixel_outputs=False)
    visible = sum((1 - m).sum(1) for m in masks.values())
    assert (visible == NUM_VISIBLE).all()
    assert all(torch.equal(masks[t], again[t]) for t in DOMAINS)
    assert preds["bscan"].shape == (2, N_TASK, 16 * 16)
    assert preds["bscanlayermap"].shape == (2, N_TASK, 13 * 8 * 8)


@pytest.mark.parametrize("n,deterministic,route", [
    (99, False, "attn_half_block"), (129, False, "block_attention"),
    (129, True, "attn_half_block")])
def test_block_routes_as_the_jax_package(monkeypatch, n, deterministic,
                                         route):
    """mirage_tpu/nn/block.py:77-129: inference and training up to 128
    tokens fuse the attention half (B1/B4); training above takes LN →
    block_attention (B6) → residual. The route decides the rounding the
    port matches, and which kernels the step launches."""
    from mirage_tpu_torch.nn import block as block_mod
    from mirage_tpu_torch.ops import block_attention as ba

    calls = []
    for name in ("attn_half_block", "block_attention"):
        orig = getattr(ba, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(ba, name, spy)
        if name == "attn_half_block":
            monkeypatch.setattr(block_mod, name, spy)
    block = block_mod.Block(32, 2, qkv_bias=True)
    for prm in block.parameters():
        torch.nn.init.normal_(prm, std=0.1)
    block(torch.randn(1, n, 32), deterministic=deterministic)
    assert calls == [route]
