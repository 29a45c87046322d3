"""The task-batched decoder tails of the PyTorch port against the JAX package.

``MIRAGE_DEC_BATCH=on`` runs identically configured decoders' tails as one
task stack (``mirage_tpu_torch/adapters/spatial_output.py:
batched_spatial_decode``): the queries and contexts stacked task-major into
one T·B batch, every tail weight on a leading task axis. On the CPU each op
of the stack runs its plain version, a loop over the tasks (the plain
``linear`` and ``layer_norm`` a batched product), so the batched route must
match both the JAX package (``mirage_tpu/adapters/spatial_output.py``, its
``tests/test_decoder_batch.py`` model: three decoders of width 64, depth 2,
2 heads) and the port's own per-task route. Also here: ``DecoderBlock``
against ``decoder_block_apply``, and the plan functions of the
task-strided kernels.

Everything runs in float32 on the CPU, torch on one thread; weights come
from one JAX initialisation through ``jax_params_to_state_dict``, inputs
and explicit masks from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mirage_tpu.models.mirage as jmm
from mirage_tpu.adapters.input_adapters import PatchedInputAdapter as JPatched
from mirage_tpu.adapters.input_adapters import SemSegInputAdapter as JSemSeg
from mirage_tpu.adapters.spatial_output import SpatialOutputAdapter as JSpatial
from mirage_tpu.adapters.spatial_output import \
    decoders_batchable as jax_batchable
from mirage_tpu.nn.block import decoder_block_apply, decoder_block_init
from mirage_tpu_torch.adapters.input_adapters import (PatchedInputAdapter,
                                                      SemSegInputAdapter)
from mirage_tpu_torch.adapters.spatial_output import (SpatialOutputAdapter,
                                                      decoders_batchable)
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.models.mirage import MIRAGEModel
from mirage_tpu_torch.nn.block import DecoderBlock
from mirage_tpu_torch.nn.layers import layer_norm, linear
from mirage_tpu_torch.ops import fused_mlp, runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_ref,
                                                  xattn_half_block,
                                                  xattn_half_block_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

DOMAINS = ("bscan", "slo", "bscanlayermap")
NUM_VISIBLE = 12
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run no faster on more threads, and the suite runs
    several test processes on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decoder_kwargs(d, depth=2):
    return dict(num_channels=13 if d == "bscanlayermap" else 1,
                patch_size_full=(8, 8) if d == "bscanlayermap" else (32, 32),
                dim_tokens=64, depth=depth, num_heads=2, task=d,
                context_tasks=DOMAINS, use_task_queries=True, use_xattn=True,
                image_size=(32, 32) if d == "bscanlayermap" else (128, 128))


def _jax_model():
    """tests/test_decoder_batch.py's model."""
    inputs = {
        "bscan": JPatched(num_channels=1, patch_size_full=(32, 32),
                          image_size=128),
        "slo": JPatched(num_channels=1, patch_size_full=(32, 32),
                        image_size=128),
        "bscanlayermap": JSemSeg(num_classes=13, patch_size_full=(8, 8),
                                 image_size=32, dim_class_emb=16)}
    outputs = {d: JSpatial(**_decoder_kwargs(d)) for d in DOMAINS}
    return jmm.MIRAGEModel(input_adapters=inputs, output_adapters=outputs,
                           dim_tokens=96, depth=2, num_heads=2)


def _port_model():
    inputs = {
        "bscan": PatchedInputAdapter(num_channels=1, patch_size_full=(32, 32),
                                     image_size=128),
        "slo": PatchedInputAdapter(num_channels=1, patch_size_full=(32, 32),
                                   image_size=128),
        "bscanlayermap": SemSegInputAdapter(num_classes=13,
                                            patch_size_full=(8, 8),
                                            image_size=32, dim_class_emb=16)}
    outputs = {d: SpatialOutputAdapter(**_decoder_kwargs(d)) for d in DOMAINS}
    return MIRAGEModel(inputs, outputs, dim_tokens=96, depth=2, num_heads=2)


@pytest.fixture(scope="module")
def models():
    """The model in both packages with the same weights."""
    jmodel = _jax_model()
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    port = _port_model()
    port.load_state_dict(jax_params_to_state_dict(params, port), strict=True)
    return jmodel, params, port


def _batch(seed=0, b=2):
    """Inputs and explicit task masks (1 = masked) with NUM_VISIBLE visible
    tokens a sample, spread at random over the tasks."""
    rng = np.random.default_rng(seed)
    x = {"bscan": rng.random((b, 1, 128, 128), dtype=np.float32),
         "slo": rng.random((b, 1, 128, 128), dtype=np.float32),
         "bscanlayermap": rng.integers(0, 13, (b, 32, 32)).astype(np.int32)}
    mask = np.ones((b, 48), np.int32)
    for i in range(b):
        mask[i, rng.choice(48, NUM_VISIBLE, replace=False)] = 0
    return x, {t: mask[:, 16 * k:16 * (k + 1)] for k, t in enumerate(DOMAINS)}


@pytest.fixture
def jax_dec_batch():
    """Sets the JAX package's switch as tests/test_decoder_batch.py does."""
    old = jmm._DEC_BATCH
    yield lambda on: setattr(jmm, "_DEC_BATCH", on)
    jmm._DEC_BATCH = old


def _jax_train(jmodel, params, x, masks, on, set_switch):
    """The JAX loss and gradients (jit: the switch is read while tracing)."""
    def loss(p, x, m):
        preds, _ = jmodel(p, x, mask_inputs=True, task_masks=m,
                          num_visible=NUM_VISIBLE, rng=jax.random.PRNGKey(7),
                          deterministic=False)
        return sum(jnp.mean(v.astype(jnp.float32) ** 2)
                   for v in preds.values())
    set_switch(on)
    value, grads = jax.jit(jax.value_and_grad(loss))(
        params, {k: jnp.asarray(v) for k, v in x.items()},
        {k: jnp.asarray(v) for k, v in masks.items()})
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _port_train(port, x, masks, on):
    port.zero_grad(set_to_none=True)
    with runtime.switched({"MIRAGE_DEC_BATCH": on}):
        preds, _ = port({k: _t(v) for k, v in x.items()},
                        task_masks={k: _t(v) for k, v in masks.items()},
                        num_visible=NUM_VISIBLE, deterministic=False)
        loss = sum((v.float() ** 2).mean() for v in preds.values())
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in port.named_parameters()
                         if p.grad is not None}


# ------------------------------------------------------------ the switch

def test_the_switch_keeps_the_jax_values_and_default():
    name = "MIRAGE_DEC_BATCH"
    assert runtime.SWITCHES[name] == ("off", ("on", "off"))
    with pytest.raises(ValueError, match=name):
        runtime.set_switch(name, "yes")
    with runtime.switched({name: "on"}):
        assert runtime.switches[name] == "on"
    assert runtime.switches[name] == "off"


# --------------------------------------------------------- batchability

def _info(counts):
    return {"tasks": {t: {"num_tokens": n} for t, n in zip(DOMAINS, counts)}}


CASES = {
    "homogeneous": (dict(), (16, 16, 16)),
    "one_depth_changed": (dict(bscan=1), (16, 16, 16)),
    "single_adapter": (None, (16, 16, 16)),
    "unequal_token_counts": (dict(), (16, 16, 64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoders_batchable_matches_jax(case):
    depths, counts = CASES[case]
    domains = ("bscan",) if depths is None else DOMAINS
    depth = {} if depths is None else depths
    jax_ads = {d: JSpatial(**_decoder_kwargs(d, depth.get(d, 2)))
               for d in domains}
    port_ads = {d: SpatialOutputAdapter(**_decoder_kwargs(d, depth.get(d, 2)))
                for d in domains}
    want = jax_batchable(jax_ads, _info(counts))
    assert decoders_batchable(port_ads, _info(counts)) == want
    assert want == (case == "homogeneous")


# ---------------------------------------------- the model against JAX

def test_batched_training_forward_matches_jax(models, jax_dec_batch):
    """The masked training loss and every gradient, the port batched and
    per-task against the JAX package batched and per-task (1e-5), and the
    port batched against the port per-task (1e-6)."""
    jmodel, params, port = models
    x, masks = _batch(1)
    j_on = _jax_train(jmodel, params, x, masks, True, jax_dec_batch)
    j_off = _jax_train(jmodel, params, x, masks, False, jax_dec_batch)
    p_on = _port_train(port, x, masks, "on")
    p_off = _port_train(port, x, masks, "off")
    np.testing.assert_allclose(p_on[0], j_on[0], rtol=ATOL)
    np.testing.assert_allclose(p_off[0], j_off[0], rtol=ATOL)
    np.testing.assert_allclose(p_on[0], p_off[0], rtol=1e-6)
    want = jax_params_to_state_dict(j_on[1], port)
    assert set(p_on[1]) <= set(want)
    assert any(k.startswith("output_adapters.slo.decoder_transformer.1")
               for k in p_on[1])
    for name, g in p_on[1].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL,
                                   rtol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p_off[1][name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_batched_static_inference_matches_jax(models, jax_dec_batch):
    """The explicit-mask inference (every token of bscan visible, slo and
    the layer map masked) through the masked forward and through the
    wrapper's static path, batched, against the JAX package."""
    jmodel, params, port = models
    x, _ = _batch(2)
    masks = {"bscan": np.zeros((2, 16), np.int32),
             "slo": np.ones((2, 16), np.int32),
             "bscanlayermap": np.ones((2, 16), np.int32)}
    absent = ("slo", "bscanlayermap")
    jax_dec_batch(True)
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    mj = {k: jnp.asarray(v) for k, v in masks.items()}

    def infer(p, x, m, absent_tasks):
        return jmodel(p, x, mask_inputs=False, task_masks=m, num_visible=16,
                      deterministic=True, absent_tasks=absent_tasks)[0]

    want = jax.jit(lambda p, x, m: infer(p, x, m, ()))(params, xj, mj)
    want_static = jax.jit(lambda p, x, m: infer(p, x, m, absent))(params, xj,
                                                                  mj)
    xt = {k: _t(v) for k, v in x.items()}
    with torch.no_grad(), runtime.switched({"MIRAGE_DEC_BATCH": "on"}):
        got, _ = port(xt, task_masks={k: _t(v) for k, v in masks.items()},
                      num_visible=16, mask_inputs=False, deterministic=True)
        got_static = port(xt, absent_tasks=absent)
    with torch.no_grad():
        per_task = port(xt, absent_tasks=absent)
    for t in DOMAINS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   atol=ATOL, rtol=ATOL, err_msg=t)
        np.testing.assert_allclose(got_static[t].numpy(),
                                   np.asarray(want_static[t]), atol=ATOL,
                                   rtol=ATOL, err_msg=t)
        np.testing.assert_allclose(got_static[t].numpy(),
                                   per_task[t].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=t)


def test_batched_route_takes_one_tail(models, monkeypatch):
    """With the switch on, the static forward runs one tail over a task
    stack: its projections see (T, ·, ·) weights; with it off, none do."""
    _, _, port = models
    import mirage_tpu_torch.ops.block_attention as ba

    seen = []
    real = ba.xattn_half_block_ref

    def spy(x, context, lnq_w, *args, **kw):
        seen.append(lnq_w.shape)
        return real(x, context, lnq_w, *args, **kw)

    monkeypatch.setattr(ba, "xattn_half_block_ref", spy)
    x, _ = _batch(3)
    xt = {k: _t(v) for k, v in x.items()}
    with torch.no_grad():
        with runtime.switched({"MIRAGE_DEC_BATCH": "on"}):
            port(xt, absent_tasks=())
        assert seen and all(s == (3, 64) for s in seen[:1])
        seen.clear()
        port(xt, absent_tasks=())
        assert seen and all(s == (64,) for s in seen)


def test_block_fuse_decoder_runs_one_fused_block_a_task(models, monkeypatch):
    """The B10 deviation's pin (mirage_tpu_torch/DEVIATIONS.md): under
    MIRAGE_BLOCK_FUSE=decoder the batched tails run fused_block once a task
    on that task's rows, and equal the per-task route."""
    import mirage_tpu_torch.ops.fused_block as fb

    _, _, port = models
    x, _ = _batch(4)
    xt = {k: _t(v) for k, v in x.items()}
    calls = []
    real = fb._fused_block_fwd

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(fb, "_fused_block_fwd", spy)
    with torch.no_grad(), runtime.switched({"MIRAGE_BLOCK_FUSE": "decoder"}):
        want = port(xt, absent_tasks=("slo",))
        per_task_calls = [c for c in calls if c[-1] == 64]
        calls.clear()
        with runtime.switched({"MIRAGE_DEC_BATCH": "on"}):
            got = port(xt, absent_tasks=("slo",))
    # the encoder's blocks (width 96) fuse too; the decoders' 2 blocks a
    # task, each one call on that task's (B, n, d) rows
    assert [c for c in calls if c[-1] == 64] == per_task_calls
    assert per_task_calls == [(2, 16, 64)] * 6
    for t in DOMAINS:
        np.testing.assert_allclose(got[t].numpy(), want[t].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=t)


# ------------------------------------- each task-axis op's plain version

def _stack_args(rng, tasks, d, hidden, n_fused=3, bias=True):
    f = np.float32

    def r(*s, scale=1.0):
        return _t((scale * rng.standard_normal(s)).astype(f))
    return {"ln_w": 1 + r(tasks, d, scale=0.1), "ln_b": r(tasks, d, scale=0.1),
            "w1": r(tasks, n_fused * d, d, scale=d ** -0.5),
            "b1": r(tasks, n_fused * d, scale=0.05) if bias else None,
            "w2": r(tasks, d, hidden, scale=hidden ** -0.5),
            "b2": r(tasks, d, scale=0.05)}


def _loop(fn, tasks, xs, weights):
    parts = [x.chunk(tasks) for x in xs]
    return torch.cat([fn(*(p[t] for p in parts),
                         *(None if w is None else w[t] for w in weights))
                      for t in range(tasks)])


@pytest.mark.parametrize("tasks", [2, 3])
def test_plain_linear_and_layer_norm_match_the_loop(tasks):
    rng = np.random.default_rng(tasks)
    a = _stack_args(rng, tasks, 32, 128, n_fused=4)
    x = _t(rng.standard_normal((tasks * 2, 5, 32)).astype(np.float32))
    np.testing.assert_allclose(
        layer_norm(x, a["ln_w"], a["ln_b"]).numpy(),
        _loop(layer_norm, tasks, (x,), (a["ln_w"], a["ln_b"])).numpy(),
        atol=1e-6, rtol=1e-6)
    for b in (a["b1"], None):
        np.testing.assert_allclose(
            linear(x, a["w1"], b).numpy(),
            _loop(linear, tasks, (x,), (a["w1"], b)).numpy(),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("residual", [True, False])
def test_mlp_block_task_stack_matches_the_loop(residual):
    """Forward and gradients (to x and to every stacked weight) of
    mlp_block and mlp_block_ref over a task stack against T calls."""
    tasks, d = 3, 32
    rng = np.random.default_rng(7)
    a = _stack_args(rng, tasks, d, 4 * d, n_fused=4)
    w = [a[k].requires_grad_() for k in ("ln_w", "ln_b", "w1", "b1", "w2",
                                         "b2")]
    x = _t(rng.standard_normal((tasks * 2, 7, d)).astype(np.float32))
    x.requires_grad_()
    dy = _t(rng.standard_normal((tasks * 2, 7, d)).astype(np.float32))
    for op in (mlp_block, mlp_block_ref):
        got = op(x, *w, residual=residual)
        g_got = torch.autograd.grad(got, [x, *w], dy)
        want = _loop(lambda xt, *wt: mlp_block_ref(xt, *wt,
                                                   residual=residual),
                     tasks, (x,), w)
        g_want = torch.autograd.grad(want, [x, *w], dy)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=1e-6)
        for g1, g2 in zip(g_got, g_want):
            np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_attn_half_block_task_stack_matches_the_loop(bias):
    tasks, d, heads = 3, 32, 2
    rng = np.random.default_rng(8)
    a = _stack_args(rng, tasks, d, d, n_fused=3, bias=bias)
    w = [a["ln_w"], a["ln_b"], a["w1"], a["b1"], a["w2"][..., :d].contiguous(),
         a["b2"]]
    x = _t(rng.standard_normal((tasks * 2, 9, d)).astype(np.float32))
    x.requires_grad_()
    got = attn_half_block(x, *w, heads)
    want = _loop(lambda xt, *wt: attn_half_block_ref(xt, *wt, heads), tasks,
                 (x,), w)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        attn_half_block_ref(x, *w, heads).detach().numpy(),
        want.detach().numpy(), atol=1e-6)
    gx, = torch.autograd.grad(got.sum(), [x])
    gx_want, = torch.autograd.grad(want.sum(), [x])
    np.testing.assert_allclose(gx.numpy(), gx_want.numpy(), atol=1e-5)


def test_xattn_half_block_task_stack_matches_the_loop():
    tasks, d, heads = 3, 32, 2
    rng = np.random.default_rng(9)

    def r(*s, scale=1.0):
        return _t((scale * rng.standard_normal(s)).astype(np.float32))
    w = [1 + r(tasks, d, scale=0.1), r(tasks, d, scale=0.1),
         1 + r(tasks, d, scale=0.1), r(tasks, d, scale=0.1),
         r(tasks, d, d, scale=d ** -0.5), r(tasks, d, scale=0.05),
         r(tasks, 2 * d, d, scale=d ** -0.5), r(tasks, 2 * d, scale=0.05),
         r(tasks, d, d, scale=d ** -0.5), r(tasks, d, scale=0.05)]
    x, ctx = r(tasks * 2, 6, d), r(tasks * 2, 11, d)
    for residual in (True, False):
        got = xattn_half_block(x, ctx, *w, heads, residual=residual)
        want = _loop(lambda xt, ct, *wt: xattn_half_block_ref(
            xt, ct, *wt, heads, residual=residual), tasks, (x, ctx), w)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ------------------------------------------------- DecoderBlock vs JAX

@pytest.mark.parametrize("nq,nc", [(16, 24), (40, 600)])
def test_decoder_block_matches_jax(nq, nc):
    """DecoderBlock against decoder_block_apply and jax.grad of it (600
    context tokens: the cross-attention through flash_attention's plain
    version, as B8 takes it on the card)."""
    d, heads, b = 32, 2, 2
    params = jax.tree_util.tree_map(
        np.asarray, decoder_block_init(jax.random.PRNGKey(3), d))
    block = DecoderBlock(d, heads)
    block.load_state_dict(jax_params_to_state_dict(params, block),
                          strict=True)
    rng = np.random.default_rng(nq)
    x = rng.standard_normal((b, nq, d)).astype(np.float32)
    ctx = rng.standard_normal((b, nc, d)).astype(np.float32)
    dy = rng.standard_normal((b, nq, d)).astype(np.float32)

    def jax_loss(p, x, c):
        return jnp.sum(decoder_block_apply(p, x, c, heads) * dy)

    want = jax.jit(lambda p, x, c: decoder_block_apply(p, x, c, heads))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    gp, gx, gc = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    xt, ct = _t(x).requires_grad_(), _t(ctx).requires_grad_()
    got = block(xt, ct)
    (got * _t(dy)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc), atol=ATOL,
                               rtol=ATOL)
    want_g = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gp), block)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=name)


# --------------------------------------------- the task-strided plans

@pytest.mark.parametrize("m,n,k,tasks", [(16448, 512, 256, 3),
                                         (65536, 1024, 256, 3),
                                         (300, 264, 72, 2)])
def test_task_gemm_plan_runs_each_tasks_tiles_once(m, n, k, tasks):
    """mtt_gemm_tasks' schedule: every task's every tile once, a cluster's
    CTAs in one task, the tiles of one task in the one-task raster."""
    plan = fused_mlp.gemm_plan(m, n, k, 132, tasks)
    one = fused_mlp.gemm_plan(m, n, k, 132)
    assert plan.tiles == tasks * one.tiles
    assert plan.grid == min(plan.tiles, 66) * 2
    sched = fused_mlp.pingpong_schedule(plan, m, n, tasks)
    seen = [(t, tm, tn) for cta in sched for t, tm, tn, _ in cta]
    tiles_m = -(-m // 128) + (-(-m // 128)) % 2  # whole cluster tiles
    assert sorted(seen) == [(t, r, c) for t in range(tasks)
                            for r in range(tiles_m)
                            for c in range(-(-n // 128))]
    for c in range(0, plan.grid, plan.cluster):
        tasks_a = [t for t, *_ in sched[c]]
        assert tasks_a == [t for t, *_ in sched[c + 1]]


def test_task_ln_and_mlp_bwd_plans():
    """The task launches share the card's CTAs out between the tasks."""
    one = runtime.layernorm_plan(16384, 256, 132, torch.bfloat16, True)
    three = runtime.layernorm_plan(16384, 256, 132, torch.bfloat16, True, 3)
    assert one.grid == 132 and three.grid == 44
    assert three.finish_groups == 4 and three.partial_rows == 44
    fwd = runtime.layernorm_plan(16448, 256, 132, torch.bfloat16, False, 3)
    assert fwd.grid == 88
    plan = fused_mlp.mlp_bwd_plan(65536, 256, 1024, 132, 3)
    assert plan.hidden.tiles == 3 * 512 * 8 and plan.hidden.grid == 132
    assert plan.dyln.tiles == 3 * 1024 and plan.dyln.grid == 132
    assert runtime.wgrad_chunks(65536, 1024, 256, 132, 3)[0] >= 1


def test_decbatch_bench_dry_run_on_the_cpu():
    """mirage_tpu_torch/bench/decbatch.py's two cases at the tiny size on
    the CPU: both arms agree (the step's loss, the forward's outputs) and
    nothing is timed."""
    from mirage_tpu_torch.bench import decbatch

    step = decbatch.step_case("tiny", "cpu", rounds=2, iters=1,
                              measure=False)
    assert step["loss_rel"] <= 1e-6 and step["timing"] is None
    assert not step["measured"] and step["batch"] == 2
    fwd = decbatch.forward_case("tiny", "cpu", rounds=2, iters=1,
                                measure=False)
    assert all(e["max_abs_err"] <= 1e-6 for e in fwd["agreement"].values())
    assert set(fwd["launches_per_call"]) == set(decbatch.ARMS)
