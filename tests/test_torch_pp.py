"""The port's GPipe pipeline step (parallel/pp.py, train/steps.py's 'pp'
layout) against the JAX package's pipeline step on the same mesh shape and
against the port's one-process step.

Four gloo processes on the CPU ({"data": 2, "pipe": 2}: the tiny model's
depth 2 is one block a stage, two microbatches of the local batch of 4)
take two pretraining steps from one JAX initialisation while this process
runs JAX's ``make_train_step(..., pp=True)`` with its model at
``pp=("pipe", 2)`` over 4 of the 8 virtual devices. Loss, grad norm and
the gathered standard-layout parameters and moments agree at 1e-5, plain,
with a small clip_grad (the norm summed over the stages decides the
update) and with remat at 160 visible tokens (past the 128 the half-block
ops train at, so each stage's blocks run checkpointed inside the
schedule's backward). The last case's checkpoint resumes under dp and back
under the pipeline bit for bit. The leaf specs and gradient kinds match
the JAX package's key for key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.losses.masked import masked_ce_loss_tokens as jax_ce
from mirage_tpu.losses.masked import masked_mse_loss_tokens as jax_mse
from mirage_tpu.parallel.mesh import make_mesh
from mirage_tpu.parallel.pp import pp_grad_kind as jax_pp_grad_kind
from mirage_tpu.parallel.pp import pp_param_specs as jax_pp_param_specs
from mirage_tpu.train.optim import GroupedOptimizer as JaxOptimizer
from mirage_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from mirage_tpu.train.steps import (init_train_state, make_train_step,
                                    shard_batch, shard_state)
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.parallel.pp import pp_grad_kind, pp_param_specs
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_step import (TOL, _close,  # noqa: F401
                                            _zeros_for_placeholders,
                                            one_thread)

REMAT_VISIBLE = 160  # 161 encoder tokens: past the half-block ops' 128
# name -> (clip_grad, remat, visible tokens)
CASES = {"pp": (None, False, worker.NUM_VISIBLE),
         "pp_clip": (0.002, False, worker.NUM_VISIBLE),
         "pp_remat": (None, True, REMAT_VISIBLE)}


def _jax_model():
    from mirage_tpu.api.wrapper import MIRAGEWrapper as JaxWrapper

    jw = JaxWrapper.__new__(JaxWrapper)
    jw.in_domains = jw.out_domains = worker.DOMAINS
    jw.input_size = {d: (worker.SIZE,) * 2 for d in worker.DOMAINS}
    jw.patch_size = {d: (worker.PATCH,) * 2 for d in worker.DOMAINS}
    return jw._build_model("miragepre_tiny", worker.ARGS, jnp.float32,
                           "auto")


def _jax_loss(jmodel, visible):
    def loss_fn(params, batch, rng):
        x = {t: batch[t] for t in worker.DOMAINS}
        masks = {t: batch[f"mask_{t}"] for t in worker.DOMAINS}
        preds, _ = jmodel(params, x, mask_inputs=True, task_masks=masks,
                          num_visible=visible, deterministic=False, rng=rng,
                          pixel_outputs=False)
        losses = {}
        for task, pred in preds.items():
            conf = worker.DOMAIN_CONF[task]
            if conf["loss"] == "ce":
                losses[task] = jax_ce(pred, batch[task], masks[task],
                                      patch_size=conf["patch_size"])
            else:
                losses[task] = jax_mse(pred, batch[task], masks[task],
                                       patch_size=conf["patch_size"],
                                       norm_pix=conf["norm_pix"])
        return sum(losses.values()), losses
    return loss_fn


def _jax_pp_steps(jmodel, params, clip, remat, visible):
    """Two steps of JAX's pipeline step on data 2 x pipe 2: (losses, grad
    norms, the state as numpy)."""
    mesh = make_mesh(dict(worker.PP_AXES), jax.devices()[:4])
    jmodel = dataclasses.replace(jmodel, pp=("pipe", worker.PP_MICRO),
                                 remat=remat)
    opt = JaxOptimizer(JaxOptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), eps=worker.ADAM_EPS,
        weight_decay=0.05, clip_grad=clip))
    step = make_train_step(_jax_loss(jmodel, visible), opt, mesh=mesh,
                           donate=False, pp=True)
    state = shard_state(init_train_state(params, opt), mesh)
    losses, norms = [], []
    with mesh:
        for it, seed in enumerate((11, 12)):
            batch = shard_batch({k: jnp.asarray(v) for k, v in
                                 worker.make_batch(seed, visible=visible)
                                 .items()}, mesh)
            state, metrics = step(state, batch, jax.random.PRNGKey(it),
                                  1e-3, 1.0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    return losses, norms, jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import json

    jmodel = _jax_model()
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(5)))
    port = worker.build_tiny()
    sd = jax_params_to_state_dict(params, port)
    port.load_state_dict(sd, strict=True)
    workdir = tmp_path_factory.mktemp("pp_step")
    torch.save(sd, workdir / "init.pt")
    with open(workdir / "pp.json", "w") as f:
        json.dump({"cases": [[n, *CASES[n]] for n in CASES],
                   "resume": True}, f)
    workers = worker.Workers("pp", 4, str(workdir))
    jax_out = {n: _jax_pp_steps(jmodel, params, *CASES[n]) for n in CASES}
    return jmodel, params, port, jax_out, workers.result()


@pytest.mark.parametrize("case", list(CASES))
def test_pp_step_matches_jax_and_one_process(setup, case):
    _, params, port, jax_out, out = setup
    clip, remat, visible = CASES[case]
    got = out[case]
    losses, norms, jstate = jax_out[case]
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=TOL, atol=TOL)
    _close(got["params"], jax_params_to_state_dict(jstate["params"], port),
           "param")
    for key in ("mu", "nu"):
        want = jax_params_to_state_dict(
            _zeros_for_placeholders(jstate["opt"][key], params), port)
        _close(got["opt"][key], {n: want[n] for n in got["opt"][key]}, key)
    assert list(got["params"]) == list(port.state_dict())

    one = worker.build_tiny(port.state_dict(), remat=remat)
    losses, norms, state = worker.run_steps(
        one, worker.optimizer(clip),
        [worker.make_batch(s, visible=visible) for s in (11, 12)],
        visible=visible)
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=TOL, atol=TOL)
    _close(got["params"], {n: p.detach() for n, p in
                           state["params"].items()}, "param")
    for key in ("mu", "nu"):
        _close(got["opt"][key], state["opt"][key], key)
    if clip is not None:  # the norm is past the clip: the update scales
        assert min(got["grad_norm"]) > 10 * clip
    # rank 0 (stage 0) held block 0 and every leaf outside the encoder
    assert not any(n.startswith("encoder.1.") for n in got["kept"])
    assert any(n.startswith("encoder.0.") for n in got["kept"])


def test_pp_checkpoint_resumes_under_dp_and_back(setup):
    *_, out = setup
    want = out["pp_remat"]
    for kind in ("dp", "pp"):
        got = out[f"resumed_{kind}"]
        for n, p in want["params"].items():
            assert torch.equal(got["params"][n], p), (kind, n)
        for key in ("mu", "nu"):
            for n, m in want["opt"][key].items():
                assert torch.equal(got["opt"][key][n], m), (kind, key, n)
        assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 2
        assert int(got["step"]) == 2


def test_pp_specs_and_grad_kinds_match_jax(setup):
    """Every stacked encoder leaf JAX shards over 'pipe' on its layer axis
    is an ``encoder.{i}`` leaf the port gives to stage i // (L/S); every
    other leaf is replicated; the gradient kinds likewise."""
    jmodel, params, port, _, _ = setup
    depth, n_stages = worker.ARGS["depth"], worker.PP_AXES["pipe"]
    mesh = make_mesh(dict(worker.PP_AXES), jax.devices()[:4])
    specs = jax_pp_param_specs(params, mesh)
    kinds = jax_pp_grad_kind(params)
    from jax.sharding import PartitionSpec as P

    sharded = jax.tree_util.tree_map(
        lambda leaf, sp: np.full(np.shape(leaf), float(sp == P("pipe")),
                                 np.float32), params, specs)
    local = jax.tree_util.tree_map(
        lambda leaf, k: np.full(np.shape(leaf), float(k == "local"),
                                np.float32), params, kinds)
    sharded = jax_params_to_state_dict(sharded, port)
    local = jax_params_to_state_dict(local, port)
    names = list(port.state_dict())
    ours = pp_param_specs(names, depth, n_stages)
    our_kinds = pp_grad_kind(names)
    assert any(v is not None for v in ours.values())
    for n in names:
        jax_sharded = bool(sharded[n].min() == 1)
        assert jax_sharded == bool(sharded[n].max() == 1), n
        assert jax_sharded == (ours[n] is not None), n
        if ours[n] is not None:
            i = int(n.split(".")[1])
            assert ours[n] == i // (depth // n_stages), n
        assert (our_kinds[n] == "local") == bool(local[n].min() == 1), n


def _pipe_mesh(**axes):
    from types import SimpleNamespace

    return SimpleNamespace(shape={"data": 1, "fsdp": 1, "tensor": 1,
                                  "pipe": 2, **axes})


@pytest.mark.parametrize("case", ["no pp flag", "fsdp x pipe",
                                  "tensor x pipe", "layer_decay",
                                  "drop_path", "tp and pp",
                                  "return_all_layers"])
def test_pp_scope_refusals(case):
    """What the JAX package asserts (steps.py:140-146, 417-424,
    mirage.py:83-89, 278) the port refuses with the same meaning."""
    from mirage_tpu_torch.train.optim import (GroupedOptimizer,
                                              OptimizerConfig)
    from mirage_tpu_torch.train.steps import make_train_step, mesh_layout

    opt = GroupedOptimizer(OptimizerConfig())
    if case == "no pp flag":
        with pytest.raises(ValueError, match="pipe axis > 1 but "
                                             "make_train_step was not"):
            make_train_step(None, opt, mesh=_pipe_mesh())
    elif case in ("fsdp x pipe", "tensor x pipe"):
        mesh = _pipe_mesh(**{case.split()[0]: 2})
        for fn in (lambda: mesh_layout(mesh),
                   lambda: make_train_step(None, opt, mesh=mesh, pp=True)):
            with pytest.raises(ValueError, match="composes only with data "
                                                 "parallelism"):
                fn()
    elif case == "layer_decay":
        with pytest.raises(ValueError, match="requires layer_decay=None"):
            make_train_step(None, GroupedOptimizer(OptimizerConfig(
                layer_decay=0.75)), mesh=_pipe_mesh(), pp=True)
    elif case == "drop_path":
        from mirage_tpu_torch.api.wrapper import build_model

        model = build_model("miragepre_tiny", worker.ARGS, worker.DOMAINS,
                            geometry=worker.GEOMETRY, drop_path_rate=0.1)
        with pytest.raises(ValueError, match="requires drop_path_rate == 0"):
            model.pp = ("pipe", 2)
    elif case == "tp and pp":
        model = worker.build_tiny()
        model.pp = ("pipe", 2)
        with pytest.raises(ValueError, match="exactly one of tp/pp"):
            model.tp = (None, 2)
    else:
        model = worker.build_tiny()
        model.pp = ("pipe", 2)
        batch = worker.make_batch(3, b=2)
        x = {t: torch.from_numpy(batch[t]) for t in worker.DOMAINS}
        with pytest.raises(ValueError, match="return_all_layers is not "
                                             "supported under pipeline"):
            model(x, num_encoded_tokens=worker.NUM_VISIBLE,
                  return_all_layers=True)


def test_pp_flag_without_a_pipe_is_the_plain_encoder():
    """The degenerate one-stage view (pp.py:119-126): a model with the pp
    flag and no pipe bound gives the plain encoder's output, bit for bit,
    forward and backward."""
    batch = worker.make_batch(4, b=4)
    x = {t: torch.from_numpy(batch[t]) for t in worker.DOMAINS}
    masks = {t: torch.from_numpy(batch[f"mask_{t}"]) for t in worker.DOMAINS}
    from mirage_tpu_torch.api.wrapper import build_model

    plain = build_model("miragepre_tiny", worker.ARGS, worker.DOMAINS,
                        geometry=worker.GEOMETRY,
                        generator=torch.Generator().manual_seed(1))
    flagged = worker.build_tiny(plain.state_dict())
    flagged.pp = ("pipe", 2)
    outs = []
    for model in (plain, flagged):
        preds, _ = model(x, task_masks=masks, num_visible=worker.NUM_VISIBLE,
                         deterministic=False)
        sum(p.float().square().mean() for p in preds.values()).backward()
        outs.append((preds, {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}))
    for t in outs[0][0]:
        assert torch.isfinite(outs[0][0][t]).all(), t
        assert torch.equal(outs[0][0][t], outs[1][0][t]), t
    assert outs[0][1].keys() == outs[1][1].keys()
    for n, g in outs[0][1].items():
        assert torch.equal(g, outs[1][1][n]), n
