"""The port's multi-process training steps (train/steps.py) against the
JAX package's step builder on the same mesh shape and against the port's
one-process step: dp (data=4) and fsdp (data=2, fsdp=2) here, tp and
tp_fsdp in tests/test_torch_parallel_tp_step.py.

Four gloo processes on the CPU (spawned, rendezvous through a file) take
two pretraining steps of a tiny model (dim 64, depth 2, 4 heads) in each
layout while this process runs the JAX steps. The masks ride in the batch,
so they shard with it, and the JAX loss reads them there the same way.
Loss, grad norm, and the gathered standard-layout parameters and moments
agree at 1e-5 (the bars of tests/test_torch_train.py). The same processes
then take two data-parallel classification steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.api.wrapper import MIRAGEWrapper as JaxWrapper
from mirage_tpu.losses.masked import masked_ce_loss_tokens as jax_ce
from mirage_tpu.losses.masked import masked_mse_loss_tokens as jax_mse
from mirage_tpu.parallel.mesh import make_mesh
from mirage_tpu.parallel.tp import tp_relayout_state
from mirage_tpu.train.optim import GroupedOptimizer as JaxOptimizer
from mirage_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from mirage_tpu.train.steps import (init_train_state, make_train_step,
                                    shard_batch, shard_state)
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from tests import _torch_parallel_worker as worker

TOL = 1e-5
# name -> (layout, clip_grad)
CASES = {"dp": ("dp", None), "fsdp": ("fsdp", None)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch on one thread while the workers run (each on
    one thread too): the suite runs several test processes on the same
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_layouts(tmp_path_factory, cases, **flags):
    """The tiny model in both packages with one JAX initialisation; the
    workers take ``cases`` (and ``flags``: resume, cls) while this process
    runs JAX's steps. Returns (port model, {case: JAX result}, the
    workers' results, their directory)."""
    import json

    jw = JaxWrapper.__new__(JaxWrapper)
    jw.in_domains = jw.out_domains = worker.DOMAINS
    jw.input_size = {d: (worker.SIZE,) * 2 for d in worker.DOMAINS}
    jw.patch_size = {d: (worker.PATCH,) * 2 for d in worker.DOMAINS}
    jmodel = jw._build_model("miragepre_tiny", worker.ARGS, jnp.float32,
                             "auto")
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(5)))
    port = worker.build_tiny()
    sd = jax_params_to_state_dict(params, port)
    port.load_state_dict(sd, strict=True)
    workdir = tmp_path_factory.mktemp("parallel_step")
    torch.save(sd, workdir / "init.pt")
    worker.write_cls_weights(str(workdir))
    with open(workdir / "layouts.json", "w") as f:
        json.dump({"cases": [[n, *cases[n]] for n in cases], **flags}, f)
    workers = worker.Workers("layouts", 4, str(workdir))
    jax_out = {n: _jax_steps(jmodel, params, *cases[n]) for n in cases}
    for n in jax_out:
        jax_out[n] = (*jax_out[n], params)
    return port, jax_out, workers.result(), str(workdir)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return run_layouts(tmp_path_factory, CASES, cls=True)


def _jax_loss(jmodel):
    def loss_fn(params, batch, rng):
        x = {t: batch[t] for t in worker.DOMAINS}
        masks = {t: batch[f"mask_{t}"] for t in worker.DOMAINS}
        preds, _ = jmodel(params, x, mask_inputs=True, task_masks=masks,
                          num_visible=worker.NUM_VISIBLE,
                          deterministic=False, rng=rng, pixel_outputs=False)
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


def _jax_steps(jmodel, params, kind, clip):
    """Two steps of JAX's make_train_step on the layout's mesh over 4 of
    the 8 virtual devices: (losses, grad norms, params, mu, nu) in the
    standard layout."""
    axes = dict(worker.LAYOUTS[kind])
    mesh = make_mesh(axes, jax.devices()[:4])
    tp = axes.get("tensor", 1) > 1
    if tp:
        jmodel = dataclasses.replace(jmodel, tp=("tensor", axes["tensor"]))
    opt = JaxOptimizer(JaxOptimizerConfig(
        opt="adamw", betas=(0.9, 0.95), eps=worker.ADAM_EPS, weight_decay=0.05,
        clip_grad=clip))
    step = make_train_step(_jax_loss(jmodel), opt, mesh=mesh, donate=False,
                           tp=tp)
    state = shard_state(init_train_state(params, opt), mesh,
                        tp_num_heads=worker.ARGS["num_heads"] if tp else None)
    losses, norms = [], []
    with mesh:
        for it, seed in enumerate((11, 12)):
            batch = shard_batch({k: jnp.asarray(v) for k, v in
                                 worker.make_batch(seed).items()}, mesh)
            state, metrics = step(state, batch, jax.random.PRNGKey(it),
                                  1e-3, 1.0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    state = jax.tree_util.tree_map(np.asarray, state)
    if tp:
        state = tp_relayout_state(state, worker.ARGS["num_heads"],
                                  axes["tensor"], invert=True)
    return losses, norms, state


def _zeros_for_placeholders(tree, params):
    """JAX keeps a scalar in place of a frozen leaf's moments."""
    return jax.tree_util.tree_map(
        lambda m, p: np.zeros_like(p) if np.ndim(m) == 0 and np.ndim(p)
        else np.asarray(m), tree, params)


def _close(got, want, what):
    for n, w in want.items():
        torch.testing.assert_close(got[n], w, atol=TOL, rtol=TOL,
                                   msg=f"{what} {n}")


def check_case(setup, cases, case):
    """The workers' ``case`` against JAX's and the one-process step."""
    port, jax_out, out, _ = setup
    clip = cases[case][1]
    got = out[case]
    losses, norms, jstate, params = jax_out[case]
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=TOL, atol=TOL)
    _close(got["params"], jax_params_to_state_dict(jstate["params"], port),
           "param")
    for key in ("mu", "nu"):
        want = jax_params_to_state_dict(
            _zeros_for_placeholders(jstate["opt"][key], params), port)
        _close(got["opt"][key], {n: want[n] for n in got["opt"][key]}, key)
    assert set(got["opt"]["mu"]) == {n for n, p in port.named_parameters()
                                     if "pos_emb" not in n}

    one = worker.build_tiny(port.state_dict())
    losses, norms, state = worker.run_steps(one, worker.optimizer(clip),
                                            [worker.make_batch(s)
                                             for s in (11, 12)])
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=TOL, atol=TOL)
    _close(got["params"], {n: p.detach() for n, p in
                           state["params"].items()}, "param")
    for key in ("mu", "nu"):
        _close(got["opt"][key], state["opt"][key], key)
    if clip is not None:  # the norm is past the clip: the update scales
        assert min(got["grad_norm"]) > 10 * clip


@pytest.mark.parametrize("case", list(CASES))
def test_layout_matches_jax_and_one_process(setup, case):
    check_case(setup, CASES, case)


def test_cls_dp_step_matches_one_process(setup):
    """Two data-parallel classification steps on 4 processes against the
    one-process steps on the whole batch. Every stripe weighs the same (a
    zero-weight row in each), so the mean of the stripes' losses, each
    normalised by its own weight as the JAX package's shard_map dp step
    takes it, is the whole batch's."""
    _, _, out, workdir = setup
    got = out["cls"]
    losses, whole = worker.cls_dp_steps(workdir)
    np.testing.assert_allclose(got["loss"], losses, rtol=TOL, atol=TOL)
    model, _, _ = worker.cls_setup(workdir)
    moved = [n for n, p in model.state_dict().items()
             if not torch.equal(whole["params"][n], p)]
    assert "head.weight" in moved
    assert "model.encoder.0.attn.qkv.weight" in moved
    _close(got["params"], whole["params"], "param")
    for key in ("mu", "nu"):
        _close(got["opt"][key], whole["opt"][key], key)
