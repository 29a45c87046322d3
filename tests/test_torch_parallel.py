"""The port's tensor parallelism (mirage_tpu_torch.parallel) against the JAX
package's (mirage_tpu.parallel.tp, nn/block.py:_tp_block_apply).

The relayout of the qkv weights, biases and moments is bit-equal to the
JAX package's on seeded numpy arrays; the leaf specs and gradient kinds
match key for key; and in a two-process gloo group (spawned, rendezvous
through a file) ident_f / psum_g and the tensor-parallel block, forward and
gradients, equal the port's one-process Block and JAX's _tp_block_apply
inside a shard_map over tensor=2, at 1e-5 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from mirage_tpu.nn.block import _tp_block_apply, block_init
from mirage_tpu.parallel import tp as jtp
from mirage_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mirage_tpu_torch.api.convert import jax_params_to_state_dict
from mirage_tpu_torch.nn.block import Block
from mirage_tpu_torch.parallel import tp
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_step import one_thread  # noqa: F401
from tests.test_torch_train import models  # noqa: F401

ATOL = 1e-5


def _flat_jax(tree):
    return [(jtp._names(path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_relayout_is_bit_equal_to_jax(models):  # noqa: F811
    """Parameters and two seeded moment trees: tp_relayout and its inverse
    (t = 2 of the model's 2 heads) on the state dict equal the JAX
    package's on the pytree, mapped by jax_params_to_state_dict (which
    transposes the linears)."""
    _, params, port = models
    t = 2
    heads = port.num_heads
    rng = np.random.default_rng(3)
    trees = [params] + [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
        params) for _ in range(2)]
    for tree in trees:
        sd = jax_params_to_state_dict(tree, port)
        want = jax_params_to_state_dict(jax.tree_util.tree_map(
            np.asarray, jtp.tp_relayout(tree, heads, t)), port)
        got = tp.tp_relayout(sd, heads, t)
        for n in sd:
            assert torch.equal(got[n], want[n]), n
        back = tp.tp_unrelayout(got, heads, t)
        for n in sd:
            assert torch.equal(back[n], sd[n]), n
    moved = [n for n in sd if not torch.equal(got[n], sd[n])]
    assert sorted(moved) == sorted(
        f"encoder.{i}.attn.qkv.{k}" for i in range(port.depth)
        for k in ("weight", "bias"))
    state = {"params": sd, "opt": {"mu": sd, "nu": sd, "count": 3},
             "step": 1}
    rel = tp.tp_relayout_state(state, heads, t)
    assert rel["opt"]["count"] == 3 and rel["step"] == 1
    for k in ("params", "mu", "nu"):
        tree = rel["params"] if k == "params" else rel["opt"][k]
        assert all(torch.equal(tree[n], got[n]) for n in sd)


def test_leaf_specs_and_grad_kinds_match_jax(models):  # noqa: F811
    """Every leaf's tensor axis (JAX's (L, in, out) position carried to
    torch's (out, in) layout) and gradient kind, key for key: each JAX
    leaf is marked by its index and found through jax_params_to_state_dict."""
    _, params, port = models
    flat = _flat_jax(params)
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(leaf), i, np.float32)
         for i, (_, leaf) in enumerate(flat)])
    kinds = dict(zip(range(len(flat)), jax.tree_util.tree_leaves(
        jtp.tp_grad_kind(params))))
    sd = jax_params_to_state_dict(marked, port)
    seen = set()
    for name, value in sd.items():
        i = int(value.reshape(-1)[0])
        names, leaf = flat[i]
        spec = jtp._tp_leaf_spec(names)
        axis = None
        if "tensor" in spec:
            # stacked (L, ...) leaves; torch holds the unstacked reversed
            q = spec.index("tensor") - 1
            axis = np.ndim(leaf) - 2 - q
        assert tp.tp_leaf_axis(name) == axis, (name, spec)
        assert tp.tp_grad_kind(name) == kinds[i], name
        seen.add(i)
    assert seen == set(range(len(flat)))
    assert tp.tp_grad_kind("encoder.0.norm1.weight") == "partial"
    assert tp.tp_grad_kind("encoder.0.attn.proj.bias") == "replicated"


# ------------------------------------------------ the tensor-parallel block

D, H, N, B = (worker.BLOCK_D, worker.BLOCK_H, worker.BLOCK_N,
              worker.BLOCK_B)


def _block_sd(p):
    """One JAX block's params as the port's Block state dict."""
    lin = lambda q: {"weight": torch.tensor(np.asarray(q["w"]).T),  # noqa
                     "bias": torch.tensor(np.asarray(q["b"]))}
    ln = lambda q: {"weight": torch.tensor(np.asarray(q["scale"])),  # noqa
                    "bias": torch.tensor(np.asarray(q["bias"]))}
    parts = {"norm1": ln(p["norm1"]), "attn.qkv": lin(p["attn"]["qkv"]),
             "attn.proj": lin(p["attn"]["proj"]), "norm2": ln(p["norm2"]),
             "mlp.fc1": lin(p["mlp"]["fc1"]), "mlp.fc2": lin(p["mlp"]["fc2"])}
    return {f"{k}.{w}": v for k, d in parts.items() for w, v in d.items()}


def _jax_tp_block(p, x, cot, t=2):
    """_tp_block_apply in a shard_map over tensor=t: the output, dx and the
    parameter gradients, the LayerNorms' partial ones psum'd (as the train
    step does), the qkv leaves back in the standard layout."""
    mesh = jax_make_mesh({"tensor": t}, devices=jax.devices()[:t])
    col, row = P(None, "tensor"), P("tensor", None)
    specs = {"norm1": {"scale": P(), "bias": P()},
             "attn": {"qkv": {"w": col, "b": P("tensor")},
                      "proj": {"w": row, "b": P()}},
             "norm2": {"scale": P(), "bias": P()},
             "mlp": {"fc1": {"w": col, "b": P("tensor")},
                     "fc2": {"w": row, "b": P()}}}
    p = dict(p, attn=dict(p["attn"], qkv={
        k: jtp._qkv_perm(v, H, t, invert=False)
        for k, v in p["attn"]["qkv"].items()}))

    def local(p, x, cot):
        def f(p, x):
            return _tp_block_apply(p, x, H, ("tensor", t), impl="auto",
                                   drop=0.0, attn_drop=0.0,
                                   drop_path_rate=0.0, deterministic=False,
                                   rng=None, grad_free=False)

        y = f(p, x)
        gp, gx = jax.grad(lambda p, x: jnp.sum(f(p, x) * cot),
                          argnums=(0, 1))(p, x)
        for ln in ("norm1", "norm2"):
            gp[ln] = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(g, "tensor"), gp[ln])
        return y, gx, gp

    y, gx, gp = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), P(), specs), check_vma=False))(p, x, cot)
    gp["attn"]["qkv"] = {k: jtp._qkv_perm(v, H, t, invert=True)
                         for k, v in gp["attn"]["qkv"].items()}
    return np.asarray(y), np.asarray(gx), _block_sd(gp)


def test_tp_block_matches_block_and_jax(tmp_path):
    """Two processes (tensor=2, 2 heads each): ident_f / psum_g's forward
    and backward sums; the tensor-parallel block's output, dx and every
    parameter gradient against the port's one-process Block and JAX's
    _tp_block_apply, without and with remat."""
    p = block_init(jax.random.PRNGKey(4), D, qkv_bias=True)
    rng = np.random.default_rng(5)
    p = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
            np.shape(v)).astype(np.float32), p)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    cot = rng.standard_normal((B, N, D)).astype(np.float32)
    sd = _block_sd(p)
    torch.save({"sd": sd, "x": torch.tensor(x), "cot": torch.tensor(cot)},
               tmp_path / "block.pt")
    out = worker.spawn("tp_block", 2, str(tmp_path))

    a = torch.arange(6.0).view(2, 3)
    y, ga = out["psum_g"]
    assert torch.equal(y, 2 * a + 1) and torch.equal(ga, torch.ones(2, 3))
    z, gb = out["ident_f"]
    assert torch.equal(z, a) and torch.equal(gb, torch.full((2, 3), 3.0))

    block = Block(D, H, qkv_bias=True)
    block.load_state_dict(sd)
    xt = torch.tensor(x).requires_grad_()
    yt = block(xt, deterministic=False)
    (yt * torch.tensor(cot)).sum().backward()
    jy, jgx, jgp = _jax_tp_block(p, x, cot)
    for remat in (0, 1):
        got = out[f"block_remat{remat}"]
        for want_y, want_dx, want_g in (
                (yt.detach(), xt.grad, {n: q.grad for n, q in
                                        block.named_parameters()}),
                (torch.tensor(jy), torch.tensor(jgx), jgp)):
            torch.testing.assert_close(got["y"], want_y, atol=ATOL,
                                       rtol=ATOL)
            torch.testing.assert_close(got["dx"], want_dx, atol=ATOL,
                                       rtol=ATOL)
            assert set(got["grads"]) == set(want_g)
            for n, g in got["grads"].items():
                torch.testing.assert_close(g, want_g[n], atol=ATOL,
                                           rtol=ATOL, msg=n)


def test_gspmd_steps_are_refused(monkeypatch):
    """MIRAGE_FSDP_STEP / MIRAGE_TP_STEP=gspmd (XLA's automatic
    partitioning with the kernels off, no counterpart in the port) raise for
    the layouts they govern; the default shardmap and the other layouts run
    (mirage_tpu_torch/DEVIATIONS.md)."""
    import pytest

    from mirage_tpu_torch.train import steps

    for kind in ("dp", "fsdp", "tp", "tp_fsdp"):
        steps._check_switches(kind)
    for attr, name, kinds in (("_FSDP_STEP", "MIRAGE_FSDP_STEP",
                               ("fsdp", "tp_fsdp")),
                              ("_TP_STEP", "MIRAGE_TP_STEP",
                               ("tp", "tp_fsdp"))):
        monkeypatch.setattr(steps, attr, "gspmd")
        for kind in ("dp", "fsdp", "tp", "tp_fsdp"):
            if kind in kinds:
                with pytest.raises(ValueError, match=f"{name}=gspmd"):
                    steps._check_switches(kind)
        monkeypatch.setattr(steps, attr, "shardmap")
    steps._check_switches("dp")
