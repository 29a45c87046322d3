"""The optimizer's leaf table (``mirage_tpu_torch/ops/fused_adamw.py``) on
the CPU: which leaves take it, its tile list and rates, its plain step
against the optimizer's foreach route, when the optimizer keeps and
rebuilds it, and what it tallies under a profiler. The kernels themselves
are held to these plain versions on the card (``tests/test_torch_kernels.py``).

On the CPU the optimizer keeps its routes (``fused_adamw_ref`` or foreach);
the table route is reached by making ``runtime.use_kernel`` say yes and
giving the table its plain step."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mirage_tpu_torch.ops import fused_adamw as fa
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.train.optim import (GroupedOptimizer, OptimizerConfig,
                                          global_norm)
from mirage_tpu_torch.utils import profiling

# ragged leaves: one below a vector, odd lengths, one across tiles
SHAPES = {"a.weight": (96, 90), "b.weight": (3, 7), "c.bias": (7,),
          "d.bias": (1,), "e.weight": (2, fa.TILE + 3)}
CFG = dict(betas=(0.9, 0.999), weight_decay=1e-2, clip_grad=1.0,
           skip_grad=1e3)


def _tree(seed, scale=1e-1):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=gen) * scale
            for n, s in SHAPES.items()}


@contextlib.contextmanager
def _table_on_cpu(monkeypatch):
    """The table route on CPU tensors: use_kernel says yes, and the table
    steps by its plain version."""
    with monkeypatch.context() as m:
        m.setattr(runtime, "use_kernel", lambda x: True)
        m.setattr(fa.LeafTable, "step", fa.LeafTable.step_ref)
        yield


@pytest.mark.parametrize("opt,dtype,numel,trainable,switch,kernel,want", [
    ("adamw", torch.float32, 7, True, "on", True, "table"),
    ("adamw", torch.float32, 1 << 20, True, "on", True, "table"),
    ("adamw", torch.float32, 1 << 17, True, "on", False, "ref"),
    ("adamw", torch.float32, (1 << 17) - 1, True, "on", False, "foreach"),
    ("adamw", torch.bfloat16, 1 << 20, True, "on", True, "foreach"),
    ("adam", torch.float32, 1 << 20, True, "on", True, "foreach"),
    ("sgd", torch.float32, 1 << 20, True, "on", True, "foreach"),
    ("adamw", torch.float32, 1 << 20, False, "on", True, "foreach"),
    ("adamw", torch.float32, 1 << 20, True, "off", True, "foreach"),
    ("adamw", torch.float32, 1 << 20, True, "off", False, "foreach"),
])
def test_leaf_route_by_opt_dtype_and_device(monkeypatch, opt, dtype, numel,
                                            trainable, switch, kernel, want):
    """On the card every trainable float32 AdamW leaf takes the table, with
    no element floor; on the CPU the floor stays (ref above, foreach
    below); adam, SGD, other dtypes, frozen leaves and the switch off take
    foreach."""
    monkeypatch.setattr(runtime, "use_kernel", lambda x: kernel)
    with runtime.switched({"MIRAGE_OPT_KERNEL": switch}):
        assert fa.leaf_route(torch.empty(numel, dtype=dtype), 1.0, opt,
                             trainable) == want


@pytest.mark.parametrize("numels,tile", [
    ([1, 3, 7, 131075], 8192), ([8192, 8193, 16384], 8192), ([5], 4),
    ([4096 * 1024, 1024, 1], 8192), (list(range(1, 300)), 64)])
def test_tile_list_takes_every_element_once(numels, tile):
    tiles = fa.tile_list(numels, tile).numpy()
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    assert len(tiles) == sum(-(-k // tile) for k in numels)
    seen = [np.zeros(k, dtype=int) for k in numels]
    for leaf, t in tiles:
        seen[leaf][t * tile:(t + 1) * tile] += 1
    assert all((s == 1).all() for s in seen)
    assert (np.diff(tiles[:, 0]) >= 0).all()  # leaf by leaf


@pytest.mark.parametrize("lr,wd_scale", [(1e-4, 1.0), (3.7e-5, 0.5),
                                         (1.5e-3, 2.0)])
def test_packed_rates_round_as_the_foreach_route(lr, wd_scale):
    """float32 of lr · scale and wd · wd_scale taken in double: the value
    torch rounds ``-lr * scale`` and ``wd * wd_scale`` to as the foreach
    route's scalars."""
    scales = [1.0, 0.75 ** 13, 0.75 ** 2, 1 / 3]
    wds = [0.05, 0.0, 0.3, 1e-2]
    got = fa.packed_rates(torch.tensor(scales, dtype=torch.float64),
                          torch.tensor(wds, dtype=torch.float64), lr,
                          wd_scale).numpy().view(np.float32).reshape(-1, 2)
    for (glr, gwd), s, w in zip(got, scales, wds):
        assert glr == torch.tensor(1.0).mul(lr * s).item()
        assert -glr == torch.tensor(1.0).mul(-lr * s).item()
        assert gwd == torch.tensor(1.0).mul(w * wd_scale).item()


def _run(opt, params, state, grads_seq, lrs):
    norms = [opt.update(g, state, params, lr) for g, lr in zip(grads_seq,
                                                                 lrs)]
    return [float(n) for n in norms]


def test_table_route_matches_the_foreach_route(monkeypatch):
    """Two steps with clip and skip set and a changed lr, the table (its
    plain step) against MIRAGE_OPT_KERNEL=off: the same norms, parameters
    and moments; then a step with an inf gradient leaves m, n, p and the
    count bit for bit."""
    p0 = _tree(1, 1.0)
    grads = [_tree(2), _tree(3)]
    out = {}
    for switch in ("off", "on"):
        params = {n: t.clone() for n, t in p0.items()}
        opt = GroupedOptimizer(OptimizerConfig(**CFG))
        state = opt.init(params)
        with contextlib.ExitStack() as st:
            if switch == "on":
                st.enter_context(_table_on_cpu(monkeypatch))
            st.enter_context(runtime.switched({"MIRAGE_OPT_KERNEL": switch}))
            norms = _run(opt, params, state, grads, (1e-2, 5e-3))
            if switch == "on":
                assert opt._table is not None
                assert opt._table.names == list(SHAPES)
            before = ({n: t.clone() for n, t in params.items()},
                      {k: {n: t.clone() for n, t in state[k].items()}
                       for k in ("mu", "nu")}, int(state["count"]))
            bad = dict(grads[0], **{"c.bias": torch.full((7,), np.inf)})
            gn = opt.update(bad, state, params, 1e-2)
        assert not np.isfinite(float(gn))
        assert int(state["count"]) == before[2] == 2
        for n in SHAPES:
            assert torch.equal(params[n], before[0][n])
            for k in ("mu", "nu"):
                assert torch.equal(state[k][n], before[1][k][n])
        out[switch] = (norms, params, state)
    np.testing.assert_allclose(out["on"][0], out["off"][0], rtol=1e-6)
    for n in SHAPES:
        torch.testing.assert_close(out["on"][1][n], out["off"][1][n],
                                   rtol=1e-6, atol=1e-7)
        for k in ("mu", "nu"):
            torch.testing.assert_close(out["on"][2][k][n],
                                       out["off"][2][k][n], rtol=1e-6,
                                       atol=1e-7)


def test_the_table_is_kept_and_rebuilt(monkeypatch):
    """One build for steps over the same state; a build again after a
    moment is reallocated (a checkpoint that assigns), after fresh moments,
    and after a parameter is; none for a copy in place."""
    params = {n: t.clone() for n, t in _tree(4, 1.0).items()}
    opt = GroupedOptimizer(OptimizerConfig(**CFG))
    state = opt.init(params)
    g = _tree(5)
    with _table_on_cpu(monkeypatch):
        builds = fa.LeafTable.builds
        for _ in range(3):
            opt.update(g, state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 1
        state["mu"]["a.weight"].copy_(torch.zeros(SHAPES["a.weight"]))
        opt.update(g, state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 1
        state["mu"]["a.weight"] = state["mu"]["a.weight"].clone()
        opt.update(g, state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 2
        assert opt._table.ms[0] is state["mu"]["a.weight"]
        state = opt.init(params)
        opt.update(g, state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 3
        params["e.weight"] = params["e.weight"].clone()
        before = params["e.weight"].clone()
        opt.update(g, state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 4
        assert not torch.equal(params["e.weight"], before)
        # a leaf without a gradient leaves the table's set
        opt.update(dict(g, **{"d.bias": None}), state, params, 1e-3)
        assert fa.LeafTable.builds == builds + 5
        assert "d.bias" not in opt._table.index


def test_the_norm_counts_gradients_outside_the_table(monkeypatch):
    """A frozen leaf's gradient has no moments and stays out of the table,
    yet counts toward the norm, as global_norm takes it."""
    params = {n: t.clone() for n, t in _tree(6, 1.0).items()}
    opt = GroupedOptimizer(OptimizerConfig(frozen_paths=("d",), **CFG))
    state = opt.init(params)
    g = _tree(7)
    with _table_on_cpu(monkeypatch):
        gn = opt.update(g, state, params, 1e-3)
    assert "d.bias" not in opt._table.index
    np.testing.assert_allclose(float(gn), float(global_norm(g.values())),
                               rtol=1e-6)


def _profiled_update(opt, state, params, g):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("mirage.optimizer"):
            opt.update(g, state, params, 1e-3)
    return profiling.summary()["mirage.optimizer"]["counts"]


def test_the_update_tallies_its_routes_under_a_profiler(monkeypatch):
    """Under a profiler the optimizer span records each route's leaves and
    elements and the table's builds; with none, nothing is recorded."""
    params = {n: t.clone() for n, t in _tree(8, 1.0).items()}
    numel = sum(t.numel() for t in params.values())
    g = _tree(9)
    opt = GroupedOptimizer(OptimizerConfig(**CFG))
    state = opt.init(params)
    with _table_on_cpu(monkeypatch):
        first = _profiled_update(opt, state, params, g)
        second = _profiled_update(opt, state, params, g)
    assert first == {"table_builds": 1, "table_leaves": len(SHAPES),
                     "table_elems": numel, "foreach_leaves": 0,
                     "foreach_elems": 0}
    assert second == {k: v for k, v in first.items() if k != "table_builds"}
    # the CPU's own routes: the leaf floor leaves these on foreach
    got = _profiled_update(opt, opt.init(params), params, g)
    assert got == {"table_leaves": 0, "table_elems": 0,
                   "foreach_leaves": len(SHAPES), "foreach_elems": numel}
    with runtime.switched({"MIRAGE_OPT_KERNEL": "off"}):
        got = _profiled_update(opt, opt.init(params), params, g)
    assert got["foreach_leaves"] == len(SHAPES)
    profiling.reset()
    with profiling.annotate("mirage.optimizer"):
        opt.update(g, state, params, 1e-3)
    assert profiling.records() == [] and profiling.summary() == {}


def test_tally_adds_to_the_innermost_span_only_while_recording():
    profiling.reset()
    profiling.tally(x=1)  # nothing open: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("mirage.step"):
            profiling.tally(x=2)
            with profiling.annotate("mirage.optimizer"):
                profiling.tally(x=3, y=1)
                profiling.tally(x=4)
    rows = profiling.summary()
    assert rows["mirage.step"]["counts"] == {"x": 2}
    assert rows["mirage.optimizer"]["counts"] == {"x": 7, "y": 1}
    profiling.reset()
