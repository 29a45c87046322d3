"""The ping-pong GEMM (csrc/gemm_pingpong.cuh) on the CPU: its launch plan,
and the plain versions of its epilogues at its tiles' ragged edges.

``gemm_plan`` and ``gemm_s8_plan`` (mirage_tpu_torch/ops/fused_mlp.py)
mirror the launcher of the bf16 GEMM (csrc/gemm.cu) and the int8 GEMM
(csrc/quant.cu): 128 × 128 tiles a consumer warpgroup, clusters of two CTAs
along M taking 256 × 128 cluster tiles in a grouped raster, cluster c taking
cluster tiles c, c + clusters, ... and each CTA handing its g-th tile to
consumer g % 2.
The kernels run only on the card (``tests/test_torch_kernels.py`` holds
them to these plain versions there); here the plain versions of the
epilogues they fuse run at M = 1, 63, 65, 129 and N = 8, 264 against the
JAX package: B2 (bias, GELU, residual) through
``mirage_tpu/ops/fused_mlp.py:mlp_block`` with the Pallas kernel in
interpret mode, S5's GELU formulas against ``scripts/bench_vpu.py``'s
interpreted ``_mlp_kernel_v``, B12's dequantising epilogues against
``mirage_tpu/ops/quant.py:_mlp_q_math`` and S3's s32 product against an
int64 product. Tolerances: float32 1e-5 (the same float operations in
another summation order), bf16 GELU's max-abs 5e-2 / rel-L2 1e-2 (it
rounds every operation to bf16), S3 exact.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mirage_tpu.ops.fused_mlp import mlp_block as jax_mlp_block
from mirage_tpu.ops.quant import _mlp_q_math
from mirage_tpu_torch.ops import fused_mlp as fm
from mirage_tpu_torch.ops import quant as q

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mirage_tpu_torch" / "csrc" / "gemm_pingpong.cuh"
F32 = dict(atol=1e-5, rtol=1e-5)
# the ragged edges of a 128 × 128 tile: (rows M, model width d); fc1's N
# is 4d (264 at d = 66), fc2's N is d (8)
EDGES = [(1, 8), (63, 66), (65, 8), (129, 66)]
PLAN_SHAPES = [(1, 8, 16), (63, 264, 80), (65, 8, 1008), (129, 264, 64),
               (16448, 4096, 1024), (4100, 768, 3072), (17985, 136, 144)]
PLANS = [(fm.gemm_plan, 64), (fm.gemm_s8_plan, 128)]


def _tiles(m, n):
    return -(-m // fm.GEMM_TILE[0]), -(-n // fm.GEMM_TILE[1])


@pytest.mark.parametrize("plan_fn,bk", PLANS)
@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 7, 2])
def test_plans_cover_every_tile_once(plan_fn, bk, m, n, k, sms):
    """Every tile once over the CTAs (an odd tile-row count leaves the last
    cluster's second CTA rows past M), the grid whole clusters of two, one
    CTA an SM at most, each CTA's consumers taking its tiles in turn and the
    two CTAs of a cluster in lockstep on the same tile columns."""
    plan = plan_fn(m, n, k, sms)
    sched = fm.pingpong_schedule(plan, m, n)
    tm, tn = _tiles(m, n)
    got = sorted(t[:2] for cta in sched for t in cta)
    real = [t for t in got if t[0] < tm]
    assert real == [(i, j) for i in range(tm) for j in range(tn)]
    assert len(got) - len(real) == (tm % 2) * tn
    clusters = min(-(-tm // 2) * tn, sms // 2)
    assert plan.cluster == 2 and plan.grid == 2 * clusters == len(sched)
    assert plan.ktiles == -(-k // bk)
    assert plan.tiles_per_cta == max(len(cta) for cta in sched)
    for cta in sched:
        assert [c for *_, c in cta] == [g % 2 for g in range(len(cta))]
    for a, b in zip(sched[::2], sched[1::2]):
        assert [(r + 1, c) for r, c, _ in a] == [(r, c) for r, c, _ in b]


@pytest.mark.parametrize("plan_fn,bk", PLANS)
def test_consumers_alternate_with_an_odd_tile_count(plan_fn, bk):
    """Three tiles a CTA: consumer 0 takes the first and the third."""
    plan = plan_fn(256, 264, 2 * bk, 2)
    sched = fm.pingpong_schedule(plan, 256, 264)
    assert [len(cta) for cta in sched] == [3, 3]
    assert all([c for *_, c in cta] == [0, 1, 0] for cta in sched)


def test_grouped_raster_keeps_a_wave_within_eight_tile_rows():
    """The tiles the CTAs take at once lie in eight tile rows (shared A
    rows in L2), down the group's cluster rows column by column."""
    m, n, k, sms = 16448, 4096, 1024, 132
    plan = fm.gemm_plan(m, n, k, sms)
    assert plan.group * plan.cluster == fm.GEMM_GROUP == 8
    first = [t for cta in fm.pingpong_schedule(plan, m, n) for t in cta[:1]]
    assert {r for r, _, _ in first} == set(range(8))
    assert [t[:2] for t in first[:10]] == [(r, 0) for r in range(8)] \
        + [(0, 1), (1, 1)]
    # a last group shorter than four cluster rows
    tail = [fm.tile_order(t, 10, 3, 8) for t in range(30)]
    assert sorted(tail) == [(i, j) for i in range(10) for j in range(3)]
    assert tail[24:] == [(8, 0), (9, 0), (8, 1), (9, 1), (8, 2), (9, 2)]


@pytest.mark.parametrize("m,n,k", [(64, 264, 12), (64, 260, 64)])
def test_bf16_plan_raises_where_the_kernel_refuses(m, n, k):
    with pytest.raises(ValueError, match="gemm_plan"):
        fm.gemm_plan(m, n, k, 132)


@pytest.mark.parametrize("m,n,k", [(64, 264, 24), (64, 260, 64)])
def test_s8_plan_raises_where_the_kernel_refuses(m, n, k):
    with pytest.raises(ValueError, match="gemm_s8_plan"):
        fm.gemm_s8_plan(m, n, k, 132)


def test_plan_constants_match_the_header():
    """The tile, ring depth, cluster, staging stride and row grouping of
    csrc/gemm_pingpong.cuh are the plan's; both kernels' shared memory fits
    the 227 KB a block may use."""
    src = HEADER.read_text()
    bm, bn = fm.GEMM_TILE
    assert f"constexpr int BM = {bm}, BN = {bn}, MH = BM / 64, " \
        f"STAGES = {fm.GEMM_STAGES}," in src
    assert f"#define MTT_GEMM_CLUSTER {fm.GEMM_CLUSTER}\n" in src
    assert "EPI_STRIDE = 72" in src
    assert f"constexpr int GROUP = {fm.GEMM_GROUP} / CLUSTER;" in src
    for plan_fn, _ in PLANS:
        assert plan_fn(16448, 4096, 1024, 132).smem_bytes <= 232448


def _mlp_inputs(seed, m, d):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((m, d)).astype(f)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(f)
    be = (0.05 * rng.standard_normal(d)).astype(f)
    w1 = (rng.standard_normal((4 * d, d)) / np.sqrt(d)).astype(f)
    b1 = (0.02 * rng.standard_normal(4 * d)).astype(f)
    w2 = (rng.standard_normal((d, 4 * d)) / np.sqrt(4 * d)).astype(f)
    b2 = (0.02 * rng.standard_normal(d)).astype(f)
    return x, g, be, w1, b1, w2, b2


@pytest.fixture
def interpret_pallas(monkeypatch):
    """pallas_call in the interpreter (the bench script passes no flag)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("m,d", EDGES)
def test_b2_epilogues_at_the_tile_edges_match_jax(m, d):
    """fc1's bias and GELU and fc2's bias and residual (the plain B2)
    against the JAX package's interpreted _mlp_kernel on the same rows."""
    x, g, be, w1, b1, w2, b2 = _mlp_inputs(m + d, m, d)
    got = fm.mlp_block(*[torch.from_numpy(a)
                         for a in (x, g, be, w1, b1, w2, b2)]).numpy()
    jp = ({"scale": jnp.asarray(g), "bias": jnp.asarray(be)},
          {"fc1": {"w": jnp.asarray(w1.T), "b": jnp.asarray(b1)},
           "fc2": {"w": jnp.asarray(w2.T), "b": jnp.asarray(b2)}})
    want = np.asarray(jax_mlp_block(jnp.asarray(x), *jp, interpret=True))
    np.testing.assert_allclose(got, want, **F32)


@pytest.fixture(scope="module")
def bench_vpu():
    spec = importlib.util.spec_from_file_location(
        "_gemm_test_bench_vpu", ROOT / "scripts" / "bench_vpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,d", EDGES)
@pytest.mark.parametrize("act,mode", [("v0", "as26"), ("bf16", "bf16"),
                                      ("hastings", "hastings"),
                                      ("skip", "skip")])
def test_s5_gelu_epilogues_at_the_tile_edges_match_the_script(
        bench_vpu, interpret_pallas, m, d, act, mode):
    """The GELU formulas of mtt_gemm_gelu_mode (S5) in the plain
    mlp_block_modes against scripts/bench_vpu.py:_mlp_kernel_v."""
    x, g, be, w1, b1, w2, b2 = _mlp_inputs(2 * m + d, m, d)
    got = fm.mlp_block_modes(*[torch.from_numpy(a) for a in (
        x[None], g, be, w1, b1, w2, b2)], act=mode).numpy()[0]
    want = np.asarray(bench_vpu.make_mlp(ln="v0", act=act)(*[
        jnp.asarray(a) for a in (x[None], g, be, w1.T, b1, w2.T, b2)]))[0]
    if mode == "bf16":
        diff = got - want
        assert np.abs(diff).max() <= 5e-2
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("m,d", EDGES)
def test_b12_epilogues_at_the_tile_edges_match_the_jax_math(m, d):
    """The int8 GEMM's dequantising epilogues (fc1: acc·rs·s + b and the
    A&S GELU; fc2: acc·rs·s + b and the residual) in the plain
    mlp_block_q_parts against mirage_tpu/ops/quant.py:_mlp_q_math."""
    x, g, be, w1, b1, w2, b2 = _mlp_inputs(3 * m + d, m, d)
    qp = q.quantize_mlp_params(*[torch.from_numpy(a)
                                 for a in (w1, b1, w2, b2)])
    got = q.mlp_block_q_parts(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(be), *qp)[0].numpy()
    w1q, s1, qb1, w2q, s2, qb2 = [a.numpy() for a in qp]
    want = np.asarray(_mlp_q_math(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w1q.T),
        jnp.asarray(s1), jnp.asarray(qb1), jnp.asarray(w2q.T),
        jnp.asarray(s2), jnp.asarray(qb2)))
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("m,n,k", [(1, 8, 16), (63, 264, 80),
                                   (65, 8, 1008), (129, 264, 4096)])
def test_s3_s32_product_is_exact(m, n, k):
    """gemm_s8's plain version (the card's s32 epilogue) equals the int64
    product of the codes, at the extremes ±127 too."""
    rng = np.random.default_rng(m + n + k)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    a[0] = 127
    w[0] = -127
    got = q.gemm_s8(torch.from_numpy(a), torch.from_numpy(w))
    want = a.astype(np.int64) @ w.astype(np.int64).T
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
