"""The bench's S2, S5 and S6 ops against the JAX bench scripts they port,
on the CPU in float32.

Each plain op is held to its script's Pallas kernel run in the interpreter
on the same numpy inputs at (2, 17, 64, 4): ``scripts/bench_attn_half.py``
(S2), ``scripts/bench_vpu.py`` (S5) and ``scripts/bench_overlap.py`` (S6)
are each loaded once, by file path, and pass no ``interpret`` flag, so
``pallas_call`` is patched to interpret. The port's ops take their plain
versions here (CPU tensors); on the card the same ops launch
csrc/attention_phased.cu, csrc/mlp_chunked.cu and the LN and GELU modes,
which ``tests/test_torch_kernels.py`` and ``chip_smoke.py`` phase 9 hold to
these plain versions.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mirage_tpu_torch.ops.block_attention import (SMEM_PER_BLOCK,
                                                  attn_half_block,
                                                  attn_half_block_phased,
                                                  phased_plan)
from mirage_tpu_torch.ops.fused_mlp import (mlp_block_chunked,
                                            mlp_block_modes,
                                            mlp_chunked_plan)

ROOT = Path(__file__).resolve().parents[1]
B, N, D, H = 2, 17, 64, 4
# the script's mode names -> the port's
LN = {"v0": "two_pass", "onepass": "onepass", "skip": "skip"}
SMAX = {"v0": "exp", "exp2": "exp2", "nomax": "nomax", "skip": "skip"}
ACT = {"v0": "as26", "bf16": "bf16", "hastings": "hastings", "skip": "skip"}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ablation_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    """The three scripts, each loaded once for the module."""
    return {n: _script(n) for n in ("bench_attn_half", "bench_vpu",
                                    "bench_overlap")}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """pallas_call in the interpreter: the scripts pass no flag."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, which, d=D, h=H, qk_bias=0.0):
    """x (B, N, d) and a half's parameters as float32 numpy: the port's
    (torch Linear layout) and the script's (transposed); ``qk_bias`` is
    added to the q and k biases of an attention half."""
    rng = np.random.default_rng(seed)
    f = np.float32
    fused, hidden = (3, 1) if which == "attn" else (4, 4)
    x = rng.standard_normal((B, N, d)).astype(f)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(f)
    be = (0.05 * rng.standard_normal(d)).astype(f)
    w1 = (rng.standard_normal((fused * d, d)) / np.sqrt(d)).astype(f)
    b1 = (0.02 * rng.standard_normal(fused * d)).astype(f)
    if which == "attn":
        b1[:2 * d] += qk_bias
    w2 = (rng.standard_normal((d, hidden * d)) / np.sqrt(hidden * d)).astype(f)
    b2 = (0.02 * rng.standard_normal(d)).astype(f)
    port = [torch.from_numpy(a) for a in (x, g, be, w1, b1, w2, b2)]
    jax_args = [jnp.asarray(a) for a in (x, g, be, w1.T, b1, w2.T, b2)]
    return port, jax_args


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_s2_three_phase_half_matches_the_script(scripts):
    """S2: the three-phase half (all heads in one group) against the
    interpreted _v2_kernel at 1e-4, and against B1 (the script's "v1")."""
    port, jax_args = _inputs(40, "attn")
    want = scripts["bench_attn_half"].v2_call(*jax_args, H, (D // H) ** -0.5)
    got = attn_half_block_phased(*port, H, H)
    _close(got, want)
    _close(got, attn_half_block(*port, H).numpy())


@pytest.mark.parametrize("ln,smax", [("v0", "v0"), ("skip", "v0"),
                                     ("onepass", "v0"), ("v0", "skip"),
                                     ("v0", "nomax"), ("v0", "exp2")])
def test_s5_attention_modes_match_the_script(scripts, ln, smax):
    """S5a: every attention mode of bench_vpu.py's __main__ against the
    interpreted _attn_kernel_v at 1e-4. "skip" divides by the sum of the
    raw scores, which is ill-conditioned where that sum nears zero, so its
    case adds 1 to the q and k biases: every score is then positive
    (≈ dh·scale = 4), the sum far from zero and the division exact to
    float rounding."""
    port, jax_args = _inputs(41, "attn", qk_bias=1.0 if smax == "skip"
                             else 0.0)
    want = np.asarray(scripts["bench_vpu"].make_attn(H, ln=ln, smax=smax)(
        *jax_args))
    got = attn_half_block_phased(*port, H, H, ln=LN[ln], smax=SMAX[smax])
    _close(got, want)


def test_s5_attention_pipe2_matches_the_script(scripts):
    """S5b: two elements per program (_attn_kernel_pipe2) computes the
    default three-phase half."""
    port, jax_args = _inputs(42, "attn")
    want = scripts["bench_vpu"].make_attn_pipe2(H)(*jax_args)
    _close(attn_half_block_phased(*port, H, H), want)


@pytest.mark.parametrize("ln,act", [("v0", "v0"), ("skip", "v0"),
                                    ("onepass", "v0"), ("v0", "skip"),
                                    ("v0", "hastings"), ("v0", "bf16")])
def test_s5_mlp_modes_match_the_script(scripts, ln, act):
    """S5d: every MLP mode of bench_vpu.py's __main__ and act=bf16 (which
    the script never ran on its TPU) against the interpreted _mlp_kernel_v:
    1e-4, and for bf16 the bf16 bars (max-abs 5e-2, rel-L2 1e-2: its GELU
    rounds every operation to bf16, and the two frameworks evaluate them on
    the same bf16 values in float, rounding once each)."""
    port, jax_args = _inputs(43, "mlp")
    want = np.asarray(scripts["bench_vpu"].make_mlp(ln=ln, act=act)(
        *jax_args))
    got = mlp_block_modes(*port, ln=LN[ln], act=ACT[act]).numpy()
    if act == "bf16":
        d = got - want
        assert np.abs(d).max() <= 5e-2
        assert np.linalg.norm(d) <= 1e-2 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_s5_mlp_pipe2_matches_the_script(scripts):
    """S5c: two elements per program (_mlp_kernel_pipe2) computes the
    default MLP modes (two-pass LN, A&S GELU)."""
    port, jax_args = _inputs(44, "mlp")
    _close(mlp_block_modes(*port), scripts["bench_vpu"].make_mlp_pipe2()(
        *jax_args))


@pytest.mark.parametrize("chunks", [2, 4, 8])
def test_s6_chunked_mlp_matches_the_script(scripts, chunks):
    """S6a: the MLP with the hidden in chunks against the interpreted
    _mlp_kernel_chunked (the A&S erf; the port's plain version takes
    torch's erf, as the kernel's erff) at 1e-4."""
    port, jax_args = _inputs(45 + chunks, "mlp")
    want = scripts["bench_overlap"].make_mlp(chunks)(*jax_args)
    _close(mlp_block_chunked(*port, chunks), want)


@pytest.mark.parametrize("group,heads,d", [(2, 4, 64), (4, 4, 64),
                                           (8, 8, 128)])
def test_s6_grouped_attention_matches_the_script(scripts, group, heads, d):
    """S6b: three phases per group of heads against the interpreted
    _attn_half_grouped at 1e-4."""
    port, jax_args = _inputs(50 + group, "attn", d, heads)
    want = scripts["bench_overlap"].make_attn(group, heads)(*jax_args)
    _close(attn_half_block_phased(*port, heads, group), want)


def test_the_ops_refuse_unknown_modes_and_groups():
    port, _ = _inputs(60, "attn")
    with pytest.raises(ValueError, match="LN mode"):
        attn_half_block_phased(*port, H, H, ln="v0")
    with pytest.raises(ValueError, match="softmax mode"):
        attn_half_block_phased(*port, H, H, smax="exp3")
    with pytest.raises(ValueError, match="does not divide"):
        attn_half_block_phased(*port, H, 3)
    mport, _ = _inputs(61, "mlp")
    with pytest.raises(ValueError, match="activation mode"):
        mlp_block_modes(*mport, act="erf")
    with pytest.raises(ValueError, match="do not divide"):
        mlp_block_chunked(*mport, 3)


# csrc/attention_phased.cu's plan: (keys, head dim, heads, group) of the
# bench's S2/S5/S6b cases at (64, 257, 1024, 16) and of the card tests'
# PHASED_CASES (tests/test_torch_kernels.py)
RESIDENT = [(257, 64, 16, 16), (257, 64, 16, 8), (257, 64, 16, 4),
            (257, 64, 16, 2), (33, 16, 4, 2), (100, 128, 2, 1),
            (17, 48, 4, 4), (257, 64, 8, 8)]


@pytest.mark.parametrize("nk,dh,heads,group", RESIDENT)
def test_phased_plan_keeps_k_and_v_resident(nk, dh, heads, group):
    """Every shape the bench and the card tests send takes the resident
    branch: a cluster of at most 8 CTAs within a CTA's shared memory."""
    plan = phased_plan(nk, dh, heads, group)
    assert plan.branch == "resident"
    assert plan.cluster <= 8 and plan.smem <= SMEM_PER_BLOCK
    assert plan.cluster * plan.heads_per_cta == group


@pytest.mark.parametrize("group,cluster", [(2, 1), (4, 2), (8, 4), (16, 8)])
def test_phased_plan_splits_the_bench_groups_two_heads_a_cta(group, cluster):
    """At dh 64 and 257 keys two heads' K and V (157 KB) and a 16-query
    tile fit a CTA, so S6b's groups differ only in the cluster's size."""
    plan = phased_plan(257, 64, 16, group, batch=64, sms=132)
    assert (plan.heads_per_cta, plan.cluster, plan.qtile, plan.qsplit) == (
        2, cluster, 16, 1)


@pytest.mark.parametrize("nk", [400, 512])
def test_phased_plan_stages_where_one_head_does_not_fit(nk):
    """dh 128 above 384 keys: one head's K and V and a query tile exceed
    a CTA's shared memory, so the kernel stages them (8 queries a block)."""
    plan = phased_plan(nk, 128, 2, 2)
    assert plan.branch == "staging" and plan.qtile == 8
    assert plan.smem <= SMEM_PER_BLOCK


def test_phased_plan_splits_queries_when_the_ctas_leave_sms_idle():
    """Batch 1 × 16 heads is 8 CTAs on 132 SMs: two clusters per group
    split the query tiles; batch 64 fills the card with one."""
    assert phased_plan(257, 64, 16, 16, batch=1, sms=132).qsplit == 2
    assert phased_plan(257, 64, 16, 16, batch=64, sms=132).qsplit == 1


@pytest.mark.parametrize("nk,dh,heads,group", [(512, 128, 8, 8),
                                               (300, 128, 16, 16)])
def test_phased_plan_raises_where_neither_branch_fits(nk, dh, heads, group):
    """No resident layout and the group's scores too large to stage: a
    ValueError from the plan, and from the op on the CPU too."""
    with pytest.raises(ValueError, match="fit neither branch"):
        phased_plan(nk, dh, heads, group)
    x = torch.zeros(1, nk, heads * dh)
    p = [torch.zeros(heads * dh), torch.zeros(heads * dh),
         torch.zeros(3 * heads * dh, heads * dh), None,
         torch.zeros(heads * dh, heads * dh), torch.zeros(heads * dh)]
    with pytest.raises(ValueError, match="fit neither branch"):
        attn_half_block_phased(x, *p, heads, group)


# csrc/mlp_chunked.cu's plan: the rows of the bench's S6a (64·257 = 16448),
# of the card tests' test_mlp_chunked_kernel_matches_plain and of small
# batches, at every width the kernel takes
@pytest.mark.parametrize("rows_per_cluster", [1, 2])
@pytest.mark.parametrize("d", [256, 512, 768, 1024])
@pytest.mark.parametrize("m", [17, 100, 16448])
def test_mlp_chunked_plan_fits_and_covers_the_rows(m, d, rows_per_cluster):
    """A cluster of at most 8 CTAs within a CTA's shared memory, one column
    of CTAs per 256 output columns, and row tiles that cover the m rows
    exactly once (a last cluster's second tile lies wholly past m)."""
    plan = mlp_chunked_plan(m, d, 4 * d, rows_per_cluster)
    c, r = plan.cluster
    assert (c, r) == (d // 256, rows_per_cluster) and c * r <= 8
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.grid[0] == c and plan.grid[1] % r == 0
    starts = [128 * y for y in range(plan.grid[1])]
    covered = [row for s in starts for row in range(s, min(s + 128, m))]
    assert covered == list(range(m))
    assert sum(s >= m for s in starts) < r
    assert plan.sub_chunk == 64 * c and (4 * d) % plan.sub_chunk == 0


def test_mlp_chunked_plan_multicast_halves_the_l2_reads():
    """At the bench's (16448, 1024, 4096) the first version's tiling read
    ≈ 4.3 GB from L2; multicasting y across a row tile's 4 CTAs and W1, W2
    across 2 row tiles reads ≈ 1.6 GB, at least 2× less (R = 1: ≈ 2.7)."""
    one, two = (mlp_chunked_plan(16448, 1024, 4096, r) for r in (1, 2))
    assert one.l2_bytes_unicast == two.l2_bytes_unicast
    assert 4.2e9 < one.l2_bytes_unicast < 4.4e9
    assert 2 * two.l2_bytes <= one.l2_bytes_unicast
    assert two.l2_bytes < one.l2_bytes < one.l2_bytes_unicast


@pytest.mark.parametrize("d,hidden,rows_per_cluster,match", [
    (320, 1280, 2, "multiple of 256"), (1280, 5120, 2, "multiple of 256"),
    (1024, 4000, 2, "hidden width"), (1024, 4096, 3, "row tiles")])
def test_mlp_chunked_plan_raises_for_what_the_kernel_does_not_take(
        d, hidden, rows_per_cluster, match):
    with pytest.raises(ValueError, match=match):
        mlp_chunked_plan(100, d, hidden, rows_per_cluster)
