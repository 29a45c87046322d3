"""The LN kernel's launch plan (csrc/layernorm.cu) on the CPU.

``runtime.layernorm_plan`` mirrors every launch of the forward and the
backward: the instantiation (a width class held in registers, or the
generic kernels), the rows a CTA takes and the grid; CTA c's lane group s
takes rows (k·grid + c)·rows_per_cta + s. The backward writes one partial
row of dgamma and dbeta a CTA and finishes them on the card: the CTAs in
groups of 12, each group's rows summed in CTA order, then the groups in
order. The kernels run only on the card (``tests/test_torch_kernels.py``
holds them to their plain versions there). Here: the plan covers every row
once, keeps the partial rows to the grid, picks the generic kernels exactly
off the vector, and shares its constants with the source; and the plain
backward summed in the plan's order meets the dgamma and dbeta of the JAX
package's B5 kernel (``_mlp_block_bwd_defused``, interpreted) at widths 256
and 768 with a ragged last CTA: float32, 1e-5 relative to the largest
element (the same float terms summed in another order).
"""

import functools
import operator
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.ops.fused_mlp import _mlp_block_bwd_defused, _mlp_bwd_rows
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import ln_bwd_ref

SOURCE = (Path(__file__).resolve().parents[1] / "mirage_tpu_torch" / "csrc"
          / "layernorm.cu")
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("sms", [132, 7, 2])
@pytest.mark.parametrize("d", [72, 76, 256, 768, 1024])
@pytest.mark.parametrize("m", [5, 33, 16384, 16448, 25344, 65536])
def test_plan_covers_every_row_once(m, d, sms):
    """Every row in exactly one lane group of one CTA, forward and backward,
    in both types; the backward's partial rows are its grid, at most one a
    CTA an SM, in groups of 12."""
    for dtype in DTYPES:
        for backward in (False, True):
            plan = runtime.layernorm_plan(m, d, sms, dtype, backward)
            rows = np.concatenate([
                np.arange(r.start, r.stop, r.step) for c in range(plan.grid)
                for r in runtime.layernorm_rows(plan, m, c)])
            np.testing.assert_array_equal(np.sort(rows), np.arange(m))
            # every CTA has a row: no CTA launched for nothing
            assert all(runtime.layernorm_rows(plan, m, c)[0]
                       for c in range(plan.grid))
            if backward:
                assert plan.partial_rows == plan.grid \
                    <= sms * runtime.LN_BWD_CTAS
                assert plan.finish_groups == -(-plan.grid // 12)
            else:
                assert plan.partial_rows == plan.finish_groups == 0
                assert plan.grid <= sms * runtime.LN_FWD_CTAS[
                    dtype.itemsize]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_takes_the_generic_kernel_exactly_off_the_vector(dtype):
    """Up to 1024 wide, the generic kernels (width 0, element by element)
    take exactly the widths that are not a multiple of the 16-byte vector;
    the others take the least width class that holds them, a half-warp a
    row at 256 and a warp above."""
    vec = 16 // dtype.itemsize
    for d in range(1, 1025):
        plan = runtime.layernorm_plan(4096, d, 132, dtype, False)
        assert (plan.width == 0) == (d % vec != 0), d
        if plan.width:
            assert plan.vec == vec
            assert plan.width == min(w for w in runtime.LN_WIDTHS if w >= d)
            assert plan.threads_per_row == (16 if plan.width == 256 else 32)
            assert (plan.width // plan.vec) % plan.threads_per_row == 0
        else:
            assert (plan.vec, plan.threads_per_row) == (1, 32)
    assert runtime.layernorm_plan(64, 1032, 132, dtype, True).width == 0


def test_plan_constants_match_the_source():
    """The CTA size, the CTAs an SM, the generic backward's block, the
    finish groups, the width classes and the lanes a row of
    csrc/layernorm.cu are the plan's."""
    src = SOURCE.read_text()
    assert f"constexpr int LN_THREADS = {runtime.LN_THREADS};" in src
    assert f"constexpr int LN_BWD_CTAS = {runtime.LN_BWD_CTAS};" in src
    assert f"constexpr int LN_FINISH_CTAS = {runtime.LN_FINISH_CTAS};" in src
    assert f"constexpr int LN_GENERIC_ROWS = {runtime.LN_GENERIC_ROWS};" \
        in src
    fwd = runtime.LN_FWD_CTAS
    assert (f"constexpr int LN_FWD_CTAS = sizeof(T) == 2 ? {fwd[2]} : "
            f"{fwd[4]};") in src
    assert "return w == 256 ? 16 : 32;" in src
    # both launchers switch on exactly the plan's width classes
    assert sorted(int(w) for w in re.findall(r"case (\d+):", src)) == sorted(
        2 * runtime.LN_WIDTHS)
    assert "(width == 256 || width == 768 || width == 1024)" in src


def _fold(terms):
    """Left-to-right float sum, as the kernel adds (0 + t0 + t1 + ...)."""
    return functools.reduce(operator.add, terms, torch.zeros_like(terms[0]))


def _ln_bwd_in_plan_order(x, dyln, plan):
    """dgamma and dbeta as csrc/layernorm.cu sums them: each lane group
    over its rows in order (the generic kernel: each block's rows, then the
    blocks), the CTA's groups in order, the CTAs of a finish group in
    order, then the finish groups in order."""
    m = x.shape[0]
    mean = x.mean(-1, keepdim=True)
    inv = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + 1e-6)
    terms = torch.stack([dyln * (x - mean) * inv, dyln], 1)  # (m, 2, d)
    ctas = []
    for c in range(plan.grid):
        slots = runtime.layernorm_rows(plan, m, c)
        if plan.width:
            ctas.append(_fold([_fold([terms[r] for r in rows])
                               for rows in slots if rows]))
        else:  # block k: rows (k·grid + c)·32 + s
            blocks = zip(*(list(rows) + [None] * (len(slots[0]) - len(rows))
                           for rows in slots))
            ctas.append(_fold([_fold([terms[r] for r in blk if r is not None])
                               for blk in blocks]))
    groups = [_fold(ctas[i:i + runtime.LN_FINISH_CTAS])
              for i in range(0, plan.grid, runtime.LN_FINISH_CTAS)]
    assert len(groups) == plan.finish_groups
    out = _fold(groups)
    return out[0], out[1]


@pytest.mark.parametrize("m,d,sms", [(200, 256, 13), (200, 768, 20),
                                     (70, 76, 2)])
def test_plan_ordered_backward_matches_jax_b5(m, d, sms):
    """dgamma and dbeta summed in the plan's order from the float dyln
    (dh·W1, dh the JAX kernel's own) against the interpreted B5 kernel's,
    two finish groups with a ragged last CTA (width 76: the generic
    kernel's blocks); dx against the kernel's dx."""
    plan = runtime.layernorm_plan(m, d, sms, torch.float32, True)
    assert plan.finish_groups == (1 if d == 76 else 2)
    assert m % (plan.grid * plan.rows_per_cta) \
        or m < plan.grid * plan.rows_per_cta
    rng = np.random.default_rng(m + d)
    f = np.float32
    x = rng.standard_normal((m, d)).astype(f)
    dy = rng.standard_normal((m, d)).astype(f)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(f)
    be = (0.05 * rng.standard_normal(d)).astype(f)
    w1 = (rng.standard_normal((d, 4 * d)) / np.sqrt(d)).astype(f)
    b1 = (0.02 * rng.standard_normal(4 * d)).astype(f)
    w2 = (rng.standard_normal((4 * d, d)) / np.sqrt(4 * d)).astype(f)
    jx = jnp.asarray(x)
    want_dx, want_dg, want_db = _mlp_block_bwd_defused(
        jx, jnp.asarray(dy), g, be, w1, b1, w2, interpret=True)[:3]
    # dh as the kernel rounds it (float32 here), then dyln = dh·W1 in float
    dh = _mlp_bwd_rows(jx, jnp.asarray(dy), jnp.asarray(g)[None],
                       jnp.asarray(be)[None], w1, jnp.asarray(b1)[None], w2,
                       defused=True)[6]
    dyln = torch.from_numpy(np.array(dh)) @ torch.from_numpy(w1.T.copy())
    xt = torch.from_numpy(x)
    got_dg, got_db = _ln_bwd_in_plan_order(xt, dyln, plan)
    for got, want in ((got_dg, want_dg), (got_db, want_db)):
        want = np.asarray(want).reshape(-1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    got_dx = ln_bwd_ref(xt, dyln, torch.from_numpy(g), torch.from_numpy(dy))[0]
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
