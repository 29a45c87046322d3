"""S4 · scripts/bench_lnfold.py on the card: fold the next LN into B2's tail.

Pair A is the current order, B2 (``mlp_block``) then B1 (``attn_half_block``,
which starts with its LayerNorm). Pair B folds that LayerNorm into the MLP
half: ``mlp_block_lnfold`` also writes y = LN_next(out) (one new kernel,
csrc/gemm_lnfold.cu: fc2, bias, residual and the LayerNorm in one cluster
epilogue), and ``attn_half_block_prenormed`` starts at the qkv product from
y. The fold saves the attention half's LN pass (a read of out and a write
of its normed rows) and costs a second output of the MLP half; the bench
decides, as the script's docstring says.

At bench_lnfold.py:46-49's flagship (128, 257, 1024, 16), with :166-179's
inputs (standard-normal x; unit LN scales and zero biases; 0.02-scaled
weights) from seed 0: each half is held to its plain version at the
bench's bars, pair B to pair A (:195-199), then each pair is chained
``ITERS`` times (:201-209) and timed with CUDA events. The fold kernel
alone (``runtime.gemm_lnfold``) is timed beside fc2 with bias and residual
(``runtime.gemm``) followed by the LN kernel, which is what it replaces.
The TPU kernel's exp2 softmax (:124) is a TPU workaround; the port keeps
its exact softmax.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (
    attn_half_block, attn_half_block_prenormed, attn_half_block_prenormed_ref)
from mirage_tpu_torch.ops.fused_mlp import (mlp_block, mlp_block_lnfold,
                                            mlp_block_lnfold_ref)

ITERS = 30  # bench_lnfold.py:51
# (B, N, D, H): bench_lnfold.py:46-49, and the dry run's
SHAPE, TINY = (128, 257, 1024, 16), (2, 17, 256, 4)
REPLACES = {"mlp_block_lnfold": "scripts/bench_lnfold.py:63",
            "attn_half_block_prenormed": "scripts/bench_lnfold.py:105"}


def inputs(shape, device, dtype=torch.bfloat16):
    """x, the MLP's params (γ, β, w1, b1, w2, b2), the next LN's (γn, βn)
    and the attention's (wqkv, bqkv, wproj, bproj), torch Linear layout."""
    b, n, d, _ = shape
    g = torch.Generator().manual_seed(0)

    def rn(*s, scale=0.02):
        return (torch.randn(*s, generator=g) * scale).to(device, dtype)

    def const(v, size):
        return torch.full((size,), v, device=device, dtype=dtype)

    x = rn(b, n, d, scale=1.0)
    mlp = (const(1.0, d), const(0.0, d), rn(4 * d, d), const(0.0, 4 * d),
           rn(d, 4 * d), const(0.0, d))
    ln_next = (const(1.0, d), const(0.0, d))
    attn = (rn(3 * d, d), const(0.0, 3 * d), rn(d, d), const(0.0, d))
    return x, mlp, ln_next, attn


def pairs(mlp, ln_next, attn, heads):
    def pair_a(x):
        return attn_half_block(mlp_block(x, *mlp), *ln_next, *attn, heads)

    def pair_b(x):
        return attn_half_block_prenormed(*mlp_block_lnfold(x, *mlp, *ln_next),
                                         *attn, heads)

    return pair_a, pair_b


def work(shape):
    """(FLOPs, bytes) of the MLP half (with the fold's second output), of
    the attention half, and of the fold kernel alone (fc2 + epilogue)."""
    b, n, d, _ = shape
    m = b * n
    mlp = (2 * m * d * 8 * d, 2 * (3 * m * d + 8 * d * d + 9 * d))
    attn = (2 * m * d * 4 * d + 4 * b * n * n * d,
            2 * (3 * m * d + 4 * d * d + 4 * d))
    fold = (2 * m * 4 * d * d, 2 * (m * 4 * d + 3 * m * d + 4 * d * d + 3 * d))
    return mlp, attn, fold


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """Rows: the fold op, the prenormed half, the fold kernel alone, and
    pair A against pair B."""
    shape = bench.sizes(size, SHAPE, TINY)
    b, n, d, h = shape
    x, mlp, ln_next, attn = inputs(shape, device)
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    out, y = mlp_block_lnfold(x, *mlp, *ln_next)
    xo = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)) \
        .to(device, x.dtype)
    xa = attn_half_block_prenormed(xo, y, *attn, h)
    with runtime.plain_on_card():
        want_out, want_y = mlp_block_lnfold_ref(x.float(), *f32(mlp),
                                                *f32(ln_next))
        want_a = attn_half_block_prenormed_ref(xo.float(), y.float(),
                                               *f32(attn), h)
    errs = {"out": bench.check("S4 mlp_block_lnfold out", out, want_out),
            "y": bench.check("S4 mlp_block_lnfold y", y, want_y),
            "prenormed": bench.check("S4 attn_half_block_prenormed", xa,
                                     want_a)}
    pair_a, pair_b = pairs(mlp, ln_next, attn, h)
    a, bb = pair_a(x), pair_b(x)
    pair_err = bench.check("S4 pair B vs pair A", bb, a)
    pair_err["max_rel_diff"] = ((a.float() - bb.float()).abs().max()
                                / a.float().abs().max()).item()
    del out, y, xa, want_out, want_y, want_a, a, bb
    (fm, bm), (fa, ba), (ff, bf) = work(shape)
    bounds = {"fold": bench.bound(fm, bm), "prenormed": bench.bound(fa, ba),
              "kernel": bench.bound(ff, bf), "pair": bench.bound(fm + fa,
                                                                 bm + ba)}
    rows = [
        {"case": "S4 lnfold mlp_block_lnfold", "op": "mlp_block_lnfold",
         "replaces": REPLACES["mlp_block_lnfold"], "shape": list(shape),
         "max_abs_err": max(errs["out"]["max_abs_err"],
                            errs["y"]["max_abs_err"]), "errors": errs,
         "bound_ms": bounds["fold"][0], "bound_by": bounds["fold"][1],
         "kernel_bound_ms": bounds["kernel"][0]},
        {"case": "S4 lnfold attn_half_block_prenormed",
         "op": "attn_half_block_prenormed",
         "replaces": REPLACES["attn_half_block_prenormed"],
         "shape": list(shape), **errs["prenormed"],
         "bound_ms": bounds["prenormed"][0],
         "bound_by": bounds["prenormed"][1]},
        {"case": "S4 lnfold pair A vs pair B", "shape": list(shape),
         "iters": ITERS, **pair_err, "bound_ms": bounds["pair"][0],
         "bound_by": bounds["pair"][1]}]
    if not measure:
        return [{**r, "measured": False} for r in rows]

    # the fold op and the prenormed half alone, with their plain versions
    # and library composites
    out, y = mlp_block_lnfold(x, *mlp, *ln_next)
    fold, pre = mlp_block_lnfold, attn_half_block_prenormed
    timed = {}
    for name, fn, library in (
            ("fold", lambda: fold(x, *mlp, *ln_next),
             lambda: _library_fold(x, mlp, ln_next)),
            ("prenormed", lambda: pre(out, y, *attn, h),
             lambda: bench.library_attn_half(out, None, None, *attn, h,
                                             y=y))):
        timed[name] = bench.time_op(fn, library, 10)
    # the fold kernel alone against what it replaces
    x2, bias = x.view(-1, d), mlp[5]
    hid = runtime.gemm(runtime.layernorm(x2, *mlp[:2]), mlp[2], mlp[3],
                       gelu=True)
    kernel_ms = bench.cuda_ms(lambda: runtime.gemm_lnfold(
        hid, mlp[4], bias, x2, *ln_next), iters=10)
    unfolded_ms = bench.cuda_ms(lambda: runtime.layernorm(runtime.gemm(
        hid, mlp[4], bias, residual=x2), *ln_next), iters=10)
    del hid
    # the pairs, chained as bench_lnfold.py:201-209
    pair_ms, launches = {}, {}
    for name, pair in (("pair_a", pair_a), ("pair_b", pair_b)):
        start = runtime.launch_counts()
        pair_ms[name] = bench.chain_ms(pair, x, ITERS)
        launches[name] = dict(runtime.launch_counts() - start)
    ta, tb = pair_ms["pair_a"], pair_ms["pair_b"]
    card = bench.card()
    rows[0].update(timed["fold"], kernel_ms=kernel_ms,
                   unfolded_fc2_ln_ms=unfolded_ms)
    rows[1].update(timed["prenormed"])
    rows[2].update(pair_a_ms=ta, pair_b_ms=tb, delta=(ta - tb) / ta,
                   launches=launches, **card)
    return rows


def _library_fold(x, mlp, ln_next):
    """The fold from library calls: the MLP half, then F.layer_norm."""
    import torch.nn.functional as F

    out = bench.library_mlp(x, *mlp)
    return out, F.layer_norm(out, (x.shape[-1],), *ln_next, 1e-6)
