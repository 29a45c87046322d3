"""S7 · scripts/bench_pad264.py on the card: does padding 257 tokens pay?

The TPU's bf16 tiles are 16 rows, so the script pads MIRAGE-Large's 257
tokens to 264 and masks the keys past 257 (``_attn_half_masked_kernel``,
:24; ``make_mlp_flat`` :100 and ``make_mlp_3d`` :125 run B2 on the padded
rows). On the card the cases are:

- B1 at 257 (``attn_half_block``) against B1 at 264 with the keys past 257
  masked (``attn_half_block_masked``);
- B2 at 64·257 rows against 64·264 rows (``mlp_block``; the flat and the
  per-element 3-D forms are one chain on the card, whose rows need no
  alignment);
- both again at 320 tokens, a pad that fits this card's tiles: 320 = 5 × 64
  is a whole number of the attention kernel's 64-row query and key chunks,
  and 64 · 320 = 160 × 128 rows a whole number of the GEMM's 128-row M
  tiles (csrc/gemm_pingpong.cuh, ``BM = 128``).

Each masked case is first held to its plain version at the bench's bars,
and its first 257 rows to the unmasked B1 at 257 on the same rows. Times
are per call, from CUDA events.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_masked,
                                                  attn_half_block_masked_ref)
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_ref

REPS = 24  # bench_pad264.py:21
# (batch, valid tokens, width, heads, the pads): bench_pad264.py:166, 179
SHAPE, TINY = (64, 257, 1024, 16, (264, 320)), (2, 17, 64, 4, (24, 32))
REPLACES = {"attn": "scripts/bench_pad264.py:24",
            "mlp": "scripts/bench_pad264.py:100,125"}


def params(d, device, dtype=torch.bfloat16):
    """bench_pad264.py:167-177: unit LN, zero biases, 0.02-scaled weights
    (torch Linear layout), from seed 0."""
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return (torch.randn(*s, generator=g) * 0.02).to(device, dtype)

    ones = torch.ones(d, device=device, dtype=dtype)
    zeros = torch.zeros(d, device=device, dtype=dtype)
    attn = (ones, zeros, rn(3 * d, d), torch.zeros_like(ones).repeat(3),
            rn(d, d), zeros)
    mlp = (ones, zeros, rn(4 * d, d), torch.zeros_like(ones).repeat(4),
           rn(d, 4 * d), zeros)
    return attn, mlp


def work(b, n, d, n_valid, which):
    """(FLOPs, bytes) of one call at n rows per element (n_valid keys)."""
    m = b * n
    if which == "attn":
        return (2 * m * d * 4 * d + 4 * b * n * n_valid * d,
                2 * (2 * m * d + 4 * d * d + 6 * d))
    return 2 * m * d * 8 * d, 2 * (2 * m * d + 8 * d * d + 7 * d)


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """Rows: B1 and B2 at 257 and at each pad (B1 masked), each with its
    ms per call, bound, agreement and the C entries it launched."""
    b, nv, d, h, pads = bench.sizes(size, SHAPE, TINY)
    attn_p, mlp_p = params(d, device)
    g = torch.Generator().manual_seed(1)
    xs = {n: (torch.randn(b, n, d, generator=g) * 0.02).to(device,
                                                            torch.bfloat16)
          for n in (nv, *pads)}
    rows = []
    for n, x in xs.items():
        masked = n != nv

        def attn(x=x):
            if masked:
                return attn_half_block_masked(x, *attn_p, h, nv)
            return attn_half_block(x, *attn_p, h)

        def mlp(x=x):
            return mlp_block(x, *mlp_p)

        fp = [p.float() for p in attn_p]
        with runtime.plain_on_card():
            want = attn_half_block_masked_ref(x.float(), *fp, h, nv)
            want_mlp = mlp_block_ref(x.float(), *[p.float() for p in mlp_p])
        got = attn()
        errs = {"attn": bench.check(f"S7 attention half n={n}", got, want),
                "mlp": bench.check(f"S7 mlp_block n={n}", mlp(), want_mlp)}
        if masked:
            base = attn_half_block(x[:, :nv].contiguous(), *attn_p, h)
            bench.check(f"S7 masked n={n}: first {nv} rows vs B1 at {nv}",
                        got[:, :nv], base)
            errs["attn"]["first_rows_vs_unmasked"] = bench.agreement(
                got[:, :nv], base)["max_abs_err"]
        cases = [("attn", attn, "attn_half_block_masked" if masked
                  else "attn_half_block",
                  lambda x=x: bench.library_attn_half(x, *attn_p, h, nv)),
                 ("mlp", mlp, "mlp_block",
                  lambda x=x: bench.library_mlp(x, *mlp_p))]
        for which, fn, op, library in cases:
            bound_ms, bound_by = bench.bound(*work(b, n, d, nv, which))
            row = {"case": f"S7 pad264 {which} n={n}", "op": op,
                   "replaces": REPLACES[which], "shape": [b, n, d, h],
                   "n_valid": nv, "bound_ms": bound_ms, "bound_by": bound_by,
                   **errs[which]}
            if not measure:
                rows.append({**row, "measured": False})
                continue
            start = runtime.launch_counts()
            ms = bench.cuda_ms(fn, iters=REPS)
            launches = dict(runtime.launch_counts() - start)
            with runtime.plain_on_card():
                plain_ms = bench.cuda_ms(fn, iters=3, warmup=1)
            rows.append({**row, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": bench.cuda_ms(library, iters=REPS),
                         "launches": launches, "ms_per_24_layers": ms * REPS,
                         **bench.card()})
    return rows
