"""S6 · scripts/bench_overlap.py on the card: chunked MLP, grouped attention.

The script asks whether the TPU overlaps one stage's vector work with the
next stage's products when the work is split (24-layer chains at (64, 257,
1024, 16)):

- ``make_mlp(chunks)`` (:61) → ``_mlp_kernel_chunked`` (:32): B2 with the
  hidden split into 2, 4 or 8 chunks, fc1 → GELU → fc2 per chunk, the float
  partials summed; ``make_mlp(0)`` is B2 itself ("v0");
- ``make_attn(group)`` (:133) → ``_attn_half_grouped`` (:90): B1 in three
  phases per group of 2, 4 or 8 heads; ``make_attn(0)`` is B1 ("v0").

On the card the chunked MLP is ``mlp_block_chunked`` (csrc/mlp_chunked.cu):
the fused MLP that never writes its (M, 4D) hidden to device memory. D/256
CTAs own a 128-row tile, R of those row tiles a thread-block cluster
(``mlp_chunked_plan``), the operand slices multicast across it; each
sub-chunk of the hidden (``mlp_chunk_width``: 256 columns at D = 1024) is
computed by fc1 + GELU into the row tile's CTAs' shared memory and
accumulated by fc2 in registers. The script's chunks (2048, 1024 or 512
columns) are walked in those sub-chunks, so every chunk count runs the
same kernel; each row prints both widths and the plan's cluster and L2
bytes, and :func:`rows_sweep` times the kernel at R = 1 and 2. The
grouped attention is ``attn_half_block_phased`` with ``group`` heads per
cluster (csrc/attention_phased.cu: 2 heads a CTA, so a cluster of group /
2 CTAs). B1 and B2 are the port's own chains ("v0").

Each case is held to its plain version in float32 on the same bf16 inputs
and to "v0" at the bench's bars, then timed with CUDA events.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_phased,
                                                  attn_half_block_phased_ref,
                                                  attn_half_block_ref)
from mirage_tpu_torch.ops.fused_mlp import (MLP_CHUNK_ROWS, mlp_block,
                                            mlp_block_chunked,
                                            mlp_block_chunked_ref,
                                            mlp_block_ref, mlp_chunk_width,
                                            mlp_chunked_plan)

REPS = 24  # bench_overlap.py:27
# (batch, tokens, width, heads): bench_overlap.py:187, and the dry run's
SHAPE, TINY = (64, 257, 1024, 16), (2, 17, 64, 4)
CHUNKS, GROUPS = (2, 4, 8), (2, 4, 8)  # bench_overlap.py:202-207
REPLACES = {"mlp": "scripts/bench_overlap.py:32",
            "attn": "scripts/bench_overlap.py:90"}


def _plan_fields(m, d, rows_per_cluster=MLP_CHUNK_ROWS):
    plan = mlp_chunked_plan(m, d, 4 * d, rows_per_cluster)
    return {"cluster": list(plan.cluster), "l2_bytes": plan.l2_bytes,
            "l2_bytes_unicast": plan.l2_bytes_unicast}


def cases(x, attn_p, mlp_p, h, plan=False):
    """(tag, which, op, fn, plain version in float32, extra row fields);
    ``plan``: the chunked rows carry the kernel's plan."""
    f32 = [t.float() for t in (x, *mlp_p)]
    fa = [t.float() for t in (x, *attn_p)]
    d = x.shape[-1]
    planned = _plan_fields(x.numel() // d, d) if plan else {}
    out = [("mlp/v0", "mlp", mlp_block, lambda: mlp_block(x, *mlp_p),
            lambda: mlp_block_ref(*f32), {})]
    for c in CHUNKS:
        out.append((f"mlp/chunk{c}", "mlp", mlp_block_chunked,
                    lambda c=c: mlp_block_chunked(x, *mlp_p, c),
                    lambda c=c: mlp_block_chunked_ref(*f32, c),
                    {"chunks": c, "script_chunk_width": 4 * d // c,
                     "hidden_width_on_chip": mlp_chunk_width(d),
                     **planned}))
    out.append(("attn/v0", "attn", attn_half_block,
                lambda: attn_half_block(x, *attn_p, h),
                lambda: attn_half_block_ref(*fa, h), {}))
    for g in GROUPS:
        if h % g:
            continue
        out.append((f"attn/group{g}", "attn", attn_half_block_phased,
                    lambda g=g: attn_half_block_phased(x, *attn_p, h, g),
                    lambda g=g: attn_half_block_phased_ref(*fa, h, g),
                    {"heads_per_block": g}))
    return out


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """Rows: B2 and its chunked form at 2, 4, 8 chunks; B1 and its grouped
    form at 2, 4, 8 heads per block; each checked, then timed."""
    shape = bench.sizes(size, SHAPE, TINY)
    b, n, d, h = shape
    x, attn_p, mlp_p = bench.half_inputs(shape, device, 0.02)  # :189
    rows, v0 = [], {}
    for tag, which, op, fn, want_fn, extra in cases(x, attn_p, mlp_p, h,
                                                    plan=measure):
        got = fn()
        with runtime.plain_on_card():
            want = want_fn()
        err = bench.check(f"S6 {tag}", got, want)
        if tag.endswith("/v0"):
            v0[which] = got
        else:
            err["vs_v0"] = bench.check(f"S6 {tag} vs v0", got, v0[which])
        bound_ms, bound_by = bench.bound(*bench.half_work(b, n, d, which))
        row = {"case": f"S6 overlap {tag}", "op": op.__name__,
               "replaces": REPLACES[which], "shape": list(shape),
               "bound_ms": bound_ms, "bound_by": bound_by, **extra, **err}
        if tag.endswith("/v0"):
            row["replaces"] = ("B2 (make_mlp(0))" if which == "mlp"
                               else "B1 (make_attn(0))")
        if not measure:
            rows.append({**row, "measured": False})
            continue
        library = ((lambda: bench.library_mlp(x, *mlp_p)) if which == "mlp"
                   else (lambda: bench.library_attn_half(x, *attn_p, h)))
        rows.append({**row, **bench.time_op(fn, library, REPS)})
    return rows


@torch.no_grad()
def rows_sweep(chunks=CHUNKS[0], device="cuda"):
    """S6a at the bench's shape with R = 1 and 2 row tiles a cluster: ms per
    call and the plan's L2 bytes, each output bit-equal to the op's (the
    op takes ``MLP_CHUNK_ROWS``)."""
    b, n, d, h = SHAPE
    x, _, mlp_p = bench.half_inputs(SHAPE, device, 0.02)
    want = mlp_block_chunked(x, *mlp_p, chunks)
    rows = []
    for r in (1, 2):
        fn = lambda r=r: mlp_block_chunked(x, *mlp_p, chunks,  # noqa: E731
                                           rows_per_cluster=r)
        if not torch.equal(fn(), want):
            raise AssertionError(f"S6a: R = {r} moves the output")
        rows.append({"case": f"S6 overlap mlp/chunk{chunks} R={r}",
                     "rows_per_cluster": r, "shape": list(SHAPE),
                     **_plan_fields(b * n, d, r),
                     "ms": bench.cuda_ms(fn, iters=REPS), **bench.card()})
    return rows
