"""S2 · scripts/bench_attn_half.py on the card: B1's attention, 3 phases.

``v2_call`` (:54) runs ``_v2_kernel`` (:16): B1's attention half with every
head's float scores in one (H, N, N) scratch, one max-subtracted ``exp``
softmax over all of them, then every P·V, the projection and the residual;
it is timed against B1 (``_attn_half_fwd``, "v1 per-head") in 24-layer
chains at (64, 257, 1024, 16). On the card the three-phase half is
``attn_half_block_phased`` (csrc/attention_phased.cu): a cluster of CTAs
per group of heads and batch element, each CTA holding two heads' K and V
and the float scores of a 16-query tile. All 16 heads of MIRAGE-Large form
one group at 257 tokens (``heads_per_block``: the largest group that
divides the heads and that ``phased_plan`` can tile, a cluster of 8); the
softmax is per (row, head), so a smaller group computes the same function.

The case is held to its plain version in float32 on the same bf16 inputs,
and to B1 (the online-softmax kernel, csrc/attention.cu), at the bench's
bars, then timed with CUDA events beside B1 in the same call.
"""

import torch

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_phased,
                                                  attn_half_block_phased_ref,
                                                  phased_plan)

REPS = 24  # bench_attn_half.py:13
# (batch, tokens, width, heads): bench_attn_half.py:94, and the dry run's
SHAPE, TINY = (64, 257, 1024, 16), (2, 17, 64, 4)
REPLACES = "scripts/bench_attn_half.py:16"


def heads_per_block(n, dh, heads):
    """The largest group of heads that divides ``heads`` and that the
    phased kernel can tile (``phased_plan``)."""

    def fits(g):
        try:
            phased_plan(n, dh, heads, g)
        except ValueError:
            return False
        return True

    return max(g for g in range(1, heads + 1) if heads % g == 0 and fits(g))


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """[row]: the three-phase half against its plain version and B1, its ms
    per call beside B1's, the bound and the C entries it launched."""
    shape = bench.sizes(size, SHAPE, TINY)
    b, n, d, h = shape
    x, p, _ = bench.half_inputs(shape, device, 0.1)  # bench_attn_half.py:96
    group = heads_per_block(n, d // h, h)
    got = attn_half_block_phased(x, *p, h, group)
    with runtime.plain_on_card():
        want = attn_half_block_phased_ref(x.float(), *[t.float() for t in p],
                                          h, group)
    err = bench.check("S2 attn_half_block_phased", got, want)
    base = attn_half_block(x, *p, h)
    err["vs_b1"] = bench.check("S2 three-phase vs B1", got, base)
    bound_ms, bound_by = bench.bound(*bench.half_work(b, n, d, "attn"))
    row = {"case": "S2 attn_half 3-phase", "op": "attn_half_block_phased",
           "replaces": REPLACES, "shape": list(shape),
           "heads_per_block": group, "bound_ms": bound_ms,
           "bound_by": bound_by, **err}
    if not measure:
        return [{**row, "measured": False}]
    timed = bench.time_op(lambda: attn_half_block_phased(x, *p, h, group),
                          lambda: bench.library_attn_half(x, *p, h), REPS)
    b1_ms = bench.cuda_ms(lambda: attn_half_block(x, *p, h), iters=REPS)
    return [{**row, **timed, "b1_ms": b1_ms,
             "vs_b1_speedup": b1_ms / timed["ms"]}]
