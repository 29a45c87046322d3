"""S1 · scripts/bench_attn2.py on the card: B6 in a 24-layer chain.

``chain`` (:33) runs REPS × (the packed-qkv attention of B6's forward,
``ops/block_attention.py:block_attention``, on the (48, 257, 3·1024) qkv
with 16 heads, then the re-projection of its (48, 257, 1024) output back to
3·1024 columns by a fixed weight). The re-projection is a plain product
outside any Pallas kernel in JAX (``einsum`` at :38), so ``torch.matmul``
does it here. The chain is timed three ways: through B6 (the port's
kernel), through the plain version, and through
``F.scaled_dot_product_attention`` as the yardstick (the port never calls
it). The JAX script's other A/B, the grid's ``dimension_semantics``
"arbitrary" against "parallel" (:15-30), has no CUDA counterpart: a CUDA
grid's blocks always run in no fixed order, so there is nothing to vary.

Before the timing, one attention call of B6 is held to its plain version
at the bars of ``mirage_tpu_torch.bench``.
"""

import torch
import torch.nn.functional as F

from mirage_tpu_torch import bench
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.block_attention import (block_attention,
                                                  block_attention_ref)

REPS = 24  # bench_attn2.py:12
# (batch, tokens, width, heads): bench_attn2.py:57, and the dry run's
SHAPE, TINY = (48, 257, 1024, 16), (2, 17, 64, 4)
REPLACES = "scripts/bench_attn2.py:21"


def sdpa_attention(qkv, num_heads, scale):
    """The yardstick: F.scaled_dot_product_attention on the packed qkv."""
    b, n, three_d = qkv.shape
    q, k, v = qkv.view(b, n, 3, num_heads, three_d // 3 // num_heads) \
        .permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return o.transpose(1, 2).reshape(b, n, three_d // 3)


def chain(attn_fn, qkv, w, num_heads, scale):
    """bench_attn2.py:33 chain: REPS × (attention, then o · w)."""
    for _ in range(REPS):
        qkv = torch.matmul(attn_fn(qkv, num_heads, scale), w)
    return qkv


def inputs(shape, device, dtype=torch.bfloat16):
    """bench_attn2.py:56-60: a standard-normal qkv and a 0.01-scaled
    (D, 3D) weight, from seed 0."""
    b, n, d, h = shape
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * d, generator=g).to(device, dtype)
    w = (torch.randn(d, 3 * d, generator=g) * 0.01).to(device, dtype)
    return qkv, w


def work(shape):
    """(FLOPs, bytes) per chain layer: the attention (4·B·N²·D; qkv read,
    its output written) and the re-projection (2·B·N·D·3D; the output and
    w read, the new qkv written)."""
    b, n, d, _ = shape
    attn = (4 * b * n * n * d, 2 * (b * n * 3 * d + b * n * d))
    proj = (2 * b * n * d * 3 * d, 2 * (b * n * d + 3 * d * d + b * n * 3 * d))
    return attn, proj


@torch.no_grad()
def run(size="large", device="cuda", measure=True):
    """[row]: B6's chain against the plain chain and the SDPA chain, ms per
    chain layer, the bound, the agreement of one call with its plain
    version, and the C entries the timed B6 chain launched."""
    shape = bench.sizes(size, SHAPE, TINY)
    b, n, d, h = shape
    scale = (d // h) ** -0.5
    qkv, w = inputs(shape, device)
    got = block_attention(qkv, h, scale)
    with runtime.plain_on_card():
        want = block_attention_ref(qkv.float(), h, scale)
    err = bench.check("S1 block_attention", got, want)
    out = chain(block_attention, qkv, w, h, scale)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("S1 chain: non-finite output")
    (fa, ba), (fp, bp) = work(shape)
    bound_ms, bound_by = bench.bound(fa + fp, ba + bp)
    row = {"case": "S1 attn2", "replaces": REPLACES, "shape": list(shape),
           "reps": REPS, **err, "bound_ms": bound_ms, "bound_by": bound_by,
           "attention_bound_ms": bench.bound(fa, ba)[0],
           "reprojection_bound_ms": bench.bound(fp, bp)[0],
           "grid_semantics_ab": "none on CUDA"}
    if not measure:
        return [{**row, "measured": False}]
    before = runtime.launch_counts()
    ms = bench.cuda_ms(lambda: chain(block_attention, qkv, w, h, scale),
                       iters=3) / REPS
    launches = dict(runtime.launch_counts() - before)
    lib_ms = bench.cuda_ms(lambda: chain(sdpa_attention, qkv, w, h, scale),
                           iters=3) / REPS
    with runtime.plain_on_card():
        plain_ms = bench.cuda_ms(
            lambda: chain(block_attention, qkv, w, h, scale), iters=1,
            warmup=1) / REPS
    attn_ms = bench.cuda_ms(lambda: block_attention(qkv, h, scale), iters=20)
    return [{**row, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "attention_ms": attn_ms,
             "launches": launches,
             "times_are": "per chain layer (attention + re-projection)",
             **bench.card()}]
