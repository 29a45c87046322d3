"""The bf16 attention forward's plan and the plain attention at its ragged
shapes, on the CPU.

``attention_plan`` (ops/block_attention.py) is the tiling that
csrc/attention_fwd.cuh's launcher mirrors: every query row and every key
must be covered exactly once, the last key chunk issued a multiple of 8
wide and at least as wide as its keys, and a CTA must fit its shared
memory. The kernel itself runs only on the card
(tests/test_torch_kernels.py::test_attention_forward_every_head_dim_and_tail).

The plain attention the port's ops take on a CPU tensor is held to the JAX
package's functions at the shapes the kernel's tails come from: 257 tokens
(a one-row query tail over 64-row tiles, a one-key tail over 64-key chunks),
a lone query, B3's 256 queries over 257 keys, S7's 264 queries over 257
valid keys, and B8's 1025. float32 at atol 3e-5 / rtol 1e-4 (the same sums
in another order); bf16 at atol 2e-2 (both round the probabilities to bf16
before P·V, one bf16 step of an O(1) output is 8e-3).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.nn.attention import sdpa_xla
from mirage_tpu.ops.block_attention import _block_attn_fwd
from mirage_tpu.ops.flash_attention import _flash_fwd
from mirage_tpu_torch.nn.attention import sdpa
from mirage_tpu_torch.ops.block_attention import (SMEM_PER_BLOCK,
                                                  attention_plan,
                                                  block_attention)
from mirage_tpu_torch.ops.flash_attention import flash_attention

SIZES = [1, 35, 99, 257, 512, 769, 1025, 4097]
# (nq, nk): equal lengths and the callers' unequal ones
SHAPES = [(n, n) for n in SIZES] + [(256, 257), (264, 257), (1, 769),
                                     (1025, 35)]
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("nq,nk", SHAPES)
def test_plan_covers_every_query_and_key_once(dh, nq, nk):
    plan = attention_plan(nq, nk, dh, 3, 2, 132)
    rows = np.zeros(nq, int)
    for row0, n in plan.query_tiles:
        assert 0 < n <= 64
        rows[row0:row0 + n] += 1
    assert (rows == 1).all()
    # a CTA's two warpgroups take a pair of consecutive tiles
    assert plan.grid == (-(-len(plan.query_tiles) // 2), 3, 2)
    assert plan.waves == plan.grid[0] * 6 / (132 * plan.ctas_per_sm)
    keys = np.zeros(nk, int)
    for i, (key0, width, n) in enumerate(plan.key_chunks):
        keys[key0:key0 + n] += 1
        assert width % 8 == 0 and n <= width <= 64
        assert width == 64 or i == len(plan.key_chunks) - 1
    assert (keys == 1).all()
    assert plan.tail_width == plan.key_chunks[-1][1] < plan.key_chunks[-1][2] + 8
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.box_cols * plan.boxes >= dh > plan.box_cols * (plan.boxes - 1)
    assert plan.swizzle_bytes == 2 * plan.box_cols in (32, 64, 128)
    assert plan.pv_width >= dh and plan.ctas_per_sm >= 1


@pytest.mark.parametrize("args", [
    (257, 257, 8, 16, 64), (257, 257, 24, 16, 64), (257, 257, 144, 4, 2),
    (257, 257, 0, 4, 2), (0, 257, 64, 4, 2), (257, 0, 64, 4, 2),
    (257, 257, 64, 0, 2), (257, 257, 64, 4, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        attention_plan(*args, 132)


def test_plan_mirrors_the_kernel_source():
    """The constants and per-dh layout the plan assumes are the header's."""
    src = (Path(__file__).resolve().parents[1] / "mirage_tpu_torch" / "csrc"
           / "attention_fwd.cuh").read_text()
    for pattern in (r"constexpr int QROWS = 64;", r"constexpr int KC = 64;",
                    r"constexpr int CONSUMERS = 2;",
                    r"BOXC = \(DH == 16 \|\| DH == 32\) \? DH : 64;",
                    r"STAGES = BOXC == 64 && NBOX == 1 \? 5 : 4;",
                    r"SMEM = 1024 \+ \(CONSUMERS \+ 2 \* STAGES\) \* TILE_BYTES "
                    r"\+ 8 \* \(2 \* STAGES \+ 1\);",
                    r"MIN_BLOCKS = NPV <= 64 \? 2 : 1;",
                    r"const dim3 grid\(\(nq \+ CONSUMERS \* QROWS - 1\) / "
                    r"\(CONSUMERS \* QROWS\), heads, batch\);"):
        assert re.search(pattern, src), pattern
    for dh, box, stages in [(16, 16, 4), (32, 32, 4), (48, 64, 5),
                            (64, 64, 5), (96, 64, 4), (128, 64, 4)]:
        plan = attention_plan(257, 257, dh, 1, 1, 132)
        assert (plan.box_cols, plan.stages) == (box, stages)


def _heads(x, h):
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(0, 2, 1, 3)


def _merge(x):
    b, h, n, dh = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, n, h * dh)


@pytest.mark.parametrize("b,n,h,dh", [(2, 257, 2, 64), (1, 257, 4, 32),
                                      (2, 65, 2, 16)])
def test_packed_attention_at_ragged_tokens_matches_jax(b, n, h, dh):
    """B6's (and B1's) attention core on a packed qkv: the port's plain op
    against the JAX Pallas kernel in interpret mode and its XLA path."""
    rng = np.random.default_rng(n * dh)
    qkv = rng.standard_normal((b, n, 3 * h * dh)).astype(np.float32)
    scale = dh ** -0.5
    got = block_attention(torch.from_numpy(qkv), h, scale).numpy()
    want = _block_attn_fwd(jnp.asarray(qkv), h, scale, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("b,nq,nk,h,dh", [
    (2, 256, 257, 2, 32),   # B3: the decoders' queries over 257 context keys
    (1, 264, 257, 2, 64),   # S7: 264 query rows over the 257 valid keys
    (2, 1, 35, 2, 64),      # a lone query
    (1, 65, 1025, 1, 64)])  # B8's 1025 keys, a one-row query tail
def test_cross_attention_at_ragged_shapes_matches_jax(b, nq, nk, h, dh):
    """The port's plain attention (flash_attention's CPU path and sdpa, the
    plain version under B3 and S7) against the JAX flash kernel in
    interpret mode and sdpa_xla."""
    rng = np.random.default_rng(nq + nk + dh)
    d = h * dh
    q = rng.standard_normal((b, nq, d)).astype(np.float32)
    kv = rng.standard_normal((b, nk, 2 * d)).astype(np.float32)
    scale = dh ** -0.5
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                          num_heads=h, scale=scale).numpy()
    qh, kh, vh = (_heads(x, h) for x in (q, kv[..., :d], kv[..., d:]))
    want = _merge(np.asarray(_flash_fwd(jnp.asarray(qh), jnp.asarray(kh),
                                        jnp.asarray(vh), scale,
                                        interpret=True)))
    np.testing.assert_allclose(got, want, **TOL)
    plain = _merge(sdpa(*(torch.from_numpy(x) for x in (qh, kh, vh)),
                        scale).numpy())
    np.testing.assert_allclose(plain, np.asarray(_merge(np.asarray(sdpa_xla(
        jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh), scale)))), **TOL)
    np.testing.assert_allclose(plain, want, **TOL)


def test_bf16_attention_at_257_tokens_matches_jax():
    """bf16 at 257 tokens: the probabilities rounded to bf16 before P·V in
    both packages."""
    rng = np.random.default_rng(257)
    h, dh = 2, 64
    q, k, v = (rng.standard_normal((1, h, 257, dh)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = sdpa(tq, tk, tv, dh ** -0.5).float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = _flash_fwd(jq, jk, jv, dh ** -0.5, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)
