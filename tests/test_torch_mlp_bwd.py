"""The MLP backward's hidden stage and its plans (csrc/mlp_bwd.cu,
csrc/wgrad.cu) on the CPU.

The hidden stage's plain version, ``mlp_bwd_hidden_ref(y, dy, w1, b1, w2)
-> (dh, act, db1)``, against the JAX package's ``_mlp_bwd_rows(...,
defused=True)`` on the same numpy inputs (y taken from the JAX side, so the
two LayerNorms do not enter): float32 at atol 3e-5 / rtol 1e-4, as
tests/test_torch_ops.py holds the ops; bf16 within a bf16 step of the
outputs (both round dh and act once from float products summed in another
order). Then the bf16 kernels' tile plans and the weight gradient's row
chunks, which the kernels take from these functions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mirage_tpu.ops.fused_mlp import _mlp_bwd_rows
from mirage_tpu_torch.ops import runtime
from mirage_tpu_torch.ops.fused_mlp import (MLP_BWD_DYLN_TILE,
                                            MLP_BWD_HIDDEN_TILE, mlp_bwd_plan,
                                            mlp_bwd_hidden_ref)

SMEM_PER_BLOCK = 232448  # an H100 CTA's dynamic shared memory


def _params(rng, d):
    """LN scale/shift, fc1 (d, 4d) and fc2 (4d, d) in the JAX (in, out)
    layout, float32."""
    f = np.float32
    return {"g": (1 + 0.1 * rng.standard_normal(d)).astype(f),
            "be": (0.05 * rng.standard_normal(d)).astype(f),
            "w1": (rng.standard_normal((d, 4 * d)) / np.sqrt(d)).astype(f),
            "b1": (0.02 * rng.standard_normal(4 * d)).astype(f),
            "w2": (rng.standard_normal((4 * d, d)) / np.sqrt(4 * d)).astype(f)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(66, 64), (99, 48)])
@pytest.mark.parametrize("large_mean", [False, True])
def test_hidden_stage_ref_matches_jax_rows(dtype, m, d, large_mean):
    rng = np.random.default_rng(m * d + large_mean)
    p = _params(rng, d)
    x = rng.standard_normal((m, d)).astype(np.float32)
    if large_mean:  # per-channel offsets up to ~30, as tests/test_torch_ops.py
        x += (30.0 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, _, _, db1, y, act, dh = _mlp_bwd_rows(
        jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["g"], p["be"],
        jnp.asarray(p["w1"], jdt), p["b1"], jnp.asarray(p["w2"], jdt),
        defused=True)
    tdt = getattr(torch, dtype)
    y_t = torch.from_numpy(np.array(y, np.float32)).to(tdt)
    got = mlp_bwd_hidden_ref(
        y_t, torch.from_numpy(dy).to(tdt),
        torch.from_numpy(np.ascontiguousarray(p["w1"].T)).to(tdt),
        torch.from_numpy(p["b1"]),
        torch.from_numpy(np.ascontiguousarray(p["w2"].T)).to(tdt))
    assert got[0].dtype == got[1].dtype == tdt
    assert got[2].dtype == torch.float32 and got[2].shape == (4 * d,)
    want = [np.asarray(dh, np.float32), np.asarray(act, np.float32),
            np.asarray(db1, np.float32).reshape(-1)]
    for name, g, w in zip(("dh", "act", "db1"), got, want):
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=3e-5, rtol=1e-4,
                                       err_msg=name)
        else:  # a bf16 step (2^-8 relative) of the largest element
            scale = np.abs(w).max()
            assert np.abs(g - w).max() <= 2 ** -7 * scale * (
                16 if name == "db1" else 1), name


# the backward's shapes: the pretraining encoder and decoder, the cls
# encoder, the card tests' ragged and narrow cuts
PLAN_SHAPES = [(25344, 768, 3072), (65536, 256, 1024), (16448, 768, 3072),
               (99, 48, 192), (8, 8, 32)]


@pytest.mark.parametrize("m,d,hdim", PLAN_SHAPES)
def test_mlp_bwd_plan_covers_every_tile_once(m, d, hdim):
    """Both launches: a persistent grid of at most one CTA per SM (the
    hidden stage's in clusters of two) whose clusters' tiles (c, c +
    clusters, ...) cover the tiling once, within a CTA's shared memory."""
    plan = mlp_bwd_plan(m, d, hdim, sms=132)
    assert (plan.hidden.cluster, plan.dyln.cluster) == (2, 1)
    for sub, (n, k), tile in ((plan.hidden, (hdim, d), MLP_BWD_HIDDEN_TILE),
                              (plan.dyln, (d, hdim), MLP_BWD_DYLN_TILE)):
        assert sub.tile == tile
        assert sub.tiles == -(-m // tile[0]) * -(-n // tile[1])
        clusters = sub.grid // sub.cluster
        assert sub.grid % sub.cluster == 0
        assert clusters == min(132 // sub.cluster, sub.tiles)
        owned = sorted(t for c in range(clusters)
                       for t in range(c, sub.tiles, clusters))
        assert owned == list(range(sub.tiles))
        assert max(len(range(c, sub.tiles, clusters))
                   for c in range(clusters)) == sub.tiles_per_cta
        assert sub.ktiles == -(-k // 64)
        assert sub.stages >= 3 and sub.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("m,d,hdim", [(0, 768, 3072), (25344, 0, 3072),
                                      (25344, 768, 0)])
def test_mlp_bwd_plan_raises_for_an_empty_product(m, d, hdim):
    with pytest.raises(ValueError, match="empty product"):
        mlp_bwd_plan(m, d, hdim, sms=132)


# weight gradients: (rows, n1, n2) of dW1 and dW2 at the pretraining
# encoder and decoder, the cls encoder, the seg head and a few rows
WGRAD_SHAPES = [(25344, 3072, 768), (65536, 256, 1024), (16448, 768, 3072),
                (65536, 1536, 384), (33, 64, 72)]


@pytest.mark.parametrize("m,n1,n2", WGRAD_SHAPES)
def test_wgrad_chunks_cover_the_rows_in_whole_slices(m, n1, n2):
    """Chunks of whole 64-row ring stages, at most 4096 rows, that cover the
    rows once, none empty; the same answer for the same shapes and SM count
    (a rerun sums in the same order)."""
    chunks, rows = runtime.wgrad_chunks(m, n1, n2, 132)
    assert rows % 64 == 0 and 64 <= rows <= runtime.WGRAD_MAX_ROWS
    assert (chunks - 1) * rows < m <= chunks * rows
    assert runtime.wgrad_chunks(m, n1, n2, 132) == (chunks, rows)
    tiles = -(-n1 // 128) * -(-n2 // 256)
    # at least half the card busy where the rows allow it
    if -(-m // 64) * tiles >= 132:
        assert 2 * chunks * tiles >= 132


@pytest.mark.parametrize("sms", [16, 114, 132])
def test_wgrad_chunks_on_other_cards(sms):
    """Any SM count gives whole-slice chunks that cover the rows; one slice
    of rows is one chunk; an empty product raises."""
    for m, n1, n2 in WGRAD_SHAPES:
        chunks, rows = runtime.wgrad_chunks(m, n1, n2, sms)
        assert rows % 64 == 0 and rows <= runtime.WGRAD_MAX_ROWS
        assert (chunks - 1) * rows < m <= chunks * rows
    assert runtime.wgrad_chunks(64, 3072, 768, sms) == (1, 64)
    with pytest.raises(ValueError, match="empty product"):
        runtime.wgrad_chunks(0, 3072, 768, sms)
