"""The port's bench (``mirage_tpu_torch.bench``) against the JAX bench
scripts it ports, on the CPU in float32.

Each A/B op is held to its script's Pallas kernel run in the interpreter on
the same numpy inputs: ``scripts/bench_lnfold.py`` is loaded with its
``LNFOLD_*`` environment (it reads its shape and ``INTERPRET`` at import);
``scripts/bench_pad264.py`` and ``scripts/bench_attn2.py`` pass no
``interpret`` flag, so ``pallas_call`` is patched to interpret. The port's
ops take their plain versions here (CPU tensors); on the card the same ops
launch the CUDA kernels, which ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` phase 9 hold to these plain versions.
"""

import functools
import importlib.util
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mirage_tpu_torch.bench import __main__ as bench_main
from mirage_tpu_torch.bench import attn2
from mirage_tpu_torch.ops.block_attention import (attn_half_block,
                                                  attn_half_block_masked,
                                                  attn_half_block_prenormed)
from mirage_tpu_torch.ops.fused_mlp import mlp_block, mlp_block_lnfold
from mirage_tpu_torch.ops.quant import gemm_s8

ROOT = Path(__file__).resolve().parents[1]
_count = itertools.count()


def _load_script(name):
    """scripts/<name>.py as a fresh module under a unique name."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_script_{name}_{next(_count)}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    """pallas_call in the interpreter, for the scripts that pass no flag."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _params(rng, d, hidden_mult, n_fused):
    """LN scale/shift, a (n_fused·d, d) and a (d, hidden_mult·d) weight in
    torch Linear layout and their biases, float32 numpy."""
    f = np.float32
    return {"g": (1 + 0.1 * rng.standard_normal(d)).astype(f),
            "be": (0.05 * rng.standard_normal(d)).astype(f),
            "w1": (rng.standard_normal((n_fused * d, d)) / np.sqrt(d)).astype(f),
            "b1": (0.02 * rng.standard_normal(n_fused * d)).astype(f),
            "w2": (rng.standard_normal((d, hidden_mult * d))
                   / np.sqrt(hidden_mult * d)).astype(f),
            "b2": (0.02 * rng.standard_normal(d)).astype(f)}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------ S4: the LN fold

# (B, N, D, H): the script's shape is read at import
LNFOLD_SHAPE = (2, 17, 64, 4)


@pytest.fixture
def lnfold_script(monkeypatch):
    b, n, d, h = LNFOLD_SHAPE
    for k, v in {"LNFOLD_B": b, "LNFOLD_N": n, "LNFOLD_D": d, "LNFOLD_H": h,
                 "LNFOLD_INTERPRET": 1}.items():
        monkeypatch.setenv(k, str(v))
    return _load_script("bench_lnfold")


def _lnfold_inputs(seed):
    b, n, d, h = LNFOLD_SHAPE
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    mlp, nxt, att = _params(rng, d, 4, 4), _params(rng, d, 1, 1), \
        _params(rng, d, 1, 3)
    return x, mlp, nxt, att


def test_mlp_block_lnfold_matches_the_script(lnfold_script):
    """out and y = LN_next(out) against the interpreted _mlp_lnfold_kernel.
    The script's LN takes the one-pass variance E[x²] − mean², the port two
    passes; at unit-scale rows the two agree to ~1e-6, so the bar is 1e-4
    (float32, the products in another order)."""
    x, p, nxt, _ = _lnfold_inputs(20)
    want_out, want_y = lnfold_script.mlp_lnfold(
        jnp.asarray(x), p["g"], p["be"], p["w1"].T, p["b1"], p["w2"].T,
        p["b2"], nxt["g"], nxt["be"])
    out, y = mlp_block_lnfold(*_t(x, p["g"], p["be"], p["w1"], p["b1"],
                                  p["w2"], p["b2"], nxt["g"], nxt["be"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)


def _bf16(*arrays):
    """The arrays rounded to bf16 (as float32 numpy) and as jax bf16."""
    r = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
         for a in arrays]
    return r, [jnp.asarray(a, jnp.bfloat16) for a in r]


def _bf16_bars(got, want):
    """The bars chip_smoke.py holds a bf16 kernel to against its float32
    plain version: max-abs 5e-2, rel-L2 1e-2."""
    d = got - want
    assert np.abs(d).max() <= 5e-2
    assert np.linalg.norm(d) <= 1e-2 * np.linalg.norm(want)


def test_attn_half_block_prenormed_matches_the_script(lnfold_script):
    """x + proj(attn(y·Wqkv + b)) against the interpreted
    _attn_prenormed_kernel (exp2 softmax). Its attention scratch is bf16
    whatever the input type, so it runs on bf16 inputs and the port's plain
    version in float32 on the same values, at the bf16 bars."""
    b, n, d, h = LNFOLD_SHAPE
    x, _, _, a = _lnfold_inputs(21)
    y = np.random.default_rng(22).standard_normal(x.shape).astype(np.float32)
    r, j = _bf16(x, y, a["w1"].T, a["b1"], a["w2"].T, a["b2"])
    want = lnfold_script.attn_prenormed(*j)
    got = attn_half_block_prenormed(*_t(r[0], r[1], r[2].T, r[3], r[4].T,
                                        r[5]), h)
    _bf16_bars(got.numpy(), np.asarray(want.astype(jnp.float32)))


def test_pair_b_equals_pair_a(lnfold_script):
    """In the port the folded pair computes what the current pair does, bit
    for bit on the CPU (the same plain LN and products); and the script's
    folded pair (bf16, as above) at the bf16 bars."""
    b, n, d, h = LNFOLD_SHAPE
    x, p, nxt, a = _lnfold_inputs(23)
    mlp = _t(p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"])
    ln_next = _t(nxt["g"], nxt["be"])
    attn = _t(a["w1"], a["b1"], a["w2"], a["b2"])
    xt = torch.from_numpy(x)
    pair_a = attn_half_block(mlp_block(xt, *mlp), *ln_next, *attn, h)
    pair_b = attn_half_block_prenormed(
        *mlp_block_lnfold(xt, *mlp, *ln_next), *attn, h)
    assert torch.equal(pair_a, pair_b)
    r, j = _bf16(x, p["g"], p["be"], p["w1"].T, p["b1"], p["w2"].T, p["b2"],
                 nxt["g"], nxt["be"], a["w1"].T, a["b1"], a["w2"].T, a["b2"])
    want = lnfold_script.attn_prenormed(*lnfold_script.mlp_lnfold(*j[:9]),
                                        *j[9:])
    got = attn_half_block_prenormed(
        *mlp_block_lnfold(*_t(r[0], r[1], r[2], r[3].T, r[4], r[5].T, r[6],
                              r[7], r[8])),
        *_t(r[9].T, r[10], r[11].T, r[12]), h)
    _bf16_bars(got.numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------- S7: the masked half

@pytest.mark.parametrize("n,n_valid", [(24, 17), (32, 17)])
def test_attn_half_block_masked_matches_the_script(interpret_pallas, n,
                                                   n_valid):
    """B1 over n rows with the keys past n_valid masked, against the
    interpreted _attn_half_masked_kernel (make_attn(True, ...)) at 1e-4; its
    first n_valid rows against B1 at n_valid on those rows (the unmasked
    kernel, make_attn(False, ...)) at 1e-4 too."""
    script = _load_script("bench_pad264")
    b, d, h = 2, 64, 4
    rng = np.random.default_rng(24 + n)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    p = _params(rng, d, 1, 3)
    jax_args = (p["g"], p["be"], p["w1"].T, p["b1"], p["w2"].T, p["b2"])
    want = script.make_attn(True, h, n_valid)(jnp.asarray(x), *jax_args)
    port = _t(p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"])
    got = attn_half_block_masked(torch.from_numpy(x), *port, h, n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    base = script.make_attn(False, h, n_valid)(jnp.asarray(x[:, :n_valid]),
                                               *jax_args)
    np.testing.assert_allclose(got[:, :n_valid].numpy(), np.asarray(base),
                               atol=1e-4)
    np.testing.assert_allclose(
        got[:, :n_valid].numpy(),
        attn_half_block(torch.from_numpy(x[:, :n_valid].copy()), *port,
                        h).numpy(), atol=1e-5)


def test_padded_mlp_rows_match_the_script(interpret_pallas):
    """B2 on 264-style padded rows: the port's mlp_block against
    make_mlp_3d and make_mlp_flat (the script's 528-row blocks over the
    flattened rows) at 1e-4."""
    script = _load_script("bench_pad264")
    b, n, d = 2, 24, 64
    rng = np.random.default_rng(26)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    p = _params(rng, d, 4, 4)
    jax_args = (p["g"], p["be"], p["w1"].T, p["b1"], p["w2"].T, p["b2"])
    got = mlp_block(*_t(x, p["g"], p["be"], p["w1"], p["b1"], p["w2"],
                        p["b2"])).numpy()
    for make in (script.make_mlp_3d, script.make_mlp_flat):
        np.testing.assert_allclose(got, np.asarray(make()(jnp.asarray(x),
                                                          *jax_args)),
                                   atol=1e-4)


# -------------------------------------------------------- S1: the chain

def test_attn2_chain_matches_the_script(monkeypatch):
    """attn2.chain through block_attention (B6) against the script's chain
    of the interpreted _block_attn_kernel (make_block("parallel")) and of
    _attn_xla, 24 layers deep, float32: rel-L2 1e-5 (a weight of gain ~1
    keeps the chain's values in range). make_block predates the kernel's
    (heads, N, N) score scratch and passes none, so the patched pallas_call
    adds the one _block_attn_fwd gives it."""
    from jax.experimental.pallas import tpu as pltpu

    from mirage_tpu.ops.block_attention import _attn_xla

    script = _load_script("bench_attn2")
    b, n, d, h = 2, 17, 64, 4
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda kernel, **kw: real(
        kernel, scratch_shapes=[pltpu.VMEM((h, n, n), jnp.float32)],
        interpret=True, **kw))
    scale = (d // h) ** -0.5
    rng = np.random.default_rng(27)
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    w = (rng.standard_normal((d, 3 * d)) / np.sqrt(d)).astype(np.float32)
    got = attn2.chain(attn2.block_attention, torch.from_numpy(qkv),
                      torch.from_numpy(w), h, scale).numpy()
    assert got.shape == qkv.shape and np.isfinite(got).all()
    for fn in (script.make_block("parallel"), _attn_xla):
        want = np.asarray(jax.jit(lambda q, w_: script.chain(
            fn, q, w_, h, scale))(jnp.asarray(qkv), jnp.asarray(w)))
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ------------------------------------------------------ S3: the int8 dot

@pytest.mark.parametrize("m,k,n", [(40, 64, 32), (33, 4096, 16)])
def test_gemm_s8_plain_is_the_int32_product(m, k, n):
    """gemm_s8's plain version bit-equal to the int32 product and to the
    probe's reference (bench_int8.py:75: jnp.dot of the int32 casts; the
    script's weight is (K, N), the port's (N, K))."""
    rng = np.random.default_rng(28)
    a = rng.integers(-127, 127, (m, k)).astype(np.int8)
    w = rng.integers(-127, 127, (n, k)).astype(np.int8)
    got = gemm_s8(*_t(a, w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.int32),
                                        jnp.asarray(w.T).astype(jnp.int32))))


# ---------------------------------------------------- the bench's entry

def test_bench_dry_run_runs_every_row(tmp_path):
    """--dry-run --device cpu --size tiny: the headline, the five train rows
    and the A/B cases run (the checks included), each row marked unmeasured
    and holding no time or value."""
    out = tmp_path / "rows.json"
    rc = bench_main.main(["--dry-run", "--device", "cpu", "--size", "tiny",
                          "--all", "--ab", "--json", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())
    assert rows[0]["metric"] == bench_main.METRIC
    assert rows[0]["output_shapes"] == {"bscan": [2, 1, 512, 512],
                                        "slo": [2, 1, 512, 512],
                                        "bscanlayermap": [2, 13, 128, 128]}
    metrics = [r["metric"] for r in rows[1:6]]
    assert metrics == ["pretrain_vitb_img_per_sec",
                       "seg_vitb_frozen_img_per_sec",
                       "seg_vitb_fullfreeze_img_per_sec",
                       "cls_vitb_probe_img_per_sec",
                       "cls_vitb_fullft_img_per_sec"]
    cases = {r["case"].split()[0] for r in rows[6:]}
    assert cases == {"S1", "S2", "S3", "S4", "S5", "S6", "S7"}
    for r in rows:
        assert r["measured"] is False
        assert not {"value", "ms", "ms_per_step"} & set(r), r


def test_bench_refuses_to_measure_without_a_card(monkeypatch):
    """No card, or a CPU device without --dry-run: exit 2, no row; in a
    fresh process that sees no card too (CUDA_VISIBLE_DEVICES empty)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_main.main([]) == 2
    assert bench_main.main(["--device", "cpu"]) == 2
    out = subprocess.run([sys.executable, "-m", "mirage_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_bench_imports_neither_jax_nor_the_jax_package():
    """In a fresh process, the bench and every module of it import no jax
    and nothing of mirage_tpu (mirage_tpu_torch is the port)."""
    code = """
import sys
import mirage_tpu_torch.bench.__main__
from mirage_tpu_torch.bench import attn2, int8, lnfold, pad264, train
from mirage_tpu_torch.bench import attn_half, overlap, vpu
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib")
             or n == "mirage_tpu" or n.startswith("mirage_tpu."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
