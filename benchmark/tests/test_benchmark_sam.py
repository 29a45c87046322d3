"""The ``sam_vit_huge.seg_frozen_1024`` cell on the CPU at a tiny size: its
run comes out correct, untraced and traced; each planted fault in the
program, and the control, reads above a limit; the work counts against
counts by hand; the new readers; its entries in BENCHMARK.json. On a card, the control and each fault read above a limit of the cell at
its own size on three seeds."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run, sam_control, work_sam
from benchmark.drivers import sam_seg
from benchmark.reference import sam as ref_sam
from benchmark.tests.conftest import ROOT

CELL = "sam_vit_huge.seg_frozen_1024"
SEED = 1234567 + 2 ** 31
# the tiny size of models/sam.py's "sam_tiny" preset: a 10 × 10 grid in
# windows of 4 (9 windows, 5 of them padded), global blocks 1 and 3
TINY = dict(encoder_embed_dim=64, encoder_depth=4, encoder_num_heads=2,
            encoder_global_attn_indexes=[1, 3], window_size=4,
            prompt_embed_dim=32, image_size=160)
# above the program's readings at the tests' seeds (bf16 on the CPU:
# 0.0060-0.0092, 0.00018-0.00062, 0.0009-0.0044, 0.0031-0.011), below the
# control's but for the loss (0.084-0.087, 0.0006-0.0018, 0.018-0.027,
# 0.026-0.041): at this size the loss gap tells the two apart by no margin
TINY_LIMITS = {"feature_gap": 0.03, "loss_gap": 0.0015, "grad_gap": 0.01,
               "change_gap": 0.02}


def _load(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


@pytest.fixture
def tiny():
    cfg = _load("benchmark/configs/sam_vit_huge.json")
    cfg.update(TINY)
    cfg["seg"] = {**cfg["seg"], "model": "sam_tiny", "image": 160}
    tr = _load("benchmark/traffic/seg_frozen_1024.json")
    tr["cli"] = {**tr["cli"], "batch_size": 2, "input_size": 160}
    tr["pool"] = 3
    return cfg, tr


def _run(tiny, traced=False):
    cfg, traffic = tiny
    return run.run_cell(CELL, SEED, 1.0, traced, device="cpu",
                        cfg=cfg,
                        traffic=traffic, cell={"limits": TINY_LIMITS})


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_is_correct(tiny, traced):
    result = _run(tiny, traced)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(TINY_LIMITS)
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {m["name"] for m in run.cell_metrics(
        run.load_json(ROOT / "BENCHMARK.json"), CELL, False)}
    if traced:
        # device metrics never come from a CPU run
        assert not {"relpos_attn_roofline.train", "mfu.train",
                    "relpos_plain_calls.train"} & set(result["metrics"])
    else:
        assert set(result["metrics"]) == e2e == {"train_images_per_s",
                                                 "setup_s"}


def _centred(t, n):
    return t[(t.shape[0] + 1) // 2 - n:][:2 * n - 1]


def _masked(qkv, bias, tab_h, tab_w, heads, window):
    """The plain attention with the padded keys masked out of each
    window's softmax."""
    from mirage_tpu_torch.ops import relpos_attention as ra

    if not window:
        return ra.relpos_attention_ref(qkv, bias, tab_h, tab_w, heads, 0)
    b, h, w, three_d = qkv.shape
    d, n = three_d // 3, window * window
    dh = d // heads
    hp, wp = -(-h // window) * window, -(-w // window) * window
    grid = torch.zeros(b, hp, wp, three_d, dtype=qkv.dtype)
    grid[:, :h, :w] = qkv
    real = torch.zeros(b, hp, wp, 1)
    real[:, :h, :w] = 1
    keep = ra._windows(real, window)[:, None, None, :, 0] > 0
    q, k, v = ra._windows(grid, window).reshape(-1, n, 3, heads, dh).float() \
        .permute(2, 0, 3, 1, 4)
    rq = q.reshape(*q.shape[:2], window, window, dh)
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", rq,
                         ra.rel_pos_table(window, tab_h.float()))
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", rq,
                         ra.rel_pos_table(window, tab_w.float()))
    logits = ((q * dh ** -0.5) @ k.transpose(-1, -2)).reshape(
        *q.shape[:2], window, window, window, window)
    logits = (logits + rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        *q.shape[:2], n, n)
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    out = (p @ v).transpose(1, 2).reshape(-1, n, d)
    return ra._unwindows(out, b, hp, wp, window)[:, :h, :w].to(qkv.dtype)


FAULTS = {
    "mask_pad": lambda f: _masked,
    "no_bias": lambda f: lambda qkv, b, h, w, heads, win: f(
        qkv, b, torch.zeros_like(h), torch.zeros_like(w), heads, win),
    "global_windowed": lambda f: lambda qkv, b, h, w, heads, win: f(
        qkv, b, _centred(h, 4), _centred(w, 4), heads, win or 4),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(tiny, fault, monkeypatch):
    from mirage_tpu_torch.models import sam

    monkeypatch.setattr(sam, "relpos_attention",
                        FAULTS[fault](sam.relpos_attention))
    result = _run(tiny)
    assert not result["correct"], result["checks"]


def test_control_and_reference_faults_read_above_a_limit(tiny):
    """The reference with fp8 products, and each fault planted in the
    reference's encoder, put in the program's place."""
    cfg, traffic = tiny
    got = sam_control.readings(5, device="cpu", cfg=cfg, traffic=traffic)
    assert set(got) == set(sam_control.FAULTS)
    for fault, r in got.items():
        assert any(r[k] > TINY_LIMITS[k] for k in TINY_LIMITS), (fault, r)


def _vit_h():
    return _load("benchmark/configs/sam_vit_huge.json")


def test_relpos_work_by_hand():
    cfg = _vit_h()
    b, h, dh, n = 4, 16, 80, 4096
    # 25 windows of 196 keys, the real queries alone; the bias products
    # 2·n·dh·14 twice a head
    assert work_sam.relpos_attn(cfg, b, 14) == (
        4 * b * h * n * 196 * dh + b * h * 2 * 2 * n * dh * 14,
        b * h * dh * 4 * n * 2)
    assert work_sam.relpos_attn(cfg, b, 0)[0] == (
        4 * b * h * n * n * dh + b * h * 4 * n * dh * 64)
    want = sum(max(f / 989e12, by / 3.35e12) * 1e3 for f, by in (
        [work_sam.relpos_attn(cfg, b, 14)] * 28
        + [work_sam.relpos_attn(cfg, b, 0)] * 4))
    assert work_sam.relpos_least_ms(cfg, b) == pytest.approx(want)


def test_step_work_by_hand():
    cfg = _vit_h()
    ops = work_sam.seg_step(cfg, 1, 0)
    d, n = 1280, 4096
    blocks = 32 * (2 * n * d * (3 * d + d + 4 * d + 4 * d))
    attn = 28 * work_sam.relpos_attn(cfg, 1, 14)[0] \
        + 4 * work_sam.relpos_attn(cfg, 1, 0)[0]
    embed = 2 * n * 768 * d
    neck = 2 * n * d * 256 + 2 * n * 9 * 256 * 256
    enc = sum(f for name, f, _ in ops.ops if not name.startswith("head"))
    assert enc == blocks + attn + embed + neck
    assert enc == pytest.approx(5.64e12, rel=2e-3)  # ≈ 5.6 TFLOP an image
    head = sum(f for name, f, _ in ops.ops if name.startswith("head"))
    assert head == pytest.approx(1.91e12, rel=2e-3)
    # the frozen encoder counts no gradient
    assert not [name for name, _, _ in ops.ops
                if name.startswith("enc") and name.endswith((".dx", ".dw"))]


def test_encoder_has_published_parameter_count():
    specs = ref_sam.param_specs(_vit_h())
    n = sum(math.prod(s) for name, s, _ in specs
            if name.startswith("image_encoder."))
    assert n == _vit_h()["encoder_params"] == 637_026_048


GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
       "memory_peak_bytes": 1}
FACTS = {"window_s": 2.0, "busy_s": 1.5, "kernels": 600,
         "dispatch_ms": 7.5, "device_ops": [], "idle_gaps": []}
TRAIN = {"mode": "train", "calls": 2, "trace": FACTS, "device": GPU,
         "relpos_attn_s": 0.5, "relpos_attn_least_s": 0.125}


def test_relpos_roofline_reader():
    read = run.reader("relpos_attn_roofline.train")
    assert read(TRAIN) == pytest.approx(25.0)
    for rec in ({**TRAIN, "relpos_attn_s": None},      # no such kernel ran
                {k: v for k, v in TRAIN.items()
                 if not k.startswith("relpos")},         # an older record
                {**TRAIN, "trace": None},
                {**TRAIN, "device": {**GPU, "platform": "cpu"}}):
        assert read(rec) is None


def test_relpos_kernel_names():
    assert sam_seg.is_relpos("void relpos_attn_fwd_kernel<80, 16>(x)")
    assert sam_seg.is_relpos("relpos_attn_bias_kernel(x)")
    assert not sam_seg.is_relpos("void attn_fwd::attention_fwd_kernel<80>")


@pytest.fixture
def spans_of_two_steps():
    """Two steps' spans under a CPU profiler, each with two windowed blocks
    (one plain call) and one global block (the kernel)."""
    from mirage_tpu_torch.utils import profiling
    from mirage_tpu_torch.utils.profiling import annotate

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with annotate("mirage.step"):
                with annotate("mirage.win_block"):
                    profiling.tally(relpos_attn_plain=1)
                with annotate("mirage.win_block"):
                    profiling.tally(relpos_attn_kernel=1)
                with annotate("mirage.global_block"):
                    profiling.tally(relpos_attn_kernel=1)
    yield
    profiling.reset()


def test_span_readers(spans_of_two_steps):
    assert run.reader("relpos_plain_calls.train")(TRAIN) == 1.0
    assert run.reader("self_ms.train_win_block")(TRAIN) > 0
    assert run.reader("self_ms.train_global_block")(TRAIN) > 0
    assert run.reader("relpos_plain_calls.train")(
        {**TRAIN, "mode": "infer"}) is None


def test_plain_calls_read_nothing_without_the_op():
    from mirage_tpu_torch.utils import profiling
    from mirage_tpu_torch.utils.profiling import annotate

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("mirage.step"):
            pass
    try:
        assert run.reader("relpos_plain_calls.train")(TRAIN) is None
    finally:
        profiling.reset()


def test_benchmark_entries():
    b = run.load_json(ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for name in ("train_images_per_s", "mfu.train", "kernel_roofline.train",
                 "idle_pct.train", "dispatch_ms.train",
                 "kernels_per_step.train", "peak_mem_gib.train"):
        assert entries[name]["workloads"][-1] == CELL
    for name in ("self_ms.train_step", "port_launches.train"):
        assert CELL not in entries[name]["workloads"]
    for name in ("relpos_attn_roofline.train", "self_ms.train_win_block",
                 "self_ms.train_global_block", "relpos_plain_calls.train"):
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "train_images_per_s"
    cfg = _vit_h()
    assert (cfg["encoder_embed_dim"], cfg["encoder_depth"],
            cfg["encoder_num_heads"], cfg["window_size"],
            cfg["encoder_global_attn_indexes"], cfg["image_size"],
            cfg["vit_patch_size"], cfg["prompt_embed_dim"]) == (
        1280, 32, 16, 14, [7, 15, 23, 31], 1024, 16, 256)
    assert cfg["reduced"] == []
    assert [c["name"] for c in b["configs"]][-1] == "sam_vit_huge"
    assert [(w["name"], w["traffic"], w["chips"]) for w in
            b["workloads"]][-1] == (CELL, "seg_frozen_1024", 1)
    assert b["configs"][-1]["reduced"] == []


@pytest.mark.card
def test_control_and_faults_fail_at_the_cell_size():
    """The fp8 control and each planted fault, put in the program's place
    at the cell's own size, read above a limit of the cell file on three
    seeds: run.run_cell's comparison would call each not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = run.load_json(ROOT / f"benchmark/cells/{CELL}.json")["limits"]
    for seed in (901, 902, 903):
        got = sam_control.readings(seed)
        assert set(got) == set(sam_control.FAULTS)
        for fault, r in got.items():
            assert any(r[k] > limits[k] for k in limits), (seed, fault, r)
        torch.cuda.empty_cache()
