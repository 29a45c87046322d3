"""The SAM ViT image encoder on the port (``models/sam.py``,
``ops/relpos_attention.py``) against the plain float32 reference
(``tests/sam_reference.py``) at a tiny size that has both kinds of block
and the padding: a 10 × 10 grid (160² at patch 16) in windows of 4, so 9
windows of which 5 are padded, global attention at blocks 1 and 3; once at
head dim 32 and once at SAM ViT-H's 80. Then the neck alone, the patch
embedding's gradients under the reference freeze, the three planted faults,
the segmentation CLI on a SAM-layout checkpoint, the benchmark's copy of
the reference, and on a card the kernel at full ViT-H shapes."""

import json
import sys
from pathlib import Path

import pytest
import torch

from mirage_tpu_torch.adapters.input_adapters import PatchedInputAdapter
from mirage_tpu_torch.api.convert import sam_checkpoint_to_port
from mirage_tpu_torch.models.sam import SAMNeck, SAMSegModel

sys.path.insert(0, str(Path(__file__).resolve().parent))
import sam_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def tiny_cfg(dim=64, heads=2):
    return {"encoder_embed_dim": dim, "encoder_depth": 4,
            "encoder_num_heads": heads, "encoder_global_attn_indexes": [1, 3],
            "image_size": 160, "vit_patch_size": 16, "prompt_embed_dim": 32,
            "window_size": 4, "mlp_ratio": 4, "in_chans": 3}


def seeded_sd(cfg, seed=0):
    """A SAM-layout state dict drawn from ``seed``, the position tables
    and the position embedding non-zero (a trained checkpoint's are)."""
    gen = torch.Generator().manual_seed(seed)
    d, g, p = cfg["encoder_embed_dim"], ref.grid(cfg), cfg["vit_patch_size"]
    dh = d // cfg["encoder_num_heads"]
    hid, out = d * cfg["mlp_ratio"], cfg["prompt_embed_dim"]

    def rnd(*shape, std=0.02, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    pre = "image_encoder"
    sd = {f"{pre}.patch_embed.proj.weight": rnd(d, 3, p, p,
                                                std=(3 * p * p) ** -0.5),
          f"{pre}.patch_embed.proj.bias": rnd(d),
          f"{pre}.pos_embed": rnd(1, g, g, d)}
    for i in range(cfg["encoder_depth"]):
        b = f"{pre}.blocks.{i}"
        k = ref.window_of(cfg, i) or g
        sd.update({
            f"{b}.norm1.weight": rnd(d, std=0.1, mean=1.0),
            f"{b}.norm1.bias": rnd(d),
            f"{b}.attn.qkv.weight": rnd(3 * d, d, std=(1 / d) ** 0.5),
            f"{b}.attn.qkv.bias": rnd(3 * d, std=0.1),
            f"{b}.attn.proj.weight": rnd(d, d, std=(1 / d) ** 0.5),
            f"{b}.attn.proj.bias": rnd(d),
            f"{b}.attn.rel_pos_h": rnd(2 * k - 1, dh, std=0.1),
            f"{b}.attn.rel_pos_w": rnd(2 * k - 1, dh, std=0.1),
            f"{b}.norm2.weight": rnd(d, std=0.1, mean=1.0),
            f"{b}.norm2.bias": rnd(d),
            f"{b}.mlp.lin1.weight": rnd(hid, d, std=(1 / d) ** 0.5),
            f"{b}.mlp.lin1.bias": rnd(hid),
            f"{b}.mlp.lin2.weight": rnd(d, hid, std=(1 / hid) ** 0.5),
            f"{b}.mlp.lin2.bias": rnd(d)})
    sd.update({f"{pre}.neck.0.weight": rnd(out, d, 1, 1, std=d ** -0.5),
               f"{pre}.neck.1.weight": rnd(out, std=0.1, mean=1.0),
               f"{pre}.neck.1.bias": rnd(out),
               f"{pre}.neck.2.weight": rnd(out, out, 3, 3,
                                           std=(9 * out) ** -0.5),
               f"{pre}.neck.3.weight": rnd(out, std=0.1, mean=1.0),
               f"{pre}.neck.3.bias": rnd(out)})
    return sd


def port_model(cfg, sd, dtype=torch.float32):
    adapter = PatchedInputAdapter(3, 1, cfg["vit_patch_size"],
                                  cfg["image_size"])
    model = SAMSegModel(
        {"bscan": adapter}, None, embed_dim=cfg["encoder_embed_dim"],
        depth=cfg["encoder_depth"], num_heads=cfg["encoder_num_heads"],
        global_attn_indexes=cfg["encoder_global_attn_indexes"],
        window_size=cfg["window_size"], out_chans=cfg["prompt_embed_dim"],
        compute_dtype=dtype, generator=torch.Generator().manual_seed(1))
    model.load_state_dict(sam_checkpoint_to_port(sd), strict=True)
    return model


def images(cfg, b=2, seed=3):
    s = cfg["image_size"]
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, 3, s, s, generator=gen)


def as_map(tokens, cfg):
    g = ref.grid(cfg)
    return tokens.reshape(tokens.shape[0], g, g, -1).permute(0, 3, 1, 2)


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(autouse=True)
def _float32():
    ref.strict_float32()


@pytest.mark.parametrize("dim,heads", [(64, 2), (160, 2)])
def test_encoder_matches_the_reference(dim, heads):
    """Both block kinds, the padded windows, at head dim 32 and 80."""
    cfg = tiny_cfg(dim, heads)
    sd = seeded_sd(cfg)
    x = images(cfg)
    with torch.no_grad():
        got = port_model(cfg, sd).forward_light({"bscan": x})
        want = ref.encoder(cfg, sd, x)
    assert got.shape == (2, 100, cfg["prompt_embed_dim"])
    assert rel(as_map(got, cfg), want) < 1e-5


def test_neck_matches_the_reference():
    cfg = tiny_cfg()
    sd = seeded_sd(cfg)
    neck = SAMNeck(64, 32)
    neck.load_state_dict({k[len("image_encoder.neck."):]: v
                          for k, v in sd.items() if ".neck." in k})
    x = torch.randn(2, 10, 10, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = neck(x).permute(0, 3, 1, 2)
        want = ref.neck(x, sd, torch.matmul)
    assert rel(got, want) < 1e-5


def test_patch_embedding_gradients_under_the_reference_freeze():
    """The blocks frozen, the patch embedding trained through them: the
    attention takes its plain version and autograd its backward."""
    cfg = tiny_cfg()
    sd = seeded_sd(cfg)
    model = port_model(cfg, sd)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("input_adapters.bscan.proj"))
    x = images(cfg)
    w = torch.randn(2, 32, 10, 10, generator=torch.Generator().manual_seed(9))
    got = torch.autograd.grad(
        (as_map(model.forward_light({"bscan": x}), cfg) * w).sum(),
        [model.input_adapters.bscan.proj.weight,
         model.input_adapters.bscan.proj.bias])
    trained = ("patch_embed.proj.weight", "patch_embed.proj.bias")
    leaves = {k: v.clone().requires_grad_(k.endswith(trained))
              for k, v in sd.items()}
    want = torch.autograd.grad(
        (ref.encoder(cfg, leaves, x) * w).sum(),
        [leaves["image_encoder.patch_embed.proj.weight"],
         leaves["image_encoder.patch_embed.proj.bias"]])
    for g, r in zip(got, want):
        assert rel(g, r) < 1e-4


@pytest.mark.parametrize("fault", ["no_bias", "mask_pad", "global_windowed"])
def test_planted_faults_fail(fault):
    """Each fault puts the reference far from the port that matches it
    unfaulted (test_encoder_matches_the_reference)."""
    cfg = tiny_cfg()
    sd = seeded_sd(cfg)
    x = images(cfg)
    with torch.no_grad():
        got = as_map(port_model(cfg, sd).forward_light({"bscan": x}), cfg)
        bad = ref.encoder(cfg, sd, x, fault=fault)
    assert rel(got, bad) > 1e-3


def test_relpos_route_is_tallied():
    """On the CPU the op takes its plain version and tallies it to the
    innermost span, here a global block's."""
    from torch.profiler import ProfilerActivity, profile

    from mirage_tpu_torch.utils import profiling

    cfg = tiny_cfg()
    model = port_model(cfg, seeded_sd(cfg))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model.forward_light({"bscan": images(cfg, b=1)})
    rows = profiling.summary()
    profiling.reset()
    assert rows["mirage.win_block"]["calls"] == 2
    assert rows["mirage.global_block"]["counts"] == {"relpos_attn_plain": 2}
    assert rows["mirage.win_block"]["counts"] == {"relpos_attn_plain": 2}
    assert {"mirage.forward", "mirage.encoder"} <= set(rows)


def _relpos_inputs(device, dtype, window, b=2, grid=10, heads=2, dh=80,
                   seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    k = window or grid
    kw = dict(device=device, generator=gen)
    return (torch.randn(b, grid, grid, 3 * heads * dh, **kw).to(dtype),
            0.1 * torch.randn(3 * heads * dh, **kw),
            0.1 * torch.randn(2 * k - 1, dh, **kw),
            0.1 * torch.randn(2 * k - 1, dh, **kw))


def _relpos_grads(fn, inputs, trained, heads, window):
    leaves = [t.clone().requires_grad_(i in trained)
              for i, t in enumerate(inputs)]
    out = fn(*leaves, heads, window)
    w = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(11), device=out.device)
    grads = torch.autograd.grad((out.float() * w).sum(),
                                [leaves[i] for i in trained],
                                allow_unused=True)
    return out, grads


@pytest.mark.parametrize("window", [4, 0])
@pytest.mark.parametrize("trained", [(0,), (0, 1, 2, 3), (2, 3)])
def test_kernel_forward_takes_the_plain_backward(monkeypatch, window,
                                                 trained):
    """With a gradient asked for, the card's route keeps the kernel's
    forward (here the plain version standing in for it) and its backward
    is the plain version's, for whichever inputs are trained; the call
    tallies the kernel."""
    from torch.profiler import ProfilerActivity, profile

    from mirage_tpu_torch.ops import relpos_attention as op
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.utils import profiling

    inputs = _relpos_inputs("cpu", torch.float32, window)
    want_out, want = _relpos_grads(op.relpos_attention_ref, inputs, trained,
                                   2, window)
    ran = []

    def kernel(*args):
        assert not torch.is_grad_enabled()
        ran.append(args[-1])
        return op.relpos_attention_ref(*args)

    monkeypatch.setattr(op, "_kernel", kernel)
    monkeypatch.setattr(runtime, "use_kernel", lambda x: True)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("mirage.win_block"):
            got_out, got = _relpos_grads(op.relpos_attention, inputs,
                                         trained, 2, window)
    rows = profiling.summary()
    profiling.reset()
    assert ran == [window]
    assert rows["mirage.win_block"]["counts"] == {"relpos_attn_kernel": 1}
    assert torch.equal(got_out, want_out)
    for g, r in zip(got, want):
        assert (g is None and r is None) or torch.equal(g, r)


def _seg_root(tmp_path):
    root = tmp_path / "AROI"
    root.mkdir()
    (root / "INFO.json").write_text(json.dumps(
        {str(k): {"label": "background" if k == 0 else f"c{k}", "value": k}
         for k in range(8)}))
    return root


def test_seg_cli_builds_loads_and_steps_with_the_head_alone(tmp_path):
    """``setup`` on a SAM-layout checkpoint named as SAM ViT-H's: every
    ``image_encoder.*`` key used, the prompt and mask keys ignored, the
    head alone trainable under the full freeze; one step moves the head
    and leaves the encoder as loaded."""
    from mirage_tpu_torch.cli import run_seg_tuning as rs
    from mirage_tpu_torch.train.steps import init_train_state, make_train_step

    cfg = tiny_cfg()
    sd = seeded_sd(cfg)
    ckpt = dict(sd, **{
        "prompt_encoder.no_mask_embed.weight": torch.zeros(1, 32),
        "mask_decoder.iou_token.weight": torch.zeros(1, 32)})
    weights = tmp_path / "sam_vit_h_tiny.pth"
    torch.save(ckpt, weights)
    root = _seg_root(tmp_path)
    args = rs.process_args(rs.get_parser().parse_args([
        "--weights", str(weights), "--data_path", str(root), "--output_dir",
        str(tmp_path / "out"), "--model_override", "sam_tiny",
        "--input_size", "160", "--patch_size", "16", "--batch_size", "2",
        "--drop_path_encoder", "0", "--freeze_input_adapters", "--dtype",
        "float32", "--device", "cpu"]))
    fm, model, opt, _, loss_fn = rs.setup(args, torch.device("cpu"))
    assert fm.norm == "imagenet" and fm.model == "sam_vit_h"
    own = model.state_dict()
    for k, v in sam_checkpoint_to_port(sd).items():
        assert torch.equal(own[k], v), k
    assert not [k for k in own if "prompt" in k or "mask_decoder" in k]
    state = init_train_state(model, opt)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(n.startswith("output_adapters.semseg.")
                             for n in trainable)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(loss_fn, opt)
    gen = torch.Generator().manual_seed(2)
    batch = {"bscan": images(cfg),
             "semseg": torch.randint(0, 8, (2, 160, 160), generator=gen)}
    _, metrics = step(state, batch, torch.Generator().manual_seed(0), 1e-3)
    assert torch.isfinite(metrics["loss"])
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) != (n in trainable), n


def test_seg_cli_refuses_stochastic_depth(tmp_path):
    from mirage_tpu_torch.cli import run_seg_tuning as rs

    weights = tmp_path / "sam_vit_h_tiny.pth"
    torch.save(seeded_sd(tiny_cfg()), weights)
    args = rs.process_args(rs.get_parser().parse_args([
        "--weights", str(weights), "--data_path", str(_seg_root(tmp_path)),
        "--model_override", "sam_tiny", "--input_size", "160",
        "--patch_size", "16", "--device", "cpu"]))
    with pytest.raises(ValueError, match="stochastic depth"):
        rs.setup(args, torch.device("cpu"))


def test_benchmark_copy_of_the_reference_agrees_bit_for_bit():
    sys.path.insert(0, str(ROOT))
    from benchmark.reference import sam as bench_sam

    cfg = tiny_cfg()
    sd = seeded_sd(cfg)
    x = images(cfg)
    with torch.no_grad():
        for fault in ref.FAULTS:
            assert torch.equal(bench_sam.encoder(cfg, sd, x, fault=fault),
                               ref.encoder(cfg, sd, x, fault=fault)), fault


# (batch, grid rows, grid columns, window; 0: global, heads of 80) of
# the kernel's card test
KERNEL_SHAPES = [(4, 64, 64, 14, 16), (4, 64, 64, 0, 16),
                 (1, 64, 64, 14, 16), (1, 64, 64, 0, 16),
                 (2, 40, 50, 14, 16), (2, 40, 56, 0, 16),
                 (1, 64, 64, 16, 16), (1, 64, 64, 20, 16),
                 (2, 10, 10, 4, 2), (2, 10, 10, 0, 2), (2, 32, 32, 14, 12)]


@pytest.mark.parametrize("gh,gw,window", sorted(
    {s[1:4] for s in KERNEL_SHAPES} | {(3, 60, 0), (33, 17, 5)}))
def test_plain_version_matches_the_reference_on_the_card_grids(gh, gw,
                                                               window):
    """The plain version, which the kernel's card test holds it to, against
    the reference's attention (zero-padded windows through the qkv
    projection, SAM's decomposed bias) on each grid that test takes: grids
    that are a multiple of the window in neither direction, global blocks
    over grids that are not square."""
    from mirage_tpu_torch.ops.relpos_attention import relpos_attention_ref

    heads, dh = 2, 16
    d = heads * dh
    kh, kw = (window, window) if window else (gh, gw)
    gen = torch.Generator().manual_seed(gh * 1000 + gw * 10 + window)
    x = torch.randn(1, gh, gw, d, generator=gen)
    sd = {"a.qkv.weight": torch.randn(3 * d, d, generator=gen) * d ** -0.5,
          "a.qkv.bias": 0.1 * torch.randn(3 * d, generator=gen),
          "a.proj.weight": torch.eye(d), "a.proj.bias": torch.zeros(d),
          "a.rel_pos_h": 0.1 * torch.randn(2 * kh - 1, dh, generator=gen),
          "a.rel_pos_w": 0.1 * torch.randn(2 * kw - 1, dh, generator=gen)}
    with torch.no_grad():
        if window:
            xw, pad_hw = ref.window_partition(x, window)
            want = ref.window_unpartition(
                ref.attention(xw, sd, "a", heads, torch.matmul), window,
                pad_hw, (gh, gw))
        else:
            want = ref.attention(x, sd, "a", heads, torch.matmul)
        qkv = x @ sd["a.qkv.weight"].t() + sd["a.qkv.bias"]
        got = relpos_attention_ref(qkv, sd["a.qkv.bias"], sd["a.rel_pos_h"],
                                   sd["a.rel_pos_w"], heads, window)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("dh,gh,window,dtype", [
    (64, 8, 4, torch.bfloat16), (80, 8, 65, torch.bfloat16),
    (80, 65, 0, torch.bfloat16), (80, 8, 4, torch.float32)])
def test_launcher_refuses_what_the_kernel_does_not_take(dh, gh, window,
                                                        dtype):
    """The kernel takes bf16 at head dim 80 and windows (or grids) of up to
    64 rows and columns; the launcher refuses anything else before it
    touches a device, and counts no launch."""
    from mirage_tpu_torch.ops import runtime

    qkv = torch.zeros(1, gh, 64, 3 * dh, dtype=dtype)
    before = runtime.launch_counts()
    with pytest.raises(NotImplementedError):
        runtime.relpos_attention(qkv, qkv[0, 0, 0], qkv[0, 0], qkv[0, 0],
                                 heads=1, window=window)
    assert runtime.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,gh,gw,window,heads",
                         KERNEL_SHAPES)
def test_kernel_at_vit_h_shapes(b, gh, gw, window, heads):
    """The kernel against the plain version (float32 math from the same
    bf16 inputs) at SAM ViT-H's widths: a windowed layer (25 windows of
    14², 9 of them padded) and a global one (64² keys) at batch 4 and 1;
    a grid that is a multiple of the window in neither direction; a global
    block over a grid that is not square; windows of 16 (no padding) and 20
    (the wide tiles, padded); the CPU tests' 10 × 10 grid at two heads, and
    12 heads (b_k's last group of 8 half past the heads). A rerun is
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu "
                    "tests/test_torch_sam.py` on a machine with one")
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                       relpos_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kh, kw = (window, window) if window else (gh, gw)
    kwargs = dict(device="cuda", generator=gen)
    qkv = torch.randn(b, gh, gw, 240 * heads, **kwargs).bfloat16()
    bias = (0.1 * torch.randn(240 * heads, **kwargs)).bfloat16()
    tab_h = (0.1 * torch.randn(2 * kh - 1, 80, **kwargs)).bfloat16()
    tab_w = (0.1 * torch.randn(2 * kw - 1, 80, **kwargs)).bfloat16()
    with torch.no_grad():
        before = runtime.launch_counts()
        got = relpos_attention(qkv, bias, tab_h, tab_w, heads, window)
        again = relpos_attention(qkv, bias, tab_h, tab_w, heads, window)
        assert runtime.launch_counts() - before == {"relpos_attn": 2}
        with runtime.plain_on_card():
            want = relpos_attention_ref(qkv.float(), bias.float(),
                                        tab_h.float(), tab_w.float(), heads,
                                        window)
    assert got.dtype == torch.bfloat16
    assert rel(got.float(), want) < 1e-2
    assert float((got.float() - want).abs().max()) < 5e-2
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [14, 0])
def test_kernel_gradients_match_the_plain_route(window):
    """On the card with a gradient asked for, the kernel's forward and the
    plain backward against the plain route's forward and backward, bf16 qkv
    and float32 bias and tables, 16 heads of 80 over a 32 × 32 grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu "
                    "tests/test_torch_sam.py` on a machine with one")
    from mirage_tpu_torch.ops import runtime
    from mirage_tpu_torch.ops.relpos_attention import relpos_attention

    inputs = _relpos_inputs("cuda", torch.bfloat16, window, grid=32,
                            heads=16)
    trained = (0, 1, 2, 3)
    before = runtime.launch_counts()
    got_out, got = _relpos_grads(relpos_attention, inputs, trained, 16,
                                 window)
    assert runtime.launch_counts() - before == {"relpos_attn": 1}
    with runtime.plain_on_card():
        want_out, want = _relpos_grads(relpos_attention, inputs, trained, 16,
                                       window)
    assert rel(got_out.detach().float(), want_out.detach().float()) < 1e-2
    for g, r in zip(got, want):
        assert (g is None and r is None) or (
            g.dtype == r.dtype and rel(g.float(), r.float()) < 1e-3)
