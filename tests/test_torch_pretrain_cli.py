"""The PyTorch port's pretraining entry point (mirage_tpu_torch.cli.
run_pretraining) and the modules it brought, against the JAX package: the
pretraining augmentation and dataset folders (bit-equal), checkpoint
pruning and weight resolution, the pixel-space losses (and the token-space
step against them), remat, the warm start, and the command line itself
against the JAX command line and against a loss computed by hand.

Everything runs on the CPU in float32. Inputs are made with numpy; weights
come from one JAX initialisation carried across with
jax_params_to_state_dict. Tolerances: 1e-6 for the losses of one input
(float32, the same sums in another order), 1e-5 for a whole step's loss
and gradients and for the two command lines' first loss, 1e-3 for their
loss after one AdamW update (the update divides by sqrt of tiny second
moments, which magnifies float32 rounding of the gradients).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirage_tpu.cli import run_pretraining as jax_cli
from mirage_tpu.data.augment import PretrainAugment as JaxAugment
from mirage_tpu.data.folder import MultiTaskDatasetFolder as JaxFolder
from mirage_tpu.data.folder import MultiTaskPretDatasetFolder as JaxPretFolder
from mirage_tpu.losses.masked import masked_ce_loss as jax_ce
from mirage_tpu.losses.masked import masked_mse_loss as jax_mse
from mirage_tpu.train import checkpoint as jax_ckpt
from mirage_tpu.utils import native
from mirage_tpu_torch.api.convert import jax_params_to_state_dict, rename_keys
from mirage_tpu_torch.cli import run_pretraining as cli
from mirage_tpu_torch.cli.config import parse_with_yaml
from mirage_tpu_torch.data.augment import PretrainAugment
from mirage_tpu_torch.data.folder import (MultiTaskDatasetFolder,
                                          MultiTaskPretDatasetFolder)
from mirage_tpu_torch.losses.masked import (masked_ce_loss,
                                            masked_ce_loss_tokens,
                                            masked_mse_loss,
                                            masked_mse_loss_tokens)
from mirage_tpu_torch.nn.block import Block
from mirage_tpu_torch.ops.patch_embed import patchify
from mirage_tpu_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
DOMAINS = ["bscan", "slo", "bscanlayermap"]
# the flags of tests/test_pretrain_cli.py: miragepre_tiny at 64², patch 8
TINY = ["--in_domains", "bscan-slo-bscanlayermap",
        "--out_domains", "bscan-slo-bscanlayermap",
        "--model", "miragepre_tiny", "--decoder_dim", "64",
        "--decoder_depth", "1", "--decoder_num_heads", "4",
        "--input_size", "64", "--patch_size", "8",
        "--num_encoded_tokens", "48", "--batch_size", "8",
        "--save_ckpt_freq", "1", "--num_workers", "0", "--use_cache",
        "--dtype", "float32"]
N_TASK = 64  # tokens per task at 64² and patch 8


@pytest.fixture(scope="module")
def jax_fastops_lib(tmp_path_factory):
    """The JAX package's native/fastops.cpp built into a temporary
    directory (never into native/), for its ``_load`` to return."""
    from test_torch_fastops import jax_fastops

    return jax_fastops(tmp_path_factory.mktemp("jax_fastops"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run no faster on more threads, and the suite runs
    several test processes on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _make_data(root: Path, rng, n=8):
    for task in DOMAINS:
        (root / task).mkdir(parents=True)
        for i in range(n):
            if task == "bscanlayermap":
                arr = rng.integers(0, 13, (96, 96)).astype(np.uint8)
            else:
                arr = (rng.random((96, 96)) * 255).astype(np.uint8)
            np.save(root / task / f"s{i}.npy", arr)


def _port_args(argv):
    return cli.process_args(parse_with_yaml(cli.get_parser(), argv))


# ------------------------------------------------------------- the parser

def test_parser_has_every_jax_flag_with_its_default():
    jax_actions = {a.dest: a.default for a in jax_cli.get_parser()._actions
                   if a.dest != "help"}
    port_actions = {a.dest: a.default for a in cli.get_parser()._actions
                    if a.dest != "help"}
    assert len(jax_actions) == 59
    assert set(port_actions) == set(jax_actions) | {"device"}
    assert {k: port_actions[k] for k in jax_actions} == jax_actions
    assert port_actions["device"] == "cuda"


@pytest.mark.parametrize("flags", [["--mesh_fsdp", "2"],
                                   ["--mesh_tensor", "2"],
                                   ["--mesh_pipe", "4"],
                                   ["--mesh_pipe", "2",
                                    "--pp_microbatches", "8"],
                                   ["--distributed"]])
def test_multi_gpu_flags_exit_naming_the_queue(tmp_path, flags,
                                              monkeypatch):
    """In one process with no process group, the mesh flags (the pipeline's
    too, tests/test_torch_pp_cli.py runs it in two) and --distributed exit
    naming what they need (tests/test_torch_parallel_cli.py runs them in
    one)."""
    for var in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["--data_path", str(tmp_path), "--device", "cpu"] + flags)


def test_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _make_data(tmp_path / "data", np.random.default_rng(0), n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY + ["--data_path", str(tmp_path / "data"),
                         "--output_dir", str(tmp_path / "out")])


# ----------------------------------------------------------- augmentation

def _augment_sample():
    rng = np.random.default_rng(3)
    return {"bscan": rng.random((96, 80), dtype=np.float32),
            "slo": rng.random((64, 64), dtype=np.float32),
            "bscanlayermap": rng.integers(0, 13, (40, 50)).astype(np.int64)}


def _assert_augment_bit_equal(hflip, affine):
    sample = _augment_sample()
    size = {"bscan": (64, 64), "slo": (64, 64), "bscanlayermap": (32, 32)}
    kw = dict(hflip=hflip, intensity_shift=0.1, affine=affine)
    for seed in range(4):
        got = PretrainAugment(size, **kw)(sample, np.random.default_rng(seed))
        want = JaxAugment(size, **kw)(sample, np.random.default_rng(seed))
        assert got.keys() == want.keys()
        for task in want:
            assert got[task].dtype == want[task].dtype, task
            assert got[task].shape == want[task].shape, task
            np.testing.assert_array_equal(got[task], want[task])
        assert got["bscanlayermap"].dtype == np.int32
        assert got["bscan"].shape == (1, 64, 64)


@pytest.mark.parametrize("hflip,affine", [(0.0, False), (1.0, False),
                                          (0.0, True), (0.5, True)])
def test_pretrain_augment_is_bit_equal(monkeypatch, hflip, affine):
    """One Generator seed, the same sample in both packages, at raw sizes
    that differ from the target and one that equals it: the port's plain
    path (resize_np_ref, affine_warp_ref) against the JAX package with its
    C++ library patched off (its numpy/scipy path)."""
    from mirage_tpu_torch.data import augment

    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(augment, "resize_np", augment.resize_np_ref)
    monkeypatch.setattr(augment, "affine_warp", augment.affine_warp_ref)
    _assert_augment_bit_equal(hflip, affine)


@pytest.mark.parametrize("hflip,affine", [(0.0, False), (1.0, False),
                                          (0.0, True), (0.5, True)])
def test_pretrain_augment_with_the_library_is_bit_equal(
        monkeypatch, jax_fastops_lib, hflip, affine):
    """The port through its host library against the JAX package through
    its own, native/fastops.cpp compiled into a temporary directory (the
    same source and flags)."""
    monkeypatch.setattr(native, "_load", lambda: jax_fastops_lib)
    _assert_augment_bit_equal(hflip, affine)


# --------------------------------------------------------------- datasets

def _folder_tree(root: Path):
    """npy images and labels, an npz layer stack, PNG images."""
    from PIL import Image

    rng = np.random.default_rng(11)
    for task in ("bscan", "slo", "bscanlayermap", "layermaps", "png",
                 "pre_bscan"):
        (root / task).mkdir(parents=True)
    for i in range(5):
        name = f"id{i:02d}"
        np.save(root / "bscan" / f"{name}.npy",
                (rng.random((24, 20)) * 255).astype(np.uint8))
        np.save(root / "pre_bscan" / f"{name}.npy",
                (rng.random((24, 20)) * 255).astype(np.uint8))
        np.save(root / "slo" / f"{name}.npy",
                (rng.random((16, 16)) * 255).astype(np.uint8))
        np.save(root / "bscanlayermap" / f"{name}.npy",
                rng.integers(0, 13, (12, 10)).astype(np.uint8))
        np.savez(root / "layermaps" / f"{name}.npz",
                 layer_maps=rng.integers(0, 9, (3, 12, 10)).astype(np.uint8))
        Image.fromarray((rng.random((10, 14)) * 255).astype(np.uint8)).save(
            root / "png" / f"{name}.png")


@pytest.mark.parametrize("use_cache", [False, True])
def test_pret_dataset_folder_is_bit_equal(tmp_path, use_cache):
    _folder_tree(tmp_path)
    tasks = ["bscan", "slo", "bscanlayermap", "layermaps", "png"]
    got = MultiTaskPretDatasetFolder(str(tmp_path), tasks,
                                     use_cache=use_cache)
    want = JaxPretFolder(str(tmp_path), tasks, use_cache=use_cache)
    assert len(got) == len(want) == 5
    for _ in range(2):  # the second pass reads the cache
        for i in range(len(want)):
            g, _, gid = got[i]
            w, _, wid = want[i]
            assert gid == wid
            for task in tasks:
                assert g[task].dtype == w[task].dtype, task
                np.testing.assert_array_equal(g[task], w[task])
            g["bscan"][:] = -1.0  # a copy: the cache keeps the original
    assert got[0][0]["bscan"].min() >= 0.0


def test_dataset_folder_prefixes_and_max_images(tmp_path):
    _folder_tree(tmp_path)
    kw = dict(prefixes={"bscan": "pre_"}, max_images=3)
    got = MultiTaskDatasetFolder(str(tmp_path), ["bscan", "slo"], **kw)
    want = JaxFolder(str(tmp_path), ["bscan", "slo"], **kw)
    assert got.samples == want.samples and len(got) == 3
    for i in range(3):
        assert got[i][2] == want[i][2]
        for task in ("bscan", "slo"):
            np.testing.assert_array_equal(got[i][0][task], want[i][0][task])


# ------------------------------------------------------------ checkpoints

def test_prune_checkpoints_keeps_the_same_directories(tmp_path):
    for pkg in ("port", "jax"):
        for tag in list(range(12)) + ["best"]:
            (tmp_path / pkg / f"checkpoint-{tag}").mkdir(parents=True)
    ckpt.prune_checkpoints(str(tmp_path / "port"), 5)
    jax_ckpt.prune_checkpoints(str(tmp_path / "jax"), 5)
    kept = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert kept == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert kept == sorted(["checkpoint-0", "checkpoint-5", "checkpoint-10",
                           "checkpoint-11", "checkpoint-best"])


def test_save_checkpoint_keep_every_prunes(tmp_path):
    state = {"params": {"w": torch.ones(2)},
             "opt": {"count": torch.zeros((), dtype=torch.int32)},
             "step": torch.zeros((), dtype=torch.int32)}
    for epoch in range(4):
        ckpt.save_checkpoint(str(tmp_path), state, epoch, keep_every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint-0", "checkpoint-2", "checkpoint-3"]


def test_resolve_pretrained_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    (tmp_path / "file.pth").write_bytes(b"x")
    for name in ("model.pth", "model.safetensors"):
        (tmp_path / "both" / name).parent.mkdir(exist_ok=True)
        (tmp_path / "both" / name).write_bytes(b"x")
    (tmp_path / "pth").mkdir()
    (tmp_path / "pth" / "model.pth").write_bytes(b"x")
    for path in ("file.pth", "both", "pth"):
        got = ckpt.resolve_pretrained(str(tmp_path / path))
        assert got == jax_ckpt.resolve_pretrained(str(tmp_path / path))
    assert got.endswith("model.pth")
    assert ckpt.resolve_pretrained(str(tmp_path / "both")).endswith(
        "model.safetensors")
    (tmp_path / "empty").mkdir()
    for fn in (ckpt.resolve_pretrained, jax_ckpt.resolve_pretrained):
        for name in ("org/no-such-model", str(tmp_path / "empty")):
            with pytest.raises(FileNotFoundError):
                fn(name)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("norm_pix,empty", [(False, False), (True, False),
                                            (True, True)])
def test_pixel_mse_matches_jax_and_the_token_form(norm_pix, empty):
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 2, 32, 32)).astype(np.float32)
    target = rng.random((3, 2, 32, 32), dtype=np.float32)
    mask = (rng.random((3, 16)) < 0.6).astype(np.int32)
    if empty:
        mask[1] = 0
    got = masked_mse_loss(_t(pred), _t(target), _t(mask), patch_size=8,
                          norm_pix=norm_pix)
    want = jax_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                   patch_size=8, norm_pix=norm_pix)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    tokens = masked_mse_loss_tokens(patchify(_t(pred), 8, 8), _t(target),
                                    _t(mask), patch_size=8, norm_pix=norm_pix)
    np.testing.assert_allclose(got.item(), tokens.item(), rtol=1e-6,
                               atol=1e-6)
    all_empty = masked_mse_loss(_t(pred), _t(target), _t(mask * 0),
                                patch_size=8)
    assert all_empty.item() == 0.0


@pytest.mark.parametrize("smoothing,empty", [(0.0, False), (0.1, False),
                                             (0.1, True)])
def test_pixel_ce_matches_jax_and_the_token_form(smoothing, empty):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 13, 16, 16)).astype(np.float32)
    target = rng.integers(0, 13, (2, 16, 16)).astype(np.int32)
    mask = (rng.random((2, 4)) < 0.5).astype(np.int32)
    mask[0, 0] = 1
    if empty:
        mask[1] = 0
    got = masked_ce_loss(_t(logits), _t(target), _t(mask), patch_size=8,
                         label_smoothing=smoothing)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask),
                  patch_size=8, label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    tokens = masked_ce_loss_tokens(patchify(_t(logits), 8, 8), _t(target),
                                   _t(mask), patch_size=8,
                                   label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), tokens.item(), rtol=1e-6,
                               atol=1e-6)
    assert masked_ce_loss(_t(logits), _t(target), _t(mask * 0),
                          patch_size=8).item() == 0.0


# ----------------------------------------------------------------- steps

def _tiny(tmp_path, extra=()):
    """A tiny model of the command line's build, its loss domains and a
    batch with explicit masks (each sample 48 visible tokens)."""
    args = _port_args(TINY + ["--data_path", str(tmp_path), "--device",
                              "cpu", "--norm_pix_loss", *extra])
    model = cli.build_model(args, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(9)
    batch = {"bscan": _t(rng.random((2, 1, 64, 64), dtype=np.float32)),
             "slo": _t(rng.random((2, 1, 64, 64), dtype=np.float32)),
             "bscanlayermap": _t(rng.integers(0, 13, (2, 64, 64)))}
    mask = np.ones((2, 3 * N_TASK), np.int32)
    for i in range(2):
        mask[i, rng.choice(3 * N_TASK, 48, replace=False)] = 0
    masks = {t: _t(mask[:, k * N_TASK:(k + 1) * N_TASK])
             for k, t in enumerate(DOMAINS)}
    return args, model, batch, masks


def _loss_and_grads(args, model, batch, **kw):
    loss, task_losses = cli.make_loss(model, args)(batch, **kw)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, task_losses, dict(zip([n for n, _ in named], grads))


def _pixel_loss_and_grads(args, model, batch, masks):
    """The loss of the same masked forward taken in pixel space: its
    reconstructions through the pixel-space references."""
    preds, _ = model(batch, task_masks=masks, num_visible=48,
                     deterministic=False, pixel_outputs=True)
    task_losses = {}
    for task, pred in preds.items():
        patch = args.patch_size[task][0]
        if cli.DOMAIN_DEFAULTS[task]["loss"] == "ce":
            task_losses[task] = masked_ce_loss(pred, batch[task], masks[task],
                                               patch_size=patch)
        else:
            task_losses[task] = masked_mse_loss(
                pred.float(), batch[task].float(), masks[task],
                patch_size=patch, norm_pix=args.norm_pix_loss)
    loss = sum(task_losses.values())
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, task_losses, dict(zip([n for n, _ in named], grads))


@pytest.mark.parametrize("norm_pix", [False, True])
def test_pixel_space_step_matches_the_token_step(tmp_path, norm_pix):
    """The step's token-space losses against the pixel-space references
    (masked_mse_loss, masked_ce_loss) on the reconstructions of the same
    forward: the same loss and gradients (1e-5)."""
    args, model, batch, masks = _tiny(tmp_path)
    args.norm_pix_loss = norm_pix
    kw = dict(task_masks=masks, num_visible=48)
    loss_t, tasks_t, grads_t = _loss_and_grads(args, model, batch, **kw)
    loss_p, tasks_p, grads_p = _pixel_loss_and_grads(args, model, batch,
                                                     masks)
    np.testing.assert_allclose(loss_p.item(), loss_t.item(), rtol=1e-5)
    for task in DOMAINS:
        np.testing.assert_allclose(tasks_p[task].item(),
                                   tasks_t[task].item(), rtol=1e-5)
    for name, g in grads_t.items():
        err = ((grads_p[name] - g).norm() / g.norm().clamp_min(1e-12)).item()
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("drop_path,reruns", [(0.1, True), (0.0, False)])
def test_remat_step_equals_the_plain_step(tmp_path, monkeypatch, drop_path,
                                          reruns):
    """--remat true against false on one model, masks and drop-path drawn
    from generators of one seed: equal losses and gradients. With
    drop-path the blocks take the route whose ops keep their intermediates,
    run under torch.utils.checkpoint (each block's forward twice); at rate
    0 they take the half-block ops, which save only their inputs, and run
    once."""
    calls = []
    forward = Block.forward
    monkeypatch.setattr(Block, "forward",
                        lambda self, *a, **k: calls.append(1)
                        or forward(self, *a, **k))
    args, model, batch, _ = _tiny(tmp_path, ["--drop_path", str(drop_path)])
    out = {}
    for remat in (False, True):
        model.encoder.remat = remat
        calls.clear()
        out[remat] = _loss_and_grads(
            args, model, batch,
            generator=torch.Generator().manual_seed(4))
        out[remat] += (len(calls),)
    depth = len(model.encoder)
    assert out[False][3] == depth + 3  # the encoder and one block a decoder
    assert out[True][3] == out[False][3] + (depth if reruns else 0)
    assert abs(out[True][0].item() - out[False][0].item()) <= 1e-6
    for name, g in out[False][2].items():
        assert torch.allclose(out[True][2][name], g, rtol=1e-6, atol=1e-7), \
            name


def test_masked_forward_applies_the_encoders_drop_path(tmp_path):
    """The masked forward hands the model's drop-path rate and the
    generator to the encoder (mirage_tpu/models/mirage.py:_encoder): at
    rate 0.9 the loss moves off the rate-0 loss, with the same masks."""
    args, model, batch, masks = _tiny(tmp_path, ["--drop_path", "0.9"])
    kw = dict(task_masks=masks, num_visible=48,
              generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        dropped = cli.make_loss(model, args)(batch, **kw)[0]
        model.drop_path_rate = 0.0
        kw["generator"] = torch.Generator().manual_seed(4)
        kept = cli.make_loss(model, args)(batch, **kw)[0]
    assert abs(dropped.item() - kept.item()) > 1e-3


# ------------------------------------------------------------- warm start

def test_warm_start_and_model_pick_match_jax(tmp_path):
    """A MAE-style .pth (encoder as blocks.{i}, no output adapters) overlays
    the same leaves in both packages."""
    argv = TINY + ["--data_path", str(tmp_path)]
    jargs = jax_cli.get_parser().parse_args(argv)
    jargs.in_domains = jargs.out_domains = DOMAINS
    from mirage_tpu.cli.config import normalize_domain_sizes

    normalize_domain_sizes(jargs, DOMAINS)
    jmodel = jax_cli.build_model(jargs)
    source = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(3)))
    args = _port_args(argv + ["--device", "cpu"])
    model = cli.build_model(args, torch.Generator().manual_seed(0))
    sd = rename_keys({k: v for k, v in jax_params_to_state_dict(
        source, model).items() if not k.startswith("output_adapters")},
        {r"^encoder\.": "blocks."})
    path = tmp_path / "mae_like_tiny.pth"
    torch.save({"model": sd}, path)
    missing = cli.warm_start(model, str(path))
    assert missing and all(k.startswith("output_adapters") for k in missing)
    jparams = jax_cli.warm_start(jmodel.init_params(jax.random.PRNGKey(0)),
                                 jmodel, str(path))
    want = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams), model)
    got = model.state_dict()
    for key in rename_keys(sd, {r"^blocks\.": "encoder."}):
        assert torch.equal(got[key], want[key]), key

    for weights, model_name in (("/w/MultiMAE-B_1600e.pth", "miragepre_base"),
                                ("/w/mae_pretrain_vit_large.pth",
                                 "miragepre_base"),
                                ("/w/other.pth", "miragepre_base"),
                                ("/w/multimae-b.pth", "miragepre_tiny"),
                                ("", "miragepre_base")):
        args.weights = jargs.weights = weights
        args.model = jargs.model = model_name
        assert cli.pick_model_from_weights(args) \
            == jax_cli.pick_model_from_weights(jargs)


# ---------------------------------------------------------- the command line

def test_pretraining_cli_runs_and_resumes(tmp_path):
    """tests/test_pretrain_cli.py's run on the port: one epoch, a checkpoint
    and a finite loss, then a resume at epoch 1 without rerunning epoch 0;
    the reconstruction panels of epoch 0."""
    _make_data(tmp_path / "data", np.random.default_rng(0))
    out = tmp_path / "out"
    common = TINY + ["--warmup_epochs", "1", "--lr", "1e-3", "--data_path",
                     str(tmp_path / "data"), "--output_dir", str(out),
                     "--device", "cpu"]
    first = cli.main(common + ["--epochs", "1"])
    assert (out / "checkpoint-0").is_dir()
    assert (out / "training_time.txt").is_file()
    assert sorted(p.name for p in (out / "debug").iterdir()) == [
        f"e00000_{t}.png" for t in sorted(DOMAINS)]
    rows = [json.loads(line) for line in open(out / "log.txt")]
    assert rows == first["log"] and np.isfinite(rows[-1]["train_loss"])
    assert len(first["step_s"]) == len(first["wait_s"]) == 1

    second = cli.main(common + ["--epochs", "2"])
    assert (out / "checkpoint-1").is_dir()
    epochs = [json.loads(line)["epoch"] for line in open(out / "log.txt")]
    assert epochs == [0, 1], epochs
    assert [r["epoch"] for r in second["log"]] == [1]
    assert int(second["state"]["step"]) == 2


def _fixed_masks(num_tokens_per_task, b, num_encoded):
    """One numpy-seeded mask for every sample and every task (an equal
    share of the num_encoded visible tokens in each): (masks, ids_keep,
    ids_restore) as numpy. The same mask for each task, because jit orders
    the JAX package's batch dict by key, so its tasks reach the masks in
    another order than the port's."""
    n = num_tokens_per_task[0]
    assert set(num_tokens_per_task) == {n}
    task = np.ones(n, np.int32)
    task[np.random.default_rng(21).choice(
        n, num_encoded // len(num_tokens_per_task), replace=False)] = 0
    mask = np.tile(task, (b, len(num_tokens_per_task)))
    ids_shuffle = np.argsort(mask, axis=1, kind="stable")
    ids_restore = np.argsort(ids_shuffle, axis=1, kind="stable")
    split = np.split(mask, len(num_tokens_per_task), axis=1)
    return split, ids_shuffle[:, :num_encoded], ids_restore


def test_pretraining_cli_matches_the_jax_cli(tmp_path, monkeypatch,
                                            jax_fastops_lib):
    """Both command lines from one warm-start .pth (the JAX model's own
    initialisation at the run's seed, encoder as blocks.{i}), each
    augmenting through its host library (the JAX package's compiled into a
    temporary directory, the same source and flags as the port's), float32,
    drop-path 0, one step an epoch, two epochs, the same masks injected into
    both packages' generate_random_masks (one mask for every sample, so the
    JAX package's data-parallel step over the test's 8 virtual devices, one
    sample each, draws the same as the port's one batch of 8). Epoch 0's
    train_loss to relative 1e-5, epoch 1's (after one AdamW update) to
    1e-3."""
    import mirage_tpu.models.mirage as jax_mirage
    import mirage_tpu_torch.models.mirage as port_mirage
    from mirage_tpu.cli.config import normalize_domain_sizes

    monkeypatch.setattr(native, "_load", lambda: jax_fastops_lib)

    def jax_masks(rng, n_per_task, b, num_encoded, **_):
        masks, keep, restore = _fixed_masks(n_per_task, b, num_encoded)
        return ([jnp.asarray(m) for m in masks], jnp.asarray(keep),
                jnp.asarray(restore))

    def port_masks(generator, n_per_task, b, num_encoded, *_, **__):
        masks, keep, restore = _fixed_masks(n_per_task, b, num_encoded)
        dev = generator.device
        return ([_t(m).to(dev) for m in masks], _t(keep).to(dev),
                _t(restore).to(dev))

    monkeypatch.setattr(jax_mirage, "generate_random_masks", jax_masks)
    monkeypatch.setattr(port_mirage, "generate_random_masks", port_masks)

    _make_data(tmp_path / "data", np.random.default_rng(0))
    common = TINY + ["--warmup_epochs", "0", "--lr", "1e-3",
                     "--data_path", str(tmp_path / "data"), "--epochs", "2",
                     "--max_steps_per_epoch", "1", "--debug_images", "false"]
    jargs = jax_cli.get_parser().parse_args(common)
    jargs.in_domains = jargs.out_domains = DOMAINS
    normalize_domain_sizes(jargs, DOMAINS)
    params = jax.tree_util.tree_map(np.asarray, jax_cli.build_model(
        jargs).init_params(jax.random.PRNGKey(jargs.seed)))
    model = cli.build_model(_port_args(common + ["--device", "cpu"]))
    sd = rename_keys(jax_params_to_state_dict(params, model),
                     {r"^encoder\.": "blocks."})
    weights = tmp_path / "init_tiny.pth"
    torch.save({"model": sd}, weights)
    common += ["--weights", str(weights)]

    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    got = cli.main(common + ["--output_dir", str(tmp_path / "port"),
                             "--device", "cpu"])["log"]
    want = [json.loads(line) for line in open(tmp_path / "jax" / "log.txt")]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got[1]["train_loss"], want[1]["train_loss"],
                               rtol=1e-3)
    assert got[1]["train_loss"] != got[0]["train_loss"]


def test_pretraining_cli_pairs_each_mask_with_its_task_and_sample(
        tmp_path, monkeypatch):
    """Port only, since the comparison with the JAX command line above
    injects one mask for every task and sample: a distinct numpy-seeded
    mask for each task and sample (a sample's 48 visible tokens spread
    unevenly over its tasks), injected into generate_random_masks with ids
    from masks_to_indices. The command line's first train_loss and its
    per-task losses (epoch 0, one step, before any update) equal the
    token-space losses computed here by hand from the model's forward at
    those masks, keyed by task, to relative 1e-5. The optimizer's update is
    held to the JAX package's in tests/test_torch_train.py."""
    import mirage_tpu_torch.data.loader as loader
    import mirage_tpu_torch.models.mirage as port_mirage
    from mirage_tpu_torch.masking.masking import masks_to_indices

    rng = np.random.default_rng(22)
    mask = np.ones((8, 3 * N_TASK), np.int32)
    for i in range(8):
        mask[i, rng.choice(3 * N_TASK, 48, replace=False)] = 0
    task_masks = {t: _t(mask[:, k * N_TASK:(k + 1) * N_TASK])
                  for k, t in enumerate(DOMAINS)}
    rows = {row.numpy().tobytes() for m in task_masks.values() for row in m}
    assert len(rows) == 3 * 8  # every (task, sample) mask differs

    def port_masks(generator, n_per_task, b, num_encoded, *_, **__):
        assert list(n_per_task) == [N_TASK] * 3 and b == 8
        keep, restore = masks_to_indices(task_masks, DOMAINS, num_encoded)
        return [task_masks[t] for t in DOMAINS], keep, restore

    monkeypatch.setattr(port_mirage, "generate_random_masks", port_masks)
    batches = []
    to_device = loader.to_device
    monkeypatch.setattr(loader, "to_device", lambda *a, **k: batches.append(
        to_device(*a, **k)) or batches[-1])

    _make_data(tmp_path / "data", np.random.default_rng(0))
    argv = TINY + ["--warmup_epochs", "0", "--lr", "1e-3", "--data_path",
                   str(tmp_path / "data"), "--epochs", "1",
                   "--max_steps_per_epoch", "1", "--debug_images", "false",
                   "--output_dir", str(tmp_path / "out"), "--device", "cpu"]
    got = cli.main(argv)["log"][0]

    args = _port_args(argv)
    model = cli.build_model(args, torch.Generator().manual_seed(args.seed))
    batch = batches[0]
    with torch.no_grad():
        preds, _ = model(batch, task_masks=task_masks, num_visible=48,
                         pixel_outputs=False)
    want = {}
    for task in DOMAINS:
        target = batch[task] if batch[task].ndim == 4 else batch[task][:, None]
        target = target.reshape(8, -1, 8, 8, 8, 8).permute(0, 2, 4, 1, 3, 5)
        target = target.reshape(8, N_TASK, -1)  # (c, ph, pw) patch tokens
        if task == "bscanlayermap":
            logp = torch.log_softmax(preds[task].reshape(8, N_TASK, 13, 64),
                                     dim=2)
            per_token = -logp.gather(2, target[:, :, None].long()).squeeze(
                2).mean(-1)
        else:
            per_token = ((preds[task] - target.float()) ** 2).mean(-1)
        m = task_masks[task].float()
        want[task] = ((per_token * m).sum(1) / m.sum(1)).mean().item()
        np.testing.assert_allclose(got[f"train_loss_{task}"], want[task],
                                   rtol=1e-5)
    np.testing.assert_allclose(got["train_loss"], sum(want.values()),
                               rtol=1e-5)


# ---------------------------------------------------------------- imports

def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    code = """
import sys
import mirage_tpu_torch.cli.run_pretraining as cli
import mirage_tpu_torch.data.augment, mirage_tpu_torch.data.folder
import mirage_tpu_torch.losses.masked, mirage_tpu_torch.train.steps
import mirage_tpu_torch.train.optim, mirage_tpu_torch.train.checkpoint
import mirage_tpu_torch.utils.profiling, mirage_tpu_torch.models.mirage
args = cli.process_args(cli.parse_with_yaml(cli.get_parser(), [
    "-c", "configs/pretrain_mirage_98_1600e.yaml", "--data_path", "x"]))
cli.build_model(args)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "mirage_tpu"))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
