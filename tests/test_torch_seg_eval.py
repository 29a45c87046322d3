"""The port's segmentation evaluation path against the JAX package: the
volume metrics (metrics/volume.py, with the HD95 golden), the semseg
metrics' functional forms, run_seg_eval's CSVs on the same PNG folders
(AROI in-domain and the --external Duke_iAMD translator, the ground truth
at another size than the predictions), and run_seg_tuning's --test,
--external and --infer_only export from one checkpoint-best.

Everything runs on the CPU in float32. The JAX package's resizes run
through its numpy path (its C++ library's ``_load`` patched to return
None), so no test builds into native/; the port's nearest resize through
its host library equals that path exactly (tests/test_torch_fastops.py).
Tolerances: the CSV cells to 1e-12 (the same float64 sums), the metrics
exactly, the exported PNGs equal at every pixel whose top two JAX logits
differ by more than 1e-4.
"""

import csv
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_seg_external import AROI_INFO, DUKE_INFO, _write_split

from mirage_tpu.utils import native as jax_native

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_jax_library(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


# ------------------------------------------------------------ the metrics

def _masks(rng, shape, p):
    return (rng.random(shape) < p).astype(np.uint8)


@pytest.mark.parametrize("p_pred,p_true", [(0.3, 0.4), (0.0, 0.2),
                                           (0.1, 0.0), (0.0, 0.0)])
def test_volume_metrics_match_jax(p_pred, p_true):
    from mirage_tpu.metrics import volume as jv

    from mirage_tpu_torch.metrics import volume as tv

    rng = np.random.default_rng(int(100 * p_pred + 10 * p_true))
    pred = _masks(rng, (3, 24, 20), p_pred)
    true = _masks(rng, (3, 24, 20), p_true)
    pred[1] = 0  # an empty slice in every case
    for name in ("dice_score", "iou_score"):
        assert getattr(tv, name)(pred, true) == getattr(jv, name)(pred, true)
    if pred[0].any() and true[0].any():
        assert tv.hausdorff_distance_95(pred[0], true[0]) == \
            jv.hausdorff_distance_95(pred[0], true[0])
    for nan in (True, False):
        got = tv.volume_hausdorff_distance(pred, true, 95, nan)
        want = jv.volume_hausdorff_distance(pred, true, 95, nan)
        assert (np.isnan(got) and np.isnan(want)) or got == want


def test_hd95_matches_the_pinned_golden():
    """tests/golden/hd95_golden.json (scripts/gen_hd95_golden.py) at
    rtol 1e-6, as tests/test_metrics.py holds the JAX package."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from gen_hd95_golden import slice_cases, volume_cases

    from mirage_tpu_torch.metrics.volume import (hausdorff_distance_95,
                                                 volume_hausdorff_distance)

    golden = json.loads((ROOT / "tests" / "golden" /
                         "hd95_golden.json").read_text())
    for name, (p, t) in slice_cases().items():
        np.testing.assert_allclose(
            hausdorff_distance_95(p, t, percentile=golden["percentile"]),
            golden["slices"][name], rtol=1e-6, err_msg=name)
    for name, (p, t) in volume_cases().items():
        for empty_nan in (True, False):
            want = golden["volumes"][f"{name}/empty_sets_nan={empty_nan}"]
            got = volume_hausdorff_distance(p, t, empty_sets_nan=empty_nan)
            if want is None:
                assert np.isnan(got), name
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=name)


@pytest.mark.parametrize("label_map,reduce_zero", [(None, False),
                                                   ({1: 3}, False),
                                                   (None, True)])
def test_semseg_functional_forms_match_jax(label_map, reduce_zero):
    from mirage_tpu.metrics import semseg as js

    from mirage_tpu_torch.metrics import semseg as ts

    rng = np.random.default_rng(3)
    preds = [rng.integers(0, 5, (9, 11)) for _ in range(3)]
    gts = [rng.integers(0, 5, (9, 11)) for _ in range(3)]
    gts[0][:2] = 255
    kw = dict(label_map=label_map, reduce_zero_label=reduce_zero)
    for g, w in zip(ts.total_intersect_and_union(preds, gts, 5, 255, **kw),
                    js.total_intersect_and_union(preds, gts, 5, 255, **kw)):
        np.testing.assert_array_equal(g, w)
    for fn, extra in (("eval_metrics", {"metrics": "mDice"}),
                      ("eval_metrics", {"metrics": ["mIoU", "mDice"],
                                        "nan_to_num": -1}),
                      ("mean_iou", {}), ("mean_dice", {"nan_to_num": 0})):
        got = getattr(ts, fn)(preds, gts, 5, 255, **extra, **kw)
        want = getattr(js, fn)(preds, gts, 5, 255, **extra, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="predictions"):
        ts.total_intersect_and_union(preds, gts[:2], 5, 255)


# ------------------------------------------------------------ run_seg_eval

def _eval_tree(root: Path):
    """datasets/{AROI,Duke_iAMD} test splits (48² label PNGs, two volumes
    of two slices) and a run directory under AROI with 32² prediction PNGs
    in preds/ and preds_Duke_iAMD/ (AROI class values, noisy bands)."""
    rng = np.random.default_rng(4)
    data = root / "datasets"
    aroi_values = [v["value"] for v in AROI_INFO.values()]
    duke_values = [v["value"] for v in DUKE_INFO.values()]
    _write_split(data / "AROI", "test", aroi_values, 4, rng, size=48)
    _write_split(data / "Duke_iAMD", "test", duke_values, 4, rng, size=48)
    json.dump(AROI_INFO, open(data / "AROI" / "INFO.json", "w"))
    json.dump(DUKE_INFO, open(data / "Duke_iAMD" / "INFO.json", "w"))
    run = root / "AROI" / "run"
    for preds in ("preds", "preds_Duke_iAMD"):
        (run / preds).mkdir(parents=True)
        for i in range(4):
            band = np.repeat(np.arange(32)[:, None] * len(aroi_values) // 32,
                             32, axis=1)
            band = np.clip(band + rng.integers(-1, 2, band.shape), 0,
                           len(aroi_values) - 1)
            img = np.asarray(aroi_values, np.uint8)[band]
            Image.fromarray(img).save(
                run / preds / f"scan{i // 2}_{i % 2}.png")
    return data, run


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("external", [None, "Duke_iAMD"])
def test_run_seg_eval_writes_the_jax_csvs(tmp_path, external):
    """The same PNG folders through both CLIs: the same CSV files, header
    and rows, text cells equal, number cells to 1e-12 (NaN as an empty
    cell in both)."""
    from mirage_tpu.cli import run_seg_eval as jax_eval

    from mirage_tpu_torch.cli import run_seg_eval as port_eval

    data, run = _eval_tree(tmp_path / "t")
    port_run = tmp_path / "p" / "AROI" / "run"
    shutil.copytree(run, port_run)
    argv = ["-d", str(data)] + (["-e", external] if external else [])
    jax_eval.main(argv + ["-m", str(run)])
    rows = port_eval.main(argv + ["-m", str(port_run)])
    names = sorted(p.name for p in run.glob("*.csv"))
    assert names == sorted(p.name for p in port_run.glob("*.csv"))
    assert names == (["results_Duke_iAMD.csv"] if external else
                     ["results_layers.csv", "results_lesions.csv"])
    n = 0
    for name in names:
        want, got = _read_csv(run / name), _read_csv(port_run / name)
        assert got[0] == want[0] == ["ID", "Class", "Dice", "IoU", "HD95"]
        assert len(got) == len(want)
        for g, w in zip(got[1:], want[1:]):
            assert g[:2] == w[:2]
            for a, b in zip(g[2:], w[2:]):
                assert (a == b == "") or abs(float(a) - float(b)) <= 1e-12
            n += 1
    assert n == len(rows) > 0


def test_run_seg_eval_imports_no_pandas(tmp_path):
    data, run = _eval_tree(tmp_path)
    code = ("import sys; from mirage_tpu_torch.cli import run_seg_eval; "
            f"run_seg_eval.main(['-d', {str(data)!r}, '-m', {str(run)!r}]); "
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('pandas', 'jax', 'mirage_tpu')); print('BAD', bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


# ----------------------------------------------- --test from checkpoint-best

TINY_ARGV = ["--model_override", "miragepre_tiny", "--input_size", "64",
             "--patch_size", "8", "--batch_size", "8", "--dtype", "float32",
             "--num_workers", "0"]


@pytest.fixture(scope="module")
def best(tmp_path_factory):
    """Seg datasets (64² PNGs: AROI train/val/test, a Duke_iAMD test split),
    an empty weights file, and one JAX train state from seed 0 saved as
    checkpoint-best by each package (the port's carried across with
    jax_params_to_state_dict), with the JAX parameters and model."""
    from mirage_tpu.api.fm_configs import pick_fm as jax_pick
    from mirage_tpu.api.fm_configs import seg_fm_factory as jax_fms
    from mirage_tpu.cli import run_seg_tuning as jcli
    from mirage_tpu.cli.config import parse_with_yaml as jax_parse
    from mirage_tpu.train import checkpoint as jax_ckpt
    from mirage_tpu.train.optim import OptimizerConfig as JaxCfg
    from mirage_tpu.train.optim import create_optimizer
    from mirage_tpu.train.steps import init_train_state as jax_init

    from mirage_tpu_torch.api.convert import jax_params_to_state_dict
    from mirage_tpu_torch.cli import run_seg_tuning as pcli
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.steps import init_train_state

    root = tmp_path_factory.mktemp("seg_test")
    rng = np.random.default_rng(0)
    aroi_values = [v["value"] for v in AROI_INFO.values()]
    for split, n in (("train", 4), ("val", 4), ("test", 4)):
        _write_split(root / "AROI", split, aroi_values, n, rng)
    json.dump(AROI_INFO, open(root / "AROI" / "INFO.json", "w"))
    _write_split(root / "Duke_iAMD", "test",
                 [v["value"] for v in DUKE_INFO.values()], 4, rng)
    json.dump(DUKE_INFO, open(root / "Duke_iAMD" / "INFO.json", "w"))
    weights = root / "mirage-base_tiny.pth"
    torch.save({"model": {}}, weights)
    common = ["--data_path", str(root / "AROI"), "--weights", str(weights),
              *TINY_ARGV]

    jargs = jcli.process_args(jax_parse(
        jcli.get_parser(), common + ["--output_dir", str(root / "jax")]))
    fm = jax_pick(jax_fms, jargs.weights)
    fm.norm = "minmax"
    jmodel = jcli.build_model(jargs, fm)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    # the optimizer as the JAX CLI builds it (run_seg_tuning.py:281-287)
    opt = create_optimizer(JaxCfg(
        opt=jargs.opt, betas=tuple(jargs.opt_betas), eps=jargs.opt_eps,
        weight_decay=jargs.weight_decay, clip_grad=jargs.clip_grad,
        layer_decay=jargs.layer_decay if jargs.layer_decay < 1.0 else None,
        num_layers=jmodel.depth, freeze_encoder=jargs.freeze_encoder,
        frozen_paths=(), learnable_pos_emb=jargs.learnable_pos_emb))
    jax_ckpt.save_checkpoint(jargs.output_dir, jax_init(params, opt), 0,
                             tag="best")

    pargs = pcli.process_args(pcli.parse_with_yaml(
        pcli.get_parser(), common + ["--output_dir", str(root / "port"),
                                     "--device", "cpu"]))
    _, model, popt, _, _ = pcli.setup(pargs, torch.device("cpu"))
    params = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    ckpt.save_checkpoint(pargs.output_dir, init_train_state(model, popt), 0,
                         tag="best")
    return {"root": root, "common": common, "jax_dir": Path(jargs.output_dir),
            "port_dir": Path(pargs.output_dir), "jmodel": jmodel,
            "params": params}


def _jax_logits(best, split_dir):
    """The JAX model's float32 logits on a test split, by sample id."""
    from mirage_tpu.data import MultiTaskImageFolder, SemSegTransform

    ds = MultiTaskImageFolder(
        str(split_dir), ["bscan", "semseg"],
        mapping={v["value"]: int(k) for k, v in AROI_INFO.items()},
        transform=SemSegTransform(train=False, input_size=64, norm="minmax"))
    items = [ds[i] for i in range(len(ds))]
    x = jnp.asarray(np.stack([it[0]["bscan"] for it in items]))
    logits = best["jmodel"].forward_light(best["params"],
                                          {"bscan": x})["semseg"]
    return {it[2]: np.asarray(lg) for it, lg in zip(items, logits)}


def _assert_same_pngs(got_dir, want_dir, logits):
    """The same file names; equal values wherever the top two JAX logits
    are more than 1e-4 apart (and most pixels are)."""
    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(f"{sid}.png" for sid in logits)
    decided = 0
    for name in names:
        lg = np.sort(logits[name[:-4]], axis=0)
        clear = lg[-1] - lg[-2] > 1e-4
        got = np.asarray(Image.open(got_dir / name))
        want = np.asarray(Image.open(want_dir / name))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got[clear], want[clear], err_msg=name)
        decided += clear.mean()
    assert decided / len(names) > 0.9


@pytest.mark.parametrize("external", [False, True])
def test_test_export_matches_the_jax_cli(best, external):
    """--test (and --test_data_path on Duke_iAMD, which sets --external):
    the best checkpoint's predictions as class-value PNGs named {sid}.png
    in preds (preds_Duke_iAMD), the same in both packages; the test
    metrics appended to log.txt."""
    from mirage_tpu.cli import run_seg_tuning as jcli

    from mirage_tpu_torch.cli import run_seg_tuning as pcli

    split = best["root"] / ("Duke_iAMD" if external else "AROI") / "test"
    argv = best["common"] + ["--test"] + (
        ["--test_data_path", str(split)] if external else [])
    preds = "preds_Duke_iAMD" if external else "preds"
    want = jcli.main(argv + ["--output_dir", str(best["root"] / "jax")])
    got = pcli.main(argv + ["--output_dir", str(best["root"] / "port"),
                            "--device", "cpu"])
    _assert_same_pngs(best["port_dir"] / preds, best["jax_dir"] / preds,
                      _jax_logits(best, split))
    for k in ("mean_iou", "pixel_accuracy", "mean_accuracy"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    rows = [json.loads(line) for line in open(best["port_dir"] / "log.txt")]
    assert "test/mean_iou" in rows[-1]


def test_infer_only_exports_exits_and_then_skips(best, tmp_path):
    """--test --infer_only: the PNGs without metrics, then exit 0 (both
    packages); a second call finds every PNG and skips."""
    from mirage_tpu.cli import run_seg_tuning as jcli

    from mirage_tpu_torch.cli import run_seg_tuning as pcli

    split = best["root"] / "AROI" / "test"
    dirs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", pcli, ["--device", "cpu"])):
        src = best[f"{name}_dir"]
        out = tmp_path / name / src.relative_to(best["root"] / name)
        shutil.copytree(src / "checkpoint-best", out / "checkpoint-best")
        argv = best["common"] + ["--test", "--infer_only", "--output_dir",
                                 str(tmp_path / name)] + extra
        with pytest.raises(SystemExit) as done:
            cli.main(argv)
        assert done.value.code == 0
        assert cli.main(argv) is None
        dirs[name] = out
    _assert_same_pngs(dirs["port"] / "preds", dirs["jax"] / "preds",
                      _jax_logits(best, split))
    assert not (dirs["port"] / "val_images").exists()


def test_test_without_a_best_checkpoint_refuses(tmp_path):
    from mirage_tpu_torch.cli import run_seg_tuning as pcli

    root = tmp_path / "AROI"
    root.mkdir()
    json.dump(AROI_INFO, open(root / "INFO.json", "w"))
    with pytest.raises(SystemExit, match="no checkpoint-best"):
        pcli.main(["--data_path", str(root), "--weights", "mirage-base.pth",
                   "--output_dir", str(tmp_path / "out"), "--test",
                   "--device", "cpu"])


def test_external_is_detected_from_a_duke_iamd_test_path(tmp_path):
    from mirage_tpu_torch.cli import run_seg_tuning as pcli

    root = tmp_path / "AROI"
    root.mkdir()
    json.dump(AROI_INFO, open(root / "INFO.json", "w"))
    base = ["--data_path", str(root), "--weights", "mirage-base.pth"]

    def parse(extra):
        return pcli.process_args(pcli.parse_with_yaml(pcli.get_parser(),
                                                      base + extra))

    args = parse(["--test", "--test_data_path", "/d/Duke_iAMD/test"])
    assert args.external == "Duke_iAMD"
    assert parse(["--test"]).test_data_path == root / "test"
    assert parse(["--test"]).external is None
    assert parse(["--test_data_path", "/d/Duke_iAMD/test"]).external is None
    assert args.inverse_mapping == {i: v["value"]
                                    for i, v in enumerate(AROI_INFO.values())}
