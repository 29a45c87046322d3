"""The port's command lines on several processes (gloo on the CPU, spawned,
rendezvous through a file; each worker joins the group before it calls
``main``, which takes the group it finds).

- Pretraining: one epoch with ``--distributed --mesh_tensor 2`` on two
  processes (each a host: ``--batch_size`` 4 each, the global batch 8),
  resumed for a second epoch in one process (data parallelism over one),
  equals two epochs in one process: the tensor-parallel checkpoint is
  written in the standard layout.
- Classification and segmentation tuning, data-parallel on two processes
  with evaluation sets that do not split evenly (the padding dropped): the
  test metrics process 0 reports equal those of one process evaluating the
  same best checkpoint (segmentation's histogram metrics; its loss is a
  mean over the processes' batches).
"""

import json

import numpy as np
import torch

from mirage_tpu_torch.cli import run_pretraining
from tests import _torch_parallel_worker as worker
from tests.test_torch_parallel_step import one_thread  # noqa: F401
from tests.test_torch_pretrain_cli import TINY, _make_data


def _spawn_cli(tmp_path, module, argv, world=2):
    workdir = tmp_path / "workers"
    workdir.mkdir()
    (workdir / "cli.json").write_text(json.dumps(
        {"module": module, "argv": argv}))
    return worker.spawn("cli", world, str(workdir))


def test_pretraining_tp_checkpoint_resumes_in_one_process(tmp_path):
    _make_data(tmp_path / "data", np.random.default_rng(0))

    def argv(out, epochs):
        # --opt_eps 1e-5: see tests/_torch_parallel_worker.py:optimizer
        return TINY + ["--warmup_epochs", "1", "--lr", "1e-3", "--opt_eps",
                       "1e-5", "--data_path", str(tmp_path / "data"),
                       "--output_dir", str(out), "--device", "cpu",
                       "--epochs", str(epochs)]

    whole = run_pretraining.main(argv(tmp_path / "one", 2))
    log = _spawn_cli(tmp_path, "mirage_tpu_torch.cli.run_pretraining",
                     argv(tmp_path / "tp", 1) + [
                         "--distributed", "--mesh_tensor", "2",
                         "--batch_size", "4"])
    np.testing.assert_allclose(log[0]["train_loss"],
                               whole["log"][0]["train_loss"], rtol=1e-5)
    resumed = run_pretraining.main(argv(tmp_path / "tp", 2))
    assert [r["epoch"] for r in resumed["log"]] == [1]
    a = torch.load(tmp_path / "one" / "checkpoint-1" / "checkpoint.pth")
    b = torch.load(tmp_path / "tp" / "checkpoint-1" / "checkpoint.pth")
    assert set(a["params"]) == set(b["params"])
    for key in ("params",):
        for n, p in a[key].items():
            torch.testing.assert_close(b[key][n], p, atol=1e-5, rtol=1e-5,
                                       msg=n)
    for key in ("mu", "nu"):
        for n, m in a["opt"][key].items():
            torch.testing.assert_close(b["opt"][key][n], m, atol=1e-5,
                                       rtol=1e-5, msg=n)
    assert int(b["opt"]["count"]) == int(a["opt"]["count"]) == 2


def test_cls_tuning_data_parallel(tmp_path):
    from mirage_tpu_torch.cli import run_cls_tuning
    from tests.test_torch_cls import _class_folder, _cli_argv

    _class_folder(tmp_path / "data", np.random.default_rng(16))
    worker.write_cls_weights(str(tmp_path))
    weights = str(tmp_path / "mirage-base_tiny.pth")
    argv = [a if a != "128" else str(worker.SIZE)
            for a in _cli_argv(tmp_path, weights)]
    stats = _spawn_cli(tmp_path, "mirage_tpu_torch.cli.run_cls_tuning", argv)
    run = next((tmp_path / "out" / "v1" / "0" / "OCTX").iterdir())
    rows = (run / "train_eval.csv").read_text().splitlines()
    assert len(rows) == 3 and (run / "valid_eval.csv").is_file()
    again = run_cls_tuning.main(argv + ["--eval"])
    assert again["bacc"] == stats["bacc"]
    for k in ("loss", "auroc", "ap", "f1", "mcc"):
        np.testing.assert_allclose(again[k], stats[k], rtol=1e-6, atol=1e-6)


def test_seg_tuning_data_parallel(tmp_path):
    from mirage_tpu_torch.api.wrapper import build_model
    from mirage_tpu_torch.cli import run_seg_tuning
    from tests.test_torch_seg import CONFIG, _seg_dataset

    rng = np.random.default_rng(14)
    _seg_dataset(tmp_path / "AROI", rng)
    # a test split of 3 scans: two processes' stripes of a batch of 2
    # leave the last one padded
    for task in ("bscan", "semseg"):
        (tmp_path / "AROI" / "test" / task).mkdir(parents=True)
    for i in range(3):
        src = tmp_path / "AROI" / "val"
        for task in ("bscan", "semseg"):
            arr = np.load(src / task / f"s{i % 2}.npy")
            np.save(tmp_path / "AROI" / "test" / task / f"t{i}.npy",
                    np.flip(arr, 1).copy() if i == 2 else arr)
    domains = ["bscan", "slo", "bscanlayermap"]
    args = dict(model="miragepre_tiny", in_domains=domains,
                out_domains=["bscan"], decoder_dim=32, decoder_depth=1,
                decoder_num_heads=2)
    weights = tmp_path / "mirage-base_tiny.pth"
    torch.save({"model": build_model(
        "miragepre_tiny", args, domains, 64, 8,
        generator=torch.Generator().manual_seed(0)).state_dict(),
        "args": args}, weights)
    argv = ["-c", str(CONFIG), "--data_path", str(tmp_path / "AROI"),
            "--weights", str(weights), "--model_override", "miragepre_tiny",
            "--input_size", "64", "--patch_size", "8", "--batch_size", "2",
            "--dtype", "float32", "--output_dir", str(tmp_path / "out"),
            "--num_workers", "0", "--epochs", "1", "--max_steps_per_epoch",
            "2", "--device", "cpu", "--test_data_path",
            str(tmp_path / "AROI" / "test")]
    out = _spawn_cli(tmp_path, "mirage_tpu_torch.cli.run_seg_tuning", argv)
    run_dir = tmp_path / "out" / "v1" / "AROI" / \
        "mirage-base_tiny_frozen_convnext_CEGDice_minmax"
    assert out["output_dir"] == str(run_dir)
    assert sorted(p.name for p in (run_dir / "preds").iterdir()) == [
        "t0.png", "t1.png", "t2.png"]
    again = run_seg_tuning.main(argv + ["--test"])
    # the histogram's metrics; the loss is a mean over the stripes'
    # batches, as the JAX package's pmean over its devices' batches is
    assert set(out["test"]) == set(again)
    for k in ("mean_iou", "pixel_accuracy", "mean_accuracy"):
        np.testing.assert_allclose(again[k], out["test"][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
