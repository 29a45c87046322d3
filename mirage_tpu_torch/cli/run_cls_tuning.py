"""Classification tuning on the PyTorch/CUDA port.

Counterpart of ``mirage_tpu/cli/run_cls_tuning.py`` (reference
run_cls_tuning.py): linear probing (lr 1e-3, all but the head frozen) or a
full fine-tune (lr 1e-5) of a pretrained MIRAGE with a pooled linear head,
or of a baseline ViT (``vit_base`` / ``vit_large`` in the weights' name:
``models/vit.py``, timm keys, ImageNet-normalised RGB at 224² by default);
AdamW (0.9, 0.999), wd 1e-2; a half-cycle cosine LR set every iteration;
label-smoothed cross-entropy (0.1) in its sum form over batches padded to a
fixed size with zero-weight rows; dual-metric early stopping (BAcc, then
the loss; patience 20 from epoch 20); the best model kept in memory and
written once; BAcc / AUROC / AP / F1 / MCC into ``train_eval.csv``,
``valid_eval.csv`` and ``test_eval.csv``; ``--eval`` and
``--save_predictions`` (``predictions.npz``) from the best checkpoint; the
number of classes and the batch size from the dataset folder.

Usage:
  python -m mirage_tpu_torch.cli.run_cls_tuning --data_root /data/Classification \\
      --data_set OCTID --weights MIRAGE-Base.pth [--linear_probing] [--device cuda]
  python -m mirage_tpu_torch.cli.run_cls_tuning --data_root /data/Classification \\
      --data_set OCTID --weights vit_large_patch16_224.pth [--pool cls]

The dataset is ``{data_root}/{data_set}/{train,val,test}/{class}/*`` (val
and test optional). ``--device`` defaults to ``cuda`` and fails without a
card; ``--device cpu`` runs the plain PyTorch path. Neither sklearn nor
pandas is needed: the metrics are numpy (``metrics/classification.py``)
and the CSVs come from the ``csv`` module. The linear probe's frozen
parameters are the config's (``api/fm_configs.py:probe_frozen``): for a
baseline every name but ``head``, where the JAX CLI freezes only the final
norm (queue C fault 9, ``mirage_tpu_torch/DEVIATIONS.md``).

Several GPUs, data-parallel over every process (mirage_tpu/cli/
run_cls_tuning.py:172-): ``torchrun --nproc_per_node N -m
mirage_tpu_torch.cli.run_cls_tuning ...``. ``--batch_size`` is the global
batch and must divide over the processes; each process loads its stripe of
every batch (padded to a multiple of the processes with zero-weight rows,
which the evaluation drops), the predictions, targets and losses are
gathered from every process before the metrics are read, and process 0
alone logs and writes.
"""

import argparse
import csv
import os
import time
from pathlib import Path

import numpy as np
import torch

from mirage_tpu_torch.cli.config import args_hash, parse_with_yaml, save_args

# the CSV schema, keyed into compute_cls_metrics' dict
VAL_KEYS = ["epoch", "loss", "bacc", "auroc", "ap", "f1", "mcc"]
VAL_COLS = ["Epoch", "Loss", "BAcc", "AUROC", "AP", "F1-score", "MCC"]
# the arguments whose values name the run's output directory
HASH_KEYS = ("affine", "early_start_from", "early_stopping_delta",
             "early_stopping_delta_two", "early_stopping_epochs", "fill",
             "weights", "input_size", "linear_probing", "lr", "min_lr",
             "pool", "smoothing", "val_metric", "val_metric_two",
             "warmup_epochs", "weight_decay")


def get_parser():
    p = argparse.ArgumentParser("MIRAGE classification tuning (PyTorch/CUDA)")
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--data_root", required=True, type=str)
    p.add_argument("--data_set", required=True, type=str)
    p.add_argument("--weights", required=True, type=str)
    p.add_argument("--pool", default="global",
                   choices=["global", "cls", "token_mix"])
    p.add_argument("--linear_probing", default=False, action="store_true")
    p.add_argument("--input_size", default=None, type=int,
                   help="default: 512 for MIRAGE, 224 for the baseline "
                   "ViTs")
    p.add_argument("--patch_size", default=32, type=int)
    p.add_argument("--smoothing", default=0.1, type=float)
    p.add_argument("--warmup_epochs", default=5, type=int)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--weight_decay", default=1e-2, type=float)
    p.add_argument("--val_metric", default="bacc", type=str)
    p.add_argument("--val_metric_two", default="loss", type=str)
    p.add_argument("--early_stopping_epochs", default=20, type=int)
    p.add_argument("--early_stopping_delta", default=0.0, type=float)
    p.add_argument("--early_stopping_delta_two", default=0.0, type=float)
    p.add_argument("--early_start_from", default=20, type=int)
    p.add_argument("--fill", default=None, type=float,
                   help="affine fill value; default: 1 for Kermany, else 0 "
                        "(fm_cls_config.py:51-56); 0.5 = a random in-range "
                        "fill per image (transforms.py:125-126)")
    p.add_argument("--affine", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="random affine train transform "
                        "(run_cls_tuning.py:187-191)")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--output_dir", default="./output/cls", type=str)
    p.add_argument("--version", default="v1", type=str)
    p.add_argument("--eval", default=False, action="store_true")
    p.add_argument("--save_predictions", default=False, action="store_true")
    p.add_argument("--max_steps_per_epoch", default=None, type=int)
    p.add_argument("--model_override", default=None, type=str,
                   help="bypass the weights-name size (e.g. miragepre_tiny)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def process_args(args):
    """The dataset path, the number of classes and (when not given) the
    batch size: the power of two nearest a quarter of the training set,
    at most 64, and 8 for a tiny set (run_cls_tuning.py:239-245)."""
    args.data_path = os.path.join(args.data_root, args.data_set)
    train_dir = Path(args.data_path) / "train"
    classes = [d for d in train_dir.iterdir() if d.is_dir()]
    args.num_classes = len(classes)
    num_samples = sum(len(list(d.iterdir())) for d in classes)
    if args.batch_size is None:
        n = int(round(num_samples * 0.25)).bit_length() - 1
        args.batch_size = min(64, 2 ** n) if n >= 0 else 8
    print(f"Classes: {args.num_classes}, samples: {num_samples}, "
          f"batch: {args.batch_size}")
    return args


def output_dir(args, model_name: str) -> str:
    """{output_dir}/{version}/{seed}/{data_set}/{model}_{linear|finetune}_
    {hash}: the hash covers HASH_KEYS ('affine' only when off, so runs from
    before the flag resolve to the same directory)."""
    keys = [k for k in HASH_KEYS if k != "affine" or not args.affine]
    exclude = tuple(k for k in vars(args) if k not in keys)
    return os.path.join(
        args.output_dir, args.version, str(args.seed), args.data_set,
        model_name + ("_linear" if args.linear_probing else "_finetune")
        + "_" + args_hash(args, exclude=exclude))


def pad_batch(images, targets, size: int):
    """A batch padded to ``size`` rows with copies of its first row, and
    per-row weights (1 real, 0 padding): exact loss and gradients at one
    shape (run_cls_tuning.py:279-298)."""
    n = images.shape[0]
    weights = np.zeros((size,), np.float32)
    weights[:n] = 1.0
    if n < size:
        pad = size - n
        images = np.concatenate(
            [images, np.broadcast_to(images[:1], (pad,) + images.shape[1:])])
        targets = np.concatenate(
            [targets, np.broadcast_to(targets[:1], (pad,) + targets.shape[1:])])
    return images, targets, weights


def write_csv(path, cols, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(rows)


def setup(args, device):
    """Fills the run's defaults (fill: white for Kermany, black otherwise;
    the config's lr and input size) and builds the head model on
    ``device``, the optimizer and the loss function: (fm, model, optimizer,
    loss_fn)."""
    from mirage_tpu_torch.api.fm_configs import cls_fm_factory, pick_fm
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import make_cls_loss

    fm = pick_fm(cls_fm_factory, args.weights,
                 linear_probing=args.linear_probing)
    if args.fill is None:
        args.fill = 1.0 if "kermany" in args.data_set.lower() else 0.0
    if args.lr is None:
        args.lr = fm.lr
    if args.input_size is None:
        args.input_size = fm.default_input_size
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = fm.build_model(num_classes=args.num_classes, pool=args.pool,
                           weights=args.weights, input_size=args.input_size,
                           patch_size=args.patch_size, compute_dtype=dtype,
                           model_override=args.model_override, device=device)
    opt = GroupedOptimizer(OptimizerConfig(
        opt="adamw", betas=(0.9, 0.999), eps=1e-8,
        weight_decay=args.weight_decay,
        frozen_paths=fm.frozen_paths()))
    loss_fn = make_cls_loss(model, args.smoothing,
                            frozen_encoder=args.linear_probing)
    return fm, model, opt, loss_fn


def main(argv=None):
    import sys

    from mirage_tpu_torch.ops.runtime import resolve_device
    from mirage_tpu_torch.parallel.mesh import data_parallel, writer_prints

    args = process_args(parse_with_yaml(get_parser(), argv))
    device, mesh = data_parallel(resolve_device(args.device))
    n = 1 if mesh is None else mesh.size
    if args.batch_size % n:
        sys.exit(f"--batch_size {args.batch_size} must be divisible by the "
                 f"{n} processes")
    with writer_prints(mesh):
        return _run(args, device, mesh)


def _run(args, device, mesh):

    from mirage_tpu_torch.data.folder import ImageFolder
    from mirage_tpu_torch.data.loader import DataLoader
    from mirage_tpu_torch.losses.gdice import cross_entropy_loss
    from mirage_tpu_torch.metrics.classification import (balanced_accuracy,
                                                         compute_cls_metrics,
                                                         weighted_f1)
    from mirage_tpu_torch.parallel.mesh import (batch_count, batch_rank,
                                                gather_rows, is_writer)
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.early_stop import EarlyStopping
    from mirage_tpu_torch.train.logger import MetricLogger, append_log
    from mirage_tpu_torch.train.schedules import adjust_learning_rate
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, shard_state)

    writer = is_writer(mesh)
    shards = {} if mesh is None else {"shard_index": batch_rank(mesh),
                                      "num_shards": batch_count(mesh)}
    local_bs = args.batch_size // shards.get("num_shards", 1)
    fm, model, opt, loss_fn = setup(args, device)
    print(f">> {'Linear probing' if args.linear_probing else 'Full finetune'}"
          f" lr={args.lr} input_size={args.input_size} device {device}")
    args.output_dir = output_dir(args, type(fm).__name__)
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)
        save_args(args.output_dir, args)
    step_fn = make_train_step(loss_fn, opt, mesh=mesh)
    loaders = {}
    for subset in ("train", "val", "test"):
        path = Path(args.data_path) / subset
        if not path.exists():
            continue
        tf = fm.build_transform(train=subset == "train",
                                input_size=args.input_size, fill=args.fill,
                                affine=args.affine)
        loaders[subset] = DataLoader(
            ImageFolder(str(path), transform=tf), local_bs,
            shuffle=subset == "train", drop_last=False,
            num_workers=args.num_workers, seed=args.seed, **shards)
        print(f"{subset}: {len(loaders[subset].dataset)} samples")

    @torch.no_grad()
    def evaluate(loader, epoch, mode="Valid", save_predictions=False):
        probs_all, targets_all, sums = [], [], []
        for i, (images, targets, _) in enumerate(loader):
            real = loader.real_rows(i)  # the rest pads the stripe
            images, targets = images[:real], np.asarray(targets)[:real]
            probs = np.zeros((0, args.num_classes), np.float32)
            nll = (0.0, 0)
            if real:
                logits = model(torch.from_numpy(
                    np.ascontiguousarray(images)).to(device))
                t = torch.from_numpy(targets).to(device)
                nll = tuple(float(v) for v in cross_entropy_loss(
                    logits[..., None, None], t[..., None, None],
                    normalize=False))
                probs = torch.softmax(logits, dim=-1).cpu().numpy()
            probs_all.append(probs)
            targets_all.append(targets)
            sums.append(np.float64(nll))
        # every process's rows, in the samples' order, before any metric;
        # a batch's loss from the sums over its stripes
        probs_all = np.concatenate(gather_rows(probs_all))
        targets_all = np.concatenate(gather_rows(targets_all))
        sums = np.reshape(gather_rows(sums), (len(loader), -1, 2)).sum(1)
        losses = [s / n for s, n in sums if n]
        if save_predictions and not writer:
            return None
        if save_predictions:
            np.savez_compressed(
                os.path.join(args.output_dir, "predictions.npz"),
                true_label_decode_list=targets_all,
                prediction_decode_list=probs_all.argmax(1),
                true_label_onehot_list=np.eye(args.num_classes)[targets_all],
                prediction_list=probs_all)
            return None
        m = compute_cls_metrics(targets_all, probs_all,
                                loss=float(np.mean(losses)), epoch=epoch)
        print(f"[{mode}] epoch {epoch} loss {m['loss']:.4f} bacc "
              f"{m['bacc']:.4f} auroc {m['auroc']:.4f} f1 {m['f1']:.4f} "
              f"mcc {m['mcc']:.4f}")
        return m

    state = init_train_state(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh, model)
    if args.eval or args.save_predictions:
        state = ckpt.load_best_checkpoint(args.output_dir, state)
        stats = evaluate(loaders["test"], "Best", mode="Test",
                         save_predictions=args.save_predictions)
        if stats is not None and writer:
            write_csv(os.path.join(args.output_dir, "test_eval.csv"),
                      VAL_COLS, [[stats[k] for k in VAL_KEYS]])
        return stats

    early = EarlyStopping(
        patience=args.early_stopping_epochs, delta=args.early_stopping_delta,
        delta_two=args.early_stopping_delta_two,
        greater_is_better=args.val_metric != "loss",
        greater_is_better_two=args.val_metric_two != "loss",
        start_from=args.early_start_from)
    steps_per_epoch = len(loaders["train"])
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    best_state, best_epoch = None, -1
    train_rows, val_rows = [], []
    t0 = time.time()
    for epoch in range(args.epochs):
        loaders["train"].set_epoch(epoch)
        logger = MetricLogger()
        preds_ep, tgts_ep = [], []
        stop = False
        for step, (images, targets, _) in enumerate(loaders["train"]):
            if step >= steps_per_epoch:
                break
            lr = adjust_learning_rate(args.lr, args.min_lr,
                                      epoch + step / steps_per_epoch,
                                      args.epochs, args.warmup_epochs)
            n_real = loaders["train"].real_rows(step)
            images, targets, weights = pad_batch(
                np.asarray(images), np.asarray(targets), local_bs)
            weights[n_real:] = 0.0  # the loader's padding of the stripe
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in (("images", images), ("targets", targets),
                                  ("weights", weights))}
            gen = torch.Generator(device=device).manual_seed(
                (args.seed + 1) * 1_000_003 + epoch * steps_per_epoch + step)
            state, metrics = step_fn(state, batch, gen, lr)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                print("Non-finite training loss; early stopping")
                stop = True
                break
            logger.update(loss=loss, lr=lr,
                          grad_norm=float(metrics["grad_norm"]))
            preds_ep.append(metrics["logits"][:n_real].argmax(1).cpu()
                            .numpy())
            tgts_ep.append(targets[:n_real])
        if stop:
            break
        y = np.concatenate(gather_rows(tgts_ep))
        yh = np.concatenate(gather_rows(preds_ep))
        train_rows.append([epoch, logger.meters["loss"].global_avg,
                           balanced_accuracy(y, yh), weighted_f1(y, yh)])
        print(f"[Train] epoch {epoch} loss {train_rows[-1][1]:.4f} "
              f"bacc {train_rows[-1][2]:.4f}")
        if "val" not in loaders:  # no val split: the latest is the best
            best_state, best_epoch = ckpt.snapshot(state), epoch
            if writer:
                append_log(args.output_dir, {"epoch": epoch,
                                             "train_loss": train_rows[-1][1]})
            continue
        stats = evaluate(loaders["val"], epoch)
        val_rows.append([stats[k] for k in VAL_KEYS])
        is_best = early(stats[args.val_metric], stats[args.val_metric_two],
                        epoch)
        if early.early_stop:
            print(f"Early stopping @ epoch {epoch}")
            break
        if is_best:
            best_state, best_epoch = ckpt.snapshot(state), epoch
            print(f"New best model @ epoch {epoch} "
                  f"({early.best_value:.4f}, {early.best_value_two:.4f})")
        if writer:
            append_log(args.output_dir, {
                "epoch": epoch, "train_loss": train_rows[-1][1],
                **{f"val_{k}": v for k, v in stats.items() if k != "epoch"}})

    if best_state is None:
        best_state, best_epoch = ckpt.snapshot(state), args.epochs - 1
    ckpt.save_checkpoint(args.output_dir, best_state, best_epoch, tag="best",
                         args=vars(args))
    print(f"Training time {time.time() - t0:.1f}s")
    if writer:
        write_csv(os.path.join(args.output_dir, "train_eval.csv"),
                  ["Epoch", "Loss", "BAcc", "F1-score"], train_rows)
        write_csv(os.path.join(args.output_dir, "valid_eval.csv"), VAL_COLS,
                  val_rows)
    if "test" in loaders:
        state = ckpt.load_best_checkpoint(args.output_dir, state)
        stats = evaluate(loaders["test"], "Best", mode="Test")
        if writer:
            write_csv(os.path.join(args.output_dir, "test_eval.csv"),
                      VAL_COLS, [[stats[k] for k in VAL_KEYS]])
        return stats
    return None


if __name__ == "__main__":
    main()
