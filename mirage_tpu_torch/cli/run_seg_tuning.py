"""Segmentation tuning on the PyTorch/CUDA port.

Counterpart of ``mirage_tpu/cli/run_seg_tuning.py`` (reference
run_seg_tuning.py): a pretrained MIRAGE encoder with the ConvNeXt,
Segmenter, DPT or linear head (``--output_adapter``), the reference freeze
by default (encoder blocks frozen, the input adapters and global tokens
trained through them), stochastic depth in the encoder, the CE /
CE-ignore-background / CE+GDice losses, AdamW with layer-wise LR decay, a
validation pass per epoch (mIoU, aAcc, mAcc, an input | prediction | GT
panel in ``val_images/``) keeping the best checkpoint by mIoU, resuming
from the newest checkpoint, then the test pass with the best checkpoint
where a test split exists. ``--test`` runs only that pass: prediction PNGs
(the class values of INFO.json) named ``{sid}.png`` in ``preds`` or
``preds_{external}`` for ``run_seg_eval``; ``--infer_only`` exports without
scoring and skips when every PNG is there.

Usage:
  python -m mirage_tpu_torch.cli.run_seg_tuning -c configs/seg_200e_convnext.yaml \\
      --data_path /data/Segmentation/AROI --weights MIRAGE-Base.pth [--device cuda]
  ... --test [--test_data_path /data/Segmentation/Duke_iAMD/test] [--infer_only]

Several GPUs, data-parallel over every process (mirage_tpu/cli/
run_seg_tuning.py:289-336): ``torchrun --nproc_per_node N -m
mirage_tpu_torch.cli.run_seg_tuning ...``. ``--batch_size`` is the global
batch and must divide over the processes; each process loads its stripe of
every batch (the validation and test passes too, padded to a multiple of
the processes and the padding dropped), the metrics (the segmentation
histogram, the loss) are summed over the processes before they are read,
and process 0 alone logs and writes, but every process writes the
prediction PNGs of its own samples.

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain PyTorch path (gloo between processes). The dataset is
``{data_path}/{train,val,test}/{bscan,semseg}/...`` with matching file
names and ``{data_path}/INFO.json`` ({"0": {"label": "background",
"value": 0}, ...}).
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mirage_tpu_torch.cli.config import (normalize_domain_sizes,
                                         parse_with_yaml, save_args, str2bool)
from mirage_tpu_torch.data.loader import to_device
from mirage_tpu_torch.train.steps import step_generator


def get_parser():
    p = argparse.ArgumentParser("MIRAGE segmentation tuning (PyTorch/CUDA)")
    p.add_argument("--batch_size", default=4, type=int,
                   help="the global batch, split over the processes")
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--save_ckpt_freq", default=200, type=int)
    p.add_argument("--eval_freq", default=1, type=int)
    p.add_argument("--in_domains", default="bscan", type=str)
    p.add_argument("--decoder_main_tasks", default="bscan", type=str)
    p.add_argument("--num_global_tokens", default=1, type=int)
    p.add_argument("--patch_size", default=32, type=int)
    p.add_argument("--input_size", default=1024, type=int)
    p.add_argument("--drop_path_encoder", default=0.1, type=float)
    p.add_argument("--output_adapter", default="convnext",
                   choices=["segmenter", "convnext", "dpt", "linear"])
    p.add_argument("--decoder_interpolate_mode", default="bilinear",
                   choices=["bilinear", "nearest"])
    p.add_argument("--loss", default="CEGDice",
                   choices=["CE", "CE-ignore-bg", "CEGDice"])
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=[0.9, 0.999], type=float, nargs="+")
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--weight_decay_end", default=None, type=float)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--warmup_lr", default=1e-6, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--warmup_epochs", default=1, type=int)
    p.add_argument("--warmup_steps", default=-1, type=int)
    p.add_argument("--layer_decay", default=0.75, type=float)
    p.add_argument("--freeze_encoder", default=True, type=str2bool)
    p.add_argument("--no_freeze_encoder", dest="freeze_encoder",
                   action="store_false")
    p.add_argument("--freeze_input_adapters", default=False,
                   action="store_true",
                   help="with --freeze_encoder: also freeze the input "
                        "adapters and global tokens and skip the encoder "
                        "backward (not the reference's freeze)")
    p.add_argument("--learnable_pos_emb", default=False, type=str2bool)
    p.add_argument("--no_learnable_pos_emb", dest="learnable_pos_emb",
                   action="store_false")
    p.add_argument("--remat", default=False, action="store_true",
                   help="encoder activation checkpointing (full-FT memory)")
    p.add_argument("--weights", required=True, type=str)
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--test_data_path", default=None, type=str)
    p.add_argument("--external", default=None, type=str,
                   help="name of an external test dataset: predictions go "
                        "to preds_{external} for run_seg_eval --external "
                        "(set for a Duke_iAMD test path)")
    p.add_argument("--output_dir", default="./output/seg", type=str)
    p.add_argument("--version", default="v1", type=str)
    p.add_argument("--minmax", default=True, type=str2bool)
    p.add_argument("--test", default=False, action="store_true")
    p.add_argument("--infer_only", default=False, action="store_true")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--ignore_index", default=None, type=int)
    p.add_argument("--log_freq", default=20, type=int)
    p.add_argument("--max_steps_per_epoch", default=None, type=int)
    p.add_argument("--model_override", default=None, type=str,
                   help="bypass the weights-name registry (e.g. "
                        "miragepre_tiny)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def process_args(args):
    args.in_domains = args.in_domains.split("-")
    normalize_domain_sizes(args, args.in_domains)
    args.data_path = Path(args.data_path)
    args.dataset_name = args.data_path.stem
    args.train_data_path = args.data_path / "train"
    args.eval_data_path = args.data_path / "val"
    if args.test and args.test_data_path is None:
        args.test_data_path = args.data_path / "test"
    # an AROI model tested on Duke iAMD (mirage_tpu/cli/run_seg_tuning.py:
    # 106-113): preds_Duke_iAMD for run_seg_eval's class translator
    if args.external is None and args.test and args.test_data_path \
            is not None and "Duke_iAMD" in str(args.test_data_path):
        args.external = "Duke_iAMD"
    with open(args.data_path / "INFO.json") as f:
        original = json.load(f)
    mapping = {}
    for k, v in original.items():
        if args.ignore_index is None and any(
                bg in v["label"].lower() for bg in ("background", "bg")):
            args.ignore_index = int(k)
        mapping[v["value"]] = int(k)
    args.mapping = mapping
    args.inverse_mapping = {v: k for k, v in mapping.items()}
    args.num_classes = len(mapping)
    name = Path(args.weights).stem
    if args.freeze_encoder:
        name += "_frozen"
    if args.freeze_encoder and args.freeze_input_adapters:
        name += "_fia"
    if args.learnable_pos_emb:
        name += "_lpe"
    name += f"_{args.output_adapter}_{args.loss}"
    if args.minmax:
        name += "_minmax"
    args.output_dir = str(Path(args.output_dir) / args.version
                          / args.dataset_name / name)
    args.all_domains = sorted(set(args.in_domains) | {"semseg"})
    return args


def build_model(args, fm, dtype, generator):
    """The MIRAGE light model with the ``--output_adapter`` head (the head
    factory of mirage_tpu/cli/run_seg_tuning.py:171-191), initialised from
    ``generator`` (a checkpoint then overlays it)."""
    from mirage_tpu_torch.adapters.input_adapters import (PatchedInputAdapter,
                                                          SemSegInputAdapter)
    from mirage_tpu_torch.adapters.seg_heads import (
        ConvNeXtAdapter, DPTOutputAdapter, LinearSegAdapter,
        SegmenterMaskTransformerAdapter)
    from mirage_tpu_torch.models.mirage import model_factory

    conf = fm.domain_conf()
    inputs = {}
    for d in args.in_domains:
        c = conf[d]
        if c["semseg"]:
            inputs[d] = SemSegInputAdapter(
                num_classes=c["num_classes"], stride_level=c["stride_level"],
                patch_size_full=args.patch_size[d],
                dim_class_emb=c["dim_class_emb"],
                emb_padding_idx=c.get("emb_padding_idx"),
                image_size=args.input_size[d])
        else:
            inputs[d] = PatchedInputAdapter(
                num_channels=c["channels"], stride_level=c["stride_level"],
                patch_size_full=args.patch_size[d],
                image_size=args.input_size[d])
    model_name = args.model_override or fm.model
    if model_name != "miragelight_base" and args.output_adapter == "dpt" \
            and not args.model_override:
        raise NotImplementedError("DPT head is configured for ViT-B only")
    main = args.in_domains[0]
    main_tasks = tuple(args.decoder_main_tasks.split("-"))
    common = dict(num_classes=args.num_classes, main_tasks=main_tasks,
                  patch_size=args.patch_size[main], task="semseg",
                  image_size=args.input_size[main])
    mode = args.decoder_interpolate_mode
    heads = {
        "segmenter": lambda: SegmenterMaskTransformerAdapter(
            embed_dim=768, **common),
        "convnext": lambda: ConvNeXtAdapter(
            embed_dim=6144, preds_per_patch=16, depth=4,
            interpolate_mode=mode, **common),
        "dpt": lambda: DPTOutputAdapter(stride_level=1, head_type="semseg",
                                        **common),
        "linear": lambda: LinearSegAdapter(interpolate_mode=mode, **common)}
    return model_factory[model_name](
        inputs, {"semseg": heads[args.output_adapter]()},
        num_global_tokens=args.num_global_tokens,
        drop_path_rate=args.drop_path_encoder, compute_dtype=dtype,
        remat=args.remat, generator=generator)


def make_criterion(args):
    from mirage_tpu_torch.losses.gdice import (ce_gdice_loss,
                                               cross_entropy_loss)

    if args.loss == "CE":
        return cross_entropy_loss
    if args.loss == "CE-ignore-bg":
        if args.ignore_index is None:
            raise ValueError("Ignore index is not set")
        return lambda logits, tgt: cross_entropy_loss(
            logits, tgt, ignore_index=args.ignore_index)
    return ce_gdice_loss


def pick_seg_fm(args):
    """The foundation-model config the weights' file name picks, with the
    min-max norm under ``--minmax``."""
    from mirage_tpu_torch.api.fm_configs import pick_fm, seg_fm_factory

    fm = pick_fm(seg_fm_factory, args.weights)
    if args.minmax:
        fm.norm = "minmax"
    return fm


def setup(args, device):
    """The model (seg head, pretrained weights overlaid, on ``device``), the
    optimizer, the criterion and the loss function of a run: (fm, model,
    optimizer, criterion, loss_fn)."""
    from mirage_tpu_torch.train.optim import GroupedOptimizer, OptimizerConfig
    from mirage_tpu_torch.train.steps import make_seg_loss

    fm = pick_seg_fm(args)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_model(args, fm, dtype,
                        torch.Generator().manual_seed(args.seed))
    missing = fm.load(model, args.weights)
    print(f">> FM config: {type(fm).__name__} (norm={fm.norm}, "
          f"model={fm.model}), device {device}; loaded {args.weights}, "
          f"{len(missing)} tensors keep their initialisation")
    model = model.to(device)
    if args.learnable_pos_emb:  # fixed sin-cos otherwise (requires_grad off)
        for adapter in model.input_adapters.values():
            adapter.pos_emb.requires_grad_(True)
    full_freeze = args.freeze_encoder and args.freeze_input_adapters
    opt = GroupedOptimizer(OptimizerConfig(
        opt=args.opt, betas=tuple(args.opt_betas), eps=args.opt_eps,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        layer_decay=args.layer_decay if args.layer_decay < 1.0 else None,
        num_layers=model.depth, freeze_encoder=args.freeze_encoder,
        frozen_paths=("input_adapters", "global_tokens") if full_freeze
        else (), learnable_pos_emb=args.learnable_pos_emb))
    criterion = make_criterion(args)
    loss_fn = make_seg_loss(model, criterion, args.in_domains,
                            frozen_encoder=full_freeze,
                            return_all_layers=args.output_adapter == "dpt")
    return fm, model, opt, criterion, loss_fn


def save_panel(args, batch, pred, epoch, mode):
    """The input | prediction | GT debug panel of a batch's first sample,
    each min-max scaled to uint8, as ``val_images/e{epoch:04d}_{mode}.png``
    (mirage_tpu/cli/run_seg_tuning.py:372-383)."""
    from PIL import Image

    img = np.asarray(batch[args.in_domains[0]][0])
    img = img[0] if img.ndim == 3 else img

    def u8(a):
        return ((a - a.min()) / max(a.max() - a.min(), 1e-12)
                * 255).astype(np.uint8)

    panel = np.concatenate(
        [u8(img), u8(pred[0].astype(np.float32)),
         u8(np.asarray(batch["semseg"][0], np.float32))], axis=1)
    out = Path(args.output_dir) / "val_images"
    out.mkdir(parents=True, exist_ok=True)
    Image.fromarray(panel).save(out / f"e{epoch:04d}_{mode}.png")


def main(argv=None):
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
    from mirage_tpu_torch.data.augment import SemSegTransform
    from mirage_tpu_torch.data.folder import MultiTaskImageFolder
    from mirage_tpu_torch.data.loader import DataLoader
    from mirage_tpu_torch.metrics.semseg import SegMetricAccumulator
    from mirage_tpu_torch.nn.resize import resize2d
    from mirage_tpu_torch.parallel.mesh import (batch_count, batch_rank,
                                                is_writer, sum_across)
    from mirage_tpu_torch.train import checkpoint as ckpt
    from mirage_tpu_torch.train.logger import MetricLogger, append_log
    from mirage_tpu_torch.train.schedules import cosine_scheduler
    from mirage_tpu_torch.train.steps import (init_train_state,
                                              make_train_step, shard_state)

    writer = is_writer(mesh)
    shards = {} if mesh is None else {"shard_index": batch_rank(mesh),
                                      "num_shards": batch_count(mesh)}
    local_bs = args.batch_size // shards.get("num_shards", 1)
    # idempotence guards (mirage_tpu/cli/run_seg_tuning.py:230-238): skip a
    # finished training, refuse a test without a best checkpoint
    best_dir = Path(args.output_dir) / "checkpoint-best"
    final_dir = Path(args.output_dir) / f"checkpoint-{args.epochs - 1}"
    if not args.test and best_dir.is_dir() and final_dir.is_dir():
        print("Model already trained. Skipping...")
        return None
    if args.test and not best_dir.is_dir():
        raise SystemExit("ERROR: Model not fully trained (no checkpoint-best)")

    size = args.input_size[args.in_domains[0]][0]
    norm = pick_seg_fm(args).norm
    val_tf = SemSegTransform(train=False, input_size=size, norm=norm)
    dataset_train = MultiTaskImageFolder(
        str(args.train_data_path), args.all_domains, mapping=args.mapping,
        transform=SemSegTransform(train=True, input_size=size, norm=norm))
    dataset_val = MultiTaskImageFolder(
        str(args.eval_data_path), args.all_domains, mapping=args.mapping,
        transform=val_tf)
    print(f"Training on {len(dataset_train)}, validating on "
          f"{len(dataset_val)}")
    dataset_test = None
    if args.test_data_path is not None and Path(args.test_data_path).exists():
        dataset_test = MultiTaskImageFolder(
            str(args.test_data_path), args.all_domains, mapping=args.mapping,
            transform=val_tf)
    preds_dir = Path(args.output_dir) / (
        f"preds_{args.external}" if args.external else "preds")
    if (args.infer_only and args.test and dataset_test is not None
            and preds_dir.is_dir()
            and len(list(preds_dir.iterdir())) == len(dataset_test)):
        print("Inference already done. Skipping...")
        return None

    _, model, opt, criterion, loss_fn = setup(args, device)
    step_fn = make_train_step(loss_fn, opt, mesh=mesh)
    loader_train = DataLoader(dataset_train, local_bs, shuffle=True,
                              drop_last=True, num_workers=args.num_workers,
                              seed=args.seed, **shards)
    loader_val = DataLoader(dataset_val, local_bs,
                            num_workers=args.num_workers, **shards)
    steps_per_epoch = len(loader_train)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    lr_sched = cosine_scheduler(args.lr, args.min_lr, args.epochs,
                                steps_per_epoch,
                                warmup_epochs=args.warmup_epochs,
                                start_warmup_value=args.warmup_lr,
                                warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None \
        else args.weight_decay
    wd_sched = cosine_scheduler(1.0, wd_end / max(args.weight_decay, 1e-12),
                                args.epochs, steps_per_epoch)

    state = init_train_state(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh, model)
    start_epoch = 0
    if not args.test:
        state, start_epoch = ckpt.auto_load_checkpoint(args.output_dir, state)
    if writer:
        save_args(args.output_dir, args)
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"Params: {total / 1e6:.1f}M total, {trainable / 1e6:.2f}M "
          f"trainable (freeze_encoder={args.freeze_encoder})")
    lut = np.zeros(args.num_classes, np.uint8)
    for idx, value in args.inverse_mapping.items():
        lut[idx] = value
    return_all_layers = args.output_adapter == "dpt"

    @torch.no_grad()
    def evaluate(loader, mode="val", epoch=0, save_preds=False):
        acc = SegMetricAccumulator(args.num_classes, ignore_index=255)
        if save_preds:
            from PIL import Image

            preds_dir.mkdir(parents=True, exist_ok=True)
        step_to_save = int(np.random.default_rng(epoch).integers(
            0, max(len(loader), 1)))
        losses = []
        for step_i, (batch, _, sids) in enumerate(loader):
            real = loader.real_rows(step_i)  # the rest pads the stripe
            if real == 0:
                continue
            batch = {k: v[:real] for k, v in batch.items()}
            x = to_device(batch, device)
            logits = model.forward_light(
                {k: v for k, v in x.items() if k in args.in_domains},
                return_all_layers=return_all_layers)["semseg"].float()
            if logits.shape[-2:] != x["semseg"].shape[-2:]:
                logits = resize2d(logits, x["semseg"].shape[-2:],
                                  mode="bilinear")
            loss = criterion(logits, x["semseg"])
            pred = logits.argmax(1).cpu().numpy()
            if (writer and not args.infer_only
                    and step_i == step_to_save):
                save_panel(args, batch, pred, epoch, mode)
            if save_preds:
                for i, sid in enumerate(sids[:real]):
                    Image.fromarray(lut[pred[i]]).save(
                        preds_dir / f"{sid}.png")
            if not args.infer_only:
                acc.update(pred, batch["semseg"])
                losses.append(loss.item())
        if args.infer_only:
            print("Inference done. Exiting...")
            sys.exit(0)
        # every process's histogram and losses, summed before they are read
        (acc.intersect, acc.union, acc.pred, acc.label,
         (loss_sum, loss_n)) = sum_across(
            [acc.intersect, acc.union, acc.pred, acc.label,
             [sum(losses), len(losses)]], device)
        all_acc, cls_acc, iou = acc.compute(["mIoU"])
        stats = {"loss": loss_sum / loss_n if loss_n else 0.0,
                 "mean_iou": float(np.nanmean(iou)),
                 "pixel_accuracy": float(all_acc),
                 "mean_accuracy": float(np.nanmean(cls_acc))}
        print(f"[{mode} e{epoch}] mIoU {stats['mean_iou']:.4f} "
              f"aAcc {stats['pixel_accuracy']:.4f} "
              f"mAcc {stats['mean_accuracy']:.4f} loss {stats['loss']:.4f}")
        return stats

    def test():
        if dataset_test is None:
            raise SystemExit(f"ERROR: no test split at {args.test_data_path}")
        ckpt.load_best_checkpoint(args.output_dir, state)
        stats = evaluate(DataLoader(dataset_test, local_bs,
                                    num_workers=args.num_workers, **shards),
                         mode="test", save_preds=True)
        if writer:
            append_log(args.output_dir,
                       {f"test/{k}": v for k, v in stats.items()})
        return stats

    if args.test:
        return test()

    print(f"Start training for {args.epochs} epochs")
    t0 = time.time()
    max_miou, log_stats = 0.0, {}
    for epoch in range(start_epoch, args.epochs):
        loader_train.set_epoch(epoch)
        logger = MetricLogger()
        it = epoch * steps_per_epoch
        for step, (batch, _, _) in enumerate(logger.log_every(
                loader_train, args.log_freq,
                f"{args.dataset_name} e[{epoch}]")):
            if step >= steps_per_epoch:
                break
            state, metrics = step_fn(
                state, to_device(batch, device),
                step_generator(args.seed, it, device),
                float(lr_sched[min(it, len(lr_sched) - 1)]),
                float(wd_sched[min(it, len(wd_sched) - 1)]))
            if step % args.log_freq == 0 or step == steps_per_epoch - 1:
                host = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(host["loss"]):
                    print(f"Loss is {host['loss']}, stopping")
                    sys.exit(1)
                logger.update(**host)
            it += 1
        log_stats = {"epoch": epoch, **{f"train/{k}": m.global_avg
                                        for k, m in logger.meters.items()}}
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs:
            ckpt.save_checkpoint(args.output_dir, state, epoch,
                                 args=vars(args))
        if epoch % args.eval_freq == 0 or epoch == args.epochs - 1:
            stats = evaluate(loader_val, epoch=epoch)
            if stats["mean_iou"] > max_miou:
                max_miou = stats["mean_iou"]
                ckpt.save_checkpoint(args.output_dir, state, epoch,
                                     tag="best", args=vars(args))
            print(f"Max mIoU: {max_miou:.4f}")
            log_stats.update({f"val/{k}": v for k, v in stats.items()})
        if writer:
            append_log(args.output_dir, log_stats)
    print(f"Training time {time.time() - t0:.1f}s")
    out = {"max_miou": max_miou, "last_epoch": log_stats,
           "output_dir": args.output_dir}
    if dataset_test is not None:
        print("Testing with best checkpoint")
        out["test"] = test()
    return out


if __name__ == "__main__":
    main()
