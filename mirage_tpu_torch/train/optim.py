"""AdamW / Adam / SGD with parameter-group semantics, on named parameters.

Counterpart of ``mirage_tpu/train/optim.py`` (reference
mutils/optim_factory.py and mutils/native_scaler.py), written on a model's
``named_parameters()``:

- no weight decay for biases, 1-D parameters (LayerNorm scales) and the
  reference's skip list (pos_emb, class_emb, global_tokens, mask_token,
  task_embeddings, cls_emb);
- layer-wise LR decay: input adapters and global tokens at
  decay^(L + 1), encoder block i at decay^(L − i), everything else 1;
- frozen parameters (fixed sin-cos posembs unless ``learnable_pos_emb``,
  the encoder under ``freeze_encoder``, ``frozen_paths``) get no moments
  and no update; ``decoder_decay`` for the output adapters;
- the global gradient norm, clipping to ``clip_grad`` and skipping the
  whole update (moments and step count too) when the norm is not finite or
  reaches ``skip_grad`` — all on the device, with no host sync.

The update works in place on the parameters and the moments (the JAX
package returns new arrays); ``count`` advances only on kept steps. With
``MIRAGE_OPT_KERNEL=on`` (default off, as in the JAX package) the AdamW
leaves that ``ops.fused_adamw.leaf_update_viable`` admits take the fused
AdamW update (B11: one launch over all of them on the card); the rest take
the ``torch._foreach_*`` route, unchanged. gnorm, gscale, keep, c1 and c2
stay device scalars on both routes.

Sharded training (``train/steps.py``): a parameter FSDP2 shards is a
DTensor, and the update runs on its local shard (``.to_local()``), as do
its moments, which are plain tensors of the local shard's shape; a
tensor-parallel leaf is its tensor-local block. The caller then hands in
the global gradient norm (``gnorm``), so clipping and skipping follow the
whole model's gradient.
"""

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from mirage_tpu_torch.ops.fused_adamw import fused_adamw, leaf_update_viable

NO_DECAY_PATH_NAMES = {"pos_emb", "class_emb", "global_tokens", "mask_token",
                       "task_embeddings", "cls_emb"}


@dataclasses.dataclass
class OptimizerConfig:
    opt: str = "adamw"
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.05
    momentum: float = 0.9
    layer_decay: Optional[float] = None
    num_layers: int = 12
    freeze_encoder: bool = False
    frozen_paths: Tuple[str, ...] = ()
    learnable_pos_emb: bool = False
    decoder_decay: Optional[float] = None
    clip_grad: Optional[float] = None
    skip_grad: Optional[float] = None


def leaf_meta(cfg: OptimizerConfig, name: str, param: torch.Tensor):
    """(weight decay, lr scale, trainable) of one named parameter."""
    names = name.split(".")
    no_decay = (names[-1] == "bias" or param.ndim <= 1
                or any(n in NO_DECAY_PATH_NAMES for n in names))
    wd = 0.0 if no_decay else cfg.weight_decay
    if cfg.decoder_decay is not None and not no_decay \
            and names[0] == "output_adapters":
        wd = cfg.decoder_decay
    trainable = not (("pos_emb" in names and not cfg.learnable_pos_emb)
                     or (cfg.freeze_encoder and names[0] == "encoder")
                     or any(n in cfg.frozen_paths for n in names))
    lr_scale = 1.0
    if cfg.layer_decay is not None:
        depth = cfg.num_layers
        if names[0] in ("input_adapters", "global_tokens"):
            lr_scale = cfg.layer_decay ** (depth + 1)
        elif names[0] == "encoder":
            lr_scale = cfg.layer_decay ** (depth - int(names[1]))
    return wd, lr_scale, trainable


def local(t):
    """The local shard of a DTensor (a view: in-place updates write the
    parameter), any other tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) in float, on the tensors' device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class GroupedOptimizer:
    """The update takes the learning rate (and a weight-decay factor) per
    step, as the JAX package's does."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def meta(self, params: Mapping[str, torch.Tensor]):
        return {n: leaf_meta(self.cfg, n, p) for n, p in params.items()}

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        """Moments for the trainable parameters only (of their local
        shards), and the step count."""
        first = local(next(iter(params.values())))
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=first.device)}
        trainable = [n for n, (_, _, t) in self.meta(params).items() if t]
        moments = ("mu", "nu") if self.cfg.opt in ("adamw", "adam") else \
            ("mu",) if self.cfg.opt in ("sgd", "momentum", "nesterov") else ()
        if not moments:
            raise ValueError(f"Unknown optimizer {self.cfg.opt}")
        for k in moments:
            state[k] = {n: torch.zeros_like(local(params[n]))
                        for n in trainable}
        return state

    def count_trainable(self, params: Mapping[str, torch.Tensor]):
        """(trainable, total) element counts of the named parameters."""
        meta = self.meta(params)
        total = sum(p.numel() for p in params.values())
        trainable = sum(p.numel() for n, p in params.items() if meta[n][2])
        return trainable, total

    def stop_frozen(self, model: torch.nn.Module):
        """Frozen parameters stop requiring grad, so autograd computes no
        weight gradient for them (activation gradients still flow through)."""
        for n, p in model.named_parameters():
            if not leaf_meta(self.cfg, n, p)[2]:
                p.requires_grad_(False)

    @torch.no_grad()
    def update(self, grads: Mapping[str, Optional[torch.Tensor]], state: Dict,
               params: Mapping[str, torch.Tensor], lr: float,
               wd_scale: float = 1.0, gnorm=None) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the global
        grad norm (a device scalar): ``gnorm`` when given, else the norm of
        the given grads."""
        cfg = self.cfg
        grads = {n: None if g is None else local(g) for n, g in grads.items()}
        meta = self.meta(params)
        params = {n: local(p) for n, p in params.items()}
        if gnorm is None:
            gnorm = global_norm([g for g in grads.values() if g is not None])
        keep = (torch.isfinite(gnorm) & (gnorm < cfg.skip_grad)
                if cfg.skip_grad is not None
                else torch.ones((), dtype=torch.bool, device=gnorm.device))
        keep_f = keep.float()
        gscale = (torch.clamp(cfg.clip_grad / (gnorm + 1e-6), max=1.0)
                  if cfg.clip_grad is not None else None)
        state["count"] += keep.to(torch.int32)
        names = [n for n in state["mu"] if grads.get(n) is not None]
        if cfg.opt in ("adamw", "adam"):
            b1, b2 = cfg.betas
            count = torch.clamp(state["count"].float(), min=1.0)
            c1 = 1 - torch.pow(b1, count)
            c2 = 1 - torch.pow(b2, count)
            routed = [n for n in names if leaf_update_viable(
                params[n], meta[n][1], cfg.opt, meta[n][2])]
            fused_adamw(
                [grads[n] for n in routed], [state["mu"][n] for n in routed],
                [state["nu"][n] for n in routed], [params[n] for n in routed],
                [lr * meta[n][1] for n in routed],
                [meta[n][0] * wd_scale for n in routed],
                gscale=gscale if gscale is not None else torch.ones(
                    (), device=gnorm.device), c1=c1, c2=c2, keep=keep_f,
                b1=b1, b2=b2, eps=cfg.eps)
            names = [n for n in names if n not in routed]
        if not names:
            return gnorm
        ps = [params[n] for n in names]
        # a skipped step's grads may be inf/NaN: select, never multiply
        gs = [torch.where(keep, grads[n].float(), 0.0) for n in names]
        if gscale is not None:
            gs = torch._foreach_mul(gs, gscale)
        wds = [meta[n][0] * wd_scale for n in names]
        steps = [-lr * meta[n][1] for n in names]
        mus = [state["mu"][n] for n in names]
        if cfg.opt in ("adamw", "adam"):
            if cfg.opt == "adam":  # torch Adam: L2 on the gradient
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, wds))
            # kept: m = b1·m + (1 − b1)·g; skipped: m unchanged (exactly)
            one = torch.ones((), device=gnorm.device)
            zero = torch.zeros((), device=gnorm.device)
            nus = [state["nu"][n] for n in names]
            torch._foreach_mul_(mus, torch.where(keep, b1, one))
            torch._foreach_add_(mus, torch._foreach_mul(
                gs, torch.where(keep, 1 - b1, zero)))
            torch._foreach_mul_(nus, torch.where(keep, b2, one))
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(gs, gs), torch.where(keep, 1 - b2, zero)))
            upd = torch._foreach_div(
                torch._foreach_div(mus, c1),
                torch._foreach_add(torch._foreach_sqrt(
                    torch._foreach_div(nus, c2)), cfg.eps))
            if cfg.opt == "adamw":
                upd = torch._foreach_add(upd, torch._foreach_mul(ps, wds))
        else:  # SGD family, torch semantics: d = g + wd·p; buf = mom·buf + d
            d = torch._foreach_add(gs, torch._foreach_mul(ps, wds))
            for m, dd in zip(mus, d):
                m.copy_(torch.where(keep, cfg.momentum * m + dd, m))
            upd = (torch._foreach_add(d, torch._foreach_mul(mus, cfg.momentum))
                   if cfg.opt in ("sgd", "nesterov") else mus)
        upd = torch._foreach_mul(upd, steps)
        torch._foreach_add_(ps, torch._foreach_mul(upd, keep_f))
        return gnorm


def create_optimizer(cfg: OptimizerConfig) -> GroupedOptimizer:
    return GroupedOptimizer(cfg)
