"""The single-device training steps: pretraining (masked forward,
token-space losses) and segmentation tuning (the light forward through the
seg head, a segmentation loss), each with its backward and the grouped
optimizer's update.

Counterpart of ``mirage_tpu/train/steps.py`` (``make_pretrain_loss``,
``make_train_step``, ``init_train_state``; reference run_pretraining.py
train_one_epoch) and of the seg tuning loss of
``mirage_tpu/cli/run_seg_tuning.py:296-308``: the loss, the gradients of
every trainable parameter (frozen encoder blocks stop requiring grad, so
the backward runs through them to the input adapters without their weight
gradients, as the reference freeze does), the clipped update, and metrics
``{"loss", "grad_norm", "loss_<task>"}`` left on the device (no host sync
in the step). The multi-device steps come with the multi-GPU slice.
"""

from typing import Any, Callable, Mapping, Optional

import torch

from mirage_tpu_torch.losses.masked import (masked_ce_loss_tokens,
                                            masked_mse_loss_tokens)
from mirage_tpu_torch.train.optim import GroupedOptimizer


def make_pretrain_loss(model, domain_conf: Mapping[str, Mapping[str, Any]],
                       num_encoded_tokens: int, alphas=1.0,
                       sample_tasks_uniformly: bool = False,
                       loss_on_unmasked: bool = False):
    """domain_conf: task -> {'loss': 'mse'|'ce', 'patch_size': int,
    'norm_pix': bool}. Returns loss_fn(batch, generator=None,
    task_masks=None, num_visible=None) -> (loss, {task: loss}): random masks
    from ``generator``, or explicit ``task_masks`` (1 = masked) with
    ``num_visible`` visible tokens per sample."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None,
                task_masks=None, num_visible=None):
        preds, masks = model(
            batch, mask_inputs=True, task_masks=task_masks,
            num_encoded_tokens=num_encoded_tokens, num_visible=num_visible,
            alphas=alphas, sample_tasks_uniformly=sample_tasks_uniformly,
            generator=generator, deterministic=False, pixel_outputs=False)
        task_losses = {}
        for task, pred in preds.items():
            conf = domain_conf[task]
            mask = None if loss_on_unmasked else masks[task]
            if conf["loss"] == "ce":
                task_losses[task] = masked_ce_loss_tokens(
                    pred, batch[task], mask, patch_size=conf["patch_size"])
            else:
                task_losses[task] = masked_mse_loss_tokens(
                    pred.float(), batch[task].float(), mask,
                    patch_size=conf["patch_size"],
                    norm_pix=conf.get("norm_pix", False))
        return sum(task_losses.values()), task_losses

    return loss_fn


def make_seg_loss(model, criterion: Callable, in_domains,
                  frozen_encoder: bool = False):
    """Segmentation tuning's loss: loss_fn(batch, generator=None) -> (loss,
    {}). The light forward (stochastic depth from ``generator``), the seg
    head's logits in float, resized bilinearly to the labels' size when they
    differ, and ``criterion(logits, batch["semseg"])``."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        preds = model.forward_light(
            {k: v for k, v in batch.items() if k in in_domains},
            deterministic=False, generator=generator,
            frozen_encoder=frozen_encoder)
        logits = preds["semseg"].float()
        target = batch["semseg"]
        if logits.shape[-2:] != target.shape[-2:]:
            from mirage_tpu_torch.nn.resize import resize2d

            logits = resize2d(logits, target.shape[-2:], mode="bilinear")
        return criterion(logits, target), {}

    return loss_fn


def init_train_state(model: torch.nn.Module, optimizer: GroupedOptimizer):
    """{'params': name -> parameter (the model's own, updated in place),
    'opt': the optimizer state, 'step': a device counter}. Frozen parameters
    stop requiring grad."""
    optimizer.stop_frozen(model)
    params = dict(model.named_parameters())
    first = next(iter(params.values()))
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def make_train_step(loss_fn: Callable, optimizer: GroupedOptimizer):
    """step_fn(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs) ->
    (state, metrics): loss_fn(batch, generator=generator, **loss_kwargs)
    (e.g. the pretraining loss's task_masks and num_visible), gradients of
    every parameter that requires grad, the optimizer update in place, the
    step counter."""

    def step_fn(state, batch, generator, lr, wd_scale=1.0, **loss_kwargs):
        params = state["params"]
        loss, task_losses = loss_fn(batch, generator=generator,
                                    **loss_kwargs)
        names = [n for n, p in params.items() if p.requires_grad]
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        gnorm = optimizer.update(dict(zip(names, grads)), state["opt"],
                                 params, lr, wd_scale)
        state["step"] += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        metrics.update({f"loss_{k}": v.detach()
                        for k, v in task_losses.items()})
        return state, metrics

    return step_fn
