"""MultiMAE token masking: Dirichlet task sampling and random token choice.

Counterpart of ``mirage_tpu/masking/masking.py`` (``sample_alphas``,
``generate_random_masks``, ``masks_to_indices``), with the randomness drawn
from an explicit ``torch.Generator``; the numbers differ from JAX's for the
same seed, so tests compare invariants, or feed both packages the same
explicit masks. The one-hot matmul gathers of the JAX package are a TPU
device; here the row gather and scatter are ``torch.gather`` and
``Tensor.scatter``.
"""

import itertools
from typing import Dict, List, Sequence, Tuple, Union

import torch


def _alphas(alphas, n_tasks):
    return torch.tensor([alphas] * n_tasks if isinstance(alphas, float)
                        else list(alphas), dtype=torch.float32)


def sample_gamma(conc: torch.Tensor, generator: torch.Generator):
    """Gamma(conc, 1) variates from ``generator`` (``torch._standard_gamma``
    and ``torch.distributions.Dirichlet`` take none). conc == 1 (the
    reference pretraining config) is −log U; any other concentration takes
    Marsaglia–Tsang, with Gamma(α) = Gamma(α + 1)·U^(1/α) for α < 1."""
    dev = generator.device
    conc = conc.to(dev, torch.float32)
    out = -torch.log1p(-torch.rand(conc.shape, generator=generator,
                                   device=dev))
    pending = conc != 1.0
    if not bool(pending.any()):
        return out
    boost = conc < 1.0
    a = torch.where(boost, conc + 1.0, conc)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    while bool(pending.any()):
        z = torch.randn(conc.shape, generator=generator, device=dev)
        u = torch.rand(conc.shape, generator=generator, device=dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    u = torch.rand(conc.shape, generator=generator, device=dev)
    return torch.where(boost, out * u ** (1.0 / conc), out)


def sample_alphas(generator: torch.Generator, batch: int, n_tasks: int,
                  alphas: Union[float, Sequence[float]] = 1.0,
                  eps: float = 1e-5):
    """A uniformly chosen non-empty task subset per sample, scaled by
    alphas: the (B, n_tasks) Dirichlet concentration."""
    choices = torch.tensor(
        [list(c) for c in itertools.product([0, 1], repeat=n_tasks)][1:],
        dtype=torch.float32, device=generator.device)
    idx = torch.randint(0, choices.shape[0], (batch,), generator=generator,
                        device=generator.device)
    return choices[idx] * _alphas(alphas, n_tasks).to(choices.device) + eps


def generate_random_masks(
    generator: torch.Generator,
    num_tokens_per_task: Sequence[int],
    batch: int,
    num_encoded_tokens: int,
    alphas: Union[float, Sequence[float]] = 1.0,
    sample_tasks_uniformly: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``num_encoded_tokens`` visible tokens per sample, spread over the
    tasks by a Dirichlet draw. Returns the per-task masks ((B, n_i) int32,
    1 = masked), ids_keep (B, num_encoded_tokens) and ids_restore (B, N),
    on the generator's device."""
    dev = generator.device
    n_tasks = len(num_tokens_per_task)
    if sample_tasks_uniformly:
        conc = sample_alphas(generator, batch, n_tasks, alphas)
    else:
        conc = _alphas(alphas, n_tasks).expand(batch, n_tasks)
    g = sample_gamma(conc, generator)
    task_dist = g / g.sum(-1, keepdim=True)
    samples = torch.round(task_dist * num_encoded_tokens).long()

    masks = []
    for i, n in enumerate(num_tokens_per_task):
        noise = torch.rand((batch, n), generator=generator, device=dev)
        perm = torch.argsort(noise, dim=1)  # a uniform random permutation
        masks.append(torch.where(perm < samples[:, i:i + 1], 0, 1))
    mask_all = torch.cat(masks, dim=1)
    tiebreak = torch.rand(mask_all.shape, generator=generator, device=dev)
    ids_shuffle = torch.argsort(mask_all.float() + tiebreak, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :num_encoded_tokens]
    # re-binarise so exactly num_encoded_tokens are visible (the rounding of
    # the per-task counts may miss by a few)
    mask_all = (ids_restore >= num_encoded_tokens).to(torch.int32)
    return (list(torch.split(mask_all, list(num_tokens_per_task), dim=1)),
            ids_keep, ids_restore)


def masks_to_indices(task_masks: Dict[str, torch.Tensor],
                     task_order: Sequence[str], num_visible: int):
    """ids_keep (B, num_visible) and ids_restore (B, N) from explicit binary
    masks (1 = masked), by a stable argsort: visible tokens in task order."""
    mask_all = torch.cat([task_masks[t] for t in task_order], dim=1)
    ids_shuffle = torch.argsort(mask_all, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    return ids_shuffle[:, :num_visible], ids_restore


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[b, j] = x[b, ids[b, j]]: (B, N, D), (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def scatter_rows(values: torch.Tensor, ids: torch.Tensor, n: int,
                 fill: torch.Tensor) -> torch.Tensor:
    """out[b, ids[b, j]] = values[b, j], every other row = fill (D,):
    (B, M, D) -> (B, N, D)."""
    b, _, d = values.shape
    base = fill.to(values.dtype).expand(b, n, d)
    return base.scatter(1, ids[..., None].expand(-1, -1, d), values)
