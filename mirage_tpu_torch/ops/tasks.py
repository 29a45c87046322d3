"""Task stacks: the weights of T identically shaped modules stacked on a
leading task axis, over activations whose leading batch is T·B (the rows of
task t one after another).

``adapters/spatial_output.py:batched_spatial_decode`` runs the decoders'
tails this way, as the JAX package runs them under ``jax.vmap`` over
stacked parameters. Every op the tails reach takes such a stack: on the
card through the task-strided kernels (``ops/runtime.py``), and in its
plain version as a loop over the tasks (:func:`per_task`), which is what T
separate calls compute.
"""

import torch


def stacked(w, ndim: int) -> int:
    """T when ``w`` holds a leading task axis over a weight of ``ndim``
    dimensions, else 0 (None: 0)."""
    return w.shape[0] if w is not None and w.ndim == ndim + 1 else 0


def per_task(fn, tasks: int, xs, weights):
    """fn(*task t's parts of xs, *task t's weights) for each task, the
    outputs concatenated on the leading axis; None weights stay None. Each
    x's leading batch must be T·B."""
    if any(x.shape[0] % tasks for x in xs):
        raise ValueError(f"a batch of {[x.shape[0] for x in xs]} does not "
                         f"split into {tasks} tasks")
    parts = [x.chunk(tasks, 0) for x in xs]
    return torch.cat([fn(*(p[t] for p in parts),
                         *(None if w is None else w[t] for w in weights))
                      for t in range(tasks)], 0)


def task_sums(t: torch.Tensor, tasks: int) -> torch.Tensor:
    """Float column sums of t's rows (..., N): one row of sums a task, (T,
    N), over a task stack's rows; over all rows, (N,), when tasks is 0."""
    sums = t.reshape(max(tasks, 1), -1, t.shape[-1]).sum(1, dtype=torch.float32)
    return sums if tasks else sums[0]
