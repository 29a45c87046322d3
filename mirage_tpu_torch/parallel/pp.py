"""GPipe pipeline parallelism over the encoder's depth, with explicit
point-to-point sends and an autograd Function around the whole schedule.

Counterpart of ``mirage_tpu/parallel/pp.py``. There the stacked encoder
leaves shard over a 'pipe' mesh axis on their layer axis and a ``lax.scan``
over M + S − 1 ticks rotates the activations with one ``ppermute`` a tick;
backward is autodiff. Here each stage (the process at 'pipe' coordinate s
of S) holds only its own blocks ``encoder.{i}``, i in [s·L/S, (s+1)·L/S),
under their global names (``train/steps.py:shard_state``), and runs them
through the same ``Block`` ops as one GPU does, so every kernel sees the
stage's local operands at the microbatch's shape.

Forward (:func:`pp_encoder_apply`): the pre-encoder (input adapters,
masking) runs replicated on every stage of one batch position, its
generator folded by the batch position only, so every stage holds the same
tokens x (b, N, D). Stage 0 feeds microbatch j of M (b/M rows), stage s > 0
receives it from s − 1, runs its blocks and sends the result to s + 1; the
last stage assembles the (b, N, D) output, which is broadcast over 'pipe'
so the decoders and the loss run replicated (the JAX package's masked
psum, ``pp.py:170-174``). No bubble tick is computed: the JAX scan's
clamped chains past the M valid ones receive zero cotangents, so skipping
them changes no number.

Backward (:class:`_Pipeline`, built the way reentrant checkpointing is):
the forward keeps each microbatch's local graph (its input, made a leaf,
and its output); the backward receives the broadcast output's cotangent,
which transposes to a sum over 'pipe' into the last stage (an all-reduce),
then runs the microbatches in reverse with ``torch.autograd.backward`` (the
stage's parameters accumulate their ``.grad``) and sends each input's
gradient to s − 1; stage 0 hands dx on into the pre-encoder. So
``loss.backward()`` works unchanged. Every process issues its sends and
receives in one fixed order (forward j = 0 … M − 1, backward M − 1 … 0), as
NCCL, which ignores tags, needs; every wait has a timeout (gloo: the wait's
own, :data:`parallel.mesh.TIMEOUT`; NCCL: the group's, set at its init).

Gradient bookkeeping (``train/steps.py``, as ``steps.py:434-462`` there):
the loss is scaled by 1/S; the stage's encoder leaves ('local',
:func:`pp_grad_kind`) are then complete, every other leaf ('sum') is one
S-th (decoder side) or stage 0's alone (input side) and an all-reduce over
'pipe' completes it.

Point to point on NCCL uses ``dist.batch_isend_irecv`` on the pipe group,
after one collective has formed that group's communicator. Gloo carries no
send or receive of a CUDA tensor (its ``send`` hands the tensor's pointer
to a host transport, and the sending process aborts), so on gloo a CUDA
tensor is staged through a host copy; CPU tensors go as they are.

Scope, as in the JAX package: 'pipe' composes with 'data' only, the
drop-path rate must be 0 (per-layer rates span the whole depth), the
optimizer has no layer decay, the depth divides by S, and
``return_all_layers`` is refused.
"""

import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_BLOCK = re.compile(r"^encoder\.(\d+)\.")


def is_pp(mesh) -> bool:
    """Meshes the pipeline step covers: pipe > 1 (data any); composition
    with fsdp or tensor sharding is refused by the step's placement."""
    return mesh.shape["pipe"] > 1


def stage_of(name: str, depth: int, n_stages: int) -> Optional[int]:
    """The stage that owns the named leaf (``encoder.{i}.*``: stage
    i // (depth / n_stages)), or None for a leaf every stage holds."""
    m = _BLOCK.match(name)
    if m is None:
        return None
    if depth % n_stages:
        raise ValueError(f"encoder depth {depth} is not divisible by "
                         f"{n_stages} pipeline stages")
    return int(m.group(1)) // (depth // n_stages)


def pp_param_specs(names, depth: int,
                   n_stages: int) -> Dict[str, Optional[int]]:
    """name -> the stage holding the leaf (every ``encoder.{i}`` leaf, and
    its Adam moments, on one stage), or None (replicated over 'pipe'): the
    JAX package's P('pipe') on the stacked layer axis, one block a row."""
    return {n: stage_of(n, depth, n_stages) for n in names}


def pp_grad_kind(names) -> Dict[str, str]:
    """How each leaf's gradient relates to 'pipe' in the pipeline step
    (with the loss scaled by 1/S): 'local' (the stage's encoder leaves,
    complete as they are) or 'sum' (everything else: one all-reduce over
    'pipe' completes it)."""
    return {n: "local" if _BLOCK.match(n) else "sum" for n in names}


# ---------------------------------------------------------------------------
# the pipe group's collectives
# ---------------------------------------------------------------------------

class Pipe:
    """This process's place in its pipeline: the 'pipe' group of its batch
    position, its stage and the stage count, the stages' global ranks, and
    the sends, receives, broadcast and sum over them."""

    def __init__(self, mesh, device):
        from mirage_tpu_torch.parallel.mesh import TIMEOUT

        self.group = mesh.group(("pipe",))
        self.size = mesh.shape["pipe"]
        self.stage = mesh.coords["pipe"]
        base = dist.get_rank() - self.stage  # 'pipe' is the innermost axis
        self.ranks = [base + i for i in range(self.size)]
        self.gloo = dist.get_backend(self.group) == "gloo"
        self.timeout = TIMEOUT
        # form the group's communicator with a collective of every stage
        # before the first send (NCCL: batch_isend_irecv's first call in a
        # group must involve all its ranks)
        dist.all_reduce(torch.zeros(1, device=device), group=self.group)

    def _wait(self, work):
        if self.gloo:
            work.wait(self.timeout)
        else:  # NCCL: the stream waits; the group's watchdog times it out
            work.wait()

    def send(self, t: torch.Tensor, stage: int):
        """Starts sending ``t`` to ``stage``; :meth:`finish` the handle."""
        t = t.detach().contiguous()
        if self.gloo and t.is_cuda:
            t = t.cpu()
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, self.ranks[stage], self.group)])
        return works, t  # t stays referenced until the send is waited

    def finish(self, handles):
        for works, _ in handles:
            for w in works:
                self._wait(w)

    def recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        """The tensor ``stage`` sends next (waited on)."""
        host = self.gloo and torch.device(device).type == "cuda"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else device)
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, buf, self.ranks[stage],
                            self.group)]):
            self._wait(w)
        return buf.to(device, non_blocking=False) if host else buf

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """``stage``'s ``t`` on every stage, in place."""
        self._wait(dist.broadcast(t, self.ranks[stage], group=self.group,
                                  async_op=True))
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the stages, in place."""
        self._wait(dist.all_reduce(t, group=self.group, async_op=True))
        return t


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _local_blocks(encoder):
    return [b for b in encoder if b is not None]


def _run_stage(encoder, h, deterministic, grad_free):
    """The stage's blocks in order on one microbatch (per-block remat as
    ``Encoder.block_step`` applies it)."""
    for block in _local_blocks(encoder):
        h = encoder.block_step(block, h, deterministic, 0.0, None, grad_free)
    return h


def _forward_schedule(encoder, x, n_micro, deterministic, grad_free,
                      keep_graph):
    """The forward schedule; returns (output on every stage, the
    microbatches' (input, output) pairs when ``keep_graph``)."""
    pipe = encoder.pipe
    s, last = pipe.stage, pipe.size - 1
    b = x.shape[0]
    mb = b // n_micro
    shape = (mb,) + tuple(x.shape[1:])
    kept, outs, sends = [], [], []
    for j in range(n_micro):
        if s == 0:
            inp = x[j * mb:(j + 1) * mb].detach().contiguous()
        else:
            inp = pipe.recv(shape, x.dtype, x.device, s - 1)
        if keep_graph:
            inp.requires_grad_()
        with torch.set_grad_enabled(keep_graph):
            y = _run_stage(encoder, inp, deterministic, grad_free)
        if keep_graph:
            kept.append((inp, y))
        if s < last:
            sends.append(pipe.send(y, s + 1))
        else:
            outs.append(y.detach())
    pipe.finish(sends)
    out = torch.cat(outs) if s == last else torch.empty(
        x.shape, dtype=x.dtype, device=x.device)
    return pipe.broadcast(out, last), kept


class _Pipeline(torch.autograd.Function):
    """The whole schedule as one autograd node (see the module docstring).
    ``params``: the stage's trainable parameters, inputs only so that the
    output requires grad whenever they do; their gradients accumulate in
    ``.grad`` during this node's backward."""

    @staticmethod
    def forward(ctx, x, encoder, n_micro, deterministic, *params):
        out, kept = _forward_schedule(encoder, x, n_micro, deterministic,
                                      False, keep_graph=True)
        ctx.encoder, ctx.kept, ctx.n_params = encoder, kept, len(params)
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.encoder.pipe
        s, last = pipe.stage, pipe.size - 1
        kept, ctx.kept = ctx.kept, None
        n_micro = len(kept)
        shape, dtype, device = ctx.x_meta
        mb = shape[0] // n_micro
        if s == last:  # the broadcast's transpose: the stages' sum
            g = pipe.sum(g.contiguous().clone())
        else:
            pipe.sum(g.contiguous().clone())
        dx, sends = [None] * n_micro, []
        for j in reversed(range(n_micro)):
            inp, y = kept[j]
            if s == last:
                gj = g[j * mb:(j + 1) * mb]
            else:
                gj = pipe.recv((mb,) + tuple(shape[1:]), y.dtype, device,
                               s + 1)
            torch.autograd.backward(y, gj)
            kept[j] = None
            if s > 0:
                sends.append(pipe.send(inp.grad, s - 1))
            else:
                dx[j] = inp.grad
        pipe.finish(sends)
        grad_x = torch.cat(dx).to(dtype) if s == 0 else None
        return (grad_x, None, None, None) + (None,) * ctx.n_params


def pp_encoder_apply(encoder, x, deterministic: bool = True,
                     grad_free: bool = False,
                     n_micro: Optional[int] = None):
    """The pipelined encoder (``Encoder.forward`` with ``pp`` set): the
    schedule over the stage's blocks in ``n_micro`` microbatches (default:
    the model's ``pp`` count), or, without a pipe bound (``encoder.pipe``
    None: a model placed on no pipe axis, or on one of size 1), the plain
    loop over every block it holds, the JAX package's degenerate
    single-stage view (``pp.py:119-126``)."""
    n_micro = n_micro or encoder.pp[1]
    pipe = encoder.pipe
    if pipe is None or pipe.size == 1:
        return _run_stage(encoder, x, deterministic, grad_free)
    if x.shape[0] % n_micro:
        raise ValueError(f"local batch {x.shape[0]} not divisible by "
                         f"n_micro {n_micro}")
    params: List[torch.Tensor] = [p for p in encoder.parameters()
                                  if p.requires_grad]
    if torch.is_grad_enabled() and not grad_free and (
            x.requires_grad or params):
        return _Pipeline.apply(x, encoder, n_micro, deterministic, *params)
    return _forward_schedule(encoder, x, n_micro, deterministic, grad_free,
                             keep_graph=False)[0]
