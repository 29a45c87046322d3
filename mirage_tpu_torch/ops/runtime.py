"""Where the ops run, and the launchers of the CUDA building blocks.

An op runs its CUDA kernels on a CUDA tensor and its plain PyTorch version
on a CPU tensor. Nothing else chooses: a CUDA tensor never takes the plain
version (except inside :func:`plain_on_card`, which ``chip_smoke.py`` uses
to build its reference on the card), and a failed build or launch raises.

The launchers below (``layernorm``, ``layernorm_bwd``, ``gemm`` and its
epilogue forms, ``mlp_bwd_hidden`` and ``mlp_bwd_dyln`` (the MLP backward's
products), ``attention``, ``attention_bwd``, ``flash_attention``,
``flash_attention_bwd``, ``weight_grad``, ``colsum``) check their operands,
allocate outputs with ``torch.empty`` and launch the kernels of one
``csrc/`` entry on PyTorch's current stream, raising if the launch is
refused (``layernorm`` and ``layernorm_bwd`` launch as
:func:`layernorm_plan` says; ``attention`` and ``flash_attention`` are the
two entries of the bf16 attention forward, ``attention_bwd`` and
``flash_attention_bwd`` the two of its backward; ``gemm`` and
``gemm_dgelu_mul`` read a (K, N) weight as it lies with ``w_kn``, so the
stash backward copies no weight). :func:`wgrad` is the weight-gradient
contraction the B4/B5 backward ops leave outside their kernels, as the JAX
package leaves it to XLA; :func:`weight_grad` is the kernel that computes
the weight gradients the stash backward (B9) and the accumulating
backwards (B7) sum inside their TPU kernels; ``adamw_norm`` and
``adamw_tiles`` launch the AdamW step's two kernels (the gradient norm
and the update, B11) over a leaf table (``ops/fused_adamw.py``).

``fused_block`` launches the one-launch whole block (B10, a persistent
cooperative grid over the whole batch); ``ln_quant``, ``gemm_s8_fc1``,
``quant_rows`` and ``gemm_s8_fc2`` the four kernels of the int8 MLP half
(B12);
``gemm_s8_s32`` the same int8 GEMM with its s32 accumulator as the output,
and ``gemm_lnfold`` fc2 with bias, residual and the next LayerNorm in one
cluster epilogue (the bench's S3 and S4). The bench's S2, S5 and S6 add
``layernorm(..., onepass=True)``, ``gemm_gelu_mode`` (the GELU epilogue with
another erf formula), ``attention_phased`` (three phases over a group of
heads) and ``mlp_chunked`` (fc1 → GELU → fc2 with the hidden on chip).

``relpos_attention`` launches the SAM encoder's attention with its
decomposed relative-position bias (csrc/relpos_attention.cu: one kernel,
the bias products inside it, over windows or the whole grid).

Task stacks. ``layernorm``, ``layernorm_bwd``, ``gemm``, ``mlp_bwd_hidden``
and ``mlp_bwd_dyln`` also take a stack of T tasks' weights (a leading task
axis: gamma and beta (T, D), W (T, N, K), the bias (T, N)) with the rows
of the T tasks one task after another, M/T rows each, and launch the
task-strided form of their kernel once (the ``*_tasks`` C entries): the
task-batched decoder tails
(``adapters/spatial_output.py:batched_spatial_decode``). ``weight_grad``,
``colsum`` and ``wgrad`` take ``tasks=T`` and return one result a task.

Every launch of a ``csrc/`` entry goes through :func:`_launch`, which
counts it by entry: :func:`launch_counts` reads the counts, and what a
forward or a step launched is the difference of two readings.

The switches of the JAX package's non-default paths keep its names and
values and are read once at import, as ``mirage_tpu/utils/envflags.py``,
``mirage_tpu/nn/block.py:31`` and ``mirage_tpu/models/mirage.py:37`` read
them, with its defaults but one: ``MIRAGE_OPT_KERNEL`` (``on|off``: the
AdamW step's norm and update as two launches over a leaf table, B11, or
the ``torch._foreach_*`` chain) is ``on`` in the port (``off`` in the JAX
package; the numbers are the same, ``DEVIATIONS.md``), ``MIRAGE_MLP_BWD``
(``defused|accumulate``: the MLP half's backward, B5 or B7),
``MIRAGE_ATTN_BWD``
(``defused|accumulate|reg_batch``: the attention half's backward, B4 or
B7), ``MIRAGE_BLOCK_FUSE`` (``off|decoder|all``: deterministic blocks of
width ≤ 256, or all of them, as one whole-block launch, B10) and
``MIRAGE_DEC_BATCH`` (``off|on``: identically configured decoders' tails as
one task-stacked tail, ``models/mirage.py``). An unknown value raises.
:func:`set_switch` and :func:`switched` change them at run time (the tests
and ``chip_smoke.py``).
"""

import contextlib
import ctypes
import functools
import os
import threading
from collections import Counter, namedtuple

import torch

from mirage_tpu_torch.ops import _build
from mirage_tpu_torch.utils import profiling

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EPI = {"none": 0, "gelu": 1, "dgelu_mul": 2}
_plain_on_card = False


def env_choice(name: str, default: str, allowed: tuple) -> str:
    """The environment variable ``name`` (``default`` when unset); a value
    outside ``allowed`` raises rather than falling back silently."""
    val = os.environ.get(name, default)
    if val not in allowed:
        raise ValueError(
            f"{name}={val!r} is not one of {sorted(allowed)} — refusing to "
            f"fall back silently (it would corrupt an A/B measurement)")
    return val


SWITCHES = {"MIRAGE_OPT_KERNEL": ("on", ("on", "off")),
            "MIRAGE_MLP_BWD": ("defused", ("accumulate", "defused")),
            "MIRAGE_ATTN_BWD": ("defused",
                                ("accumulate", "reg_batch", "defused")),
            "MIRAGE_BLOCK_FUSE": ("off", ("off", "decoder", "all")),
            "MIRAGE_DEC_BATCH": ("off", ("on", "off"))}
switches = {name: env_choice(name, default, allowed)
            for name, (default, allowed) in SWITCHES.items()}


def set_switch(name: str, value: str) -> str:
    """Sets one switch (validated as at import); returns its old value."""
    allowed = SWITCHES[name][1]
    if value not in allowed:
        raise ValueError(f"{name}={value!r} is not one of {sorted(allowed)}")
    prev, switches[name] = switches[name], value
    return prev


@contextlib.contextmanager
def switched(values):
    """Sets the switches of ``values`` (name -> value) for the block."""
    prev = {name: set_switch(name, v) for name, v in values.items()}
    try:
        yield
    finally:
        for name, v in prev.items():
            switches[name] = v


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument. A CUDA device
    with no card present raises; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def plain_on_card():
    """Run the ops' plain versions on CUDA tensors. Only ``chip_smoke.py``
    uses this, to compute its reference on the card."""
    global _plain_on_card
    prev, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return not _plain_on_card


def check(name: str, t: torch.Tensor, like: torch.Tensor, shape=None,
          dtype=True):
    """Raise unless ``t`` is contiguous, on ``like``'s device, 16-byte
    aligned, of ``like``'s dtype (or a float parameter type when
    ``dtype=False``) and of ``shape``."""
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, expected {like.device}")
    if dtype and t.dtype != like.dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {like.dtype}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype} not in {list(_DTYPES)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


# the launch counts: one fixed slot per C entry for each thread that has
# launched (a thread's slots outlive it), registered under the lock
_ENTRY_SLOT = {name: i for i, name in enumerate(_build.ENTRIES)}
_slots_lock = threading.Lock()
_all_slots = []
_local = threading.local()


def _thread_slots():
    slots = getattr(_local, "slots", None)
    if slots is None:
        slots = _local.slots = [0] * len(_ENTRY_SLOT)
        with _slots_lock:
            _all_slots.append(slots)
    return slots


def launch_counts() -> Counter:
    """The launches of each ``csrc/`` entry since import, summed over every
    thread (the serving mesh's replica threads and the autograd engine's
    device threads launch at once). What a block launched is the
    difference of two readings: ``launch_counts() - before``."""
    with _slots_lock:
        every = list(_all_slots)
    return Counter({name: n for name, i in _ENTRY_SLOT.items()
                    if (n := sum(slots[i] for slots in every))})


def _launch(name: str, like: torch.Tensor, *args):
    """Calls the C entry ``name`` with ``args`` and the current stream of
    ``like``'s device (the caller's stream there: a host thread serving one
    device launches on its own), with that device current: the launchers
    keep their shared-memory limits and SM counts per device, read by
    ``cudaGetDevice`` (csrc/common.cuh). The launch counts toward ``name``
    in :func:`launch_counts` (only this thread writes its slots, so the
    count needs no lock) and, while a span is open, toward that span
    (``utils/profiling.py:launched``)."""
    dev = like.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if torch.cuda.current_device() == dev.index:
        rc = _build.entry(name)(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = _build.entry(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _thread_slots()[_ENTRY_SLOT[name]] += 1
    profiling.launched()


# csrc/layernorm.cu: threads a CTA; the width classes a row of which a lane
# group holds in registers (a half-warp at 256, a warp above); forward CTAs
# an SM by x's element size, backward CTAs an SM; rows a block of the generic
# backward; CTAs whose partial rows one finisher sums
LN_THREADS, LN_WIDTHS = 256, (256, 768, 1024)
LN_FWD_CTAS, LN_BWD_CTAS = {2: 2, 4: 1}, 1
LN_GENERIC_ROWS, LN_FINISH_CTAS = 32, 12
# task stacks the LN backward's counters hold
LN_MAX_TASKS = 16
LayerNormPlan = namedtuple("LayerNormPlan", [
    "width", "vec", "threads_per_row", "rows_per_cta", "grid",
    "partial_rows", "finish_groups"])


@functools.lru_cache(maxsize=256)
def layernorm_plan(m, d, sms, dtype, backward, tasks=1):
    """How csrc/layernorm.cu runs an (m, d) LayerNorm (``backward``: its
    backward) of ``dtype`` (torch.bfloat16 or torch.float32) on ``sms`` SMs:
    a :class:`LayerNormPlan`. ``tasks`` > 1: each of a task stack's tasks
    has m rows and is taken by a ``grid`` of its own (grid (grid, tasks):
    one task's rows a CTA), the CTAs a task shared out of the card's
    resident CTAs; each task's partial rows and finish groups as a one-task
    launch of that grid.

    ``width`` is the instantiation: the least of 256, 768 and 1024 that
    holds d when d is a multiple of ``vec`` (the elements of a 16-byte
    vector), else 0, the generic kernels (a warp a row, element by element,
    ``vec`` 1). ``threads_per_row`` lanes hold a row; a CTA takes
    ``rows_per_cta`` rows at a time (its lane groups; the generic backward:
    blocks of 32 rows), and CTA c takes the rows of :func:`layernorm_rows`.
    ``grid``: enough CTAs for every row, at most the CTAs an SM the kernel's
    launch bounds keep resident. The backward writes one partial row of
    dgamma and dbeta a CTA (``partial_rows``) and finishes them in
    ``finish_groups`` groups of up to 12 CTAs."""
    itemsize = dtype.itemsize
    vec = 16 // itemsize
    width = next((w for w in LN_WIDTHS if d <= w), 0) if d % vec == 0 else 0
    if width:
        tpr = 16 if width == 256 else 32
        rows_per_cta = LN_THREADS // tpr
    else:
        vec, tpr = 1, 32
        rows_per_cta = LN_GENERIC_ROWS if backward else LN_THREADS // 32
    ctas = LN_BWD_CTAS if backward else LN_FWD_CTAS[itemsize]
    grid = min(-(-m // rows_per_cta), -(-sms * ctas // tasks))
    return LayerNormPlan(width, vec, tpr, rows_per_cta, grid,
                         grid if backward else 0,
                         -(-grid // LN_FINISH_CTAS) if backward else 0)


def layernorm_rows(plan, m, cta):
    """The rows CTA ``cta`` of ``plan`` takes, one range a slot (a lane
    group, or a row of the generic backward's blocks): slot s takes rows
    (k·grid + cta)·rows_per_cta + s, k = 0, 1, ..., below m."""
    step = plan.grid * plan.rows_per_cta
    return [range(cta * plan.rows_per_cta + s, m, step)
            for s in range(plan.rows_per_cta)]


def _task_rows(name, m, tasks):
    """The rows a task of a stack of ``tasks`` over m rows."""
    if tasks <= 0 or m % tasks:
        raise ValueError(f"{name}: {m} rows do not split into {tasks} tasks")
    return m // tasks


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6, onepass: bool = False) -> torch.Tensor:
    """(M, D) -> (M, D) LayerNorm, float statistics: the variance in two
    passes, or with ``onepass`` as E[x²] − mean² clamped at 0. A (T, D)
    weight and bias: T tasks of M/T rows each, one task-strided launch."""
    m, d = x.shape
    if weight.ndim == 2:
        return _layernorm_tasks(x, weight, bias, eps, onepass)
    check("x", x, x)
    check("ln weight", weight, x, (d,), dtype=False)
    check("ln bias", bias, weight, (d,))
    plan = layernorm_plan(m, d, _sms(x.device), x.dtype, False)
    y = torch.empty_like(x)
    _launch("layernorm_onepass" if onepass else "layernorm", x, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), m, d,
            _DTYPES[x.dtype], _DTYPES[weight.dtype], plan.width, plan.grid,
            eps)
    return y


def _layernorm_tasks(x, weight, bias, eps, onepass):
    m, d = x.shape
    tasks = weight.shape[0]
    if onepass:
        raise ValueError("layernorm: the one-pass form takes one task")
    rows = _task_rows("layernorm", m, tasks)
    check("x", x, x)
    check("ln weight", weight, x, (tasks, d), dtype=False)
    check("ln bias", bias, weight, (tasks, d))
    plan = layernorm_plan(rows, d, _sms(x.device), x.dtype, False, tasks)
    y = torch.empty_like(x)
    _launch("layernorm_tasks", x, x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), rows, tasks, d, _DTYPES[x.dtype],
            _DTYPES[weight.dtype], plan.width, plan.grid, eps)
    return y


_ln_counters = {}  # device -> the LN backward's finish counters, zero


def layernorm_bwd(x: torch.Tensor, weight: torch.Tensor, dyln: torch.Tensor,
                  dy=None, sub_dy: bool = False, eps: float = 1e-6):
    """Backward of (M, D) LayerNorm from x, its scale and the float
    cotangent dyln of its output: (dx, dgamma, dbeta). dx = dy + the LN
    term, in x's dtype (sub_dy: T(T(dy + ·) − dy), the no-residual form);
    dgamma and dbeta are (D,) float sums, finished by the kernel in a fixed
    order (``layernorm_plan``). A (T, D) weight: T tasks of M/T rows, one
    task-strided launch; dgamma and dbeta (T, D)."""
    m, d = x.shape
    tasks = weight.shape[0] if weight.ndim == 2 else 0
    rows = _task_rows("layernorm_bwd", m, tasks) if tasks else m
    check("x", x, x)
    check("ln weight", weight, x, (tasks, d) if tasks else (d,), dtype=False)
    if dyln.dtype != torch.float32:
        raise ValueError(f"dyln: dtype {dyln.dtype}, expected torch.float32")
    check("dyln", dyln, dyln, (m, d))
    if dy is not None:
        check("dy", dy, x, (m, d))
    elif sub_dy:
        raise ValueError("sub_dy needs dy")
    sms = _sms(x.device)
    plan = layernorm_plan(rows, d, sms, x.dtype, True, max(tasks, 1))
    counters = _ln_counters.get(x.device)
    if counters is None:
        counters = _ln_counters[x.device] = torch.zeros(
            LN_MAX_TASKS * (1 + -(-sms * LN_BWD_CTAS // LN_FINISH_CTAS)),
            device=x.device, dtype=torch.int32)
    dx = torch.empty_like(x)
    if tasks:
        if tasks > LN_MAX_TASKS:
            raise ValueError(f"layernorm_bwd: {tasks} tasks, at most "
                             f"{LN_MAX_TASKS}")
        part = torch.empty((tasks, plan.partial_rows + plan.finish_groups, 2,
                            d), device=x.device, dtype=torch.float32)
        grads = torch.empty((2, tasks, d), device=x.device,
                            dtype=torch.float32)
        _launch("layernorm_bwd_tasks", x, x.data_ptr(), weight.data_ptr(),
                dyln.data_ptr(), _ptr(dy), dx.data_ptr(), part.data_ptr(),
                grads[0].data_ptr(), grads[1].data_ptr(), counters.data_ptr(),
                rows, tasks, d, _DTYPES[x.dtype], _DTYPES[weight.dtype],
                int(sub_dy), plan.width, plan.grid, eps)
        return dx, grads[0], grads[1]
    # the partial rows, the finish groups' rows, then dgamma and dbeta
    part = torch.empty((plan.partial_rows + plan.finish_groups + 1, 2, d),
                       device=x.device, dtype=torch.float32)
    _launch("layernorm_bwd", x, x.data_ptr(), weight.data_ptr(),
            dyln.data_ptr(), _ptr(dy), dx.data_ptr(), part.data_ptr(),
            part[-1, 0].data_ptr(), part[-1, 1].data_ptr(),
            counters.data_ptr(), m, d,
            _DTYPES[x.dtype], _DTYPES[weight.dtype], int(sub_dy), plan.width,
            plan.grid, eps)
    return dx, part[-1, 0], part[-1, 1]


def _gemm_operands(a, w, w_kn=False):
    m, k = a.shape
    n = w.shape[1] if w_kn else w.shape[0]
    check("a", a, a)
    check("weight", w, a, (k, n) if w_kn else (n, k))
    if a.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"bf16 gemm needs K and N multiples of 8, got "
                         f"K={k}, N={n}")
    return m, n, k


def _gemm_weight(a, w, w_kn):
    """The C entry and weight of a product: bf16 reads a (K, N) weight as
    it lies (``mtt_gemm_kn``); the float path takes it transposed."""
    if not w_kn:
        return "gemm", w
    if a.dtype == torch.bfloat16:
        return "gemm_kn", w
    return "gemm", w.t().contiguous()


def gemm(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
         gelu: bool = False, out_dtype=None, w_kn: bool = False) -> torch.Tensor:
    """a (M, K) · w (N, K)ᵀ (+ bias) [GELU] (+ residual) -> (M, N), in a's
    dtype or, with out_dtype=torch.float32, in float (no residual or GELU
    then).
    ``w_kn``: w is (K, N) and the product a · w, the weight read as it lies
    (bf16). A (T, N, K) w and (T, N) bias: T tasks of M/T rows, one
    task-strided launch (csrc/gemm.cu:mtt_gemm_tasks)."""
    if w.ndim == 3:
        return _gemm_tasks(a, w, bias, residual, gelu, out_dtype, w_kn)
    m, n, k = _gemm_operands(a, w, w_kn)
    entry, w = _gemm_weight(a, w, w_kn)
    out_f32 = out_dtype == torch.float32
    if out_dtype not in (None, a.dtype, torch.float32):
        raise ValueError(f"gemm out_dtype {out_dtype} unsupported")
    if out_f32 and (residual is not None or gelu):
        raise ValueError("gemm: a float32 output takes no residual or GELU")
    if w_kn and a.dtype == torch.bfloat16 and not out_f32:
        raise ValueError("gemm: a (K, N) weight takes a float32 output (or "
                         "gemm_dgelu_mul)")
    if bias is not None:
        check("bias", bias, a, (n,), dtype=False)
    if residual is not None:
        check("residual", residual, a, (m, n))
    c = torch.empty((m, n), device=a.device,
                    dtype=torch.float32 if out_f32 else a.dtype)
    _launch(entry, a, a.data_ptr(), w.data_ptr(), c.data_ptr(), _ptr(bias),
            _DTYPES[bias.dtype] if bias is not None else 0, _ptr(residual),
            m, n, k, _EPI["gelu" if gelu else "none"], _DTYPES[a.dtype],
            int(out_f32), None, None)
    return c


def _gemm_tasks(a, w, bias, residual, gelu, out_dtype, w_kn):
    tasks, n, k = w.shape
    m = a.shape[0]
    rows = _task_rows("gemm", m, tasks)
    if w_kn:
        raise ValueError("gemm: a task stack takes (N, K) weights")
    check("a", a, a, (m, k))
    check("weight", w, a, (tasks, n, k))
    if a.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"bf16 gemm needs K and N multiples of 8, got "
                         f"K={k}, N={n}")
    out_f32 = out_dtype == torch.float32
    if out_dtype not in (None, a.dtype, torch.float32):
        raise ValueError(f"gemm out_dtype {out_dtype} unsupported")
    if out_f32 and (residual is not None or gelu):
        raise ValueError("gemm: a float32 output takes no residual or GELU")
    if bias is not None:
        check("bias", bias, a, (tasks, n), dtype=False)
    if residual is not None:
        check("residual", residual, a, (m, n))
    c = torch.empty((m, n), device=a.device,
                    dtype=torch.float32 if out_f32 else a.dtype)
    _launch("gemm_tasks", a, a.data_ptr(), w.data_ptr(), c.data_ptr(),
            _ptr(bias), _DTYPES[bias.dtype] if bias is not None else 0,
            _ptr(residual), rows, n, k, tasks,
            _EPI["gelu" if gelu else "none"], _DTYPES[a.dtype], int(out_f32))
    return c


# the GELU formulas of the epilogue besides erff (csrc/gemm.cu GELU_*)
GELU_MODES = {"as26": 1, "bf16": 2, "hastings": 3}


def gemm_gelu_mode(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
                   mode: str = "as26") -> torch.Tensor:
    """bf16 a (M, K) · w (N, K)ᵀ + bias, then GELU with erf from ``mode``:
    "as26" (A&S 7.1.26 in float), "bf16" (the same polynomial, every
    operation rounded to bf16) or "hastings" (A&S 7.1.28), (+ residual)."""
    m, n, k = _gemm_operands(a, w)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"gemm_gelu_mode takes bf16 operands, got {a.dtype}")
    if mode not in GELU_MODES:
        raise ValueError(f"GELU mode {mode!r} not in {sorted(GELU_MODES)}")
    if bias is not None:
        check("bias", bias, a, (n,), dtype=False)
    if residual is not None:
        check("residual", residual, a, (m, n))
    c = torch.empty((m, n), device=a.device, dtype=a.dtype)
    _launch("gemm_gelu_mode", a, a.data_ptr(), w.data_ptr(), c.data_ptr(),
            _ptr(bias), _DTYPES[bias.dtype] if bias is not None else 0,
            _ptr(residual), m, n, k, GELU_MODES[mode])
    return c


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mlp_bwd_hidden(y: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor):
    """The MLP backward's hidden stage in one launch of csrc/mlp_bwd.cu:
    from y, dy (M, D), w1 (H, D), b1 (H,) and w2 (D, H) in torch layout, h
    = y·w1ᵀ + b1 and dact = dy·w2 in float (never stored), returns dh =
    T(dact·GELU′(h)), act = T(GELU(h)) (both (M, H) in y's dtype) and the
    float 16-row column partials (ceil(M/16), H) of the unrounded dh (db1's).
    bf16 tiles as ``ops/fused_mlp.py:mlp_bwd_plan`` says. w1 (T, H, D), b1
    (T, H), w2 (T, D, H): T tasks of M/T rows, one task-strided launch; the
    partials (T, ceil(M/T/16), H), a task's row groups within it."""
    from mirage_tpu_torch.ops.fused_mlp import mlp_bwd_plan

    m, d = y.shape
    h = w1.shape[-2]
    tasks = w1.shape[0] if w1.ndim == 3 else 0
    rows = _task_rows("mlp_bwd_hidden", m, tasks) if tasks else m
    lead = (tasks,) if tasks else ()
    check("y", y, y)
    check("dy", dy, y, (m, d))
    check("w1", w1, y, lead + (h, d))
    check("w2", w2, y, lead + (d, h))
    check("b1", b1, y, lead + (h,), dtype=False)
    if y.dtype == torch.bfloat16 and (d % 8 or h % 8):
        raise ValueError(f"bf16 mlp_bwd_hidden needs D and H multiples of 8, "
                         f"got D={d}, H={h}")
    plan = mlp_bwd_plan(rows, d, h, _sms(y.device), max(tasks, 1))
    dh = torch.empty((m, h), device=y.device, dtype=y.dtype)
    act = torch.empty_like(dh)
    part = torch.empty(lead + (-(-rows // 16), h), device=y.device,
                       dtype=torch.float32)
    args = (y.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            _DTYPES[b1.dtype], w2.data_ptr(), dh.data_ptr(), act.data_ptr(),
            part.data_ptr(), rows, d, h)
    if tasks:
        _launch("mlp_bwd_hidden_tasks", y, *args, tasks, _DTYPES[y.dtype],
                plan.hidden.grid)
    else:
        _launch("mlp_bwd_hidden", y, *args, _DTYPES[y.dtype],
                plan.hidden.grid)
    return dh, act, part


def mlp_bwd_dyln(dh: torch.Tensor, w1: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """dyln = dh (M, H) · w1 (H, D) in float (M, D), w1 read as it lies
    (csrc/mlp_bwd.cu; bf16 tiles as ``mlp_bwd_plan`` says); with
    ``out_dtype`` dh's dtype, rounded to it once (B4's dattn = T(dy·Wproj)).
    w1 (T, H, D): T tasks of M/T rows, one task-strided launch."""
    from mirage_tpu_torch.ops.fused_mlp import mlp_bwd_plan

    m, h = dh.shape
    d = w1.shape[-1]
    tasks = w1.shape[0] if w1.ndim == 3 else 0
    rows = _task_rows("mlp_bwd_dyln", m, tasks) if tasks else m
    check("dh", dh, dh)
    check("w1", w1, dh, ((tasks,) if tasks else ()) + (h, d))
    if out_dtype not in (torch.float32, dh.dtype):
        raise ValueError(f"mlp_bwd_dyln out_dtype {out_dtype} unsupported")
    if dh.dtype == torch.bfloat16 and (d % 8 or h % 8):
        raise ValueError(f"bf16 mlp_bwd_dyln needs D and H multiples of 8, "
                         f"got D={d}, H={h}")
    plan = mlp_bwd_plan(rows, d, h, _sms(dh.device), max(tasks, 1))
    dyln = torch.empty((m, d), device=dh.device, dtype=out_dtype)
    if tasks:
        _launch("mlp_bwd_dyln_tasks", dh, dh.data_ptr(), w1.data_ptr(),
                dyln.data_ptr(), rows, d, h, tasks, _DTYPES[dh.dtype],
                _DTYPES[out_dtype], plan.dyln.grid)
    else:
        _launch("mlp_bwd_dyln", dh, dh.data_ptr(), w1.data_ptr(),
                dyln.data_ptr(), m, d, h, _DTYPES[dh.dtype],
                _DTYPES[out_dtype], plan.dyln.grid)
    return dyln


def gemm_gelu_stash(a: torch.Tensor, w: torch.Tensor, bias=None):
    """fc1 of the stash forward: acc = a (M, K) · w (N, K)ᵀ + bias in float;
    returns act = T(GELU(acc)) and dg = T(GELU′(acc)), both (M, N), from
    csrc/gemm_stash.cu (bf16: a persistent grid of
    ``ops/fused_mlp.py:gemm_stash_plan``)."""
    from mirage_tpu_torch.ops.fused_mlp import gemm_stash_plan

    m, n, k = _gemm_operands(a, w)
    if bias is not None:
        check("bias", bias, a, (n,), dtype=False)
    act = torch.empty((m, n), device=a.device, dtype=a.dtype)
    dg = torch.empty_like(act)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    _launch("gemm_stash", a, a.data_ptr(), w.data_ptr(), act.data_ptr(),
            dg.data_ptr(), _ptr(bias),
            _DTYPES[bias.dtype] if bias is not None else 0, m, n, k,
            _DTYPES[a.dtype], gemm_stash_plan(m, n, k, sms).grid)
    return act, dg


def gemm_dgelu_mul(a: torch.Tensor, w: torch.Tensor, dg: torch.Tensor,
                   w_kn: bool = False):
    """The stash backward's dact product with GELU′ from the stash: acc = a
    (M, K) · w (N, K)ᵀ (with ``w_kn``, a · w for w (K, N), read as it
    lies), dg (M, N) in a's dtype. Returns dh = T(acc·dg) and the float
    16-row column partials (ceil(M/16), N) of the unrounded dh."""
    m, n, k = _gemm_operands(a, w, w_kn)
    entry, w = _gemm_weight(a, w, w_kn)
    check("dg", dg, a, (m, n))
    dh = torch.empty((m, n), device=a.device, dtype=a.dtype)
    colsum = torch.empty((-(-m // 16), n), device=a.device, dtype=torch.float32)
    _launch(entry, a, a.data_ptr(), w.data_ptr(), dh.data_ptr(), None, 0, None,
            m, n, k, _EPI["dgelu_mul"], _DTYPES[a.dtype], 0, dg.data_ptr(),
            colsum.data_ptr())
    return dh, colsum


def _row_chunks(m: int, tiles: int, sms: int, min_rows: int):
    """(chunks, rows per chunk) for a reduction over m rows: about two
    blocks per SM over ``tiles`` output tiles, at least ``min_rows`` rows a
    chunk, rows a multiple of 32. A function of the shapes and the card
    only, so a rerun sums in the same order."""
    chunks = max(1, min(-(-2 * sms // tiles), -(-m // min_rows)))
    per_chunk = -(-m // chunks)
    rows = -(-per_chunk // 32) * 32
    return -(-m // rows), rows


# csrc/wgrad.cu: a CTA computes one 128 × 256 tile of C over one row chunk,
# 64 rows a ring stage; a chunk is whole stages, at most 4096 rows (the
# tensor cores' float sums over longer chunks drift past a relative 1e-5)
WGRAD_TILE, WGRAD_ROWS, WGRAD_MAX_ROWS = (128, 256), 64, 4096


def wgrad_chunks(m: int, n1: int, n2: int, sms: int, tasks: int = 1):
    """(chunks, rows per chunk) of csrc/wgrad.cu's gᵀ·a over m rows into an
    (n1, n2) product on ``sms`` SMs: rows a multiple of 64 and at most 4096,
    and, of the 32 smallest chunk counts that allow it, the one that
    minimises the CTAs' waves × 64-row slices a CTA plus the partials'
    round trip (each chunk's tiles written and read back, ≈ an eighth of a
    slice a tile). ``tasks``: a task stack's launch, m rows a task, every
    task's tiles in the waves. A function of the shapes and the SM count
    alone, so a rerun sums in the same order."""
    if m <= 0 or n1 <= 0 or n2 <= 0 or sms <= 0 or tasks <= 0:
        raise ValueError(f"wgrad_chunks: empty product ({m}, {n1}, {n2}) on "
                         f"{sms} SMs")
    tiles = tasks * -(-n1 // WGRAD_TILE[0]) * -(-n2 // WGRAD_TILE[1])
    least = -(-m // WGRAD_MAX_ROWS)
    best = None
    for want in range(least, least + 32):
        per_chunk = -(-m // want)
        rows = -(-per_chunk // WGRAD_ROWS) * WGRAD_ROWS
        chunks = -(-m // rows)
        waves = -(-tiles * chunks // sms)
        cost = waves * rows // WGRAD_ROWS + (chunks > 1) * chunks * tiles / 8
        if best is None or cost < best[0]:
            best = (cost, chunks, rows)
    return best[1], best[2]


def weight_grad(g: torch.Tensor, a: torch.Tensor,
                tasks: int = 0) -> torch.Tensor:
    """gᵀ·a over the rows of g (M, N1) and a (M, N2): a float (N1, N2)
    weight gradient in torch Linear layout, summed by the wgrad kernel in
    fixed row chunks (:func:`wgrad_chunks`) and a fixed chunk order (no
    atomics). ``tasks`` = T: the rows are T tasks' of M/T rows each, one
    task-strided launch, a (T, N1, N2) gradient."""
    m, n1 = g.shape
    n2 = a.shape[1]
    rows_t = _task_rows("weight_grad", m, tasks) if tasks else m
    check("g", g, g)
    check("a", a, g, (m, n2))
    if g.dtype == torch.bfloat16 and (n1 % 8 or n2 % 8):
        raise ValueError(f"bf16 weight_grad needs widths multiples of 8, got "
                         f"{n1}, {n2}")
    lead = (tasks,) if tasks else ()
    out = torch.empty(lead + (n1, n2), device=g.device, dtype=torch.float32)
    chunks, rows = wgrad_chunks(rows_t, n1, n2, _sms(g.device), max(tasks, 1))
    part = (torch.empty(lead + (chunks, n1, n2), device=g.device,
                        dtype=torch.float32) if chunks > 1 else None)
    if tasks:
        _launch("wgrad_tasks", g, g.data_ptr(), a.data_ptr(), out.data_ptr(),
                _ptr(part), rows_t, n1, n2, tasks, chunks, rows,
                _DTYPES[g.dtype])
    else:
        _launch("wgrad", g, g.data_ptr(), a.data_ptr(), out.data_ptr(),
                _ptr(part), m, n1, n2, chunks, rows, _DTYPES[g.dtype])
    return out


def colsum(x: torch.Tensor, tasks: int = 0) -> torch.Tensor:
    """Float column sums of x (M, N), in fixed row chunks (at least 64 rows,
    about two blocks an SM) summed in order. ``tasks`` = T: the column sums
    of each task's M/T rows, (T, N), in one task-strided launch."""
    m, n = x.shape
    rows_t = _task_rows("colsum", m, tasks) if tasks else m
    check("x", x, x)
    lead = (tasks,) if tasks else ()
    out = torch.empty(lead + (n,), device=x.device, dtype=torch.float32)
    chunks, rows = _row_chunks(rows_t, max(tasks, 1) * -(-n // 256),
                               _sms(x.device), 64)
    part = (torch.empty(lead + (chunks, n), device=x.device,
                        dtype=torch.float32) if chunks > 1 else None)
    if tasks:
        _launch("colsum_tasks", x, x.data_ptr(), out.data_ptr(), _ptr(part),
                rows_t, n, tasks, chunks, rows, _DTYPES[x.dtype])
    else:
        _launch("colsum", x, x.data_ptr(), out.data_ptr(), _ptr(part), m, n,
                chunks, rows, _DTYPES[x.dtype])
    return out


def adamw_tiles(tiles: torch.Tensor, tile: int, leaves: torch.Tensor,
                step: torch.Tensor, scalars: torch.Tensor, b1: float,
                b2: float, eps: float):
    """The AdamW update in place over a leaf table (csrc/adamw.cu, one CTA
    a tile): ``tiles`` (T, 2) int32 (leaf, tile in the leaf) of ``tile``
    elements, ``leaves`` (L, 4) int64 (m, n, p pointers, length), ``step``
    (2L,) int64 (gradient pointers, then (lr, wd) float32 pairs) and
    ``scalars`` (4,) float32 (gscale, c1, c2, keep), all on one device.
    1 − b1 and 1 − b2 are taken in double and rounded, as the TPU kernel's
    static constants."""
    n_leaves = _adamw_table(tiles, tile, leaves, step, scalars)
    _launch("adamw_tiles", leaves, tiles.data_ptr(), tiles.shape[0], tile,
            leaves.data_ptr(), step.data_ptr(), n_leaves, scalars.data_ptr(),
            b1, 1.0 - b1, b2, 1.0 - b2, eps)


def adamw_norm(tiles: torch.Tensor, tile: int, leaves: torch.Tensor,
               step: torch.Tensor, slots: torch.Tensor, arrived: torch.Tensor,
               count: torch.Tensor, scalars: torch.Tensor, *, extra=None,
               gnorm_in=None, gnorm_out=None, clip=None, skip=None,
               b1: float, b2: float):
    """The gradient norm over the table's tiles into ``gnorm_out`` (0-d
    float32; ``slots`` (T,) float32 the tiles' squared sums, ``arrived`` an
    int32 counter left at zero; ``extra`` a 0-d float32 squared sum added
    before the root), then the step's scalars into ``scalars`` and
    ``count`` (0-d int32) += keep. With ``gnorm_in`` only the scalars."""
    _adamw_table(tiles, tile, leaves, step, scalars)
    dev = leaves.device
    for name, t, dtype in (("slots", slots, torch.float32),
                           ("arrived", arrived, torch.int32),
                           ("count", count, torch.int32),
                           ("extra", extra, torch.float32),
                           ("gnorm_in", gnorm_in, torch.float32),
                           ("gnorm_out", gnorm_out, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != dtype
                              or not t.is_contiguous()):
            raise ValueError(f"adamw_norm {name}: {t.dtype} on {t.device}, "
                             f"expected contiguous {dtype} on {dev}")
    if slots.numel() < tiles.shape[0]:
        raise ValueError(f"adamw_norm: {slots.numel()} slots for "
                         f"{tiles.shape[0]} tiles")
    if (gnorm_in is None) == (gnorm_out is None):
        raise ValueError("adamw_norm: give gnorm_in or gnorm_out")
    flags = (1 if clip is not None else 0) | (2 if skip is not None else 0)
    _launch("adamw_norm", leaves, tiles.data_ptr(), tiles.shape[0], tile,
            leaves.data_ptr(), step.data_ptr(), slots.data_ptr(),
            arrived.data_ptr(), _ptr(extra), _ptr(gnorm_in), _ptr(gnorm_out),
            count.data_ptr(), scalars.data_ptr(), flags,
            0.0 if clip is None else clip, 0.0 if skip is None else skip,
            b1, b2)


def _adamw_table(tiles, tile, leaves, step, scalars):
    """Checks a leaf table's tensors; returns its leaves."""
    n = leaves.shape[0] if leaves.ndim == 2 else -1
    if (leaves.dtype != torch.int64 or leaves.ndim != 2
            or leaves.shape[1] != 4 or not 0 < n < 1 << 31):
        raise ValueError(f"adamw leaves: {leaves.dtype} "
                         f"{tuple(leaves.shape)}, expected int64 (L, 4)")
    if tiles.dtype != torch.int32 or tiles.ndim != 2 or tiles.shape[1] != 2:
        raise ValueError(f"adamw tiles: {tiles.dtype} {tuple(tiles.shape)}, "
                         f"expected int32 (T, 2)")
    if step.dtype != torch.int64 or tuple(step.shape) != (2 * n,):
        raise ValueError(f"adamw step: {step.dtype} {tuple(step.shape)}, "
                         f"expected int64 ({2 * n},)")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (4,):
        raise ValueError("adamw scalars: float32 (4,)")
    if tile <= 0 or tile % 4:
        raise ValueError(f"adamw tile {tile}: a positive multiple of 4")
    for t in (tiles, step, scalars):
        if t.device != leaves.device or not t.is_contiguous():
            raise ValueError("adamw: the table's tensors, contiguous on one "
                             "device")
    return n


def wgrad(g: torch.Tensor, a: torch.Tensor, tasks: int = 0) -> torch.Tensor:
    """gᵀ·a over the rows of two (M, ·) matrices, in float: a weight
    gradient in torch Linear layout (out, in). 16-bit operands multiply
    exactly and sum in float (cuBLAS with a float output), as JAX's
    preferred_element_type=float32 contractions do; never rounded.
    ``tasks`` = T: one gradient for each task's M/T rows, (T, out, in)."""
    if tasks:
        rows = _task_rows("wgrad", g.shape[0], tasks)
        g = g.reshape(tasks, rows, g.shape[-1])
        a = a.reshape(tasks, rows, a.shape[-1])
        if g.dtype == torch.bfloat16:
            return torch.bmm(g.transpose(1, 2), a, out_dtype=torch.float32)
        acc = torch.float64 if g.dtype == torch.float64 else torch.float32
        return g.to(acc).transpose(1, 2) @ a.to(acc)
    if g.dtype == torch.bfloat16:
        return torch.mm(g.t(), a, out_dtype=torch.float32)
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    return g.to(acc).t() @ a.to(acc)


MAX_KEYS = 512


def attention(q, k, v, out, *, heads: int, dh: int, scale: float):
    """softmax(q kᵀ·scale) v for every (batch, head), in place in ``out``.

    q, k, v and out are (B, rows, width) views whose last dimension may be a
    column window of a wider packed tensor (q|k|v of a fused projection):
    head h reads columns [h·dh, (h+1)·dh) of each. Rows must be contiguous
    in that window; batch and row strides are passed to the kernel."""
    b, nq = q.shape[:2]
    nk = k.shape[1]
    if nk > MAX_KEYS:
        raise NotImplementedError(
            f"{nk} keys: the attention kernel holds at most {MAX_KEYS}; "
            f"longer sequences take flash_attention (B8)")
    strides = _attn_views(heads, dh, [("q", q), ("k", k), ("v", v),
                                      ("out", out)])
    if out.shape[:2] != (b, nq) or v.shape[:2] != (b, nk) or k.shape[0] != b:
        raise ValueError("attention: batch/row shapes disagree")
    _launch("attention", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, nq, nk, heads, dh, *strides, scale,
            _DTYPES[q.dtype])


def attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, *, heads: int,
                  dh: int, scale: float, partials: bool = False):
    """Backward of :func:`attention` on a packed (B, N, 3D) qkv with
    cotangent dout (B, N, D): dqkv (B, N, 3D) in qkv's dtype and the float
    column sums of the unrounded dqkv over all rows (for the qkv bias; with
    ``partials``, the kernel's (B·ceil(N/16), 3D) 16-row partials)."""
    b, n, three_d = qkv.shape
    d = heads * dh
    if three_d != 3 * d:
        raise ValueError(f"attention_bwd: qkv width {three_d} != 3·{heads}·{dh}")
    if n > MAX_KEYS:
        raise NotImplementedError(
            f"{n} tokens: the attention backward kernel holds at most "
            f"{MAX_KEYS}; longer sequences take flash_attention (B8)")
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"head dim {dh} unsupported: need a multiple of 16 "
                         f"up to 128")
    check("qkv", qkv, qkv)
    check("dout", dout, qkv, (b, n, d))
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((2, b, heads, n), device=qkv.device,
                        dtype=torch.float32)
    # every 16-row group's partials are written, by both kernels of either
    # dtype
    part = torch.empty((b * -(-n // 16), 3 * d), device=qkv.device,
                       dtype=torch.float32)
    _launch("attention_bwd", qkv, qkv.data_ptr(), dout.data_ptr(),
            dqkv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            part.data_ptr(), b, n, heads, dh, scale, _DTYPES[qkv.dtype])
    return dqkv, part if partials else part.sum(0)


def _attn_views(heads, dh, named):
    """Checks the (B, rows, ≥ heads·dh) views of an attention kernel (unit
    column stride, one device and dtype, a head dim it takes); returns
    their batch and row strides, in order."""
    first = named[0][1]
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"head dim {dh} unsupported: need a multiple of 16 "
                         f"up to 128")
    if first.dtype not in _DTYPES:
        raise ValueError(f"attention: dtype {first.dtype} unsupported")
    strides = []
    for name, t in named:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"attention {name}: {t.device}/{t.dtype}, "
                             f"expected {first.device}/{first.dtype}")
        if t.ndim != 3 or t.stride(-1) != 1 or t.shape[-1] < heads * dh:
            raise ValueError(f"attention {name}: rows must hold "
                             f"{heads}x{dh} contiguous columns")
        strides += [t.stride(0), t.stride(1)]
    return strides


def _strides(vals):
    arr = (ctypes.c_longlong * len(vals))(*vals)
    return arr, ctypes.addressof(arr)


def flash_attention(q, k, v, out, *, heads: int, dh: int, scale: float):
    """softmax(q kᵀ·scale) v for every (batch, head), any number of queries
    and keys, in place in ``out``; returns the float per-row log-sum-exp
    (B, heads, Nq) in log2 units, which :func:`flash_attention_bwd` takes.
    q, k, v and out are (B, rows, width) views whose rows hold the heads'
    columns contiguously (column windows of a packed qkv or kv allowed)."""
    b, nq = q.shape[:2]
    nk = k.shape[1]
    strides = _attn_views(heads, dh, [("q", q), ("k", k), ("v", v),
                                      ("out", out)])
    if out.shape[:2] != (b, nq) or v.shape[:2] != (b, nk) or k.shape[0] != b:
        raise ValueError("flash attention: batch/row shapes disagree")
    lse = torch.empty((b, heads, nq), device=q.device, dtype=torch.float32)
    arr, ptr = _strides(strides)
    _launch("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), ptr, b, nq, nk, heads, dh, scale,
            _DTYPES[q.dtype])
    return lse


def flash_attention_bwd(q, k, v, dout, lse, dq, dk, dv, *, heads: int,
                        dh: int, scale: float):
    """Backward of :func:`flash_attention`: writes dq, dk and dv (views laid
    out like q, k and v) in the working type from the cotangent dout and the
    forward's lse. dk and dv are summed in float over every query and
    rounded once."""
    b, nq = q.shape[:2]
    nk = k.shape[1]
    strides = _attn_views(heads, dh, [
        ("q", q), ("k", k), ("v", v), ("dout", dout), ("dq", dq), ("dk", dk),
        ("dv", dv)])
    if (dout.shape[:2] != (b, nq) or dq.shape[:2] != (b, nq)
            or dk.shape[:2] != (b, nk) or dv.shape[:2] != (b, nk)):
        raise ValueError("flash attention backward: batch/row shapes disagree")
    check("lse", lse, lse, (b, heads, nq))
    delta = torch.empty_like(lse)
    arr, ptr = _strides(strides)
    _launch("flash_bwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ptr, b, nq, nk, heads, dh, scale,
            _DTYPES[q.dtype])


# csrc/relpos_attention.cu: the head dims it is built for, and the most
# rows and columns of a window (or of the grid in a global block)
RELPOS_DH, RELPOS_MAX_ROW = (80,), 64


def relpos_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     tab_h: torch.Tensor, tab_w: torch.Tensor, *, heads: int,
                     window: int) -> torch.Tensor:
    """The bf16 attention with SAM's decomposed relative-position bias
    (``ops/relpos_attention.py``) over qkv (B, H, W, 3D) of the real
    tokens, in windows of ``window`` (0: the whole grid): (B, H, W, D).
    ``bias`` is the qkv bias (3D,), ``tab_h`` and ``tab_w`` the tables
    (2·k − 1, dh), all in qkv's dtype. One C entry, one kernel: the bias
    products are computed inside it, from each query tile it holds."""
    b, h, w, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads
    wh, ww = (window, window) if window else (h, w)
    if qkv.dtype != torch.bfloat16 or dh not in RELPOS_DH \
            or max(wh, ww) > RELPOS_MAX_ROW:
        raise NotImplementedError(
            f"relpos attention kernel: bf16 at head dims {RELPOS_DH}, "
            f"windows of up to {RELPOS_MAX_ROW} rows and columns; got "
            f"{qkv.dtype}, dh {dh}, {wh} × {ww}")
    check("qkv", qkv, qkv)
    check("bias", bias, qkv, (three_d,))
    check("tab_h", tab_h, qkv, (2 * wh - 1, dh))
    check("tab_w", tab_w, qkv, (2 * ww - 1, dh))
    out = torch.empty((b, h, w, d), device=qkv.device, dtype=qkv.dtype)
    _launch("relpos_attn", qkv, qkv.data_ptr(), bias.data_ptr(),
            tab_h.data_ptr(), tab_w.data_ptr(), out.data_ptr(), b, h, w,
            heads, dh, wh, ww, dh ** -0.5)
    return out


_occupancy = {}


def fused_block_blocks_per_sm(n: int, dh: int, dtype: torch.dtype,
                              device=None) -> int:
    """CTAs of csrc/fused_block.cu that one SM of ``device`` (default: the
    current one) holds at once (its shared memory and registers at n tokens
    and head dim dh), from the CUDA occupancy calculator; cached per
    device."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device is None else torch.device(device).index)
    key = (n, dh, dtype, device)
    if key not in _occupancy:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _build.entry("fused_block_occupancy")(
                n, dh, _DTYPES[dtype], ctypes.byref(blocks))
        if rc != 0 or blocks.value <= 0:
            raise RuntimeError(f"fused_block occupancy query failed: CUDA "
                               f"error {rc}, {blocks.value} blocks per SM")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def fused_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                b1, w2, b2, *, heads: int, grid: int, tile_n: int,
                attn_buffers: int, scale: float, eps: float = 1e-6,
                stamps=None) -> torch.Tensor:
    """The whole pre-LN block over x (B, N, D) in one cooperative launch of
    ``grid`` CTAs (at most what the card holds at once), bf16 GEMM tiles
    ``tile_n`` wide and ``attn_buffers`` heads' K and V resident in the
    attention stage (0: streamed): weights in x's dtype and (out, in)
    layout, the eight vectors in one parameter type (bqkv may be None). The
    scratch (LN outputs, qkv, attention output, MLP hidden and the grid
    barrier's counter) is one allocation. ``stamps`` (int64, 7 + grid)
    receives the kernel's stage timestamps in ns
    (``ops/fused_block.py:stage_us``)."""
    b, n, d = x.shape
    hidden = w1.shape[0]
    check("x", x, x)
    for name, w, shape in (("wqkv", wqkv, (3 * d, d)), ("wproj", wproj, (d, d)),
                           ("w1", w1, (hidden, d)), ("w2", w2, (d, hidden))):
        check(name, w, x, shape)
    check("ln1 weight", ln1_w, x, (d,), dtype=False)
    for name, v, size in (("ln1 bias", ln1_b, d), ("qkv bias", bqkv, 3 * d),
                          ("proj bias", bproj, d), ("ln2 weight", ln2_w, d),
                          ("ln2 bias", ln2_b, d), ("fc1 bias", b1, hidden),
                          ("fc2 bias", b2, d)):
        if v is not None:
            check(name, v, ln1_w, (size,))
    out = torch.empty_like(x)
    nd, nh = b * n * d, b * n * hidden
    scratch = x.new_empty(nd * 5 + nh + 16 // x.element_size())
    y, attn = scratch[:nd].view(b, n, d), scratch[nd:2 * nd].view(b, n, d)
    qkv = scratch[2 * nd:5 * nd].view(b, n, 3 * d)
    act = scratch[5 * nd:5 * nd + nh].view(b, n, hidden)
    bar = scratch[5 * nd + nh:]
    if stamps is not None:
        _check_plain("stamps", stamps, x, (7 + grid,), torch.int64)
    _launch("fused_block", x, x.data_ptr(), out.data_ptr(), ln1_w.data_ptr(),
            ln1_b.data_ptr(), wqkv.data_ptr(), _ptr(bqkv), wproj.data_ptr(),
            bproj.data_ptr(), ln2_w.data_ptr(), ln2_b.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), qkv.data_ptr(), attn.data_ptr(), act.data_ptr(),
            bar.data_ptr(), b, n, d, hidden, heads, grid, tile_n, attn_buffers,
            _DTYPES[ln1_w.dtype], scale, eps, _DTYPES[x.dtype], _ptr(stamps))
    return out


def _check_plain(name, t, like, shape, dtype):
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    of ``shape`` on ``like``'s device (the int8 and scale operands)."""
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.device}/{t.dtype}, expected "
                         f"{like.device}/{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: not contiguous and 16-byte aligned")


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """LN of x (M, D) with the one-pass variance clamped at 0, quantised per
    row: (yq (M, D) int8, rs (M,) float32)."""
    m, d = x.shape
    check("x", x, x)
    check("ln weight", weight, x, (d,), dtype=False)
    check("ln bias", bias, weight, (d,))
    yq = torch.empty((m, d), device=x.device, dtype=torch.int8)
    rs = torch.empty((m,), device=x.device, dtype=torch.float32)
    _launch("ln_quant", x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            _DTYPES[weight.dtype], yq.data_ptr(), rs.data_ptr(), m, d,
            _DTYPES[x.dtype])
    return yq, rs


def _s8_operands(a, wq, rs, s, b):
    m, k = a.shape
    n = wq.shape[0]
    _check_plain("a", a, a, (m, k), torch.int8)
    _check_plain("weight", wq, a, (n, k), torch.int8)
    for name, t, size in (("row scales", rs, m), ("weight scales", s, n),
                          ("bias", b, n)):
        _check_plain(name, t, a, (size,), torch.float32)
    if k % 16 or n % 8:
        raise ValueError(f"int8 gemm needs K % 16 == 0 and N % 8 == 0, got "
                         f"K={k}, N={n}")
    return m, n, k


def gemm_s8_fc1(a, wq, rs, s, b):
    """h = GELU(a·wqᵀ·rs·s + b) in float32 (M, N) from the int8 a (M, K)
    and wq (N, K), and each row's abs-max of h (M,)."""
    m, n, k = _s8_operands(a, wq, rs, s, b)
    h = torch.empty((m, n), device=a.device, dtype=torch.float32)
    amax = torch.zeros((m,), device=a.device, dtype=torch.float32)
    _launch("gemm_s8", a, a.data_ptr(), wq.data_ptr(), rs.data_ptr(),
            s.data_ptr(), b.data_ptr(), 0, h.data_ptr(), amax.data_ptr(),
            None, None, m, n, k, 0)
    return h, amax


def quant_rows(h: torch.Tensor, amax: torch.Tensor):
    """(aq (M, N) int8, rs (M,)) from the float h and its rows' abs-max."""
    m, n = h.shape
    _check_plain("h", h, h, (m, n), torch.float32)
    _check_plain("amax", amax, h, (m,), torch.float32)
    if n % 4:
        raise ValueError(f"quant_rows needs a width multiple of 4, got {n}")
    aq = torch.empty((m, n), device=h.device, dtype=torch.int8)
    rs = torch.empty((m,), device=h.device, dtype=torch.float32)
    _launch("quant_rows", h, h.data_ptr(), amax.data_ptr(), aq.data_ptr(),
            rs.data_ptr(), m, n)
    return aq, rs


def gemm_s8_fc2(a, wq, rs, s, b, x):
    """out = x + T(a·wqᵀ·rs·s + b) in x's dtype (M, N)."""
    m, n, k = _s8_operands(a, wq, rs, s, b)
    check("x", x, x, (m, n))
    out = torch.empty_like(x)
    _launch("gemm_s8", a, a.data_ptr(), wq.data_ptr(), rs.data_ptr(),
            s.data_ptr(), b.data_ptr(), 1, None, None, x.data_ptr(),
            out.data_ptr(), m, n, k, _DTYPES[x.dtype])
    return out


def gemm_s8_s32(a, wq):
    """a (M, K) int8 · wq (N, K) int8ᵀ -> the exact int32 (M, N) product
    (the int8 GEMM's third epilogue: the s32 accumulator as it is)."""
    m, k = a.shape
    n = wq.shape[0]
    _check_plain("a", a, a, (m, k), torch.int8)
    _check_plain("weight", wq, a, (n, k), torch.int8)
    if k % 16 or n % 8:
        raise ValueError(f"int8 gemm needs K % 16 == 0 and N % 8 == 0, got "
                         f"K={k}, N={n}")
    out = torch.empty((m, n), device=a.device, dtype=torch.int32)
    _launch("gemm_s8", a, a.data_ptr(), wq.data_ptr(), None, None, None, 2,
            None, None, None, out.data_ptr(), m, n, k, 0)
    return out


# the LN-fold epilogue's cluster spans D / 256 CTAs (each a 256-column tile)
LNFOLD_TILE_N, LNFOLD_MAX_CLUSTER = 256, 8


def gemm_lnfold(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                residual: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                eps: float = 1e-6):
    """out = T(residual + T(a·wᵀ + bias)) and y = T(LN(out)·ln_w + ln_b),
    both (M, N), from a (M, K) and w (N, K) in bf16: one launch of
    thread-block clusters of N / 256 CTAs, each CTA one 128 × 256 tile, the
    LN statistics of a row summed across the cluster in distributed shared
    memory. N must be a multiple of 256 up to 2048."""
    m, n, k = _gemm_operands(a, w)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"gemm_lnfold takes bf16 operands, got {a.dtype}")
    if n % LNFOLD_TILE_N or n // LNFOLD_TILE_N > LNFOLD_MAX_CLUSTER:
        raise ValueError(f"gemm_lnfold needs N a multiple of {LNFOLD_TILE_N} "
                         f"up to {LNFOLD_TILE_N * LNFOLD_MAX_CLUSTER} (one "
                         f"cluster of at most {LNFOLD_MAX_CLUSTER} CTAs per "
                         f"row tile), got N={n}")
    check("bias", bias, a, (n,), dtype=False)
    check("residual", residual, a, (m, n))
    check("ln weight", ln_w, a, (n,), dtype=False)
    check("ln bias", ln_b, ln_w, (n,))
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    y = torch.empty_like(out)
    _launch("gemm_lnfold", a, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            _DTYPES[bias.dtype], residual.data_ptr(), ln_w.data_ptr(),
            ln_b.data_ptr(), _DTYPES[ln_w.dtype], out.data_ptr(), y.data_ptr(),
            m, n, k, eps)
    return out, y


# the phased attention kernel's softmax modes (csrc/attention_phased.cu)
SMAX_MODES = {"exp": 0, "exp2": 1, "nomax": 2, "skip": 3}


def attention_phased(q, k, v, out, *, heads: int, dh: int, group: int,
                     scale: float, smax: str = "exp", divide: bool = True):
    """softmax(q kᵀ·scale) v in three phases (every score of a group of
    ``group`` heads, one softmax pass, every P·V), in place in ``out``; bf16
    views as :func:`attention` takes them, tiled as
    ``ops/block_attention.py:phased_plan`` says. ``smax``: "exp", "exp2",
    "nomax" or "skip" (the raw scores as P); ``divide=False`` leaves the
    output unnormalised."""
    from mirage_tpu_torch.ops.block_attention import phased_plan

    b, nq = q.shape[:2]
    nk = k.shape[1]
    if smax not in SMAX_MODES:
        raise ValueError(f"softmax mode {smax!r} not in {sorted(SMAX_MODES)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"attention_phased takes bf16, got {q.dtype}")
    if nk > MAX_KEYS:
        raise NotImplementedError(f"{nk} keys: the phased kernel holds at "
                                  f"most {MAX_KEYS}")
    strides = _attn_views(heads, dh, [("q", q), ("k", k), ("v", v),
                                      ("out", out)])
    if out.shape[:2] != (b, nq) or v.shape[:2] != (b, nk) or k.shape[0] != b:
        raise ValueError("attention_phased: batch/row shapes disagree")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = phased_plan(nk, dh, heads, group, batch=b, sms=sms, nq=nq)
    _launch("attention_phased", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, nq, nk, heads, dh, group,
            int(plan.branch == "resident"), plan.heads_per_cta, plan.qtile,
            plan.qsplit, *strides, scale, SMAX_MODES[smax], int(divide))


def mlp_chunked(y: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, x: torch.Tensor,
                rows_per_cluster: int) -> torch.Tensor:
    """out = T(x + T(GELU(y·w1ᵀ + b1)·w2ᵀ + b2)) over the rows of y and x
    (M, D), w1 (H, D), w2 (D, H), bf16, with the (M, H) hidden kept in the
    shared memory of a row tile's D / 256 CTAs, ``rows_per_cluster`` row
    tiles a cluster, as ``ops/fused_mlp.py:mlp_chunked_plan`` plans it (and
    raises for a shape the kernel does not take)."""
    from mirage_tpu_torch.ops.fused_mlp import mlp_chunked_plan

    m, d = y.shape
    hidden = w1.shape[0]
    if y.dtype != torch.bfloat16:
        raise ValueError(f"mlp_chunked takes bf16 operands, got {y.dtype}")
    mlp_chunked_plan(m, d, hidden, rows_per_cluster)
    check("y", y, y)
    check("w1", w1, y, (hidden, d))
    check("w2", w2, y, (d, hidden))
    check("x", x, y, (m, d))
    check("b1", b1, y, (hidden,), dtype=False)
    check("b2", b2, b1, (d,))
    out = torch.empty_like(x)
    _launch("mlp_chunked", y, y.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), _DTYPES[b1.dtype], x.data_ptr(),
            out.data_ptr(), m, d, hidden, rows_per_cluster)
    return out
