"""Where the ops run, and the launchers of the CUDA building blocks.

An op runs its CUDA kernels on a CUDA tensor and its plain PyTorch version
on a CPU tensor. Nothing else chooses: a CUDA tensor never takes the plain
version (except inside :func:`plain_on_card`, which ``chip_smoke.py`` uses
to build its reference on the card), and a failed build or launch raises.

The launchers below (``layernorm``, ``layernorm_bwd``, ``gemm`` and its
epilogue forms, ``attention``, ``attention_bwd``, ``flash_attention``,
``flash_attention_bwd``, ``weight_grad``, ``colsum``) check their operands,
allocate outputs with ``torch.empty`` (partial sums with ``torch.zeros``)
and launch the kernels of one ``csrc/`` entry on PyTorch's current stream,
raising if the launch is refused. :func:`wgrad` is the weight-gradient
contraction the B4/B5 backward ops leave outside their kernels, as the JAX
package leaves it to XLA; :func:`weight_grad` is the kernel that computes
the weight gradients the stash backward (B9) sums inside its TPU kernel.
"""

import contextlib
import ctypes

import torch

from mirage_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EPI = {"none": 0, "gelu": 1, "gelu_bwd": 2, "gelu_stash": 3, "dgelu_mul": 4}
_plain_on_card = False


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


def _launch(name: str, *args):
    rc = _build.entry(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """(M, D) -> (M, D) LayerNorm, float statistics."""
    m, d = x.shape
    check("x", x, x)
    check("ln weight", weight, x, (d,), dtype=False)
    check("ln bias", bias, weight, (d,))
    y = torch.empty_like(x)
    _launch("layernorm", x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), m, d, _DTYPES[x.dtype], _DTYPES[weight.dtype], eps)
    return y


def layernorm_bwd(x: torch.Tensor, weight: torch.Tensor, dyln: torch.Tensor,
                  dy=None, sub_dy: bool = False, eps: float = 1e-6,
                  partials: bool = False):
    """Backward of (M, D) LayerNorm from x, its scale and the float
    cotangent dyln of its output: (dx, dgamma, dbeta). dx = dy + the LN
    term, in x's dtype (sub_dy: T(T(dy + ·) − dy), the no-residual form);
    dgamma and dbeta are float sums of the kernel's per-block partials (or,
    with ``partials``, those (ceil(M/32), D) partials unsummed)."""
    m, d = x.shape
    check("x", x, x)
    check("ln weight", weight, x, (d,), dtype=False)
    if dyln.dtype != torch.float32:
        raise ValueError(f"dyln: dtype {dyln.dtype}, expected torch.float32")
    check("dyln", dyln, dyln, (m, d))
    if dy is not None:
        check("dy", dy, x, (m, d))
    elif sub_dy:
        raise ValueError("sub_dy needs dy")
    dx = torch.empty_like(x)
    blocks = -(-m // 32)
    dgp = torch.empty((blocks, d), device=x.device, dtype=torch.float32)
    dbp = torch.empty_like(dgp)
    _launch("layernorm_bwd", x.data_ptr(), weight.data_ptr(), dyln.data_ptr(),
            _ptr(dy), dx.data_ptr(), dgp.data_ptr(), dbp.data_ptr(), m, d,
            _DTYPES[x.dtype], _DTYPES[weight.dtype], int(sub_dy), eps)
    if partials:
        return dx, dgp, dbp
    return dx, dgp.sum(0), dbp.sum(0)


def _gemm_operands(a, w):
    m, k = a.shape
    n = w.shape[0]
    check("a", a, a)
    check("weight", w, a, (n, k))
    if a.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"bf16 gemm needs K and N multiples of 8, got "
                         f"K={k}, N={n}")
    return m, n, k


def gemm(a: torch.Tensor, w: torch.Tensor, bias=None, residual=None,
         gelu: bool = False, out_dtype=None) -> torch.Tensor:
    """a (M, K) · w (N, K)ᵀ (+ bias) [GELU] (+ residual) -> (M, N), in a's
    dtype or, with out_dtype=torch.float32, in float (no residual then)."""
    m, n, k = _gemm_operands(a, w)
    out_f32 = out_dtype == torch.float32
    if out_dtype not in (None, a.dtype, torch.float32):
        raise ValueError(f"gemm out_dtype {out_dtype} unsupported")
    if out_f32 and residual is not None:
        raise ValueError("gemm: a float32 output takes no residual")
    if bias is not None:
        check("bias", bias, a, (n,), dtype=False)
    if residual is not None:
        check("residual", residual, a, (m, n))
    c = torch.empty((m, n), device=a.device,
                    dtype=torch.float32 if out_f32 else a.dtype)
    _launch("gemm", a.data_ptr(), w.data_ptr(), c.data_ptr(), _ptr(bias),
            _DTYPES[bias.dtype] if bias is not None else 0, _ptr(residual),
            m, n, k, _EPI["gelu" if gelu else "none"], _DTYPES[a.dtype],
            int(out_f32), None, None, None)
    return c


def gemm_gelu_bwd(a: torch.Tensor, w: torch.Tensor, h: torch.Tensor):
    """The MLP backward's dact GEMM with the GELU backward as its epilogue:
    acc = a (M, K) · w (N, K)ᵀ, h (M, N) float the fc1 output. Returns
    dh = T(acc·GELU′(h)), act = T(GELU(h)) and db1, the float column sums of
    the unrounded dh (from the kernel's 16-row partials)."""
    m, n, k = _gemm_operands(a, w)
    if h.dtype != torch.float32:
        raise ValueError(f"h: dtype {h.dtype}, expected torch.float32")
    check("h", h, h, (m, n))
    if h.device != a.device:
        raise ValueError(f"h: on {h.device}, expected {a.device}")
    dh = torch.empty((m, n), device=a.device, dtype=a.dtype)
    act = torch.empty_like(dh)
    colsum = torch.zeros((-(-m // 16), n), device=a.device,
                         dtype=torch.float32)
    _launch("gemm", a.data_ptr(), w.data_ptr(), dh.data_ptr(), None, 0, None,
            m, n, k, _EPI["gelu_bwd"], _DTYPES[a.dtype], 0, h.data_ptr(),
            act.data_ptr(), colsum.data_ptr())
    return dh, act, colsum.sum(0)


def gemm_gelu_stash(a: torch.Tensor, w: torch.Tensor, bias=None):
    """fc1 of the stash forward: acc = a (M, K) · w (N, K)ᵀ + bias in float;
    returns act = T(GELU(acc)) and dg = T(GELU′(acc)), both (M, N)."""
    m, n, k = _gemm_operands(a, w)
    if bias is not None:
        check("bias", bias, a, (n,), dtype=False)
    act = torch.empty((m, n), device=a.device, dtype=a.dtype)
    dg = torch.empty_like(act)
    _launch("gemm", a.data_ptr(), w.data_ptr(), act.data_ptr(), _ptr(bias),
            _DTYPES[bias.dtype] if bias is not None else 0, None, m, n, k,
            _EPI["gelu_stash"], _DTYPES[a.dtype], 0, None, dg.data_ptr(), None)
    return act, dg


def gemm_dgelu_mul(a: torch.Tensor, w: torch.Tensor, dg: torch.Tensor):
    """The stash backward's dact product with GELU′ from the stash: acc = a
    (M, K) · w (N, K)ᵀ, dg (M, N) in a's dtype. Returns dh = T(acc·dg) and
    the float 16-row column partials (ceil(M/16), N) of the unrounded dh."""
    m, n, k = _gemm_operands(a, w)
    check("dg", dg, a, (m, n))
    dh = torch.empty((m, n), device=a.device, dtype=a.dtype)
    colsum = torch.zeros((-(-m // 16), n), device=a.device, dtype=torch.float32)
    _launch("gemm", a.data_ptr(), w.data_ptr(), dh.data_ptr(), None, 0, None,
            m, n, k, _EPI["dgelu_mul"], _DTYPES[a.dtype], 0, dg.data_ptr(),
            None, colsum.data_ptr())
    return dh, colsum


def _row_chunks(m: int, tiles: int, device, min_rows: int):
    """(chunks, rows per chunk) for a reduction over m rows: about two
    blocks per SM over ``tiles`` output tiles, at least ``min_rows`` rows a
    chunk, rows a multiple of 32. A function of the shapes and the card
    only, so a rerun sums in the same order."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, min(-(-2 * sms // tiles), -(-m // min_rows)))
    per_chunk = -(-m // chunks)
    rows = -(-per_chunk // 32) * 32
    return -(-m // rows), rows


def weight_grad(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """gᵀ·a over the rows of g (M, N1) and a (M, N2): a float (N1, N2)
    weight gradient in torch Linear layout, summed by the wgrad kernel in
    fixed row chunks and a fixed chunk order (no atomics)."""
    m, n1 = g.shape
    n2 = a.shape[1]
    check("g", g, g)
    check("a", a, g, (m, n2))
    if g.dtype == torch.bfloat16 and (n1 % 8 or n2 % 8):
        raise ValueError(f"bf16 weight_grad needs widths multiples of 8, got "
                         f"{n1}, {n2}")
    out = torch.empty((n1, n2), device=g.device, dtype=torch.float32)
    chunks, rows = _row_chunks(m, -(-n1 // 128) * -(-n2 // 128), g.device,
                               512)
    part = (torch.empty((chunks, n1, n2), device=g.device,
                        dtype=torch.float32) if chunks > 1 else None)
    _launch("wgrad", g.data_ptr(), a.data_ptr(), out.data_ptr(), _ptr(part),
            m, n1, n2, chunks, rows, _DTYPES[g.dtype])
    return out


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Float column sums of x (M, N), in fixed row chunks summed in order."""
    m, n = x.shape
    check("x", x, x)
    out = torch.empty((n,), device=x.device, dtype=torch.float32)
    chunks, rows = _row_chunks(m, -(-n // 256), x.device, 256)
    part = (torch.empty((chunks, n), device=x.device, dtype=torch.float32)
            if chunks > 1 else None)
    _launch("colsum", x.data_ptr(), out.data_ptr(), _ptr(part), m, n, chunks,
            rows, _DTYPES[x.dtype])
    return out


def wgrad(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """gᵀ·a over the rows of two (M, ·) matrices, in float: a weight
    gradient in torch Linear layout (out, in). 16-bit operands multiply
    exactly and sum in float (cuBLAS with a float output), as JAX's
    preferred_element_type=float32 contractions do; never rounded."""
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
    _launch("attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, nq, nk, heads, dh, *strides, scale,
            _DTYPES[q.dtype])


def attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, *, heads: int,
                  dh: int, scale: float):
    """Backward of :func:`attention` on a packed (B, N, 3D) qkv with
    cotangent dout (B, N, D): dqkv (B, N, 3D) in qkv's dtype and the float
    column sums of the unrounded dqkv over all rows (for the qkv bias)."""
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
    part = torch.zeros((b * -(-n // 16), 3 * d), device=qkv.device,
                       dtype=torch.float32)
    _launch("attention_bwd", qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), part.data_ptr(), b, n,
            heads, dh, scale, _DTYPES[qkv.dtype])
    return dqkv, part.sum(0)


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
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
    _launch("flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ptr, b, nq, nk, heads, dh, scale,
            _DTYPES[q.dtype])
