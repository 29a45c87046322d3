"""The int8 MLP half (B12): out = x + MLP_int8(LN(x)).

Replaces ``mirage_tpu/ops/quant.py:_mlp_block_q_fwd`` / ``_mlp_q_kernel``.
Weights are quantised once (``quantize_weight``: symmetric int8 per output
channel, in the port's (out, in) layout); activations per row at run time.
The math is ``_mlp_q_math`` (:72-92) op for op, because a rounding
difference moves a value by a whole int8 step: LN with the one-pass
variance E[x²] − mean² clamped at 0 (unlike the port's other LayerNorms,
which take two passes: ROADMAP queue C, fault 2), the row scale abs-max /
127 (zero -> 1), round half to even, clip to ±127, true division by every
scale, the s32 product dequantised as acc·rs·s + b, and GELU with the
Abramowitz-Stegun erf (``mirage_tpu/ops/fused_mlp.py:43``), which the JAX
XLA version uses too.

On the card it is a chain of hand-written kernels (``csrc/quant.cu``): LN +
row quantisation, the fc1 int8 GEMM (wgmma s8·s8 -> s32, the int8
instantiation of ``csrc/gemm_pingpong.cuh``) with the
dequantisation, b1, GELU and the rows' abs-max in its epilogue, the
hidden's quantisation, and the fc2 int8 GEMM with the dequantisation, b2
and the residual. Bound: operations (2·M·D·H·2 int8 operations). Forward
only, as the JAX op (:155-161). The JAX package dispatches nothing to it;
the port keeps it as an op with its own checks.

``gemm_s8`` (an A/B case of the port's bench, scripts/bench_int8.py) is the
bare s8·s8 -> s32 product on the same GEMM kernel, its s32 accumulator
stored as it is.
"""

import torch

from mirage_tpu_torch.ops import runtime

_SQRT2 = 1.4142135623730951
_LOG2E = 1.4426950408889634
_LN_EPS = 1e-6


def quantize_weight(w):
    """Symmetric per-output-channel int8 of a torch Linear weight (out, in):
    (wq int8 (out, in), scale float32 (out,)); the abs-max runs over the
    input axis (``quantize_weight`` of the JAX package on wᵀ)."""
    w32 = w.float()
    s = w32.abs().amax(dim=-1) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    wq = torch.clamp(torch.round(w32 / s[..., None]), -127, 127)
    return wq.to(torch.int8), s


def quantize_mlp_params(fc1_w, fc1_b, fc2_w, fc2_b):
    """(w1q, s1, b1, w2q, s2, b2): int8 weights, float32 scales and
    biases, the trailing arguments of :func:`mlp_block_q`."""
    w1q, s1 = quantize_weight(fc1_w)
    w2q, s2 = quantize_weight(fc2_w)
    return w1q, s1, fc1_b.float(), w2q, s2, fc2_b.float()


def _erf_as(x):
    """mirage_tpu/ops/fused_mlp.py:_erf, op for op."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp2(-(ax * ax) * _LOG2E))


def _quant_rows(y):
    """Dynamic symmetric per-row int8: (q int8, row scale (rows, 1))."""
    rs = y.abs().amax(dim=-1, keepdim=True) / 127.0
    rs = torch.where(rs == 0.0, torch.ones_like(rs), rs)
    return torch.clamp(torch.round(y / rs), -127, 127).to(torch.int8), rs


def _int_product(q, wq):
    """q (M, K) int8 · wq (N, K) int8ᵀ, exact: the int32 sum in float64
    (|sum| ≤ K·127² < 2⁵³), rounded to float32 as the s32 -> f32 cast."""
    return (q.double() @ wq.double().t()).float()


def mlp_block_q_parts(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2):
    """Plain PyTorch version, step by step as ``_mlp_q_math``: (out, yq,
    rs, aq, as) with the int8 codes of the LN output and of the hidden and
    their row scales (rows flattened)."""
    x2 = x.reshape(-1, x.shape[-1])
    x32 = x2.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp_min(x32.square().mean(-1, keepdim=True)
                          - mean.square(), 0.0)
    y = (x32 - mean) * torch.rsqrt(var + _LN_EPS)
    y = y * ln_w.float() + ln_b.float()
    yq, rs = _quant_rows(y)
    h = _int_product(yq, w1q) * rs * s1 + b1
    h = 0.5 * h * (1.0 + _erf_as(h / _SQRT2))
    aq, as_ = _quant_rows(h)
    o = _int_product(aq, w2q) * as_ * s2 + b2
    out = (x2 + o.to(x.dtype)).reshape(x.shape)
    return out, yq, rs[:, 0], aq, as_[:, 0]


def mlp_block_q_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2):
    """Plain PyTorch version (``mlp_block_q_xla``)."""
    return mlp_block_q_parts(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2)[0]


def mlp_block_q_kernel_parts(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2):
    """(out, yq, rs, aq, as) through the four kernels on a CUDA tensor,
    through the plain version on a CPU tensor."""
    if not runtime.use_kernel(x):
        return mlp_block_q_parts(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2)
    runtime.check("x", x, x)
    x2 = x.view(-1, x.shape[-1])
    yq, rs = runtime.ln_quant(x2, ln_w, ln_b)
    h, amax = runtime.gemm_s8_fc1(yq, w1q, rs, s1, b1)
    aq, as_ = runtime.quant_rows(h, amax)
    out = runtime.gemm_s8_fc2(aq, w2q, as_, s2, b2, x2)
    runtime.count(mlp_block_q)
    return out.view(x.shape), yq, rs, aq, as_


def mlp_block_q(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2):
    """x (M, D) or (B, N, D) + MLP_int8(LN(x)) in x's dtype; w1q (H, D) and
    w2q (D, H) int8 with float32 scales s1 (H,), s2 (D,) and float32 biases
    (``quantize_mlp_params``). Forward only: it raises under autograd."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("mlp_block_q is forward only (serving); do not "
                           "differentiate through it")
    return mlp_block_q_kernel_parts(x, ln_w, ln_b, w1q, s1, b1, w2q, s2,
                                    b2)[0]


mlp_block_q.launches = 0


# ----------------------------------------------- the bench's int8 GEMM (S3)

def gemm_s8_ref(a, w):
    """Plain version of :func:`gemm_s8`: ``a.to(int32) @ w.to(int32).t()``.
    PyTorch has no integer product on CUDA, so on a CUDA tensor (the card's
    reference) the sum is taken in float64, exact for |sum| ≤ K·127² < 2⁵³,
    and cast to int32."""
    if a.is_cuda:
        return (a.double() @ w.double().t()).to(torch.int32)
    return a.to(torch.int32) @ w.to(torch.int32).t()


def gemm_s8(a, w):
    """a (M, K) int8 · w (N, K) int8ᵀ -> (M, N) int32, exact. Replaces
    scripts/bench_int8.py:probe_pallas_int8's kernel (an s8·s8 -> s32 dot
    with resident weights). On the card it is B12's wgmma int8 GEMM
    (csrc/quant.cu on csrc/gemm_pingpong.cuh) with a third epilogue that stores the raw s32
    accumulator. K a multiple of 16 and N of 8."""
    if not runtime.use_kernel(a):
        return gemm_s8_ref(a, w)
    out = runtime.gemm_s8_s32(a, w)
    runtime.count(gemm_s8)
    return out


gemm_s8.launches = 0
