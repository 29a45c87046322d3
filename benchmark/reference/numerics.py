"""How the reference computes its products: float32, or fp8 for the control.

``Numerics("float32")`` is the reference: plain float32 matrix products,
with TF32 switched off by :func:`strict_float32`. ``Numerics("fp8")`` is
the control that the limits are proved against: each operand of every
product rounded to float8 e4m3 with one scale a tensor (its largest
magnitude mapped to 448) before a float32 product, and in the backward
each product's incoming gradient rounded the same way, as an fp8 training
step computes. Everything outside the products stays float32 in both.
"""

import torch

FP8_MAX = 448.0


def strict_float32():
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x):
    """x rounded to float8 e4m3 under one scale, back in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(grad)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast operands (a weight shared by a batch) sum their grads
        while db.ndim > qb.ndim:
            db = db.sum(0)
        while da.ndim > qa.ndim:
            da = da.sum(0)
        return da, db


class Numerics:
    """The products of one reference run: ``mm(a, b)`` is ``a @ b``."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.precision = precision

    def mm(self, a, b):
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)
