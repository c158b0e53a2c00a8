"""The reference's matrix products, in float32 with TF32 off, or in the
control's lower precision.

A control rounds both inputs of every product it covers (forward and, in a
gradient, the backward's products too) and accumulates in float32, as the
tensor cores do:
  * "tf32": 10 explicit mantissa bits, round to nearest even (the data
    sheet's TF32; what turning `allow_tf32` on would give a float32 run);
  * "fp8": e4m3 with one scale a tensor (amax to 448), as a per-tensor
    scaled fp8 product does.
The rounding is written out, so the control reads the same on the CPU and
on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.rnd = rnd
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rnd(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0), None


def linear_fn(mode: Optional[str]) -> Callable:
    """F.linear for float32 (mode None or "f32"), else the rounded product."""
    if mode in (None, "f32"):
        return F.linear
    rnd = ROUNDERS[mode]
    return lambda x, w, b: _RoundedLinear.apply(x, w, b, rnd)


@contextlib.contextmanager
def float32_products():
    """TF32 off for every float32 matmul and convolution inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
