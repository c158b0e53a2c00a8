"""NeRF positional encoding.

Matches the reference embedder (utils/run_lushnerf_helpers.py:311-361):
output = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]
i.e. the identity first, then for each frequency band (2^0..2^(L-1), exact
powers of two) a sin block followed by a cos block, each of the input
dimensionality.  multires=10 on xyz gives 3 + 3*2*10 = 63 channels;
multires=4 on directions gives 27.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PositionalEncoding:
    num_freqs: int
    input_dims: int = 3

    @property
    def out_dim(self) -> int:
        return self.input_dims + 2 * self.num_freqs * self.input_dims

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return posenc(x, self.num_freqs)


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """x [..., d] -> [..., d + 2 * num_freqs * d] (identity, then per-band
    [sin_f, cos_f] blocks)."""
    if num_freqs == 0:
        return x
    freqs = torch.exp2(torch.arange(num_freqs, dtype=x.dtype, device=x.device))
    xb = x[..., None, :] * freqs[:, None]  # [..., L, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., L, 2, d]
    sc = sc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def posenc_backward(x: torch.Tensor, g: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """The gradient w.r.t. x [..., d] of <posenc(x, num_freqs), g>, written
    out: d sin(f x) = f cos(f x) dx and d cos(f x) = -f sin(f x) dx."""
    d = x.shape[-1]
    if num_freqs == 0:
        return g
    freqs = torch.exp2(torch.arange(num_freqs, dtype=x.dtype, device=x.device))
    xb = x[..., None, :] * freqs[:, None]  # [..., L, d]
    sc = g[..., d:].reshape(*x.shape[:-1], num_freqs, 2, d)
    trig = sc[..., 0, :] * torch.cos(xb) - sc[..., 1, :] * torch.sin(xb)
    return g[..., :d] + torch.sum(trig * freqs[:, None], dim=-2)
