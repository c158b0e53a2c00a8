"""Ray-marching sample placement: stratified + inverse-CDF importance.

Reference conventions:
  * linear z placement between near/far (models/lushnerf.py:389-394), with
    optional lindisp (inverse-depth) spacing.
  * stratified perturbation jitters within mid-point intervals
    (models/lushnerf.py:398-412).
  * sample_pdf (utils/run_lushnerf_helpers.py:566-609): weights+1e-5 ->
    pdf -> cdf (prepended 0) -> searchsorted(right) -> linear interp between
    bin edges, with denominators < 1e-5 snapped to 1.

All functions take their uniforms explicitly, so runs are reproducible and
can be fed the same numbers as the JAX package.
"""

from __future__ import annotations

import torch


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """[0, 1] in n steps as iota * (1/(n-1)), the same f32 values as
    jnp.linspace (torch.linspace rounds some entries differently)."""
    return torch.arange(n, dtype=dtype, device=device) * (1.0 / (n - 1))


def linear_z_vals(near, far, n_samples: int, lindisp: bool = False):
    """near, far: [...] tensors.  Returns [..., n_samples]."""
    t = _linspace01(n_samples, near.dtype, near.device)
    near = near[..., None]
    far = far[..., None]
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def stratify_z_vals(z_vals, t_rand):
    """Jitter z values uniformly within their midpoint intervals."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins, weights, u):
    """Inverse-CDF sampling of `u` against a piecewise-constant pdf.

    bins: [..., M] bin edges; weights: [..., M-1]; u: [..., N] in [0, 1].
    Returns samples [..., N].
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., M]
    M = cdf.shape[-1]

    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=nb))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def det_u(batch_shape, n_samples: int, dtype=torch.float32, device=None):
    """Deterministic uniforms (linspace), reference eval mode (det=True)."""
    u = _linspace01(n_samples, dtype, device)
    return u.expand(*batch_shape, n_samples)


def merge_z_vals(z_coarse, z_importance):
    """Sorted union of coarse and importance samples (models/lushnerf.py:440)."""
    v = torch.cat([z_coarse, z_importance], dim=-1)
    return torch.sort(v, dim=-1, stable=True).values
