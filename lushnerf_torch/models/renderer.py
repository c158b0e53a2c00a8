"""Volumetric rendering engine.

Reference behavior (models/lushnerf.py):
  * render_rays (:354-583): linear z placement in [near, far] (or inverse
    depth), optional stratified perturb, coarse MLP, raw2outputs
    compositing, inverse-CDF importance sampling of weights[..., 1:-1] over
    z midpoints, sorted merge, fine MLP, composite.
  * render_rays_noise (:585-617): SND noise head -- the noise MLP at the
    single unperturbed sample `noise_sample_idx` (=16) of each ray, with
    detached inputs, returning raw per-ray RGB noise.
  * ray preparation (render_infer :679-763): viewdirs = normalized pre-NDC
    direction; NDC projection for forward-facing scenes; near/far columns.

`mlp_backend` picks how the scene MLPs are evaluated: 'torch' runs the
`NeRFMLP` modules in f32; 'cuda' sends the MLP family of
`fused.supports` (the JAX package's) to the fused path
(ops/fused/nerf_mlp.py), which on the card launches the kernels or raises
(forward, and under autograd the backward of `mlp_bwd`), and the rest (the
D=4, W=128 noise MLP) to the torch path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.compositing import raw2outputs
from lushnerf_torch.ops.encoding import PositionalEncoding
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.ops.rays import ndc_rays
from lushnerf_torch.ops.sampling import (
    det_u,
    linear_z_vals,
    merge_z_vals,
    sample_pdf,
    stratify_z_vals,
)
from lushnerf_torch.utils.trace import span

ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "none": lambda x: x,
    "sigmoid1": lambda x: 1.002 / (torch.exp(-x) + 1.0) - 0.001,
    "softplus": lambda x: F.softplus(x - 1.0),
}

MLP_BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration."""

    n_samples: int = 64
    n_importance: int = 64
    use_viewdirs: bool = True
    ndc: bool = True
    lindisp: bool = False
    perturb: bool = True  # train-time stratified jitter
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    rm_nearplane: float = 0.0  # applied at inference only (caller gates)
    rgb_activate: str = "sigmoid"
    sigma_activate: str = "relu"
    multires: int = 10
    multires_views: int = 4
    noise_sample_idx: int = 16
    # points a chunk of the scene MLP's evaluation (0: all at once): the
    # plain path runs chunks under a checkpoint, the fused path's backward
    # sizes its scratch by it (eval_points)
    point_chunk: int = 0
    mlp_backend: str = "torch"  # 'torch' | 'cuda'
    # matmul input precision inside the fused kernel ('float32' |
    # 'bfloat16'); accumulation is always f32.  The 'torch' backend is f32.
    mlp_compute_dtype: str = "float32"
    # the fused path's backward: 'remat' recomputes the activations, 'stash'
    # reads those the forward stored (more memory, less compute)
    mlp_bwd: str = "remat"

    def __post_init__(self):
        if self.mlp_backend not in MLP_BACKENDS:
            raise ValueError(f"mlp_backend {self.mlp_backend!r} not in {MLP_BACKENDS}")
        if self.mlp_compute_dtype not in fused.COMPUTE_DTYPES:
            raise ValueError(f"mlp_compute_dtype {self.mlp_compute_dtype!r} not in "
                             f"{fused.COMPUTE_DTYPES}")
        if self.mlp_bwd not in fused.BWD_MODES:
            raise ValueError(f"mlp_bwd {self.mlp_bwd!r} not in {fused.BWD_MODES}")

    @property
    def pe_x(self) -> PositionalEncoding:
        return PositionalEncoding(num_freqs=self.multires, input_dims=3)

    @property
    def pe_d(self) -> PositionalEncoding:
        return PositionalEncoding(num_freqs=self.multires_views, input_dims=3)

    @property
    def input_ch(self) -> int:
        return self.pe_x.out_dim

    @property
    def input_ch_views(self) -> int:
        return self.pe_d.out_dim if self.use_viewdirs else 0


def prepare_rays(cfg: RenderConfig, H: int, W: int, focal, rays_o, rays_d, near, far):
    """Viewdirs + optional NDC projection + per-ray near/far.

    rays_o, rays_d: [R, 3].  Returns dict of [R, ...] tensors.
    """
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if cfg.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    near_c = torch.full_like(rays_d[..., :1], near)
    far_c = torch.full_like(rays_d[..., :1], far)
    return dict(rays_o=rays_o, rays_d=rays_d, viewdirs=viewdirs, near=near_c, far=far_c)


def eval_points(
    mlp: NeRFMLP,
    mlp_cfg: MLPConfig,
    cfg: RenderConfig,
    pts: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
) -> torch.Tensor:
    """The scene MLP at pts [R, S, 3] with per-ray viewdirs [R, 3].

    With cfg.point_chunk > 0 and more points than that, the plain path
    pads the flattened points with zeros to whole chunks and runs each
    chunk on its own, under `torch.utils.checkpoint` where a gradient is
    needed (its activations are recomputed in the backward), as the JAX
    package's `eval_points` maps its chunks under `jax.checkpoint`; the
    fused path's backward sizes its scratch by it.  Returns raw [R, S,
    out_ch].
    """
    if cfg.mlp_backend != "cuda":
        return _eval_points_plain(mlp, cfg, pts, viewdirs)
    if fused.supports(mlp_cfg, cfg) and fused.kernel_covers(mlp_cfg, cfg):
        with span("mlp.fwd"):
            return fused.eval_points_fused(mlp, mlp_cfg, cfg, pts, viewdirs)
    with span("mlp.plain"):  # an MLP the kernels do not cover
        return _eval_points_plain(mlp, cfg, pts, viewdirs)


def _eval_points_plain(mlp: NeRFMLP, cfg: RenderConfig, pts: torch.Tensor,
                       viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """`eval_points` in plain torch."""
    R, S = pts.shape[0], pts.shape[1]
    P = R * S
    x = pts.reshape(P, 3)
    d = None if viewdirs is None else viewdirs[:, None, :].expand(R, S, 3).reshape(P, 3)

    def apply_flat(x_f, d_f):
        return mlp(cfg.pe_x(x_f), None if d_f is None else cfg.pe_d(d_f))

    chunk = cfg.point_chunk
    if not chunk or P <= chunk:
        return apply_flat(x, d).reshape(R, S, -1)
    pad = -P % chunk
    x = F.pad(x, (0, 0, 0, pad))
    d = None if d is None else F.pad(d, (0, 0, 0, pad))
    grad = torch.is_grad_enabled()
    raws = []
    for p0 in range(0, P + pad, chunk):
        x_c = x[p0:p0 + chunk]
        d_c = None if d is None else d[p0:p0 + chunk]
        raws.append(torch.utils.checkpoint.checkpoint(apply_flat, x_c, d_c, use_reentrant=False)
                    if grad else apply_flat(x_c, d_c))
    return torch.cat(raws)[:P].reshape(R, S, -1)


def render_rays_scene(
    coarse: NeRFMLP,
    fine: Optional[NeRFMLP],
    mlp_cfg: MLPConfig,
    cfg: RenderConfig,
    prepared: Dict[str, torch.Tensor],
    *,
    t_rand: Optional[torch.Tensor] = None,
    u_importance: Optional[torch.Tensor] = None,
    density_noise_coarse: Optional[torch.Tensor] = None,
    density_noise_fine: Optional[torch.Tensor] = None,
    inference: bool = False,
) -> Dict[str, torch.Tensor]:
    """Hierarchical scene render of a prepared ray batch (no noise head).

    Randomness is passed explicitly: t_rand [R, S] stratified uniforms
    (None = unperturbed), u_importance [R, S_imp] (None = deterministic
    linspace, reference det mode), density noise arrays (None = off).
    """
    rays_o, rays_d = prepared["rays_o"], prepared["rays_d"]
    viewdirs = prepared["viewdirs"]
    near, far = prepared["near"][..., 0], prepared["far"][..., 0]
    R = rays_o.shape[0]

    rgb_act = ACTIVATIONS[cfg.rgb_activate]
    sigma_act = ACTIVATIONS[cfg.sigma_activate]
    rm = cfg.rm_nearplane if inference else 0.0

    z_vals = linear_z_vals(near, far, cfg.n_samples, cfg.lindisp)
    if t_rand is not None:
        z_vals = stratify_z_vals(z_vals, t_rand)

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = eval_points(coarse, mlp_cfg, cfg, pts, viewdirs)
    comp = raw2outputs(
        raw, z_vals, rays_d, rgb_act, sigma_act, density_noise_coarse, rm, cfg.white_bkgd
    )

    out = {
        "rgb": comp.rgb,
        "depth": comp.depth,
        "acc": comp.acc,
        "density": comp.density,
        "weights": comp.weights,
        "z_vals": z_vals,
    }
    if cfg.n_importance <= 0:
        return out

    out.update(rgb0=comp.rgb, depth0=comp.depth, acc0=comp.acc, density0=comp.density)

    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if u_importance is None:
        u_importance = det_u((R,), cfg.n_importance, z_vals.dtype, z_vals.device)
    z_samples = sample_pdf(
        z_mid.detach(), comp.weights[..., 1:-1].detach(), u_importance
    ).detach()
    z_all = merge_z_vals(z_vals, z_samples)

    pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    mlp_f = fine if fine is not None else coarse
    raw_f = eval_points(mlp_f, mlp_cfg, cfg, pts_f, viewdirs)
    comp_f = raw2outputs(
        raw_f, z_all, rays_d, rgb_act, sigma_act, density_noise_fine, rm, cfg.white_bkgd
    )

    out.update(
        rgb=comp_f.rgb,
        depth=comp_f.depth,
        acc=comp_f.acc,
        density=comp_f.density,
        weights=comp_f.weights,
        z_vals=z_all,
        z_std=torch.std(z_samples, dim=-1, correction=0),
    )
    return out


def render_rays_noise(
    noise: NeRFMLP,
    noise_cfg: MLPConfig,
    cfg: RenderConfig,
    prepared: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """SND noise head: raw per-ray RGB noise [R, 3] (caller applies
    0.1*sigmoid), at linear-z sample `noise_sample_idx` with detached
    point and direction inputs (models/lushnerf.py:585-617)."""
    rays_o, rays_d = prepared["rays_o"], prepared["rays_d"]
    viewdirs = prepared["viewdirs"]
    near, far = prepared["near"][..., 0], prepared["far"][..., 0]

    z_vals = linear_z_vals(near, far, cfg.n_samples, cfg.lindisp)
    z = z_vals[..., cfg.noise_sample_idx]
    pt = (rays_o + rays_d * z[..., None]).detach()  # [R, 3]
    d_pe = cfg.pe_d(viewdirs.detach()) if viewdirs is not None else None
    return noise(cfg.pe_x(pt), d_pe)
