"""LuSh-NeRF's step and render in plain PyTorch: the yardstick that decides
`correct`.

A frozen, independent transcription of the published model (quzefan/
LuSh-NeRF, NeurIPS 2024: `run_lushnerf.py`, `models/lushnerf.py`,
`utils/run_lushnerf_helpers.py`, `utils/rigid_warping.py`) with the
framework additions the shipped configurations turn on (the RBK's centred
bundle, its dz guard, the drift anchor, the tone map's floor).  It imports
nothing of the program: the parameters come as a dict of tensors under the
program's state-dict names, which are the reference's module names.

`lin` is the matrix product of the scene MLPs and `lin_other` that of the
SND and RBK MLPs (`precision.linear_fn`): float32 for the reference, the
lower precision for the control.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]
NOISE_SCALE = 0.1  # rgb_noise = 0.1 * sigmoid(raw)
NOISE_SAMPLE = 16  # the SND head's sample on each ray
GUARD_DZ_EPS = 1e-3
HALF_PIX = 0.5


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    parts = [x]
    for k in range(num_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def mlp(p: Params, prefix: str, x_pe, d_pe, depth: int, lin: Callable, rgb_only=False,
        skips=(4,)):
    """The NeRF MLP: depth relu layers with the input concatenated after
    layer 4, alpha and feature heads, a views layer on [feature, d_pe], rgb
    head.  Returns [..., 4] = [rgb_raw, alpha_raw] ([..., 3] rgb_only)."""
    def layer(name, h):
        return lin(h, p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"])

    h = x_pe
    for i in range(depth):
        h = torch.relu(layer(f"pts_linears.{i}", h))
        if i in skips:
            h = torch.cat([x_pe, h], dim=-1)
    alpha = layer("alpha_linear", h)
    feature = layer("feature_linear", h)
    h = torch.relu(layer("views_linears.0", torch.cat([feature, d_pe], dim=-1)))
    rgb = layer("rgb_linear", h)
    return rgb if rgb_only else torch.cat([rgb, alpha], dim=-1)


def pixel_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor, ii, jj):
    """(rays_o, rays_d) [n, 3] through pixels (column ii, row jj)."""
    dirs = torch.stack([(ii + (HALF_PIX - K[0, 2])) / K[0, 0],
                        -(jj + (HALF_PIX - K[1, 2])) / K[1, 1],
                        -torch.ones_like(ii)], dim=-1)
    R = c2w[..., :3, :3]  # one pose [3, 4], or one a pixel [n, 3, 4]
    rays_d = (dirs[:, 0:1] * R[..., :, 0] + dirs[:, 1:2] * R[..., :, 1]
              + dirs[:, 2:3] * R[..., :, 2])
    return c2w[..., :3, 3].expand(rays_d.shape), rays_d


def ndc(H: int, W: int, focal: float, o, d, near: float = 1.0):
    """The NeRF NDC projection of forward-facing rays."""
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ax, ay = -1.0 / (W / (2.0 * focal)), -1.0 / (H / (2.0 * focal))
    o_n = torch.stack([ax * o[..., 0] / o[..., 2], ay * o[..., 1] / o[..., 2],
                       1.0 + 2.0 * near / o[..., 2]], dim=-1)
    d_n = torch.stack([ax * (d[..., 0] / d[..., 2] - o[..., 0] / o[..., 2]),
                       ay * (d[..., 1] / d[..., 2] - o[..., 1] / o[..., 2]),
                       -2.0 * near / o[..., 2]], dim=-1)
    return o_n, d_n


def linspace01(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device) * (1.0 / (n - 1))


def composite(raw, z, d, noise=None, rm_nearplane: float = 0.0):
    """(rgb [R, 3], weights [R, S]) of raw [R, S, 4]: sigmoid colour over all
    samples, relu density over the first S - 1 intervals (|d|-scaled, no
    far pad), a last alpha of 1, weights alpha * cumprod(1 - alpha + 1e-10)."""
    dists = (z[:, 1:] - z[:, :-1]) * torch.linalg.norm(d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[:, :-1, 3]
    if noise is not None:
        sigma = sigma + noise
    density = torch.relu(sigma)
    if rm_nearplane > 0:
        density = density * (z[:, 1:] > rm_nearplane / 128.0).to(density.dtype)
    alpha = 1.0 - torch.exp(-density * dists)
    alpha = torch.cat([alpha, torch.ones_like(alpha[:, :1])], dim=-1)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                                    dim=-1), dim=-1)[:, :-1]
    w = alpha * trans
    return torch.sum(w[..., None] * rgb, dim=-2), w


def sample_pdf(bins, weights, u):
    """Inverse-CDF samples of a piecewise-constant pdf (weights + 1e-5)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    b0 = torch.gather(bins, -1, torch.clamp(below, max=nb))
    b1 = torch.gather(bins, -1, torch.clamp(above, max=nb))
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def scene(p: Params, cfg: dict, o, d, viewdirs, lin: Callable, draws: Optional[dict] = None,
          inference: bool = False):
    """(rgb, rgb0) [R, 3] before tone mapping: the coarse pass, importance
    samples, the fine pass.  `draws` (train): t_rand, u_importance,
    density_noise_coarse, density_noise_fine; inference: none, with
    near-plane removal."""
    S, SI = cfg["N_samples"], cfg["N_importance"]
    Lx, Ld, depth = cfg["multires"], cfg["multires_views"], cfg["netdepth"]
    rm = cfg["render_rmnearplane"] if inference else 0.0
    draws = draws or {}
    R = o.shape[0]
    t = linspace01(S, o)
    z = torch.zeros((R, 1), dtype=o.dtype, device=o.device) * (1.0 - t) + 1.0 * t
    if draws.get("t_rand") is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * draws["t_rand"]
    d_pe = posenc(viewdirs, Ld)

    def field(prefix, zz):
        pts = o[:, None, :] + d[:, None, :] * zz[..., None]
        n = zz.shape[1]
        raw = mlp(p, prefix, posenc(pts.reshape(-1, 3), Lx),
                  d_pe[:, None, :].expand(R, n, d_pe.shape[-1]).reshape(R * n, -1), depth, lin)
        return raw.reshape(R, n, 4)

    rgb0, w0 = composite(field("mlp_coarse", z), z, d, draws.get("density_noise_coarse"), rm)
    u = draws.get("u_importance")
    if u is None:
        u = linspace01(SI, o).expand(R, SI)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_imp = sample_pdf(z_mid.detach(), w0[:, 1:-1].detach(), u).detach()
    z_all = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1, stable=True).values
    rgb, _ = composite(field("mlp_fine", z_all), z_all, d, draws.get("density_noise_fine"), rm)
    return rgb, rgb0


def prepare(cfg: dict, H: int, W: int, focal: float, o, d):
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o_n, d_n = ndc(H, W, focal, o, d)
    return o_n, d_n, viewdirs


def tonemap(cfg: dict, x):
    if cfg["tone_mapping_type"] != "gamma":
        raise ValueError("the reference covers the gamma tone map only")
    eps = cfg["tonemap_eps"]
    if eps > 0.0:
        x = torch.maximum(x, torch.zeros_like(x)) + eps
    return x ** (1.0 / 2.2)


def snd(p: Params, cfg: dict, o_n, d_n, viewdirs, lin_other: Callable):
    """The SND noise head on the original rays: 0.1 * sigmoid of the noise
    MLP (depth / 2, width / 2, rgb only) at linear sample 16, inputs
    detached."""
    t = linspace01(cfg["N_samples"], o_n)[NOISE_SAMPLE]
    pt = (o_n + d_n * t).detach()
    raw = mlp(p, "mlp_noise_coarse", posenc(pt, cfg["multires"]),
              posenc(viewdirs.detach(), cfg["multires_views"]), cfg["netdepth"] // 2,
              lin_other, rgb_only=True)
    return NOISE_SCALE * torch.sigmoid(raw)


def se3_warp(pts, rot, trans):
    """Points warped by the SE(3) exponential of the screw (rot, trans)."""
    theta = torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-10
    w, v = rot / theta, trans / theta
    wxp = torch.linalg.cross(w, pts, dim=-1)
    wxv = torch.linalg.cross(w, v, dim=-1)
    rotated = pts + torch.sin(theta) * wxp + (1.0 - torch.cos(theta)) * torch.linalg.cross(
        w, wxp, dim=-1)
    return rotated + theta * v + (1.0 - torch.cos(theta)) * wxv + (
        theta - torch.sin(theta)) * torch.linalg.cross(w, wxv, dim=-1)


def rbk(p: Params, cfg: dict, rays, idx, lin_other: Callable):
    """(sub_rays [N, M+1, 3, 2], ccw [N, M+1]): the original ray and M
    SE(3)-warped ones with their composite weights."""
    def layer(name, h):
        return lin_other(h, p[f"mlp_rbk.{name}.weight"], p[f"mlp_rbk.{name}.bias"])

    def branch(name, depth, h):
        for i in range(depth):
            h = torch.relu(layer(f"{name}.{i}", h))
        return h

    M = cfg["rbk_num_motion"]
    e = p["dbk_view_embedding.view_embed_layer.weight"][idx.long()]
    h = e
    for i in range(cfg["rbk_enc_brc_depth"]):
        h = torch.relu(layer(f"view_embed_linears.{i}", h))
        if i == cfg["rbk_enc_brc_skips"]:
            h = torch.cat([e, h], dim=-1)
    r = layer("r_linear", branch("r_branch", cfg["rbk_se_r_depth"], h)) * cfg["rbk_se_rv_window"]
    v = layer("v_linear", branch("v_branch", cfg["rbk_se_v_depth"], h)) * cfg["rbk_se_rv_window"]
    w = torch.sigmoid(layer("w_linear", branch("w_branch", cfg["rbk_ccw_depth"], h)))
    ccw = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)
    r = r.reshape(-1, 3, M).transpose(1, 2)
    v = v.reshape(-1, 3, M).transpose(1, 2)
    o, d = rays[..., 0], rays[..., 1]
    wo = se3_warp(o[:, None].expand(r.shape), r, v)
    wd = se3_warp((o + d)[:, None].expand(r.shape), r, v) - wo
    orig = rays
    sub = torch.cat([orig[:, None], torch.stack([wo, wd], dim=-1)], dim=1)
    if cfg["rbk_center_bundle"]:
        mean = torch.sum(sub * ccw[..., None, None], dim=1)
        sub = sub - (mean - orig)[:, None]
    if cfg["rbk_guard_dz"]:
        ok = sub[..., 2, 1] < -GUARD_DZ_EPS
        sub = torch.where(ok[..., None, None], sub, orig[:, None])
    return sub, ccw


def kernel_loss(p: Params, cfg: dict, H: int, W: int, focal: float, rays, idx, fq, target,
                draws: dict, lin: Callable, lin_other: Callable, rows: Optional[int] = None):
    """The loss of a `kernel`-stage iteration: RBK sub-rays (their gradient
    gated by the frequency mask), the scene through each, SND on the
    original rays, the ccw-weighted composite, gamma, 0.5 (MSE + L1) of the
    fine and the coarse colour, plus rbk_anchor_reg x the bundle's drift.
    `rows` (a fault) takes the colour terms over the first rows only."""
    for key, want in (("rbk_spread_l1", 0.0), ("snd_l1", 0.0), ("use_snd", True)):
        if cfg[key] != want:
            raise ValueError(f"the reference covers {key} = {want} only")
    N = rays.shape[0]
    sub, ccw = rbk(p, cfg, rays, idx, lin_other)
    sub = torch.where(fq.bool().reshape(N, 1, 1, 1), sub, sub.detach())
    M1 = sub.shape[1]
    flat = sub.reshape(N * M1, 3, 2)
    o_n, d_n, vd = prepare(cfg, H, W, focal, flat[..., 0], flat[..., 1])
    rgb, rgb0 = scene(p, cfg, o_n, d_n, vd, lin, draws)
    o_r, d_r, vd_r = prepare(cfg, H, W, focal, rays[..., 0], rays[..., 1])
    noise = snd(p, cfg, o_r, d_r, vd_r, lin_other)
    rgb = torch.sum(rgb.reshape(N, M1, 3) * ccw[..., None], dim=1)
    rgb0 = torch.sum(rgb0.reshape(N, M1, 3) * ccw[..., None], dim=1)
    blur, blur0 = tonemap(cfg, rgb + noise)[:rows], tonemap(cfg, rgb0 + noise)[:rows]
    target = target[:rows]
    loss = 0.5 * (torch.mean((blur - target) ** 2) + torch.mean(torch.abs(blur - target))
                  + torch.mean((blur0 - target) ** 2) + torch.mean(torch.abs(blur0 - target)))
    if cfg["rbk_anchor_reg"] > 0.0:
        mean = torch.sum(sub * ccw[..., None, None], dim=1)
        do, dd = mean[..., 0] - rays[..., 0], mean[..., 1] - rays[..., 1]
        Z = cfg["rbk_anchor_depth"]
        drift = torch.mean(torch.sum(do ** 2, -1) + torch.sum((do + Z * dd) ** 2, -1))
        loss = loss + cfg["rbk_anchor_reg"] * drift
    return loss


def render_pixels(p: Params, cfg: dict, H: int, W: int, K, c2w, pix, lin: Callable,
                  chunk: int = 8192):
    """Tone-mapped rgb [n, 3] of the pixels `pix` (flat row-major indices)
    of the view at c2w, rendered for eval: no jitter, no density noise,
    deterministic importance samples, near-plane removal."""
    out = []
    with torch.no_grad():
        for part in pix.split(chunk):
            ii, jj = (part % W).float(), (part // W).float()
            o, d = pixel_rays(H, W, K, c2w, ii, jj)
            o_n, d_n, vd = prepare(cfg, H, W, float(K[0, 0]), o, d)
            rgb, _ = scene(p, cfg, o_n, d_n, vd, lin, inference=True)
            out.append(tonemap(cfg, rgb))
    return torch.cat(out)


def lower_precision(cfg: dict) -> dict:
    """The control's products: one step below the configuration's compute
    dtype (float32 -> TF32 everywhere, as allow_tf32 would; bfloat16 -> fp8
    in the scene MLPs, the products the configuration runs in bf16)."""
    return {"float32": {"lin": "tf32", "lin_other": "tf32"},
            "bfloat16": {"lin": "fp8", "lin_other": "f32"}}[cfg["mlp_compute_dtype"]]
