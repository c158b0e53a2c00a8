"""The composed LuSh-NeRF model: hierarchical NeRF + SND noise head +
RBK deformable blur kernel + tone mapping.

Mirrors the mode dispatch of the reference NeRFAll.forward
(models/lushnerf.py:619-677) as separate functions:

  * forward_naive  -- warmup stage: the scene on the original rays, no blur
    kernel (:657-662).
  * forward_kernel -- main DSK stage: RBK sub-ray bundles rendered through
    the field, composited with learned weights, SND noise added before tone
    mapping (:636-654); optional frequency-mask gradient gating (:641-643).
  * render_image   -- eval path (:868-896): full-image render returning
    tonemapped rgb, tonemapped 0.1*sigmoid(noise) image, and depth.
  * render_warped_view -- each RBK sub-ray bundle of one training view
    rendered as its own image (the trainer's save_warped_ray_img).

`LushNeRF` holds the parameters under the reference's module names, so a
reference state dict loads with load_state_dict(strict=True).  Randomness
comes from an explicit torch.Generator, or from `rand_override`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.rbk import RBK, RBKConfig, ViewEmbedding, apply_rbk, rbk_weighted_sum
from lushnerf_torch.models.renderer import (
    RenderConfig,
    prepare_rays,
    render_rays_noise,
    render_rays_scene,
)
from lushnerf_torch.models.tonemap import LEARNED_TYPES, ToneMapping, apply_tonemap
from lushnerf_torch.ops.rays import get_rays

NOISE_SCALE = 0.1  # reference: rgb_noise = 0.1 * sigmoid(raw)


def resolve_device(device: str | torch.device) -> torch.device:
    """`device`, or an error when it names CUDA and there is no card: a CPU
    run is asked for by name (device="cpu"), never fallen back to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lushnerf_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class LushConfig:
    """Static model + rendering configuration for the full LuSh-NeRF stack.

    The framework additions (rbk_anchor_reg, rbk_spread_l1, tonemap_eps,
    snd_bias_init, snd_l1) keep the meaning they have in
    lushnerf_tpu/models/lushnerf.py; 0.0 reproduces the reference.
    """

    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    rbk: RBKConfig = dataclasses.field(default_factory=RBKConfig)
    blur_model_type: str = "dpnerf"  # 'dpnerf' | 'none'
    tone_mapping_type: str = "gamma"
    num_images: int = 1
    near: float = 0.0
    far: float = 1.0
    rbk_anchor_reg: float = 0.0
    rbk_anchor_depth: float = 8.0
    use_snd: bool = True
    rbk_spread_l1: float = 0.0
    tonemap_eps: float = 0.0
    snd_bias_init: float = 0.0
    snd_l1: float = 0.0

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(
            depth=self.netdepth,
            width=self.netwidth,
            input_ch=self.render.input_ch,
            input_ch_views=self.render.input_ch_views,
            use_viewdirs=self.render.use_viewdirs,
        )

    @property
    def mlp_cfg_fine(self) -> MLPConfig:
        return MLPConfig(
            depth=self.netdepth_fine,
            width=self.netwidth_fine,
            input_ch=self.render.input_ch,
            input_ch_views=self.render.input_ch_views,
            use_viewdirs=self.render.use_viewdirs,
        )

    @property
    def noise_cfg(self) -> MLPConfig:
        # NeRF_Noise is built at half depth/width (models/lushnerf.py:203-207).
        return MLPConfig(
            depth=self.netdepth // 2,
            width=self.netwidth // 2,
            input_ch=self.render.input_ch,
            input_ch_views=self.render.input_ch_views,
            use_viewdirs=self.render.use_viewdirs,
            rgb_only=True,
        )


class BlurKernelNet(nn.Module):
    """The reference's second handle on the RBK (`blur_kernel_net`): it
    shares the embedding and the RBK module, so its state-dict entries are
    aliases of `dbk_view_embedding.*` and `mlp_rbk.*`."""

    def __init__(self, view_embed_layer: ViewEmbedding, rbk: RBK):
        super().__init__()
        self.view_embed_layer = view_embed_layer
        self.RBK = rbk


class LushNeRF(nn.Module):
    """All parameters of the LuSh-NeRF stack, under the reference's names:
    mlp_coarse, mlp_fine, mlp_noise_coarse, dbk_view_embedding, mlp_rbk,
    blur_kernel_net and, for a learned tone map, tonemapping.  Initialised on the CPU from `seed` (so one seed gives
    the same weights on every device), then moved to `device`."""

    def __init__(self, cfg: LushConfig, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        cpu = torch.device("cpu")
        g = torch.Generator(device=cpu).manual_seed(seed)
        self.cfg = cfg
        self.mlp_coarse = NeRFMLP(cfg.mlp_cfg, g, cpu)
        self.mlp_noise_coarse = NeRFMLP(cfg.noise_cfg, g, cpu)
        if cfg.snd_bias_init != 0.0:
            with torch.no_grad():
                self.mlp_noise_coarse.rgb_linear.bias.fill_(cfg.snd_bias_init)
        if cfg.render.n_importance > 0:
            self.mlp_fine = NeRFMLP(cfg.mlp_cfg_fine, g, cpu)
        else:
            self.mlp_fine = None
        if cfg.blur_model_type == "dpnerf":
            rbk_cfg = dataclasses.replace(cfg.rbk, num_images=cfg.num_images)
            self.dbk_view_embedding = ViewEmbedding(cfg.num_images, rbk_cfg.embed_ch, g, cpu)
            self.mlp_rbk = RBK(rbk_cfg, self.dbk_view_embedding, g, cpu)
            self.blur_kernel_net = BlurKernelNet(self.dbk_view_embedding, self.mlp_rbk)
        self.tonemapping = (ToneMapping(cfg.tone_mapping_type, g, cpu)
                            if cfg.tone_mapping_type in LEARNED_TYPES else None)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.mlp_coarse.pts_linears[0].weight.device


# ---------------------------------------------------------------------------
# Randomness plumbing
# ---------------------------------------------------------------------------


def _train_randomness(generator: Optional[torch.Generator], cfg: LushConfig, n_rays: int,
                      device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """Sampled randomness for one scene render of n_rays rays (the keys of
    `rand_override`)."""
    rc = cfg.render
    S, SI = rc.n_samples, rc.n_importance
    need = rc.perturb or rc.raw_noise_std > 0
    if need and generator is None:
        raise ValueError("forward_kernel: pass a torch.Generator or rand_override")

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    t_rand = rand(n_rays, S) if rc.perturb else None
    u_imp = rand(n_rays, SI) if (rc.perturb and SI > 0) else None
    dn_c = dn_f = None
    if rc.raw_noise_std > 0:
        dn_c = randn(n_rays, S - 1) * rc.raw_noise_std
        if SI > 0:
            dn_f = randn(n_rays, S + SI - 1) * rc.raw_noise_std
    return dict(
        t_rand=t_rand,
        u_importance=u_imp,
        density_noise_coarse=dn_c,
        density_noise_fine=dn_f,
    )


# ---------------------------------------------------------------------------
# Training forwards
# ---------------------------------------------------------------------------


def forward_naive(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    focal,
    rays: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    rand_override: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Warmup / no-blur forward on the original rays (reference :657-662).

    rays: [N, 3, 2].  Returns tonemapped rgb/rgb0 and the (unused in the
    loss) noise prediction, as the reference's return tuple.  Randomness as
    forward_kernel.
    """
    prepared = prepare_rays(
        cfg.render, H, W, focal, rays[..., 0], rays[..., 1], cfg.near, cfg.far
    )
    if rand_override is not None:
        rnd = rand_override
    else:
        rnd = _train_randomness(generator, cfg, rays.shape[0], rays.device)
    out = render_rays_scene(
        model.mlp_coarse, model.mlp_fine, cfg.mlp_cfg, cfg.render, prepared, **rnd
    )
    raw_noise = render_rays_noise(model.mlp_noise_coarse, cfg.noise_cfg, cfg.render, prepared)

    def tmap(v):
        return apply_tonemap(cfg.tone_mapping_type, v, cfg.tonemap_eps, model.tonemapping)

    return {
        "rgb_blur": tmap(out["rgb"]),
        "rgb0_blur": tmap(out.get("rgb0", out["rgb"])),
        "rgb_noise": NOISE_SCALE * torch.sigmoid(raw_noise),
        "depth": out["depth"],
        "acc": out["acc"],
    }


def forward_kernel(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    focal,
    rays: torch.Tensor,
    image_idx: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    fq_mask: Optional[torch.Tensor] = None,
    rand_override: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Main DSK training forward (reference :636-654).

    rays: [N, 3, 2]; image_idx: [N] int; fq_mask: [N] bool or None.  When
    fq_mask is given, gradients to the blur kernel flow only through rays
    whose mask is True (torch.where detach gating, :641-643).  Randomness
    comes from `generator` (on the rays' device) unless `rand_override`
    gives it (keys as _train_randomness).
    """
    tm = cfg.tone_mapping_type
    N = rays.shape[0]
    M1 = cfg.rbk.num_rays_out

    sub_rays, ccw = apply_rbk(model.mlp_rbk, rays, image_idx)  # [N, M1, 3, 2]
    if fq_mask is not None:
        gate = fq_mask.bool().reshape(N, 1, 1, 1)
        sub_rays = torch.where(gate, sub_rays, sub_rays.detach())

    flat = sub_rays.reshape(N * M1, 3, 2)  # fold the bundle into the ray axis
    prepared = prepare_rays(
        cfg.render, H, W, focal, flat[..., 0], flat[..., 1], cfg.near, cfg.far
    )
    if rand_override is not None:
        rnd = rand_override
    else:
        rnd = _train_randomness(generator, cfg, N * M1, rays.device)
    out = render_rays_scene(
        model.mlp_coarse, model.mlp_fine, cfg.mlp_cfg, cfg.render, prepared, **rnd
    )

    # SND noise on the ORIGINAL rays (render_train_noise, :647)
    if cfg.use_snd:
        prep_orig = prepare_rays(
            cfg.render, H, W, focal, rays[..., 0], rays[..., 1], cfg.near, cfg.far
        )
        raw_noise = render_rays_noise(
            model.mlp_noise_coarse, cfg.noise_cfg, cfg.render, prep_orig
        )
        rgb_noise = NOISE_SCALE * torch.sigmoid(raw_noise)  # [N, 3]
    else:
        rgb_noise = torch.zeros((N, 3), dtype=rays.dtype, device=rays.device)

    rgb_pure = rbk_weighted_sum(out["rgb"].reshape(N, M1, 3), ccw)
    rgb0_pure = rbk_weighted_sum(out["rgb0"].reshape(N, M1, 3), ccw)
    depth = rbk_weighted_sum(out["depth"].reshape(N, M1), ccw)
    acc = rbk_weighted_sum(out["acc"].reshape(N, M1), ccw)

    # zero-mean-blur anchor: squared drift of the bundle's weighted-mean ray
    # from the original ray, at the origin and rbk_anchor_depth ray-lengths
    # out (see lushnerf_tpu LushConfig.rbk_anchor_reg)
    mean_sub = rbk_weighted_sum(sub_rays, ccw)  # [N, 3, 2]
    drift_o = mean_sub[..., 0] - rays[..., 0]
    drift_d = mean_sub[..., 1] - rays[..., 1]
    Z = cfg.rbk_anchor_depth
    rbk_drift = torch.mean(
        torch.sum(drift_o**2, dim=-1) + torch.sum((drift_o + Z * drift_d) ** 2, dim=-1)
    )

    # ccw-weighted L1 dispersion of the bundle around its mean at the
    # anchor depth (see LushConfig.rbk_spread_l1)
    dev = sub_rays - mean_sub[:, None]  # [N, M1, 3, 2]
    dev_pt = dev[..., 0] + Z * dev[..., 1]  # [N, M1, 3]
    rbk_spread = torch.mean(
        torch.sum(ccw * torch.sqrt(torch.sum(dev_pt**2, dim=-1) + 1e-12), dim=-1)
    )

    def tmap(v):
        return apply_tonemap(tm, v, cfg.tonemap_eps, model.tonemapping)

    return {
        "rbk_drift": rbk_drift,
        "rbk_spread": rbk_spread,
        "rgb_blur": tmap(rgb_pure + rgb_noise),
        "rgb0_blur": tmap(rgb0_pure + rgb_noise),
        "rgb_noise": rgb_noise,
        "rgb_pure": tmap(rgb_pure),
        "rgb0_pure": tmap(rgb0_pure),
        "depth": depth,
        "acc": acc,
        "ccw": ccw,
    }


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


@torch.no_grad()
def render_rays_chunked_eval(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    focal,
    rays: torch.Tensor,
    ray_chunk: int = 4096,
):
    """Eval-mode render of rays [R, 3, 2] in chunks of `ray_chunk` rays.

    No perturbation and no density noise; near-plane removal active
    (render_kwargs_test, run_lushnerf.py:406-410).  The rays are
    zero-padded to a whole number of chunks, as the JAX package does.
    Returns raw (pre-tonemap) rgb [R, 3], raw noise [R, 3], depth [R].
    """
    R = rays.shape[0]
    R_pad = -(-R // ray_chunk) * ray_chunk
    rays_p = torch.cat([rays, rays.new_zeros((R_pad - R, 3, 2))], dim=0)
    rgbs, noises, depths = [], [], []
    for chunk in rays_p.split(ray_chunk):
        prepared = prepare_rays(
            cfg.render, H, W, focal, chunk[..., 0], chunk[..., 1], cfg.near, cfg.far
        )
        out = render_rays_scene(
            model.mlp_coarse, model.mlp_fine, cfg.mlp_cfg, cfg.render, prepared,
            inference=True,
        )
        rgbs.append(out["rgb"])
        noises.append(render_rays_noise(model.mlp_noise_coarse, cfg.noise_cfg, cfg.render, prepared))
        depths.append(out["depth"])
    return torch.cat(rgbs)[:R], torch.cat(noises)[:R], torch.cat(depths)[:R]


@torch.no_grad()
def render_image(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    K,
    c2w,
    ray_chunk: int = 4096,
):
    """Render one full image from a camera pose (reference render_path).

    K: [3, 3], c2w: [3, 4] (tensors or arrays).  Returns (rgb [H,W,3]
    tonemapped, noise_img [H,W,3] tonemapped 0.1*sigmoid, depth [H,W]),
    as NeRFAll's eval outputs (:671-677).
    """
    dev = model.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    rays_o, rays_d = get_rays(H, W, K, c2w)
    rays = torch.stack([rays_o, rays_d], dim=-1).reshape(-1, 3, 2)
    rgb, raw_noise, depth = render_rays_chunked_eval(
        model, cfg, H, W, float(K[0, 0]), rays, ray_chunk
    )
    tm, eps = cfg.tone_mapping_type, cfg.tonemap_eps
    rgb = apply_tonemap(tm, rgb, eps, model.tonemapping).reshape(H, W, 3)
    noise_img = apply_tonemap(
        tm, NOISE_SCALE * torch.sigmoid(raw_noise), eps, model.tonemapping
    ).reshape(H, W, 3)
    return rgb, noise_img, depth.reshape(H, W)


@torch.no_grad()
def render_warped_view(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    K,
    c2w,
    image_idx: int,
    ray_chunk: int = 4096,
):
    """Render each RBK sub-ray bundle of one training view separately.

    A working equivalent of the reference's dead render_warped_path
    (models/lushnerf.py:898-947, signature-mismatched with RBK.forward), as
    lushnerf_tpu's: returns (rgbs [M+1, H, W, 3] tonemapped, depths
    [M+1, H, W], centre_sub_rays [M+1, 3, 2]) so the learned blur
    decomposition can be inspected.
    """
    dev = model.device
    M1 = cfg.rbk.num_rays_out
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    rays_o, rays_d = get_rays(H, W, K, c2w)
    rays = torch.stack([rays_o, rays_d], dim=-1).reshape(-1, 3, 2)
    idx = torch.full((rays.shape[0],), int(image_idx), dtype=torch.long, device=dev)
    sub_rays, _ = apply_rbk(model.mlp_rbk, rays, idx)  # [HW, M1, 3, 2]
    centre = sub_rays.reshape(H, W, M1, 3, 2)[H // 2, W // 2]
    flat = sub_rays.transpose(0, 1).reshape(M1 * H * W, 3, 2)
    rgb, _, depth = render_rays_chunked_eval(model, cfg, H, W, float(K[0, 0]), flat, ray_chunk)
    rgb = apply_tonemap(cfg.tone_mapping_type, rgb, cfg.tonemap_eps,
                        model.tonemapping).reshape(M1, H, W, 3)
    return rgb, depth.reshape(M1, H, W), centre
