"""Typed configuration, key-compatible with the reference's scene configs.

A copy of lushnerf_tpu/config.py: the reference uses configargparse with
~70 flags (run_lushnerf.py:32-229) and flat `key = value` scene files
(configs/poster_lushnerf etc.), where a bare key on its own line is a
boolean flag.  `Config.from_file` / `Config.from_args` accept exactly those
files/keys (including the dashed `scaleup-gamma` / `scaleup-clahe`
spellings), so the shipped scene configs drop in unchanged.

`mlp_backend` takes 'torch' (plain ops; the JAX package's 'xla') and
'cuda' (the fused kernel; JAX 'pallas'); scene files that use the JAX
spellings map onto these.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

from lushnerf_torch.models.lushnerf import LushConfig
from lushnerf_torch.models.rbk import RBKConfig
from lushnerf_torch.models.renderer import RenderConfig

BACKEND_ALIASES = {"xla": "torch", "pallas": "cuda"}


@dataclasses.dataclass
class Config:
    # experiment / paths
    config: Optional[str] = None
    expname: str = "exp"
    basedir: str = "./logs"
    datadir: str = ""
    datadownsample: float = -1
    tbdir: str = "./logs_tb"
    num_gpu: int = 1  # accepted for config compat; unused
    torch_hub_dir: str = ""

    # network
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    N_rand: int = 32 * 32 * 4
    lrate: float = 5e-4
    lrate_decay: int = 250
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 32
    no_reload: bool = False
    ft_path: Optional[str] = None

    # rendering
    N_iters: int = 50000
    N_samples: int = 64
    N_importance: int = 0
    perturb: float = 1.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    rgb_activate: str = "sigmoid"
    sigma_activate: str = "relu"

    # render-only options
    render_only: bool = False
    render_test: bool = False
    render_rmnearplane: float = 0
    render_focuspoint_scale: float = 1.0
    render_radius_scale: float = 1.0
    render_factor: int = 0
    render_epi: bool = False

    # llff
    factor: Optional[int] = None
    no_ndc: bool = False
    lindisp: bool = False
    spherify: bool = False
    llffhold: int = 8

    # unused-but-accepted reference params
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    dataset_type: str = "llff"
    testskip: int = 8
    shape: str = "greek"
    white_bkgd: bool = False
    half_res: bool = False

    # logging / cadence
    i_print: int = 200
    i_tensorboard: int = 200
    # finite-guard on every step's loss (device sync per iter — debug only;
    # the i_print-cadence guard is always on).  Reference analog: per-key
    # NaN/Inf prints, models/lushnerf.py:474-478.
    debug_nan_check: bool = False
    i_weights: int = 10000
    i_testset: int = 5000
    i_video: int = 20000

    # LuSh-NeRF options
    blur_model_type: str = "dpnerf"
    kernel_start_iter: int = 0
    scaleup_gamma: float = 0.8  # config key: scaleup-gamma
    scaleup_clahe: float = 15  # config key: scaleup-clahe
    noisenerf_start_iter: int = 200000
    allkernel_start_iter: int = 0
    fq_threshold: int = 50
    tone_mapping_type: str = "none"
    use_dpnerf: bool = False
    rbk_use_view_embed: bool = False
    rbk_view_embed_ch: int = 32
    rbk_use_viewdirs: bool = False
    rbk_enc_brc_depth: int = 4
    rbk_enc_brc_width: int = 64
    rbk_enc_brc_skips: int = 4
    rbk_num_motion: int = 4
    rbk_se_r_depth: int = 1
    rbk_se_r_width: int = 32
    rbk_se_r_output_ch: int = 3
    rbk_se_v_depth: int = 1
    rbk_se_v_width: int = 32
    rbk_se_v_output_ch: int = 3
    rbk_ccw_depth: int = 1
    rbk_ccw_width: int = 32
    rbk_se_rv_window: float = 0.2
    rbk_use_origin: bool = False
    # zero-mean-blur anchor weight (framework addition; 0 = reference
    # behavior — see models/lushnerf.py LushConfig.rbk_anchor_reg)
    rbk_anchor_reg: float = 0.0
    # L1 blur-spread shrinkage: magnitude-adaptive gate that collapses
    # sub-pixel (unidentifiable) kernels to identity (framework addition;
    # 0 = reference — see models/lushnerf.py LushConfig.rbk_spread_l1)
    rbk_spread_l1: float = 0.0
    # zero-init the r/v head biases so warps start exactly at identity
    # (framework addition; False = reference init — see models/rbk.py)
    rbk_zero_head_bias: bool = False
    # re-center each sub-ray bundle so its weighted-mean ray equals the
    # original ray, removing the RBK gauge-drift mode structurally
    # (framework addition; False = reference — see models/rbk.py)
    rbk_center_bundle: bool = False
    # replace degenerate warped sub-rays (dz >= -eps: the NDC division
    # pole) with the original ray (framework addition; False = reference
    # — see models/rbk.py RBKConfig.guard_dz)
    rbk_guard_dz: bool = False
    # SND noise head on/off (ablation aid; True = reference behavior).
    # False removes the noise MLP from the blur-stage forward entirely.
    use_snd: bool = True
    # gamma-tonemap input floor (framework addition; 0.0 = reference.
    # Guards the x^(1/2.2) gradient pole when dark-pixel radiance
    # saturates to exactly 0 — see models/tonemap.py)
    tonemap_eps: float = 0.0
    # SND output-bias init (framework addition; 0.0 = reference init,
    # which starts the noise head at a constant +0.05 radiance — see
    # models/lushnerf.py LushConfig.snd_bias_init)
    snd_bias_init: float = 0.0
    # L1 gauge-fixing penalty on the SND noise output (framework
    # addition; 0 = reference — see models/lushnerf.py LushConfig.snd_l1)
    snd_l1: float = 0.0
    # global-norm gradient clip (framework addition; 0.0 = reference/off)
    grad_clip_norm: float = 0.0
    # far anchor depth in ray-lengths (see models/lushnerf.py)
    rbk_anchor_depth: float = 8.0
    use_coarse_to_fine_opt: bool = False
    save_warped_ray_img: bool = False

    # consistency (CTE) — reference hardcodes these; exposed as config here
    consist_threshold: float = 0.8
    consist_num_pixels: int = 32
    rematch_interval: int = 20000
    matcher: str = "none"  # 'none' | 'precomputed' | 'dkm' | 'stub' | 'gt'
    match_table_path: str = ""
    dkm_ckpt_path: str = ""  # gim_dkm_100h.ckpt (or LUSHNERF_DKM_CKPT env)

    # ---- runtime additions of the JAX package (accepted keys; the port
    # reads point_chunk, mlp_backend, mlp_compute_dtype, ray_chunk_eval,
    # seed and the multi-process keys below) ----
    # one process per card: empty, or a shape whose product is the number of
    # processes (lushnerf_torch/parallel/mesh.py)
    mesh_shape: str = ""
    mesh_axes: str = "data"
    coordinator_address: str = ""  # host:port of process 0 (or torchrun's env)
    num_processes: int = 0
    process_id: int = -1
    local_device_ids: str = ""  # the one card of this process, e.g. "1"
    point_chunk: int = 65536  # remat chunk for MLP point eval (0 = off)
    ray_chunk_eval: int = 4096
    # 'torch' (plain ops) | 'cuda' (the fused kernel); scene files may use
    # the JAX package's spellings 'xla' and 'pallas', mapped in __post_init__
    mlp_backend: str = "torch"
    mlp_compute_dtype: str = "float32"  # 'bfloat16' for full-rate tensor cores
    pallas_tile: str = ""
    mlp_bwd: str = "remat"  # backward strategy: 'remat' | 'stash'
    param_dtype: str = "float32"
    seed: int = 0

    # number of training images, filled by the data pipeline
    num_images: int = 1

    def __post_init__(self):
        self.mlp_backend = BACKEND_ALIASES.get(self.mlp_backend, self.mlp_backend)

    _ALIASES = {
        "scaleup-gamma": "scaleup_gamma",
        "scaleup-clahe": "scaleup_clahe",
    }

    # ------------------------------------------------------------------
    # parsing
    # ------------------------------------------------------------------

    @classmethod
    def field_names(cls) -> List[str]:
        return [f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")]

    @classmethod
    def _coerce(cls, name: str, value: str) -> Any:
        ftypes = {f.name: f.type for f in dataclasses.fields(cls)}
        ftype = ftypes[name]
        v = value.strip()
        if ftype in ("bool", bool):
            return v.lower() in ("1", "true", "yes", "on")
        if ftype in ("int", int):
            return int(float(v))
        if ftype in ("float", float):
            return float(v)
        if ftype in ("Optional[int]",):
            return None if v.lower() == "none" else int(float(v))
        if ftype in ("Optional[str]",):
            return None if v.lower() == "none" else v
        return v

    @classmethod
    def parse_kv_lines(cls, text: str) -> Dict[str, Any]:
        """Parse the reference's flat config format: `key = value` lines,
        bare keys are boolean flags, '#' starts a comment."""
        out: Dict[str, Any] = {}
        valid = set(cls.field_names())
        for raw_line in text.splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                k = k.strip()
                k = cls._ALIASES.get(k, k)
                if k not in valid:
                    raise KeyError(f"unknown config key: {k!r}")
                out[k] = cls._coerce(k, v)
            else:
                k = cls._ALIASES.get(line, line)
                if k not in valid:
                    raise KeyError(f"unknown config flag: {k!r}")
                out[k] = True
        return out

    @classmethod
    def from_file(cls, path: str | Path, **overrides) -> "Config":
        kv = cls.parse_kv_lines(Path(path).read_text())
        kv.update(overrides)
        kv.setdefault("config", str(path))
        return cls(**kv)

    @classmethod
    def from_args(cls, argv: List[str]) -> "Config":
        """CLI: --key value / --flag, with --config FILE loading a scene
        config first (CLI overrides file, as configargparse does)."""
        file_path = None
        cli: Dict[str, Any] = {}
        i = 0
        valid = set(cls.field_names())
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                raise ValueError(f"unexpected argument {arg!r}")
            key = cls._ALIASES.get(arg[2:], arg[2:])
            if key == "config":
                file_path = argv[i + 1]
                i += 2
                continue
            if key not in valid:
                raise KeyError(f"unknown flag --{arg[2:]}")
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                cli[key] = cls._coerce(key, argv[i + 1])
                i += 2
            else:
                cli[key] = True
                i += 1
        if file_path is not None:
            return cls.from_file(file_path, **cli)
        return cls(**cli)

    # ------------------------------------------------------------------
    # derived model configs
    # ------------------------------------------------------------------

    def render_config(self, inference_defaults: bool = False) -> RenderConfig:
        return RenderConfig(
            n_samples=self.N_samples,
            n_importance=self.N_importance,
            use_viewdirs=self.use_viewdirs,
            ndc=not self.no_ndc,
            lindisp=self.lindisp if self.no_ndc else False,
            perturb=(self.perturb > 0) and not inference_defaults,
            raw_noise_std=0.0 if inference_defaults else self.raw_noise_std,
            white_bkgd=self.white_bkgd,
            rm_nearplane=self.render_rmnearplane,
            rgb_activate=self.rgb_activate,
            sigma_activate=self.sigma_activate,
            multires=self.multires,
            multires_views=self.multires_views,
            point_chunk=self.point_chunk,
            mlp_backend=self.mlp_backend,
            mlp_compute_dtype=self.mlp_compute_dtype,
            mlp_bwd=self.mlp_bwd,
        )

    def rbk_config(self) -> RBKConfig:
        return RBKConfig(
            num_images=self.num_images,
            embed_ch=self.rbk_view_embed_ch,
            depth=self.rbk_enc_brc_depth,
            width=self.rbk_enc_brc_width,
            skips=(self.rbk_enc_brc_skips,),
            num_motion=self.rbk_num_motion,
            r_depth=self.rbk_se_r_depth,
            r_width=self.rbk_se_r_width,
            r_output_ch=self.rbk_se_r_output_ch,
            v_depth=self.rbk_se_v_depth,
            v_width=self.rbk_se_v_width,
            v_output_ch=self.rbk_se_v_output_ch,
            w_depth=self.rbk_ccw_depth,
            w_width=self.rbk_ccw_width,
            rv_window=self.rbk_se_rv_window,
            use_origin=self.rbk_use_origin,
            zero_head_bias=self.rbk_zero_head_bias,
            center_bundle=self.rbk_center_bundle,
            guard_dz=self.rbk_guard_dz,
        )

    def lush_config(self, near: float = 0.0, far: float = 1.0) -> LushConfig:
        return LushConfig(
            render=self.render_config(),
            netdepth=self.netdepth,
            netwidth=self.netwidth,
            netdepth_fine=self.netdepth_fine,
            netwidth_fine=self.netwidth_fine,
            rbk=self.rbk_config(),
            blur_model_type=self.blur_model_type,
            tone_mapping_type=self.tone_mapping_type,
            num_images=self.num_images,
            near=near,
            far=far,
            rbk_anchor_reg=self.rbk_anchor_reg,
            rbk_spread_l1=self.rbk_spread_l1,
            rbk_anchor_depth=self.rbk_anchor_depth,
            use_snd=self.use_snd,
            tonemap_eps=self.tonemap_eps,
            snd_bias_init=self.snd_bias_init,
            snd_l1=self.snd_l1,
        )


def flagship_cfg(num_images: int = 8, tiny: bool = False) -> Config:
    """The flagship configuration (poster_lushnerf shapes: D=8, W=256,
    64+64 samples, 4 motions, fused kernel in bf16), or its tiny twin for
    tests.  A copy of the JAX package's flagship config, with the port's
    backend name."""
    if tiny:
        return Config(
            num_images=num_images,
            N_samples=18,
            N_importance=6,
            netdepth=2,
            netwidth=16,
            netdepth_fine=2,
            netwidth_fine=16,
            multires=4,
            multires_views=2,
            use_viewdirs=True,
            raw_noise_std=1.0,
            blur_model_type="dpnerf",
            use_dpnerf=True,
            rbk_use_origin=True,
            rbk_num_motion=2,
            rbk_view_embed_ch=8,
            rbk_enc_brc_width=8,
            rbk_se_r_width=8,
            rbk_se_v_width=8,
            rbk_ccw_width=8,
            tone_mapping_type="gamma",
            point_chunk=0,
        )
    return Config(
        num_images=num_images,
        N_samples=64,
        N_importance=64,
        use_viewdirs=True,
        raw_noise_std=1.0,
        blur_model_type="dpnerf",
        use_dpnerf=True,
        rbk_use_origin=True,
        rbk_num_motion=4,
        rbk_view_embed_ch=64,
        rbk_se_rv_window=0.1,
        rbk_zero_head_bias=True,
        rbk_center_bundle=True,
        rbk_guard_dz=True,
        tone_mapping_type="gamma",
        tonemap_eps=1e-4,
        point_chunk=0,
        mlp_backend="cuda",
        mlp_compute_dtype="bfloat16",
        mlp_bwd="stash",
    )
