"""Weight bridge: the JAX package's params tree <-> `LushNeRF` state dict,
and reference `.tar` checkpoints.

`LushNeRF` carries the reference's module names, so its state dict IS the
reference's NeRFAll state dict (without the DataParallel `module.`
prefix).  Key map (reference module path -> JAX params tree):
  mlp_coarse / mlp_fine / mlp_noise_coarse   -> coarse / fine / noise
    .pts_linears.{i}                         -> ["pts"][i]
    .feature_linear/.alpha_linear            -> ["feature"]/["alpha"]
    .views_linears.0/.rgb_linear             -> ["views"]/["rgb"]
    .output_linear (no-viewdirs variant)     -> ["output"]
  dbk_view_embedding.view_embed_layer.weight -> rbk["embed"]
  mlp_rbk.view_embed_linears.{i}             -> rbk["trunk"][i]
  mlp_rbk.{r,v,w}_branch.{i} / {r,v,w}_linear-> rbk["{r,v,w}_branch"][i] / "_out"
  tonemapping.linear.{0,2,4,6} ('learn')     -> tonemap["layers"][0..3]
  tonemapping.linear_{r,g,b}.{0,2,4}         -> tonemap["r" / "g" / "b"][0..2]
    ('split_linear'; the JAX importer has no reference keys for it, and
    these are the port's: an nn.Sequential per channel, as 'learn')
The embedding and RBK are shared by further module paths
(blur_kernel_net.*, mlp_rbk.view_embedding_layer.*), which appear in the
state dict as aliases of the same tensors.

Linear weights are [out, in] here and [in, out] in the JAX tree.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

EMBED_KEYS = (
    "dbk_view_embedding.view_embed_layer.weight",
    "blur_kernel_net.view_embed_layer.view_embed_layer.weight",
    "mlp_rbk.view_embedding_layer.view_embed_layer.weight",
    "blur_kernel_net.RBK.view_embedding_layer.view_embed_layer.weight",
)
RBK_PREFIXES = ("mlp_rbk", "blur_kernel_net.RBK")
LEARN_LINEARS = (0, 2, 4, 6)  # the Linears of the tone maps' nn.Sequential
SPLIT_LINEARS = (0, 2, 4)


def strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the DataParallel `module.` prefix (a prefix, not a character set)."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# JAX params tree -> state dict
# ---------------------------------------------------------------------------


def _linear_out(sd, prefix: str, wb) -> None:
    w, b = wb
    sd[prefix + ".weight"] = torch.from_numpy(np.asarray(w, np.float32).T.copy())
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(b, np.float32).copy())


def _mlp_out(sd, prefix: str, p: Params) -> None:
    """prefix: '' or a module path ending in '.'."""
    for i, wb in enumerate(p["pts"]):
        _linear_out(sd, f"{prefix}pts_linears.{i}", wb)
    if "feature" in p:
        _linear_out(sd, f"{prefix}feature_linear", p["feature"])
        _linear_out(sd, f"{prefix}alpha_linear", p["alpha"])
        _linear_out(sd, f"{prefix}views_linears.0", p["views"])
        _linear_out(sd, f"{prefix}rgb_linear", p["rgb"])
    else:
        _linear_out(sd, f"{prefix}output_linear", p["output"])


def mlp_state_from_jax(p: Params) -> "OrderedDict[str, torch.Tensor]":
    """One JAX MLP params tree -> `NeRFMLP` state dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _mlp_out(sd, "", p)
    return sd


def _tonemap_out(sd, prefix: str, tonemap: Params) -> None:
    if "layers" in tonemap:
        for i, wb in zip(LEARN_LINEARS, tonemap["layers"]):
            _linear_out(sd, f"{prefix}linear.{i}", wb)
    elif tonemap:
        for ch in "rgb":
            for i, wb in zip(SPLIT_LINEARS, tonemap[ch]):
                _linear_out(sd, f"{prefix}linear_{ch}.{i}", wb)


def tonemap_state_from_jax(tonemap: Params) -> "OrderedDict[str, torch.Tensor]":
    """A JAX tone-map params tree ('learn' or 'split_linear') -> `ToneMapping`
    state dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _tonemap_out(sd, "", tonemap)
    return sd


def params_from_jax(params: Params) -> "OrderedDict[str, torch.Tensor]":
    """JAX params tree (numpy leaves) -> `LushNeRF` state dict (CPU tensors)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _mlp_out(sd, "mlp_coarse.", params["coarse"])
    _mlp_out(sd, "mlp_noise_coarse.", params["noise"])
    if "fine" in params:
        _mlp_out(sd, "mlp_fine.", params["fine"])
    if "rbk" in params:
        rbk = params["rbk"]
        emb = torch.from_numpy(np.asarray(rbk["embed"], np.float32).copy())
        for key in EMBED_KEYS:
            sd[key] = emb
        for base in RBK_PREFIXES:
            for i, wb in enumerate(rbk["trunk"]):
                _linear_out(sd, f"{base}.view_embed_linears.{i}", wb)
            for h in ("r", "v", "w"):
                for i, wb in enumerate(rbk[f"{h}_branch"]):
                    _linear_out(sd, f"{base}.{h}_branch.{i}", wb)
                _linear_out(sd, f"{base}.{h}_linear", rbk[f"{h}_out"])
    _tonemap_out(sd, "tonemapping.", params.get("tonemap") or {})
    return sd


# ---------------------------------------------------------------------------
# state dict -> JAX params tree
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _linear_in(sd, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    return _np(sd[prefix + ".weight"]).T.copy(), _np(sd[prefix + ".bias"])


def _seq_in(sd, prefix: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    out = []
    i = 0
    while f"{prefix}.{i}.weight" in sd:
        out.append(_linear_in(sd, f"{prefix}.{i}"))
        i += 1
    return out


def _mlp_in(sd, prefix: str) -> Params:
    p: Params = {"pts": _seq_in(sd, f"{prefix}.pts_linears")}
    if f"{prefix}.feature_linear.weight" in sd:
        p["feature"] = _linear_in(sd, f"{prefix}.feature_linear")
        p["alpha"] = _linear_in(sd, f"{prefix}.alpha_linear")
        p["views"] = _linear_in(sd, f"{prefix}.views_linears.0")
        p["rgb"] = _linear_in(sd, f"{prefix}.rgb_linear")
    else:
        p["output"] = _linear_in(sd, f"{prefix}.output_linear")
    return p


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Params:
    """`LushNeRF` (or reference NeRFAll) state dict -> JAX params tree."""
    sd = strip_module(state_dict)
    params: Params = {"coarse": _mlp_in(sd, "mlp_coarse"), "tonemap": {}}
    if "mlp_noise_coarse.pts_linears.0.weight" in sd:
        params["noise"] = _mlp_in(sd, "mlp_noise_coarse")
    if "mlp_fine.pts_linears.0.weight" in sd:
        params["fine"] = _mlp_in(sd, "mlp_fine")
    if EMBED_KEYS[0] in sd:
        rbk: Params = {
            "embed": _np(sd[EMBED_KEYS[0]]),
            "trunk": _seq_in(sd, "mlp_rbk.view_embed_linears"),
        }
        for h in ("r", "v", "w"):
            rbk[f"{h}_branch"] = _seq_in(sd, f"mlp_rbk.{h}_branch")
            rbk[f"{h}_out"] = _linear_in(sd, f"mlp_rbk.{h}_linear")
        params["rbk"] = rbk
    if "tonemapping.linear.0.weight" in sd:
        params["tonemap"] = {"layers": [_linear_in(sd, f"tonemapping.linear.{i}")
                                        for i in LEARN_LINEARS]}
    elif "tonemapping.linear_r.0.weight" in sd:
        params["tonemap"] = {ch: [_linear_in(sd, f"tonemapping.linear_{ch}.{i}")
                                  for i in SPLIT_LINEARS] for ch in "rgb"}
    return params


def load_reference_checkpoint(path: str | Path) -> Tuple[int, Dict[str, torch.Tensor]]:
    """A reference-format `.tar` ({global_step, network_state_dict}) ->
    (global_step, state dict for LushNeRF.load_state_dict(strict=True)).
    Loads tensors only (weights_only=True)."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = ckpt["network_state_dict"] if "network_state_dict" in ckpt else ckpt
    return int(ckpt.get("global_step", 0)), strip_module(sd)
