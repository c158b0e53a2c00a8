"""DKM weights into and out of the port's module.

The checkpoint's key cleanup (run_lushnerf.py:352-356): a leading
'model.' is stripped and the unused classifier head 'encoder.net.fc' and
BN's 'num_batches_tracked' are dropped; every other key is a parameter or
buffer of `matcher.DKM` under the same name.  The JAX package keeps the
same names (numpy arrays keyed by them), so its params carry over by name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lushnerf_torch.matcher.dkm.matcher import DKM

_SKIP_SUBSTR = ("encoder.net.fc", "num_batches_tracked")


def clean_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """The checkpoint's keys cleaned up, its values as f32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if any(s in k for s in _SKIP_SUBSTR):
            continue
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32)
    return out


def load_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The cleaned state dict of a DKM checkpoint (a state dict, or a dict
    holding one under 'state_dict'), read with weights_only=True: a file
    that needs an unpickler beyond tensors and containers is refused."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise RuntimeError(
            f"cannot read the DKM checkpoint {path} with torch.load(weights_only=True): {e}"
        ) from e
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return clean_state_dict(sd)


def module_from_params(params: Dict[str, np.ndarray], device="cpu") -> DKM:
    """The port's module holding the JAX package's DKM params (arrays keyed
    by the checkpoint's names)."""
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}
    return DKM.from_state_dict(sd).to(device)


def params_from_module(model: DKM) -> Dict[str, np.ndarray]:
    """The reverse: the module's weights as numpy arrays by name."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
