"""The weights of every cell, made on the card from the seed.

The benchmark, not the program, makes them: one `torch.Generator` on the
device and two large draws (uniforms for every linear layer, normals for
the view embedding), sliced and scaled leaf by leaf in the type they are
served in (float32; the bf16 configuration rounds inside its kernels).
The same tensors go to the program and to the reference.

Rules, by leaf name and shape (torch.nn.Linear's and nn.Embedding's
initial distributions):
  * a 2-D `weight` [out, in]: U(-1/sqrt(in), 1/sqrt(in));
  * a `bias`: U(-1/sqrt(in), 1/sqrt(in)) of its layer's weight;
  * the view embedding (`view_embed_layer.weight`): N(0, 1);
  * the RBK's rotation and translation heads (`r_linear`, `v_linear`):
    weights U(-HEAD_BOUND, HEAD_BOUND) and zero biases, so that each
    sub-ray is warped by a few pixels, as a trained blur kernel warps it
    (at the torch default the warps would span the frame; at the program's
    own 1e-5 they would start at the identity).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

HEAD_BOUND = 1e-2
EMBEDDING = "view_embed_layer.weight"
RBK_HEADS = ("r_linear.", "v_linear.")


def _bound(name: str, shapes: Dict[str, Tuple[int, ...]]) -> float:
    if any(h in name for h in RBK_HEADS):
        return HEAD_BOUND if name.endswith("weight") else 0.0
    weight = name if name.endswith("weight") else name[: -len("bias")] + "weight"
    return 1.0 / math.sqrt(shapes[weight][1])


def make_weights(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every (name, shape)."""
    shapes = dict(named_shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    linear = [n for n in shapes if not n.endswith(EMBEDDING)]
    embed = [n for n in shapes if n.endswith(EMBEDDING)]
    sizes = [math.prod(shapes[n]) for n in linear]
    uni = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for n, size in zip(linear, sizes):
        out[n] = (uni[off:off + size] * _bound(n, shapes)).view(shapes[n])
        off += size
    if embed:
        sizes = [math.prod(shapes[n]) for n in embed]
        nrm = torch.randn(sum(sizes), generator=gen, device=device)
        off = 0
        for n, size in zip(embed, sizes):
            out[n] = nrm[off:off + size].view(shapes[n]).clone()
            off += size
    return out
