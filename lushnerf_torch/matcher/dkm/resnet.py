"""ResNet50 feature-pyramid encoder (torchvision's layout, eval mode), a
port of lushnerf_tpu/matcher/dkm/resnet.py written in torch.nn.

The exercised path of the reference encoder (DKMv3.py:416-455, Encoder
:896-915): features at strides {1, 2, 4, 8, 16, 32}.  Modules sit under
torchvision's names (`encoder.net.conv1`, `bn1`, `layer{1-4}.{b}.conv{1,2,3}`
/ `bn{1,2,3}` / `downsample.{0,1}`), the LuSh checkpoint's after its key
cleanup (run_lushnerf.py:352-356).  The widths come from the shape table;
the block counts and strides are ResNet50's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from lushnerf_torch.matcher.dkm.nn import Conv, FrozenBN, Shapes, maxpool2d

BLOCKS = {1: 3, 2: 4, 3: 6, 4: 3}  # ResNet50 bottleneck counts


class Bottleneck(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str, stride: int):
        super().__init__()
        self.conv1 = Conv(shapes, f"{prefix}.conv1")
        self.bn1 = FrozenBN(shapes, f"{prefix}.bn1")
        self.conv2 = Conv(shapes, f"{prefix}.conv2", stride=stride, padding=1)
        self.bn2 = FrozenBN(shapes, f"{prefix}.bn2")
        self.conv3 = Conv(shapes, f"{prefix}.conv3")
        self.bn3 = FrozenBN(shapes, f"{prefix}.bn3")
        if f"{prefix}.downsample.0.weight" in shapes:
            self.downsample = nn.Sequential(Conv(shapes, f"{prefix}.downsample.0", stride=stride),
                                            FrozenBN(shapes, f"{prefix}.downsample.1"))
        else:
            self.downsample = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet50(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str = "encoder.net"):
        super().__init__()
        self.conv1 = Conv(shapes, f"{prefix}.conv1", stride=2, padding=3)
        self.bn1 = FrozenBN(shapes, f"{prefix}.bn1")
        for layer, n_blocks in BLOCKS.items():
            stride = 1 if layer == 1 else 2
            setattr(self, f"layer{layer}", nn.Sequential(*[
                Bottleneck(shapes, f"{prefix}.layer{layer}.{b}", stride if b == 0 else 1)
                for b in range(n_blocks)]))

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """x: [N, 3, H, W] -> {1, 2, 4, 8, 16, 32: feature map}."""
        feats = {1: x}
        x = torch.relu(self.bn1(self.conv1(x)))
        feats[2] = x
        x = maxpool2d(x, 3, 2, 1)
        for layer in BLOCKS:
            x = getattr(self, f"layer{layer}")(x)
            feats[2 ** (layer + 1)] = x
        return feats


class Encoder(nn.Module):
    """The reference's `encoder` holding torchvision's ResNet50 as `net`."""

    def __init__(self, shapes: Shapes, prefix: str = "encoder"):
        super().__init__()
        self.net = ResNet50(shapes, f"{prefix}.net")

    def forward(self, x):
        return self.net(x)
