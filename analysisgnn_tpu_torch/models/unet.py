"""2-D convolutional UNet (counterpart of ``analysisgnn_tpu/models/unet.py``,
the reference's vendored UNet, analysisgnn/models/core/unet.py:8-38: in the
model zoo, unused by the analysis path; e.g. pianoroll-image experiments).

It takes and returns ``[B, H, W, C]`` images, as the flax module does, and
runs ``[B, C, H, W]`` inside.  flax's layers and their torch counterparts:
``Conv`` (kernel ``[kh, kw, in, out]``) is ``nn.Conv2d`` (``[out, in, kh,
kw]``); ``padding="SAME"`` pads ``(k - 1) // 2`` before and the rest after,
which for the 2x2 up-convolution is ``(0, 1)``: padded explicitly, since
torch's ``padding="same"`` is the symmetric case only; ``GroupNorm`` has eps
1e-6 (torch's default is 1e-5) and ``min(8, features)`` groups;
``jax.image.resize(..., "nearest")`` to twice the size repeats every row and
column.  Module names follow flax's auto-names: ``ConvBlock_i`` is
``blocks.i``, ``Conv_i`` ``convs.i`` and ``GroupNorm_i`` ``norms.i``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax's GroupNorm eps


def _same_pads(k: int) -> tuple:
    """F.pad's ``(left, right, top, bottom)`` of flax's SAME for a k x k kernel."""
    lo = (k - 1) // 2
    return (lo, k - 1 - lo, lo, k - 1 - lo)


class SameConv2d(nn.Conv2d):
    """A stride-1 ``nn.Conv2d`` with flax's SAME padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, _same_pads(self.kernel_size[0])))


class ConvBlock(nn.Module):
    """(3x3 SAME conv -> GroupNorm -> ReLU) twice."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.convs = nn.ModuleList([SameConv2d(in_features, features, 3), SameConv2d(features, features, 3)])
        groups = min(8, features)
        self.norms = nn.ModuleList([nn.GroupNorm(groups, features, eps=GN_EPS) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x)))
        return x


class UNet(nn.Module):
    """Encoder-decoder with skip connections over ``[B, H, W, C]`` images
    (H and W divisible by ``2 ** (len(features) - 1)``)."""

    def __init__(self, in_channels: int, features: Sequence[int] = (32, 64, 128), out_channels: int = 1):
        super().__init__()
        features = tuple(features)
        down = [ConvBlock(i, f) for i, f in zip((in_channels,) + features[:-2], features[:-1])]
        bottom = ConvBlock(features[-2] if len(features) > 1 else in_channels, features[-1])
        ups, up_blocks, width = [], [], features[-1]
        for f in reversed(features[:-1]):
            ups.append(SameConv2d(width, f, 2))
            up_blocks.append(ConvBlock(2 * f, f))
            width = f
        self.depth = len(features) - 1
        self.blocks = nn.ModuleList(down + [bottom] + up_blocks)
        # flax's creation order: the up-convolutions Conv_0 .. Conv_{depth-1}, then the 1x1 output Conv
        self.convs = nn.ModuleList(ups + [nn.Conv2d(width, out_channels, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.blocks[: self.depth]:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.blocks[self.depth](x)
        for i, skip in enumerate(reversed(skips)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = torch.cat([self.convs[i](x), skip], dim=1)
            x = self.blocks[self.depth + 1 + i](x)
        return self.convs[-1](x).permute(0, 2, 3, 1)
