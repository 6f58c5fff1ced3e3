"""SFT-GAN generator (spatial feature transform), as ``nn.Module``s.

Counterpart of ``exsr/models/sft.py``: :class:`SFTLayer`,
:class:`ResBlockSFT` and :class:`SFTNet`, the segmentation-conditioned x4
generator.  No entry point builds it; it keeps the reference's module
vocabulary for SFT-GAN checkpoints.

``exsr`` runs its 16 identical blocks as one ``nn.scan`` over stacked
parameters, which only saves XLA compile time; here they are an
``nn.ModuleList`` (:func:`exsr_torch.models.convert.sft_from_exsr_vars`
unstacks the parameters).  Public tensors are NHWC; the convolutions run
on NCHW views.  The sub-pixel upsampling is :func:`F.pixel_shuffle`, whose
channel order (``(c, a, b)`` row-major for sub-pixel ``(a, b)``) is
``exsr``'s ``_depth_to_space``.  Fresh weights are flax's defaults, drawn
from a ``torch.Generator`` seeded with ``seed``: LeCun-normal truncated at
two standard deviations, zero biases.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.discriminators import lecun_normal_
from exsr_torch.ops.filters import to_nchw, to_nhwc


def flax_init_(module: nn.Module, seed: int) -> None:
    """flax's default initialisers on every conv and linear layer of
    ``module``, in ``modules()`` order: LeCun-normal (truncated) weights,
    zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """flax's SAME conv (odd ``k``)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class SFTLayer(nn.Module):
    """``fea * (scale + 1) + shift``, scale and shift two 1x1 convs each of
    the 32-channel condition (LeakyReLU 0.1 between); NCHW."""

    def __init__(self):
        super().__init__()
        self.scale_conv0 = _conv(32, 32, 1)
        self.scale_conv1 = _conv(32, 64, 1)
        self.shift_conv0 = _conv(32, 32, 1)
        self.shift_conv1 = _conv(32, 64, 1)

    def forward(self, fea, cond):
        s = self.scale_conv1(F.leaky_relu(self.scale_conv0(cond), 0.1))
        t = self.shift_conv1(F.leaky_relu(self.shift_conv0(cond), 0.1))
        return fea * (s + 1.0) + t


class ResBlockSFT(nn.Module):
    """SFT, 3x3 conv, ReLU, SFT, 3x3 conv, plus the input; NCHW."""

    def __init__(self):
        super().__init__()
        self.sft0 = SFTLayer()
        self.conv0 = _conv(64, 64, 3)
        self.sft1 = SFTLayer()
        self.conv1 = _conv(64, 64, 3)

    def forward(self, fea, cond):
        y = F.relu(self.conv0(self.sft0(fea, cond)))
        return fea + self.conv1(self.sft1(y, cond))


class SFTNet(nn.Module):
    """``forward(img, seg)``: ``img`` NHWC RGB ``[N, h, w, 3]``, ``seg``
    NHWC class probabilities ``[N, 4h, 4w, 8]`` (a 4x4 stride-4 VALID conv
    brings them to the LR grid) -> ``[N, 4h, 4w, 3]``."""

    def __init__(self, n_blocks: int = 16, seed: int = 0):
        super().__init__()
        self.cond0 = nn.Conv2d(8, 128, 4, stride=4)
        self.cond1 = _conv(128, 128, 1)
        self.cond2 = _conv(128, 128, 1)
        self.cond3 = _conv(128, 128, 1)
        self.cond4 = _conv(128, 32, 1)
        self.conv0 = _conv(3, 64, 3)
        self.blocks = nn.ModuleList([ResBlockSFT() for _ in range(n_blocks)])
        self.sft_final = SFTLayer()
        self.conv_final = _conv(64, 64, 3)
        self.hr0 = _conv(64, 256, 3)
        self.hr1 = _conv(64, 256, 3)
        self.hr2 = _conv(64, 64, 3)
        self.hr3 = _conv(64, 3, 3)
        flax_init_(self, seed)

    def forward(self, img: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        cond = F.leaky_relu(self.cond0(to_nchw(seg)), 0.1)
        for conv in (self.cond1, self.cond2, self.cond3):
            cond = F.leaky_relu(conv(cond), 0.1)
        cond = self.cond4(cond)
        fea = self.conv0(to_nchw(img))
        res = fea
        for block in self.blocks:
            res = block(res, cond)
        fea = fea + self.conv_final(self.sft_final(res, cond))
        x = F.relu(F.pixel_shuffle(self.hr0(fea), 2))
        x = F.relu(F.pixel_shuffle(self.hr1(x), 2))
        x = F.relu(self.hr2(x))
        return to_nhwc(self.hr3(x))
