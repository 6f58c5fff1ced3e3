"""The plain SR generators, without Z and without the CEM, as
``nn.Module``s: :class:`MSRResNet` and :class:`SRResNet`.

Counterpart of ``exsr/models/classifiers.py:87-162``.  Both take and return
NHWC tensors; inside, the convolutions run on NCHW views in
``channels_last`` memory.  Module names are those of ``exsr``'s flax
parameters (``conv_first``, ``rb{i}_conv1``, ...), so
:func:`exsr_torch.models.convert.from_exsr_plain_params` maps one tree onto
the other by name.  ``SVHNClassifier`` is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.rrdb import INIT_SCALE, Conv3x3
from exsr_torch.ops.filters import (bilinear_resize, nearest_upsample,
                                    to_nchw, to_nhwc)


def _init_(module: nn.Module, scaled: tuple[str, ...], seed: int) -> None:
    """Zero biases; Kaiming-normal fan-in weights times 0.1 for the convs
    named in ``scaled`` (``exsr``'s ``kaiming_conv_init(0.1)``) and
    LeCun-normal ones for the rest (flax's default initialiser, without its
    truncation), drawn from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = INIT_SCALE * np.sqrt(2.0 / fan_in) if name in scaled \
                    else np.sqrt(1.0 / fan_in)
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * std)
                m.bias.zero_()


def _up_stages(upscale: int) -> tuple[int, int]:
    """(stages, factor per stage): one x3 stage, or log2(upscale) x2."""
    if upscale == 3:
        return 1, 3
    return int(np.log2(upscale)), 2


def pixel_shuffle_nhwc(x: torch.Tensor, f: int) -> torch.Tensor:
    """Depth to space of NHWC ``x`` with ``exsr``'s channel order: channel
    ``(fy * f + fx) * C' + c`` lands at sub-pixel ``(fy, fx)``, channel
    ``c`` (``torch.nn.functional.pixel_shuffle`` orders them
    ``c * f * f + fy * f + fx``)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, f, f, c // (f * f))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * f, w * f, c // (f * f))


class MSRResNet(nn.Module):
    """Modified SRResNet: ``nb`` residual blocks without batch norm,
    pixel-shuffle upsampling, and a bilinear global skip with half-pixel
    centers (``exsr/ops/filters.py:161``)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 16, upscale: int = 4, seed: int = 0):
        super().__init__()
        self.nb, self.upscale = nb, upscale
        self.n_up, self.f = _up_stages(upscale)
        self.conv_first = Conv3x3(in_nc, nf)
        for i in range(nb):
            setattr(self, f'rb{i}_conv1', Conv3x3(nf, nf))
            setattr(self, f'rb{i}_conv2', Conv3x3(nf, nf))
        for i in range(self.n_up):
            setattr(self, f'upconv{i + 1}', Conv3x3(nf, nf * self.f ** 2))
        self.HRconv = Conv3x3(nf, nf)
        self.conv_last = Conv3x3(nf, out_nc)
        _init_(self, ('conv_first', 'HRconv', 'conv_last') + tuple(
            f'upconv{i + 1}' for i in range(self.n_up)), seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        out = F.leaky_relu(self.conv_first(to_nchw(x)), 0.1)
        for i in range(self.nb):
            res = F.relu(getattr(self, f'rb{i}_conv1')(out))
            out = out + getattr(self, f'rb{i}_conv2')(res)
        for i in range(self.n_up):
            up = to_nhwc(getattr(self, f'upconv{i + 1}')(out))
            out = to_nchw(pixel_shuffle_nhwc(up, self.f))
            out = F.leaky_relu(out, 0.1)
        out = F.leaky_relu(self.HRconv(out), 0.1)
        out = to_nhwc(self.conv_last(out))
        n, h, w, _ = inp.shape
        return out + bilinear_resize(inp, h * self.upscale, w * self.upscale)


class SRResNet(nn.Module):
    """Plain SRResNet: a feature conv, ``nb`` ResNet blocks inside a long
    skip, nearest-upsample + conv stages, two HR convs."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 16, upscale: int = 4, seed: int = 0):
        super().__init__()
        self.nb, self.upscale = nb, upscale
        self.n_up, self.f = _up_stages(upscale)
        self.fea_conv = Conv3x3(in_nc, nf)
        for i in range(nb):
            setattr(self, f'rb{i}_conv1', Conv3x3(nf, nf))
            setattr(self, f'rb{i}_conv2', Conv3x3(nf, nf))
        self.lr_conv = Conv3x3(nf, nf)
        for i in range(self.n_up):
            setattr(self, f'upconv{i}', Conv3x3(nf, nf))
        self.hr_conv0 = Conv3x3(nf, nf)
        self.hr_conv1 = Conv3x3(nf, out_nc)
        _init_(self, (), seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.fea_conv(to_nchw(x))
        out = fea
        for i in range(self.nb):
            res = F.relu(getattr(self, f'rb{i}_conv1')(out))
            out = out + getattr(self, f'rb{i}_conv2')(res)
        out = fea + self.lr_conv(out)
        for i in range(self.n_up):
            out = to_nchw(nearest_upsample(to_nhwc(out), self.f))
            out = F.relu(getattr(self, f'upconv{i}')(out))
        out = F.relu(self.hr_conv0(out))
        return to_nhwc(self.hr_conv1(out))
