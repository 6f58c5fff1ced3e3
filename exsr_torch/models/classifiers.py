"""The SVHN digit classifier and the plain SR generators, without Z and
without the CEM, as ``nn.Module``s: :class:`SVHNClassifier`,
:class:`MSRResNet` and :class:`SRResNet`.

Counterpart of ``exsr/models/classifiers.py``.  All take NHWC tensors;
inside, the convolutions run on NCHW views in ``channels_last`` memory.
Module names are those of ``exsr``'s flax parameters (``conv0``, ``bn0``,
``fc9``, ``conv_first``, ``rb{i}_conv1``, ...), so the bridges of
:mod:`exsr_torch.models.convert` map one tree onto the other by name.
:func:`load_svhn_torch_state_dict` converts the reference's SVHN ``.pth``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.discriminators import BatchNorm, lecun_normal_
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


SVHN_FEATURES = (48, 64, 128, 160, 192, 192, 192, 192)
SVHN_HEADS = ('digit_length',) + tuple(f'digit{i}' for i in range(1, 6))


class SVHNClassifier(nn.Module):
    """The multi-digit SVHN classifier of the 'digit' objective:
    ``forward(x)`` takes ``[N, 54, 54, 3]`` images in [-1, 1] and returns
    the six heads ``(length logits [N, 7], digit1..digit5 logits [N,
    11])``.

    Eight stages of a 5 x 5 conv, batch norm by its running statistics
    (eval mode, eps 1e-5), ReLU and a 2 x 2 max-pool with torch's padding
    1 (padded with -inf), stride 2 on even stages and 1 on odd ones: 54 ->
    28 -> 29 -> 15 -> 16 -> 9 -> 10 -> 6 -> 7, so 7 x 7 x 192; then
    the NCHW flatten (the reference's order), ``fc9`` and ``fc10`` at 3072
    with ReLU, and the heads.  Fresh weights are flax's defaults
    (LeCun-normal, zero biases, unit scale) from a generator seeded with
    ``seed``."""

    def __init__(self, seed: int = 0):
        super().__init__()
        c = 3
        for i, f in enumerate(SVHN_FEATURES):
            setattr(self, f'conv{i}', nn.Conv2d(c, f, 5, padding=2))
            setattr(self, f'bn{i}', BatchNorm(f, momentum=0.9, eps=1e-5))
            c = f
        self.fc9 = nn.Linear(192 * 7 * 7, 3072)
        self.fc10 = nn.Linear(3072, 3072)
        for name in SVHN_HEADS:
            setattr(self, name, nn.Linear(3072, 7 if name ==
                                          'digit_length' else 11))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, gen)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> tuple:
        x = to_nchw(x)
        for i in range(len(SVHN_FEATURES)):
            x = getattr(self, f'conv{i}')(x)
            x = F.relu(getattr(self, f'bn{i}')(x, batch_stats=False))
            x = F.max_pool2d(x, 2, stride=2 if i % 2 == 0 else 1,
                             padding=1)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc10(F.relu(self.fc9(x))))
        return tuple(getattr(self, name)(x) for name in SVHN_HEADS)


def load_svhn_torch_state_dict(path: str) -> dict:
    """The reference's SVHN ``.pth`` (``_hidden{1..8}.0`` conv,
    ``_hidden{1..8}.1`` batch norm, ``_hidden9.0``, ``_hidden10.0``,
    ``_digit_length.0``, ``_digit{1..5}.0``) -> the state dict of
    :class:`SVHNClassifier`."""
    raw = torch.load(path, map_location='cpu', weights_only=True)
    names = {f'_hidden{i + 1}.0': f'conv{i}' for i in range(8)}
    names.update({f'_hidden{i + 1}.1': f'bn{i}' for i in range(8)})
    names.update({'_hidden9.0': 'fc9', '_hidden10.0': 'fc10'})
    names.update({f'_{h}.0': h for h in SVHN_HEADS})
    out = {}
    for key, value in raw.items():
        prefix, leaf = key.rsplit('.', 1)
        if leaf != 'num_batches_tracked':
            out[f'{names[prefix]}.{leaf}'] = value.float()
    return out


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
