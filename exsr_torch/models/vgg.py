"""VGG19 perceptual feature extractor, NHWC at its surface.

Counterpart of ``exsr/models/vgg.py``: torchvision VGG19's ``features``
through conv5_4, before its ReLU ("VGG19-54"), with ImageNet input
normalization and frozen weights.  It serves the ``'VGG'`` objective of the
Z-edit engine as its feature callable.  Pretrained weights come only from a
local torchvision state dict (:func:`load_torch_vgg19_features`); without
one the extractor runs on seeded random weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.rrdb import Conv3x3
from exsr_torch.ops.filters import to_nchw, to_nhwc

# torchvision vgg19 'features': conv widths, 'M' = 2 x 2 max pool
VGG19_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
             512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M')

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _layers(num_convs: int, trailing: str):
    """The ``features`` layers the extractor runs: ('conv', i, width),
    ('relu',) and ('pool',), cut after conv ``num_convs`` as ``trailing``
    says: 'conv' before its ReLU, 'relu' after it, 'pool' through the next
    max pool."""
    out, done, conv = [], False, 0
    for item in VGG19_CFG:
        if item == 'M':
            out.append(('pool',))
            if done:
                return out
            continue
        if done:
            return out
        out.append(('conv', conv, item))
        conv += 1
        if conv == num_convs:
            if trailing == 'conv':
                return out
            out.append(('relu',))
            if trailing == 'relu':
                return out
            done = True
            continue
        out.append(('relu',))
    return out


class VGG19Features(nn.Module):
    """VGG19 trunk cut after ``num_convs`` convolutions (16: conv5_4).
    ``forward`` takes NHWC images in [0, 1] and returns NHWC features."""

    def __init__(self, num_convs: int = 16, use_input_norm: bool = True,
                 trailing: str = 'conv', seed: int = 1):
        super().__init__()
        if trailing not in ('conv', 'relu', 'pool'):
            raise ValueError(f'trailing must be conv, relu or pool, got '
                             f'{trailing!r}')
        self.use_input_norm = use_input_norm
        self.layers = _layers(num_convs, trailing)
        cin = 3
        for layer in self.layers:
            if layer[0] == 'conv':
                setattr(self, f'conv{layer[1]}', Conv3x3(cin, layer[2]))
                cin = layer[2]
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD),
                             persistent=False)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():   # LeCun-normal (flax's default), zero bias
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    std = np.sqrt(1.0 / m.weight[0].numel())
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=gen) * std)
                    m.bias.zero_()
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = to_nchw(x)
        for layer in self.layers:
            if layer[0] == 'conv':
                x = getattr(self, f'conv{layer[1]}')(x)
            elif layer[0] == 'relu':
                x = F.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
        return to_nhwc(x)


def load_torch_vgg19_features(path: str, num_convs: int = 16) -> dict:
    """A local torchvision ``vgg19`` state dict (``.pth``, or ``.npz`` with
    the same ``features.<i>.weight`` / ``.bias`` keys) as the state dict of
    :class:`VGG19Features`.  torchvision's weights are OIHW already."""
    if path.endswith('.npz'):
        with np.load(path) as f:
            state = {k: torch.from_numpy(f[k]) for k in f.files}
    else:
        state = torch.load(path, map_location='cpu', weights_only=True)
    # torchvision's index of each conv inside 'features': a conv and its
    # ReLU take two slots, a pool one
    conv_indices, idx = [], 0
    for item in VGG19_CFG:
        if item == 'M':
            idx += 1
        else:
            conv_indices.append(idx)
            idx += 2
    out = {}
    for ci, ti in enumerate(conv_indices[:num_convs]):
        if f'features.{ti}.weight' not in state:
            raise KeyError(f'missing features.{ti}.weight in {path}')
        for k in ('weight', 'bias'):
            out[f'conv{ci}.{k}'] = torch.as_tensor(
                state[f'features.{ti}.{k}'])
    return out
