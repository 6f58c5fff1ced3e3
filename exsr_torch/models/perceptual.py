"""Auxiliary perceptual feature extractors, as ``nn.Module``s.

Counterpart of ``exsr/models/perceptual.py``:

* :class:`MINCNet`, the VGG16-like material-classification trunk whose
  last conv has no activation;
* :class:`ResNet101Features`, torchvision's resnet101 through layer4,
  after ImageNet input normalisation (the constants of
  :mod:`exsr_torch.models.vgg`).

No entry point builds them; :func:`exsr_torch.models.factory.
make_feature_extractor` names them.  Batch norm keeps flax's defaults, as
``exsr``'s ``nn.BatchNorm()`` there does: momentum 0.99, eps 1e-5.
``forward(x, train=False)`` as the encoders' (:mod:`exsr_torch.models.
encoders`).  Public tensors are NHWC.  Fresh weights are flax's defaults
(:func:`~exsr_torch.models.sft.flax_init_`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.discriminators import BatchNorm
from exsr_torch.models.sft import flax_init_
from exsr_torch.models.vgg import IMAGENET_MEAN, IMAGENET_STD
from exsr_torch.ops.filters import to_nchw, to_nhwc

FLAX_BN_MOMENTUM = 0.99
FLAX_BN_EPS = 1e-5


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, FLAX_BN_MOMENTUM, FLAX_BN_EPS)


class MINCNet(nn.Module):
    """Four VGG16 stages (2, 2, 3, 3 convs of 64 ... 512, each followed by
    a 2 x 2 max pool), then three 512-wide convs, the last without ReLU:
    ``[N, H, W, 3]`` -> ``[N, H/16, W/16, 512]``."""

    PLAN = ((2, 64), (2, 128), (3, 256), (3, 512))

    def __init__(self, in_nc: int = 3, seed: int = 0):
        super().__init__()
        cin, i = in_nc, 0
        for n_convs, feats in self.PLAN:
            for _ in range(n_convs):
                setattr(self, f'conv{i}', nn.Conv2d(cin, feats, 3, padding=1))
                cin, i = feats, i + 1
        for _ in range(3):
            setattr(self, f'conv{i}', nn.Conv2d(512, 512, 3, padding=1))
            i += 1
        self.n_convs = i
        flax_init_(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, i = to_nchw(x), 0
        for n_convs, _ in self.PLAN:
            for _ in range(n_convs):
                x = F.relu(getattr(self, f'conv{i}')(x))
                i += 1
            x = F.max_pool2d(x, 2)
        for j in range(i, self.n_convs):
            x = getattr(self, f'conv{j}')(x)
            if j < self.n_convs - 1:
                x = F.relu(x)
        return to_nhwc(x)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (stride ``stride``), 1x1 (``4 * features``) bias-free
    convs, each batch-normed, ReLU between; the input or its projection
    (a strided 1x1 conv and batch norm) added; ReLU.  NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn0 = _bn(features)
        self.conv1 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn2 = _bn(4 * features)
        self.proj = (nn.Conv2d(cin, 4 * features, 1, stride, bias=False)
                     if project else None)
        self.proj_bn = _bn(4 * features) if project else None

    def forward(self, x, train: bool = False):
        def bn(m, v):
            return m(v, update_stats=train, batch_stats=train)
        y = F.relu(bn(self.bn0, self.conv0(x)))
        y = F.relu(bn(self.bn1, self.conv1(y)))
        y = bn(self.bn2, self.conv2(y))
        res = x if self.proj is None else bn(self.proj_bn, self.proj(x))
        return F.relu(y + res)


class ResNet101Features(nn.Module):
    """resnet101 through layer4: ``[N, H, W, 3]`` in [0, 1] ->
    ``[N, H/32, W/32, 2048]``."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2))

    def __init__(self, use_input_norm: bool = True, seed: int = 0):
        super().__init__()
        self.use_input_norm = use_input_norm
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        blocks, cin = [], 64
        for feats, n, stride in self.STAGES:
            blocks.append(BottleneckBlock(cin, feats, stride, project=True))
            blocks += [BottleneckBlock(4 * feats, feats)
                       for _ in range(n - 1)]
            cin = 4 * feats
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD),
                             persistent=False)
        flax_init_(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = self.bn1(self.conv1(to_nchw(x)), update_stats=train,
                     batch_stats=train)
        # exsr pads with -inf before a VALID pool: max_pool2d's padding
        x = F.max_pool2d(F.relu(x), 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        return to_nhwc(x)
