"""The perceptual feature-extractor factory.

Counterpart of ``exsr/models/factory.py`` (the reference's ``define_F``
and its arch dispatch):

* ``'vgg19'`` (default) / ``'vgg19_<layer>'``: the VGG19 trunk cut at
  torchvision ``features`` index ``<layer>`` (34 is conv5_4 before its
  ReLU, the perceptual-loss standard);
* ``'SegNetAE'``: the 4-stage SegNet encoder, on un-normalised inputs;
* ``'minc'``: :class:`~exsr_torch.models.perceptual.MINCNet`;
* ``'resnet101'``: :class:`~exsr_torch.models.perceptual.ResNet101Features`.

:func:`make_feature_extractor` returns the module, which is its own apply
(``module(images_nhwc)``); its weights come from the converters of
:mod:`exsr_torch.models.convert` or are seeded.
"""
from __future__ import annotations

import torch.nn as nn

from exsr_torch.models.encoders import SegNet
from exsr_torch.models.perceptual import MINCNet, ResNet101Features
from exsr_torch.models.vgg import VGG19_CFG, VGG19Features


def _vgg19_layer_map() -> dict:
    """torchvision ``features`` index -> ``(convs kept, what the index
    lands on)``: a conv (its pre-ReLU output), its ReLU, or a pool; the
    reference keeps ``features[:feature_layer + 1]``."""
    out, idx, conv = {}, 0, 0
    for item in VGG19_CFG:
        if item == 'M':
            out[idx] = (conv, 'pool')
            idx += 1
        else:
            conv += 1
            out[idx] = (conv, 'conv')
            out[idx + 1] = (conv, 'relu')
            idx += 2
    return out


_VGG19_LAYER_MAP = _vgg19_layer_map()


def make_feature_extractor(arch: str = 'vgg19', feature_layer: int = 34,
                           seed: int = 0) -> nn.Module:
    """The perceptual network the reference's vocabulary names; an
    unknown ``arch`` raises ``ValueError``."""
    if arch.startswith('vgg'):
        if '_' in arch:
            feature_layer = int(arch.split('_', 1)[1])
        num_convs, trailing = _VGG19_LAYER_MAP[feature_layer]
        return VGG19Features(num_convs=num_convs, trailing=trailing,
                             seed=seed)
    if arch == 'SegNetAE':
        return SegNet(encode_only=True, num_layers=4, batch_norm_ds=False,
                      seed=seed)
    if arch == 'minc':
        return MINCNet(seed=seed)
    if arch == 'resnet101':
        return ResNet101Features(seed=seed)
    raise ValueError(f'unknown feature-extractor arch: {arch!r}')
