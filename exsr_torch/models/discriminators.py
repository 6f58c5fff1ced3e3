"""The discriminators of the SR trainer, as ``nn.Module``s.

Counterpart of ``exsr/models/discriminators.py``:

* :class:`DiscriminatorVGG128`: the VGG-style critic of explorable SR
  (depth ``nb`` <= 10, ``num_2_strides`` stride-2 stages, batch norm,
  LeakyReLU), with the FC head when ``num_2_strides == 5`` and otherwise
  ``exsr``'s patch head, whose final logit conv has no norm and no
  activation (``exsr/models/discriminators.py:100-112``);
* :class:`PatchGANDiscriminator`: the pix2pix PatchGAN, optionally judging
  the CEM's (low, high) pair through a second stream, with pre-clipping.

Both take NHWC images and return NHWC logits (``[B, 1]`` for the FC
head); inside, the convolutions run on NCHW views.  ``forward(x,
update_stats)``: batch norm always normalizes by the batch's statistics,
as torch's train mode and ``exsr``'s ``flax_d_adapter`` do, and moves the
running statistics only when ``update_stats`` is set.  The running
statistics follow flax's ``BatchNorm(momentum=0.9)``: they keep 0.9 of
their value and take 0.1 of the batch's mean and **biased** variance
(``nn.BatchNorm2d`` would take the unbiased one).  Fresh weights follow
``exsr``'s distributions, drawn from a ``torch.Generator`` seeded with
``seed``: Kaiming-normal fan-in convs in the VGG critic, flax's default
LeCun-normal (truncated at two standard deviations) for the ``Dense``
layers and the PatchGAN's convs, zero biases, batch-norm scale 1.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.ops.filters import to_nchw, to_nhwc

BN_MOMENTUM = 0.9     # flax's: the share of the running value kept
BN_EPS = 1e-5
# flax's truncated_normal variance scaling: the std of a unit normal cut
# at +-2 standard deviations
_TRUNC_STD = 0.87962566103423978


def kaiming_normal_(w: torch.Tensor, gen: torch.Generator,
                    scale: float = 1.0) -> None:
    """``exsr``'s ``kaiming_conv_init(scale)``: normal, std ``scale *
    sqrt(2 / fan_in)``."""
    std = scale * np.sqrt(2.0 / w[0].numel())
    w.copy_(torch.randn(w.shape, generator=gen) * std)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init: a unit normal truncated to [-2, 2],
    scaled to std ``sqrt(1 / fan_in)`` (``w[0].numel()`` for conv and
    linear weights alike)."""
    lo, hi = (0.5 * (1 + torch.erf(torch.tensor(v / np.sqrt(2.0),
                                                dtype=torch.float64)))
              for v in (-2.0, 2.0))
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64)
    x = torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * np.sqrt(2.0)
    std = np.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    w.copy_((x * std).to(w.dtype))


class BatchNorm(nn.Module):
    """Batch norm over NCHW that normalizes by the batch's statistics (or,
    without ``batch_stats``, by the running ones) and updates the running
    ones flax's way only when asked: they keep ``momentum`` of their value
    and take the rest from the batch's mean and biased variance."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                batch_stats: bool = True):
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3),
                                           correction=0)
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var)
        if not batch_stats:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, momentum=0.0, eps=self.eps)


class ConvBlock(nn.Module):
    """conv (+ batch norm) (+ LeakyReLU 0.2) on NCHW; padding
    ``(kernel - 1) // 2`` as torch's SAME arithmetic, or an int."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, norm: bool = True, act: bool = True,
                 padding: str | int = 'SAME'):
        super().__init__()
        pad = (kernel - 1) // 2 if padding == 'SAME' else int(padding)
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, pad)
        self.bn = BatchNorm(features) if norm else None
        self.act = act

    def forward(self, x, update_stats: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, update_stats)
        return F.leaky_relu(x, 0.2) if self.act else x


def _torch_conv_out(size: int, kernel: int, stride: int) -> int:
    """Output size of a conv with padding ``(kernel - 1) // 2``."""
    p = (kernel - 1) // 2
    return (size + 2 * p - kernel) // stride + 1


class DiscriminatorVGG128(nn.Module):
    """VGG-style critic: ``nb`` conv blocks (odd ones 4x4, the first
    ``num_2_strides`` of those stride 2), then the FC head (Dense 100,
    LeakyReLU, Dense 1; the features flattened in NHWC order, as ``exsr``
    flattens them) when ``num_2_strides == 5``, else the patch head (8x8
    VALID conv block, LeakyReLU, a bare 1x1 logit conv).
    ``input_patch_size`` is the true input size, CEM margins removed."""

    def __init__(self, base_nf: int = 64, nb: int = 10,
                 num_2_strides: int = 5, input_patch_size: int = 128,
                 init_scale: float = 1.0, in_nc: int = 3, seed: int = 0):
        super().__init__()
        nf = base_nf
        self.nb, self.num_2_strides = nb, num_2_strides
        feats = [nf, nf, nf * 2, nf * 2, nf * 4, nf * 4, nf * 8, nf * 8,
                 nf * 8, nf * 8]
        strides_left, size, cin = num_2_strides, input_patch_size, in_nc
        for i in range(nb):
            k = 4 if i % 2 == 1 else 3
            s = 1
            if i % 2 == 1 and strides_left > 0:
                s = 2
                strides_left -= 1
            setattr(self, f'conv{i}', ConvBlock(cin, feats[i], k, s,
                                                norm=i != 0))
            size = _torch_conv_out(size, k, s)
            cin = feats[i]
        if num_2_strides == 5:
            self.fc0 = nn.Linear(size * size * cin, 100)
            self.fc1 = nn.Linear(100, 1)
        else:
            if size < 8:
                raise ValueError(
                    f'feature map {size}x{size} too small for the 8x8 '
                    'patch head: use fewer stride-2 stages or a larger '
                    'input patch')
            self.pseudo_fc0 = ConvBlock(cin, min(100, cin), kernel=8,
                                        padding=0)
            self.pseudo_fc1 = ConvBlock(min(100, cin), 1, kernel=1,
                                        norm=False, act=False)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    kaiming_normal_(m.weight, gen, init_scale)
                    m.bias.zero_()
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, gen)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = to_nchw(x)
        for i in range(self.nb):
            x = getattr(self, f'conv{i}')(x, update_stats)
        if self.num_2_strides == 5:
            x = to_nhwc(x).reshape(x.shape[0], -1)
            return self.fc1(F.leaky_relu(self.fc0(x), 0.2))
        x = F.leaky_relu(self.pseudo_fc0(x, update_stats), 0.2)
        return to_nhwc(self.pseudo_fc1(x))


class PatchGANDiscriminator(nn.Module):
    """70x70-style PatchGAN critic: 4x4 convs with padding 1, instance
    norm (biased, eps 1e-5, no affine) on the middle stages, LeakyReLU 0.2
    on all but the last.

    ``decomposed_input``: ``forward`` takes ``(projected, x)``, the CEM's
    low- and high-frequency components; the projected one flows through
    its own stride-matched 4x4 convs and is concatenated in front of the
    main stream's input at every stage.  ``pre_clipping`` clamps the input
    to the valid range first (``x`` into ``[-projected, 1 - projected]``
    when decomposed, else ``[0, 1]``)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 decomposed_input: bool = False, pre_clipping: bool = False,
                 in_nc: int = 3, seed: int = 0):
        super().__init__()
        self.decomposed_input = decomposed_input
        self.pre_clipping = pre_clipping
        max_out = 512
        stages = [(ndf, 2, False)]
        for n in range(1, n_layers):
            nf_mult = min(2 ** n, 8)
            stride = 2 if n > n_layers - 3 else 1
            stages.append((min(max_out, ndf * nf_mult), stride, True))
        stages.append((min(max_out, ndf * min(2 ** n_layers, 8)), 1, True))
        stages.append((1, 1, False))
        self.stages = stages
        cin = in_nc
        for i, (f, s, _) in enumerate(stages):
            extra = in_nc if decomposed_input else 0
            setattr(self, f'conv{i}', nn.Conv2d(cin + extra, f, 4, s, 1))
            if decomposed_input and i > 0:
                setattr(self, f'proj{i}', nn.Conv2d(
                    in_nc, in_nc, 4, stages[i - 1][1], 1))
            cin = f
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, gen)
                    m.bias.zero_()

    def forward(self, x, update_stats: bool = False):
        """``update_stats`` is accepted for the trainer's one D contract;
        instance norm keeps no running statistics."""
        if self.decomposed_input:
            projected, x = x
            if self.pre_clipping:
                x = torch.maximum(torch.minimum(x, 1 - projected),
                                  -projected)
            proj = to_nchw(projected)
        elif self.pre_clipping:
            x = torch.minimum(torch.maximum(x, x.new_zeros(())),
                              x.new_ones(()))
        x = to_nchw(x)
        last = len(self.stages) - 1
        for i, (_, _, norm) in enumerate(self.stages):
            if self.decomposed_input:
                if i > 0:
                    proj = getattr(self, f'proj{i}')(proj)
                inp = torch.cat([proj, x], 1)
            else:
                inp = x
            x = getattr(self, f'conv{i}')(inp)
            if norm:
                x = F.instance_norm(x, eps=BN_EPS)
            if i < last:
                x = F.leaky_relu(x, 0.2)
        return to_nhwc(x)
