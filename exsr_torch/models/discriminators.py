"""The discriminators of the SR trainer, as ``nn.Module``s.

Counterpart of ``exsr/models/discriminators.py``:

* :class:`DiscriminatorVGG128`: the VGG-style critic of explorable SR
  (depth ``nb`` <= 10, ``num_2_strides`` stride-2 stages, batch norm,
  LeakyReLU), with the FC head when ``num_2_strides == 5`` and otherwise
  ``exsr``'s patch head, whose final logit conv has no norm and no
  activation (``exsr/models/discriminators.py:100-112``);
* :class:`PatchGANDiscriminator`: the pix2pix PatchGAN, optionally judging
  the CEM's (low, high) pair through a second stream, with pre-clipping;
* the fixed-size critics no entry point builds
  (``exsr/models/discriminators.py:125-196``): :class:`DiscriminatorVGG`
  (96 / 192 px), :class:`DiscriminatorVGG128SN` (spectral norm, no batch
  norm) and :class:`ACDVGGBN96` (SFT-GAN's GAN and class heads).

All take NHWC images and return NHWC logits (``[B, 1]`` for the FC
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


def combine_moments(means: torch.Tensor, m2: torch.Tensor, n: int):
    """``(mean, biased variance)`` of the union of equal parts of ``n``
    values each, from each part's mean and sum of squared deviations
    (stacked on dim 0): Chan et al.'s exact pairwise update, which keeps
    the variance where the mean is large against the spread (sums of
    squares of the raw values would lose it to cancellation in fp32)."""
    mean = means.mean(dim=0)
    var = (m2 + n * (means - mean) ** 2).sum(dim=0) / (n * means.shape[0])
    return mean, var


class BatchNorm(nn.Module):
    """Batch norm over NCHW that normalizes by the batch's statistics (or,
    without ``batch_stats``, by the running ones) and updates the running
    ones flax's way only when asked: they keep ``momentum`` of their value
    and take the rest from the batch's mean and biased variance.

    ``dp`` (set by :func:`exsr_torch.parallel.dist.sync_batch_norm`) makes
    the batch the union of the batches of ``dp``'s ranks: each rank's
    per-channel mean and sum of squared deviations (two-pass, as one
    process computes them) are gathered, gradients included, and combined
    exactly (:func:`combine_moments`).  The ranks must hold equal counts.

    ``rows`` (a slice of H) takes the statistics from those rows only and
    normalizes all rows by them: a height shard extended by a halo counts
    its own rows, which its neighbours do not."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.dp = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                (1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_(
                (1 - self.momentum) * var)

    def _stats(self, own: torch.Tensor):
        """The batch's mean and biased variance, from the rank's ``own``
        values (over ``dp``'s ranks when set)."""
        var, mean = torch.var_mean(own, dim=(0, 2, 3), correction=0)
        if self.dp is None:
            return mean, var
        c = own.shape[1]
        n = own.numel() // c              # equal on every rank
        parts = self.dp.gather(torch.cat([mean, n * var])[None], 0)
        return combine_moments(parts[:, :c], parts[:, c:], n)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                batch_stats: bool = True, rows: slice | None = None):
        if not batch_stats or (self.dp is None and rows is None):
            if update_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(
                        x if rows is None else x[:, :, rows],
                        dim=(0, 2, 3), correction=0)
                    self._update(mean, var)
            if not batch_stats:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, training=False,
                                    eps=self.eps)
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, momentum=0.0, eps=self.eps)
        mean, var = self._stats(x if rows is None else x[:, :, rows])
        if update_stats:
            self._update(mean.detach(), var.detach())
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x * scale[:, None, None]
                + (self.bias - mean * scale)[:, None, None])


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


def _init_critic(module: nn.Module, seed: int, init_scale: float = 1.0
                 ) -> None:
    """``exsr``'s critic initialisers in ``modules()`` order: Kaiming-normal
    fan-in convs (times ``init_scale``), LeCun-normal linear layers, zero
    biases; drawn from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m.weight, gen, init_scale)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, gen)
                m.bias.zero_()


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
        _init_critic(self, seed, init_scale)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = to_nchw(x)
        for i in range(self.nb):
            x = getattr(self, f'conv{i}')(x, update_stats)
        if self.num_2_strides == 5:
            x = to_nhwc(x).reshape(x.shape[0], -1)
            return self.fc1(F.leaky_relu(self.fc0(x), 0.2))
        x = F.leaky_relu(self.pseudo_fc0(x, update_stats), 0.2)
        return to_nhwc(self.pseudo_fc1(x))


def _vgg_features(nf: int, n_convs: int = 10) -> list[int]:
    return ([nf, nf, nf * 2, nf * 2, nf * 4, nf * 4] + [nf * 8] * 6)[
        :n_convs]


def _add_vgg_trunk(module: nn.Module, nf: int, n_convs: int,
                   in_nc: int) -> None:
    """The fixed-size critics' trunk as ``module.conv<i>``: conv blocks,
    odd ones 4x4 stride 2, batch norm on all but the first."""
    cin = in_nc
    for i, f in enumerate(_vgg_features(nf, n_convs)):
        odd = i % 2 == 1
        setattr(module, f'conv{i}', ConvBlock(cin, f, 4 if odd else 3,
                                              2 if odd else 1, norm=i != 0))
        cin = f


def _vgg_trunk(module: nn.Module, n_convs: int, x, update_stats: bool):
    """The trunk's features of NHWC ``x``, flattened in NHWC order."""
    x = to_nchw(x)
    for i in range(n_convs):
        x = getattr(module, f'conv{i}')(x, update_stats)
    return to_nhwc(x).reshape(x.shape[0], -1)


class DiscriminatorVGG(nn.Module):
    """The fixed-size VGG critics of 96 / 192 px inputs: five (six) conv
    pairs down to 3 x 3 x ``8 nf``, the FC head (Dense 100, LeakyReLU,
    Dense 1)."""

    def __init__(self, base_nf: int = 64, input_size: int = 96,
                 in_nc: int = 3, seed: int = 0):
        super().__init__()
        if input_size not in (96, 192):
            raise ValueError(f'input_size must be 96 or 192, got '
                             f'{input_size}')
        self.n_convs = 10 if input_size == 96 else 12
        _add_vgg_trunk(self, base_nf, self.n_convs, in_nc)
        self.fc0 = nn.Linear(9 * base_nf * 8, 100)
        self.fc1 = nn.Linear(100, 1)
        _init_critic(self, seed)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = _vgg_trunk(self, self.n_convs, x, update_stats)
        return self.fc1(F.leaky_relu(self.fc0(x), 0.2))


class DiscriminatorVGG128SN(nn.Module):
    """The spectral-norm VGG-128 critic: ten spectral-norm convs and
    LeakyReLU 0.2, no batch norm, the FC head.  Its stride-2 stages are
    ``exsr``'s: a stride-1 4x4 conv with padding 1, then the even
    positions ``[::2, ::2]`` (not torch's stride-2 conv, whose outputs
    differ).  ``update_stats`` moves each conv's ``u``, as ``exsr``'s
    ``spectral`` collection does when mutable."""

    def __init__(self, nf: int = 64, in_nc: int = 3, seed: int = 0):
        super().__init__()
        from exsr_torch.models.dncnn import SpectralNormConv
        gen = torch.Generator().manual_seed(seed)
        self.plan = [(nf, 3, 1), (nf, 4, 2), (2 * nf, 3, 1), (2 * nf, 4, 2),
                     (4 * nf, 3, 1), (4 * nf, 4, 2), (8 * nf, 3, 1),
                     (8 * nf, 4, 2), (8 * nf, 3, 1), (8 * nf, 4, 2)]
        cin = in_nc
        for i, (f, k, _) in enumerate(self.plan):
            setattr(self, f'conv{i}', SpectralNormConv(
                cin, f, k, padding=(k - 1) // 2, gen=gen))
            cin = f
        self.fc0 = nn.Linear(16 * cin, 100)
        self.fc1 = nn.Linear(100, 1)
        with torch.no_grad():
            for fc in (self.fc0, self.fc1):
                lecun_normal_(fc.weight, gen)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = to_nchw(x)
        for i, (_, _, s) in enumerate(self.plan):
            x = getattr(self, f'conv{i}')(x, update_stats)
            if s == 2:
                x = x[:, :, ::2, ::2]
            x = F.leaky_relu(x, 0.2)
        x = to_nhwc(x).reshape(x.shape[0], -1)
        return self.fc1(F.leaky_relu(self.fc0(x), 0.2))


class ACDVGGBN96(nn.Module):
    """The auxiliary-classifier VGG-BN-96 critic of SFT-GAN: the 96 px
    trunk, a GAN head and a ``num_classes``-way class head (each Dense
    100, LeakyReLU, Dense); ``forward`` returns ``(gan [N, 1], cls [N,
    num_classes])``."""

    def __init__(self, base_nf: int = 64, num_classes: int = 8,
                 in_nc: int = 3, seed: int = 0):
        super().__init__()
        _add_vgg_trunk(self, base_nf, 10, in_nc)
        flat = 9 * base_nf * 8
        self.gan_fc0 = nn.Linear(flat, 100)
        self.gan_fc1 = nn.Linear(100, 1)
        self.cls_fc0 = nn.Linear(flat, 100)
        self.cls_fc1 = nn.Linear(100, num_classes)
        _init_critic(self, seed)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        x = _vgg_trunk(self, 10, x, update_stats)
        gan = self.gan_fc1(F.leaky_relu(self.gan_fc0(x), 0.2))
        cls = self.cls_fc1(F.leaky_relu(self.cls_fc0(x), 0.2))
        return gan, cls


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
