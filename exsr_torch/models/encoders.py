"""Auxiliary encoders: SegNet and E_ResNet, as ``nn.Module``s.

Counterpart of ``exsr/models/encoders.py``:

* :class:`SegNet`, the VGG-style autoencoder whose decoder unpools to the
  encoder's max positions; with ``encode_only`` its 4-stage encoder on
  un-normalised [0, 1] inputs is the ``'SegNetAE'`` perceptual feature
  extractor (:mod:`exsr_torch.models.factory`);
* :class:`EResNet`, the BicycleGAN-style image encoder (pre-activation
  residual blocks with mean-pool downsampling, an optional second head).

The pool and unpool pair is ``exsr``'s: :func:`max_pool_argmax` returns a
one-hot selector per 2 x 2 cell, ties going to the first element of the
cell in row-major order (``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does), and :func:`max_unpool` scatters through it.

Batch norm is the port's :class:`~exsr_torch.models.discriminators.
BatchNorm` with SegNet's flax settings (momentum 0.9, eps 1e-5).
``forward(x, train=False)``: ``train`` normalises by the batch's
statistics and moves the running ones, as ``exsr``'s ``train=True`` with
``batch_stats`` mutable; otherwise the running ones normalise.  Public
tensors are NHWC.  Fresh weights are flax's defaults
(:func:`~exsr_torch.models.sft.flax_init_`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.discriminators import BatchNorm
from exsr_torch.models.sft import flax_init_
from exsr_torch.ops.filters import to_nchw, to_nhwc

SEGNET_BN_MOMENTUM = 0.9
SEGNET_BN_EPS = 1e-5


def max_pool_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2 x 2 stride-2 max pool of NHWC ``x``: ``(pooled [N, H/2, W/2, C],
    sel [N, H/2, W/2, 4, C])``, ``sel`` one-hot at each cell's argmax (the
    cell read row-major, the first maximum taken)."""
    n, h, w, c = x.shape
    cells = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    cells = cells.reshape(n, h // 2, w // 2, 4, c)
    pooled = cells.amax(dim=3)
    idx = cells.argmax(dim=3)
    sel = (idx[..., None, :] == torch.arange(4, device=x.device)[
        None, None, None, :, None]).to(x.dtype)
    return pooled, sel


def max_unpool(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The pooled NHWC values back at their argmax positions, zeros
    elsewhere."""
    n, hp, wp, c = x.shape
    cells = x[:, :, :, None, :] * sel
    cells = cells.reshape(n, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return cells.reshape(n, hp * 2, wp * 2, c)


class ConvBNRelu(nn.Module):
    """3x3 conv (padding 1), optional batch norm, ReLU; NCHW."""

    def __init__(self, cin: int, features: int, with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3, padding=1)
        self.bn = (BatchNorm(features, SEGNET_BN_MOMENTUM, SEGNET_BN_EPS)
                   if with_bn else None)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, update_stats=train, batch_stats=train)
        return F.relu(x)


class SegNetDown(nn.Module):
    """``n_convs`` conv blocks, then the argmax pool; NHWC out."""

    def __init__(self, cin: int, features: int, n_convs: int,
                 with_bn: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            [ConvBNRelu(cin if i == 0 else features, features, with_bn)
             for i in range(n_convs)])

    def forward(self, x, train: bool = False):
        x = to_nchw(x)
        for layer in self.layers:
            x = layer(x, train)
        return max_pool_argmax(to_nhwc(x))


class SegNetUp(nn.Module):
    """Unpool, then ``n_convs`` batch-normed conv blocks, the last one
    ``out_features`` wide; NHWC."""

    def __init__(self, mid_features: int, out_features: int, n_convs: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [ConvBNRelu(mid_features, out_features if i == n_convs - 1
                        else mid_features) for i in range(n_convs)])

    def forward(self, x, sel, train: bool = False):
        x = to_nchw(max_unpool(x, sel))
        for layer in self.layers:
            x = layer(x, train)
        return to_nhwc(x)


class SegNet(nn.Module):
    """SegNet over NHWC images whose sides divide by ``2 **
    num_layers``.  ``encode_only`` returns the encoder's ``[N, H/2^L,
    W/2^L, 512]``; otherwise the decoder's ``[N, H, W, n_classes]``."""

    WIDTHS = (64, 128, 256, 512, 512)
    NCONVS = (2, 2, 3, 3, 3)

    def __init__(self, n_classes: int = 3, num_layers: int = 5,
                 encode_only: bool = False, batch_norm_ds: bool = True,
                 in_nc: int = 3, seed: int = 0):
        super().__init__()
        if num_layers not in (4, 5):
            raise ValueError(f'num_layers must be 4 or 5, got {num_layers}')
        self.num_layers, self.encode_only = num_layers, encode_only
        cin = in_nc
        for i in range(num_layers):
            setattr(self, f'down{i + 1}', SegNetDown(
                cin, self.WIDTHS[i], self.NCONVS[i], batch_norm_ds))
            cin = self.WIDTHS[i]
        if not encode_only:
            for i in range(num_layers):
                out = self.WIDTHS[i - 1] if i > 0 else n_classes
                setattr(self, f'up{i + 1}', SegNetUp(
                    self.WIDTHS[i], out, self.NCONVS[i]))
        flax_init_(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        sels = []
        for i in range(self.num_layers):
            x, sel = getattr(self, f'down{i + 1}')(x, train)
            sels.append(sel)
        if self.encode_only:
            return x
        for i in reversed(range(self.num_layers)):
            x = getattr(self, f'up{i + 1}')(x, sels[i], train)
        return x


class BasicBlock(nn.Module):
    """``[lrelu, conv3x3, lrelu, conv3x3, avgpool2] + [avgpool2,
    conv1x1]``; NCHW."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_features, in_features, 3, padding=1)
        self.conv1 = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.shortcut = nn.Conv2d(in_features, out_features, 1)

    def forward(self, x):
        h = self.conv0(F.leaky_relu(x, 0.2))
        h = F.avg_pool2d(self.conv1(F.leaky_relu(h, 0.2)), 2)
        return h + self.shortcut(F.avg_pool2d(x, 2))


class EResNet(nn.Module):
    """E_ResNet over NHWC ``[N, input_size, input_size, in_nc]``: a 4x4
    stride-2 stem, ``n_blocks - 1`` basic blocks of widths ``ndf *
    min(4, n + 1)``, LeakyReLU, 8 x 8 average pooling, a dense head over
    the NHWC-flattened features; ``vae_like`` returns ``(mu, logvar)``
    from two heads.  No normalisation, as in ``exsr``."""

    def __init__(self, output_nc: int = 1, ndf: int = 64, n_blocks: int = 4,
                 vae_like: bool = False, input_size: int = 128,
                 in_nc: int = 3, seed: int = 0):
        super().__init__()
        self.vae_like = vae_like
        self.stem = nn.Conv2d(in_nc, ndf, 4, stride=2, padding=1)
        size, width = input_size // 2, ndf
        blocks = []
        for n in range(1, n_blocks):
            width = ndf * min(4, n + 1)
            blocks.append(BasicBlock(ndf * min(4, n), width))
            size //= 2
        self.blocks = nn.ModuleList(blocks)
        flat = (size // 8) ** 2 * width
        self.fc = nn.Linear(flat, output_nc)
        self.fc_var = nn.Linear(flat, output_nc) if vae_like else None
        flax_init_(self, seed)

    def forward(self, x: torch.Tensor):
        x = self.stem(to_nchw(x))
        for block in self.blocks:
            x = block(x)
        x = F.avg_pool2d(F.leaky_relu(x, 0.2), 8)
        flat = to_nhwc(x).reshape(x.shape[0], -1)
        out = self.fc(flat)
        return (out, self.fc_var(flat)) if self.vae_like else out
