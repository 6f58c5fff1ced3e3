"""DnCNN: the explorable-JPEG generator and discriminator, as
``nn.Module``s.

Counterpart of ``exsr/models/dncnn.py``.  A plain conv stack in the DCT
domain; public tensors are NHWC (``[N, H/8, W/8, 64]`` luma coefficients),
the convolutions run on NCHW views.

Generator (:class:`DnCNN`):

* Z is concatenated in front of the input (``[z, x]``) of every conv
  (``'all_layers'``) or of the first (``'first_layer'``).  The widths flax
  infers are spelt out: ``conv0`` takes ``in_nc + nz``, the later convs
  ``n_channels (+ nz)``; only ``conv0`` has a bias.
* ReLU after ``conv0``; after each middle conv the norm, then LeakyReLU
  0.01.  Batch norm is flax's ``BatchNorm(momentum=0.05, epsilon=1e-4)``
  (torch's momentum 0.95): running statistics unless ``train``, in which
  case the batch's (biased variance) normalise.  The running ones move
  only with ``update_stats``, which defaults to ``train``: ``exsr``'s
  trainer keeps them from one train-mode forward of each G step and
  discards them everywhere else.
  Instance norm has eps 1e-5 and no affine; ``'layer'`` and None
  normalise nothing in the generator, as in ``exsr``.
* The output is ``quantized + (sigmoid(x) - 0.5)``: the correction stays
  within one quantisation bin.  The chroma generator instead returns the
  error of two chroma channels of ``block_size^2`` coefficients, with the
  quantised low frequencies (input channels 256 on) added onto each
  block's 8 x 8 low-frequency quadrant, in NHWC order.

Discriminator (:class:`DnCNNDiscriminator`): SAME padding for the first
convs, VALID once the field allows (at least 5 x 5 left before the head),
layer norm (eps 1e-5, biased, no affine) or batch norm, optional spectral
norm (:class:`SpectralNormConv`), an FC head over the NHWC-flattened
features or a fully convolutional pooling head.  As the port's other
discriminators, ``forward(x, z, update_stats)`` normalises batch norm by
the batch's statistics and moves the running ones, and spectral norm's
``u``, only when ``update_stats``.

Fresh weights follow ``exsr``'s initialisers, drawn from a
``torch.Generator`` seeded with ``seed``: flax's LeCun-normal (truncated
at two standard deviations) for plain convs and the dense head,
He-normal (the same, doubled variance) for spectral-norm convs, a unit
normal for ``u``, zero biases, batch-norm scale 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.models.discriminators import BatchNorm, lecun_normal_
from exsr_torch.ops.filters import bilinear_resize, to_nchw, to_nhwc

BN_MOMENTUM = 0.05   # flax's: the share of the running value kept
BN_EPS = 1e-4
NORM_EPS = 1e-5      # instance norm (generator), layer norm (discriminator)


@dataclasses.dataclass(frozen=True)
class DnCNNConfig:
    n_channels: int = 320          # nf
    depth: int = 10                # nb
    kernel_size: int = 3
    in_nc: int = 64
    out_nc: int = 64
    norm: str | None = 'batch'     # 'batch' | 'layer' | 'instance' | None
    latent_input: str | None = 'all_layers'
    num_latent_channels: int = 0
    chroma_generator: bool = False
    block_size: int = 8            # chroma works on 16x16 DCT blocks


def _standardize(x: torch.Tensor, dims) -> torch.Tensor:
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + NORM_EPS)


def _conv(in_ch: int, out_ch: int, k: int, pad: int, bias: bool,
          gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, padding=pad, bias=bias)
    with torch.no_grad():
        lecun_normal_(conv.weight, gen)
        if bias:
            conv.bias.zero_()
    return conv


class DnCNN(nn.Module):
    """The generator; ``forward(coeffs, z=None, train=False,
    update_stats=None)``."""

    def __init__(self, cfg: DnCNNConfig = DnCNNConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.nz = cfg.num_latent_channels if cfg.latent_input else 0
        gen = torch.Generator().manual_seed(seed)
        k = cfg.kernel_size
        width = cfg.in_nc
        for i in range(cfg.depth):
            feats = cfg.out_nc if i == cfg.depth - 1 else cfg.n_channels
            in_ch = width + (self.nz if self._takes_z(i) else 0)
            setattr(self, f'conv{i}', _conv(in_ch, feats, k, k // 2,
                                            i == 0, gen))
            width = feats
        self.bns = nn.ModuleList(
            [BatchNorm(cfg.n_channels, BN_MOMENTUM, BN_EPS)
             for _ in range(cfg.depth - 2)]
            if cfg.norm == 'batch' else [])

    def _takes_z(self, i: int) -> bool:
        return bool(self.nz) and (self.cfg.latent_input == 'all_layers' or (
            self.cfg.latent_input == 'first_layer' and i == 0))

    def forward(self, quantized_coeffs: torch.Tensor,
                z: torch.Tensor | None = None, train: bool = False,
                update_stats: bool | None = None) -> torch.Tensor:
        """``quantized_coeffs`` ``[N, h, w, in_nc]`` and ``z``
        ``[N, h, w, nz]`` -> ``[N, h, w, out_nc]`` coefficients (the
        chroma generator's error with the low frequencies added).
        ``train`` normalises batch norm by the batch's statistics;
        ``update_stats`` (``train`` when None) moves the running ones."""
        if update_stats is None:
            update_stats = train
        x = self.convs(to_nchw(quantized_coeffs),
                       to_nchw(z) if self.nz else None,
                       lambda i, x: self.norm(i, x, train, update_stats))
        return self.head(x, quantized_coeffs)

    def norm(self, i: int, x: torch.Tensor, train: bool,
             update_stats: bool, rows: slice | None = None
             ) -> torch.Tensor:
        """The norm after middle conv ``i`` (NCHW); ``rows``: the rows
        whose statistics count (the rest is normalised alike)."""
        if self.cfg.norm == 'batch':
            return self.bns[i - 1](x, update_stats=update_stats,
                                   batch_stats=train, rows=rows)
        if self.cfg.norm == 'instance':
            return _standardize(x, (2, 3))
        return x

    def convs(self, x: torch.Tensor, zc: torch.Tensor | None,
              norm) -> torch.Tensor:
        """The conv stack on NCHW ``x`` (Z ``zc`` NCHW or None), with
        ``norm(i, x)`` after each middle conv; the last conv's output,
        before the head."""
        depth = self.cfg.depth
        for i in range(depth):
            if self._takes_z(i):
                x = torch.cat([zc, x], 1)
            x = getattr(self, f'conv{i}')(x)
            if i == depth - 1:
                break
            x = F.relu(x) if i == 0 else F.leaky_relu(norm(i, x), 0.01)
        return x

    def head(self, x: torch.Tensor, quantized_coeffs: torch.Tensor
             ) -> torch.Tensor:
        """The output from the last conv's NCHW ``x``: the bin-bounded
        correction of ``quantized_coeffs`` (NHWC), or the chroma error
        with the quantised low frequencies added, block by block."""
        cfg = self.cfg
        err = to_nhwc(torch.sigmoid(x)) - 0.5
        if not cfg.chroma_generator:
            return quantized_coeffs + err
        bs = cfg.block_size
        n, h, w, _ = err.shape
        err = err.reshape(n, h, w, 2, bs // 8, 8, bs // 8, 8).clone()
        q = quantized_coeffs[..., 256:].reshape(n, h, w, 2, 8, 8)
        err[..., 0, :, 0, :] += q
        return err.reshape(n, h, w, -1)


class SpectralNormConv(nn.Module):
    """Conv2d with spectral weight normalisation: one power iteration per
    call on the weight as ``exsr`` reshapes it (HWIO to ``[kh*kw*in,
    out]``), ``norm + 1e-12`` in each normalisation, the weight divided by
    the estimate ``sigma`` with no gradient through it, and ``u`` updated
    only when ``update_stats``."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 padding: int = 0, use_bias: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None
        with torch.no_grad():
            lecun_normal_(self.weight, gen)
            self.weight.mul_(np.sqrt(2.0))   # He-normal: twice the variance
        self.register_buffer('u', torch.randn(features, generator=gen))

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        with torch.no_grad():
            w_mat = self.weight.permute(2, 3, 1, 0).reshape(
                -1, self.weight.shape[0])
            v = w_mat @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u_new = w_mat.T @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
            sigma = v @ w_mat @ u_new
            if update_stats:
                self.u.copy_(u_new)
        return F.conv2d(x, self.weight / sigma, self.bias,
                        padding=self.padding)


class DnCNNDiscriminator(nn.Module):
    """The DCT-domain critic; ``forward(x, z=None, update_stats=False)``
    takes NHWC ``x`` ``[N, s, s, in_nc]`` with ``s =
    expected_input_size`` and returns ``[N, 1]`` logits (FC head) or the
    NHWC ``[N, s', s', 1]`` map (``pooling_no_fc``)."""

    def __init__(self, n_channels: int = 320, depth: int = 10,
                 kernel_size: int = 3, expected_input_size: int = 32,
                 norm: str | None = 'layer', latent_input: str | None = None,
                 num_latent_channels: int = 0, spectral_norm: bool = False,
                 pooling_no_fc: bool = False, out_nc: int = 64,
                 in_nc: int = 64, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        k = kernel_size
        self.depth, self.norm = depth, norm
        self.latent_input = latent_input
        self.nz = num_latent_channels if latent_input else 0
        self.pooling_no_fc = pooling_no_fc
        self.num_padded = max(0, depth - int(np.floor(
            (expected_input_size - 5) / (k - 1))))
        size, width = expected_input_size, in_nc
        for i in range(depth):
            padded = i < self.num_padded
            if not padded:
                size -= k - 1
            last = i == depth - 1
            feats = (1 if pooling_no_fc else out_nc) if last else n_channels
            use_bias = pooling_no_fc if last else i == 0
            in_ch = width + (self.nz if self._takes_z(i) else 0)
            pad = (k - 1) // 2 if padded else 0
            conv = (SpectralNormConv(in_ch, feats, k, pad, use_bias, gen)
                    if spectral_norm else
                    _conv(in_ch, feats, k, pad, use_bias, gen))
            setattr(self, f'conv{i}', conv)
            width = feats
        self.spectral_norm = spectral_norm
        self.bns = nn.ModuleList(
            [BatchNorm(n_channels, BN_MOMENTUM, BN_EPS)
             for _ in range(depth - 2)]
            if norm == 'batch' else [])
        self.fc = None
        if not pooling_no_fc:
            self.fc = nn.Linear(size * size * width, 1)
            with torch.no_grad():
                lecun_normal_(self.fc.weight, gen)
                self.fc.bias.zero_()

    def _takes_z(self, i: int) -> bool:
        return bool(self.nz) and self.latent_input in (
            'all_layers', 'first_layer') and (
            self.latent_input == 'all_layers' or i == 0)

    def forward(self, x: torch.Tensor, z: torch.Tensor | None = None,
                update_stats: bool = False) -> torch.Tensor:
        h = to_nchw(x)
        for i in range(self.depth):
            if self._takes_z(i):
                zi = z
                if z.shape[1] != h.shape[2]:
                    zi = bilinear_resize(z, h.shape[2], h.shape[3])
                h = torch.cat([to_nchw(zi), h], 1)
            conv = getattr(self, f'conv{i}')
            h = conv(h, update_stats) if self.spectral_norm else conv(h)
            if i == self.depth - 1:
                break
            if i == 0:
                h = F.relu(h)
                continue
            if self.norm == 'layer':
                h = _standardize(h, (1, 2, 3))
            elif self.norm == 'batch':
                h = self.bns[i - 1](h, update_stats)
            h = F.leaky_relu(h, 0.01)
        if self.pooling_no_fc:
            return to_nhwc(h)
        return self.fc(to_nhwc(h).reshape(h.shape[0], -1))
