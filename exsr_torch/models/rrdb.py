"""RRDB generator with per-layer latent (Z) injection, as ``nn.Module``s.

Counterpart of ``exsr/models/rrdb.py``: an ESRGAN-style RRDB trunk where
the latent control map Z is concatenated to the input of the trunk's
convolutions, 2x nearest-upsample + conv stages, and two HR convs that take
the full-resolution Z.  Z-injection topology (``exsr/models/rrdb.py:8-14``):

* Z (HR-domain) is bilinearly downscaled to LR for the trunk;
* it goes into the first conv, every conv of every residual-dense block,
  and the trunk-end conv, but NOT into the upsample convs;
* the two HR convs take the full-HR Z.

:class:`RRDBNet` takes and returns NHWC tensors; the blocks inside work on
NCHW views in ``channels_last`` memory.  The ``exsr`` scan over 23 stacked
blocks is an ``nn.ModuleList`` here.  The module is differentiable; the
fast grouped inference path is :mod:`exsr_torch.models.rrdb_fast`.  With
``fused_trunk`` the trunk runs through the fused RDB kernel
(:mod:`exsr_torch.ops.kernels.rrdb_block`), for inference only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.ops.filters import (bilinear_resize, nearest_upsample,
                                    to_nchw, to_nhwc)
from exsr_torch.ops.kernels.rrdb_block import (mul_in_dtype, pack_rrdb,
                                              rrdb_block)


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv computed in its input's dtype, whatever its
    parameters' dtype (flax's ``nn.Conv(dtype=...)``)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, padding=1)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=1)


class ZConv(Conv3x3):
    """3x3 SAME conv whose input is ``cat([z, x])`` along channels."""

    def forward(self, x, z=None):
        if z is not None:
            x = torch.cat([z.to(x.dtype), x], 1)
        return super().forward(x)


class ResidualDenseBlock(nn.Module):
    """5-conv residual dense block with Z at every conv."""

    def __init__(self, nf: int = 64, gc: int = 32, nz: int = 0):
        super().__init__()
        for i in range(5):
            setattr(self, f'conv{i}', ZConv(nz + nf + i * gc,
                                            gc if i < 4 else nf))

    def forward(self, x, z):
        # z rides at the front of the feature list: cat([z, x, c0, ...])
        feats = ([z] if z is not None else []) + [x]
        for i in range(4):
            out = getattr(self, f'conv{i}')(torch.cat(feats, 1))
            feats.append(F.leaky_relu(out, 0.2))
        return mul_in_dtype(self.conv4(torch.cat(feats, 1)), 0.2) + x


class RRDB(nn.Module):
    """Residual-in-residual dense block; Z re-injected into each RDB."""

    def __init__(self, nf: int = 64, gc: int = 32, nz: int = 0):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc, nz)
        self.rdb2 = ResidualDenseBlock(nf, gc, nz)
        self.rdb3 = ResidualDenseBlock(nf, gc, nz)

    def forward(self, x, z):
        out = self.rdb3(self.rdb2(self.rdb1(x, z), z), z)
        return mul_in_dtype(out, 0.2) + x


INIT_SCALE = 0.1


def kaiming_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal fan-in init scaled by 0.1 with zero biases
    (``exsr/models/rrdb.py:34-43``), drawn from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = INIT_SCALE * np.sqrt(2.0 / fan_in)
                w = torch.randn(m.weight.shape, generator=generator,
                                dtype=torch.float32) * std
                m.weight.copy_(w)
                m.bias.zero_()


class RRDBNet(nn.Module):
    """The explorable-SR generator.

    ``forward(lr, z_hr)``: ``lr`` is NHWC ``[N, h, w, 3]``; ``z_hr`` the
    HR-domain latent map ``[N, h*upscale, w*upscale, latent_channels]`` or
    None when ``latent_channels == 0``.  Weights are drawn from
    ``torch.Generator().manual_seed(seed)``.  The module returns the input's
    dtype.

    ``dtype`` is the compute dtype (``exsr``'s ``RRDBNet.dtype``): the
    parameters stay fp32 and each conv casts them; None computes in the
    parameters' dtype.  ``fused_trunk`` (``exsr``'s ``pallas_trunk``) runs
    each trunk block through the fused RRDB kernel
    (:func:`exsr_torch.ops.kernels.rrdb_block.rrdb_block`) with the shared
    LR latent map, as ``exsr/models/rrdb.py:150-161`` does: inference only
    (no backward on CUDA), and it needs ``latent_channels > 0``.  The
    packed trunk weights it feeds the kernel live on the module and are
    rebuilt when the trunk's parameters, the device or the dtype change.
    """

    def __init__(self, nf: int = 64, nb: int = 23, gc: int = 32,
                 upscale: int = 4, latent_channels: int = 0, seed: int = 0,
                 dtype: torch.dtype | None = None, fused_trunk: bool = False):
        super().__init__()
        nz = latent_channels
        if fused_trunk and nz == 0:
            raise ValueError('fused_trunk needs latent_channels > 0: the '
                             'fused RRDB kernel takes z, as exsr\'s does')
        self.nf, self.nb, self.gc = nf, nb, gc
        self.upscale, self.latent_channels = upscale, nz
        self.dtype, self.fused_trunk = dtype, fused_trunk
        self._packed = None
        self.fea_conv = Conv3x3(nz + 3, nf)
        self.trunk = nn.ModuleList(RRDB(nf, gc, nz) for _ in range(nb))
        self.trunk_conv = ZConv(nz + nf, nf)
        self.n_up = 1 if upscale == 3 else int(np.log2(upscale))
        for i in range(self.n_up):
            setattr(self, f'upconv{i}', Conv3x3(nf, nf))
        self.hr_conv0 = ZConv(nz + nf, nf)
        self.hr_conv1 = ZConv(nz + nf, 3)
        kaiming_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, lr: torch.Tensor, z_hr: torch.Tensor | None = None):
        if (z_hr is None) != (self.latent_channels == 0):
            raise ValueError('z_hr must be given iff latent_channels > 0')
        in_dtype = lr.dtype
        dtype = self.fea_conv.weight.dtype if self.dtype is None \
            else self.dtype
        n, h, w, _ = lr.shape
        lr = lr.to(dtype)
        if z_hr is not None:
            z_hr = z_hr.to(dtype)
            z_lr = bilinear_resize(z_hr, h, w)
            x = torch.cat([z_lr, lr], -1)
            z_fused = z_lr.contiguous()
            z_lr, z_hr = to_nchw(z_lr), to_nchw(z_hr)
        else:
            z_lr, x = None, lr
        fea = self.fea_conv(to_nchw(x))
        if self.fused_trunk:
            trunk = to_nhwc(fea).contiguous()
            for w3 in self._packed_trunk(dtype):
                trunk = rrdb_block(trunk, z_fused, w3)
            trunk = to_nchw(trunk)
        else:
            trunk = fea
            for block in self.trunk:
                trunk = block(trunk, z_lr)
        x = fea + self.trunk_conv(trunk, z_lr)
        # upsampling: nearest + conv per stage, no Z
        f = 3 if self.upscale == 3 else 2
        for i in range(self.n_up):
            x = to_nchw(nearest_upsample(to_nhwc(x), f))
            x = F.leaky_relu(getattr(self, f'upconv{i}')(x), 0.2)
        x = F.leaky_relu(self.hr_conv0(x, z_hr), 0.2)
        x = self.hr_conv1(x, z_hr)
        return to_nhwc(x).to(in_dtype)

    def _packed_trunk(self, dtype) -> list:
        """The trunk's weights packed for the fused kernel, one triple of
        RDBs per block, packed from the fp32 parameters once and kept until
        a parameter is replaced or modified in place."""
        params = list(self.trunk.parameters())
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError('the fused trunk packs fp32 parameters; keep '
                             'them fp32 and set dtype= for the compute dtype')
        key = (dtype, torch.is_inference_mode_enabled(),
               tuple((p.data_ptr(), p._version) for p in params))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, [pack_rrdb(b, dtype) for b in self.trunk])
        return self._packed[1]
