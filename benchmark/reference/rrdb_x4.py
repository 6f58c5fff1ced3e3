"""The explorable RRDB generator (``rrdb_x4``), written plainly from its
published description: ESRGAN's RRDB trunk with the latent map Z
concatenated in front of the input of the first conv, of every conv of
every residual-dense block and of the trunk conv (Z bilinearly resized to
LR, half-pixel centres), x2 nearest upsampling + conv twice without Z,
and the two HR convs on ``[Z, x]`` at full resolution.  LeakyReLU 0.2,
residual scaling 0.2.  One module per layer in float32; no grouping of
the convolutions, no kernels of the program.

It reads the weights from the state dict the benchmark made (names of
``exsr_torch``'s ``RRDBNet``: ``trunk.<i>.rdb<r>.conv<c>``, OIHW).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import conv3x3


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def generator(state: dict, cfg: dict, precision: str = 'float32'):
    """``g(lr, z_hr)``: NHWC float32 LR ``[N, h, w, 3]`` and Z
    ``[N, 4h, 4w, nz]`` to the HR image ``[N, 4h, 4w, 3]``."""
    conv = conv3x3(precision)
    nb = cfg['nb']

    def c(name, x):
        return conv(x, state[f'{name}.weight'], state[f'{name}.bias'])

    def lrelu(x):
        return F.leaky_relu(x, 0.2)

    def rdb(prefix, x, z):
        feats = [z, x]
        for i in range(4):
            feats.append(lrelu(c(f'{prefix}.conv{i}', torch.cat(feats, 1))))
        return 0.2 * c(f'{prefix}.conv4', torch.cat(feats, 1)) + x

    def g(lr, z_hr):
        n, h, w, _ = lr.shape
        x = _nchw(lr.float())
        z = _nchw(z_hr.float())
        z_lr = F.interpolate(z, size=(h, w), mode='bilinear',
                             align_corners=False)
        fea = c('fea_conv', torch.cat([z_lr, x], 1))
        t = fea
        for i in range(nb):
            o = t
            for r in (1, 2, 3):
                o = rdb(f'trunk.{i}.rdb{r}', o, z_lr)
            t = 0.2 * o + t
        t = fea + c('trunk_conv', torch.cat([z_lr, t], 1))
        for i in (0, 1):
            t = F.interpolate(t, scale_factor=2, mode='nearest')
            t = lrelu(c(f'upconv{i}', t))
        t = lrelu(c('hr_conv0', torch.cat([z, t], 1)))
        return _nhwc(c('hr_conv1', torch.cat([z, t], 1)))
    return g


def shapes(cfg: dict) -> dict:
    """``{name: shape}`` of the generator's weights and biases."""
    nf, gc, nz, nb = cfg['nf'], cfg['gc'], cfg['latent_channels'], cfg['nb']
    out = {}

    def add(name, co, ci):
        out[f'{name}.weight'] = (co, ci, 3, 3)
        out[f'{name}.bias'] = (co,)
    add('fea_conv', nf, nz + cfg['in_nc'])
    for i in range(nb):
        for r in (1, 2, 3):
            for c in range(5):
                add(f'trunk.{i}.rdb{r}.conv{c}', gc if c < 4 else nf,
                    nz + nf + c * gc)
    add('trunk_conv', nf, nz + nf)
    add('upconv0', nf, nf)
    add('upconv1', nf, nf)
    add('hr_conv0', nf, nz + nf)
    add('hr_conv1', cfg['out_nc'], nz + nf)
    return out
