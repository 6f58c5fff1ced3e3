"""BasicSR's MSRResNet x4 (``msrresnet_x4``), written plainly from its
published description (``codes/models/modules/architecture.py:18-66``
of the reference): a first conv with LeakyReLU 0.1, ``nb`` residual
blocks ``x + conv(relu(conv(x)))`` without batch norm, two x2 pixel
shuffles (conv ``nf -> 4 nf``, depth to space, LeakyReLU 0.1), the HR
conv with LeakyReLU 0.1, the last conv, plus the input bilinearly
upsampled (half-pixel centres).  float32, one conv at a time.

Weights come from the state dict the benchmark made (``exsr_torch``'s
names: ``conv_first``, ``rb<i>_conv1``, ``upconv1``, ``HRconv``, ...).
Depth to space uses ``exsr``'s channel order: channel
``(fy * 2 + fx) * C + c`` lands at sub-pixel ``(fy, fx)``.
"""
from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference.precision import conv3x3


def _depth_to_space(x, f: int):
    """NCHW depth to space, sub-pixel major: ``[N, f*f*C, H, W]`` ->
    ``[N, C, f*H, f*W]``."""
    n, cf, h, w = x.shape
    c = cf // (f * f)
    x = x.reshape(n, f, f, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * f, w * f)


def generator(state: dict, cfg: dict, precision: str = 'float32'):
    """``g(lr, z_hr)``: NHWC float32 LR to HR; ``z_hr`` is ignored (the
    network has no latent input)."""
    conv = conv3x3(precision)
    nb, sf = cfg['nb'], cfg['scale']

    def c(name, x):
        return conv(x, state[f'{name}.weight'], state[f'{name}.bias'])

    def g(lr, z_hr=None):
        n, h, w, _ = lr.shape
        x = lr.float().permute(0, 3, 1, 2)
        out = F.leaky_relu(c('conv_first', x), 0.1)
        for i in range(nb):
            out = out + c(f'rb{i}_conv2', F.relu(c(f'rb{i}_conv1', out)))
        for i in (1, 2):
            out = F.leaky_relu(_depth_to_space(c(f'upconv{i}', out), 2), 0.1)
        out = F.leaky_relu(c('HRconv', out), 0.1)
        out = c('conv_last', out)
        skip = F.interpolate(x, size=(h * sf, w * sf), mode='bilinear',
                             align_corners=False)
        return (out + skip).permute(0, 2, 3, 1)
    return g


def shapes(cfg: dict) -> dict:
    """``{name: shape}`` of the generator's weights and biases."""
    nf, nb = cfg['nf'], cfg['nb']
    out = {}

    def add(name, co, ci):
        out[f'{name}.weight'] = (co, ci, 3, 3)
        out[f'{name}.bias'] = (co,)
    add('conv_first', nf, cfg['in_nc'])
    for i in range(nb):
        add(f'rb{i}_conv1', nf, nf)
        add(f'rb{i}_conv2', nf, nf)
    add('upconv1', 4 * nf, nf)
    add('upconv2', 4 * nf, nf)
    add('HRconv', nf, nf)
    add('conv_last', cfg['out_nc'], nf)
    return out
