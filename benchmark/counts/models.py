"""Model operations of the generators, from a configuration's shapes:
every convolution counted as a direct convolution (2 operations a
product), whatever algorithm implements it.  Elementwise work, the
bilinear resizes and the CEM's filters are left out (under 0.1 % of a
forward)."""
from __future__ import annotations


def conv(ci: int, co: int, k: int = 3) -> int:
    """Operations of one ``k x k`` convolution at one output pixel."""
    return 2 * k * k * ci * co


def rdb(nf: int, gc: int, nz: int) -> int:
    """One residual-dense block at one pixel: five convolutions over the
    growing concatenation ``[z, x, c0, ..., c3]``."""
    cins = [nz + nf + i * gc for i in range(5)]
    couts = [gc, gc, gc, gc, nf]
    return sum(conv(ci, co) for ci, co in zip(cins, couts))


def rrdbnet_per_lr_pixel(cfg: dict) -> int:
    """The explorable RRDB generator's operations per LR pixel: the first
    conv on ``[z, lr]``, ``3 * nb`` residual-dense blocks, the trunk conv
    on ``[z, trunk]``, two x2 upsampling convs (at 4 and 16 pixels per LR
    pixel) and the two HR convs on ``[z, x]`` (16 pixels)."""
    nf, gc, nz, nb = cfg['nf'], cfg['gc'], cfg['latent_channels'], cfg['nb']
    in_nc, out_nc, sf = cfg['in_nc'], cfg['out_nc'], cfg['scale']
    if sf != 4:
        raise ValueError('counted for x4 (two x2 stages) only')
    return (conv(nz + in_nc, nf) + 3 * nb * rdb(nf, gc, nz)
            + conv(nz + nf, nf) + 4 * conv(nf, nf) + 16 * conv(nf, nf)
            + 16 * conv(nz + nf, nf) + 16 * conv(nz + nf, out_nc))


def msrresnet_per_lr_pixel(cfg: dict) -> int:
    """MSRResNet's operations per LR pixel: the first conv, ``nb``
    residual blocks of two convs, two pixel-shuffle convs ``nf -> 4 nf``
    (at 1 and 4 pixels per LR pixel), the HR conv and the last conv (16
    pixels)."""
    nf, nb = cfg['nf'], cfg['nb']
    in_nc, out_nc, sf = cfg['in_nc'], cfg['out_nc'], cfg['scale']
    if sf != 4:
        raise ValueError('counted for x4 (two x2 stages) only')
    return (conv(in_nc, nf) + 2 * nb * conv(nf, nf) + conv(nf, 4 * nf)
            + 4 * conv(nf, 4 * nf) + 16 * conv(nf, nf)
            + 16 * conv(nf, out_nc))


PER_LR_PIXEL = {'RRDB_net': rrdbnet_per_lr_pixel,
                'MSRResNet': msrresnet_per_lr_pixel}


def forward_flops(cfg: dict, batch: int, h: int, w: int) -> int:
    """One forward's model operations at LR ``h x w`` (the size the
    generator runs at: pre-padded under the CEM)."""
    return PER_LR_PIXEL[cfg['arch']](cfg) * batch * h * w
