"""Requests made from a cell's traffic parameters and the run's seed.

One general generator for every serving cell.  A request is what the
entry point is handed for one image: the LR image as a host array
``[1, h, w, 3]`` in [0, 1] and the list of Z maps of its latent mode,
``[1, 4h, 4w, max(nz, 1)]``, made as ``eval_sr``'s ``build_zs`` makes
them and then kept on the card (:func:`to_device`): the served sweep of a
server that holds its Z maps there, not ``eval_sr``'s host arrays.  The
LR images are smooth random fields with fine noise, like photographs in
their spread of frequencies; every seed gives the same sizes and the same
Z sweep, and only the pixels change.

Parameters (``traffic`` in the cell's file): ``lr_h``, ``lr_w``, ``pool``
(distinct images, cycled through), ``latent`` (``uniform_sweep`` or
``rand_uniform``, ``eval_sr``'s modes of the same names) and ``num_z``.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import zoom


def sweep_values(num: int, z_range: float = 1.0) -> list:
    """``eval_sr``'s ``uniform_sweep``: symmetric values with 0 in the
    middle; an even ``num`` gives ``num - 1`` of them."""
    half = list(np.linspace(-z_range, 0.0, int(np.ceil(num / 2))))[:-1]
    return half + [0.0] + [-v for v in half[::-1]]


def latent_maps(params: dict, nz: int, scale: int, rng) -> list:
    """The Z maps of one request, as ``eval_sr``'s ``build_zs`` makes
    them (swept channel 0, the others 0)."""
    shape = (1, scale * params['lr_h'], scale * params['lr_w'], max(nz, 1))
    if params['latent'] == 'uniform_sweep':
        zs = []
        for v in sweep_values(params['num_z']):
            z = np.zeros(shape, np.float32)
            z[..., 0] = v
            zs.append(z)
        return zs
    if params['latent'] == 'rand_uniform':
        zs = [np.zeros(shape, np.float32)]
        for _ in range(params['num_z'] - 1):
            v = rng.uniform(-1, 1, size=(1, 1, 1, shape[-1]))
            zs.append(np.broadcast_to(v, shape).astype(np.float32))
        return zs
    raise ValueError(f"unknown latent mode {params['latent']!r}")


def lr_image(h: int, w: int, rng) -> np.ndarray:
    """A smooth random field at 1/8 of the size, upsampled linearly, plus
    noise of 0.05, clipped to [0, 1]: ``[1, h, w, 3]`` float32."""
    coarse = rng.random((h // 8 + 2, w // 8 + 2, 3))
    field = zoom(coarse, ((h + 16) / coarse.shape[0],
                          (w + 16) / coarse.shape[1], 1), order=1)
    img = field[8:8 + h, 8:8 + w] + 0.05 * rng.standard_normal((h, w, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)[None]


def requests(params: dict, nz: int, scale: int, seed: int) -> list:
    """``params['pool']`` requests ``(lr, zs)`` drawn from ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    # maps that take nothing from the seed are made once and shared
    fixed = params['latent'] == 'uniform_sweep' or params['num_z'] == 1
    shared = latent_maps(params, nz, scale, rng) if fixed else None
    return [(lr_image(params['lr_h'], params['lr_w'], rng),
             shared if fixed else latent_maps(params, nz, scale, rng))
            for _ in range(params['pool'])]


def to_device(pool: list, device) -> list:
    """The requests with their Z maps on ``device``; a list of maps that
    requests share is copied once."""
    import torch
    moved = {}
    out = []
    for lr, zs in pool:
        if id(zs) not in moved:
            moved[id(zs)] = [torch.as_tensor(z, device=device) for z in zs]
        out.append((lr, moved[id(zs)]))
    return out
