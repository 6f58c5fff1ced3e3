"""Serving entry point of the CEM-wrapped explorable generator.

Counterpart of ``build_model`` and ``bucketed_sweep`` in
``exsr/apps/eval_sr.py``.  The rest of that CLI (datasets, metrics, latent
modes, checkpoints) is not ported yet.
"""
from __future__ import annotations

import torch

from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
from exsr_torch.device import resolve_device
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.models.rrdb_fast import pack_grouped_params, \
    rrdbnet_apply_fast
from exsr_torch.utils.serve import best_bucket, pad_batch


def build_model(scale: int, nb: int = 23, latent_channels: int = 3,
                nf: int = 64, device=None, dtype=torch.float32, *,
                params=None, checkpoint: str | None = None):
    """Build the CEM and the serving forward: ``(cem, forward)``.

    ``forward(lr, z_hr)`` takes NHWC ``lr`` ``[N, h, w, 3]`` and
    ``z_hr`` ``[N, h*scale, w*scale, latent_channels]`` (arrays or
    tensors) and returns the CEM-wrapped output clipped to [0, 1], as an
    fp32 tensor on ``device``.  It runs the grouped trunk in ``dtype`` (fp32
    by default, as ``exsr``'s ``build_model``; bf16 for fast serving) with
    the stage-4 epilogue kernel and the fp32 CEM chain through the
    separable filter kernel, with the inputs replicate-padded by the CEM's
    invalidity margins (``pre_pad``).  Weights are ``params`` (the port's
    RRDBNet or a state dict, e.g. from
    :func:`exsr_torch.models.convert.from_exsr_params`) or, when None,
    random weights from seed 0.
    """
    if checkpoint is not None:
        raise NotImplementedError(
            'checkpoint loading is not ported yet; convert the weights with '
            'exsr_torch.models.convert.from_exsr_params and pass params=')
    device = resolve_device(device)
    cem = CEM.create(CEMConf(scale_factor=scale))
    if params is None:
        params = RRDBNet(nf=nf, nb=nb, upscale=scale,
                         latent_channels=latent_channels)
    state = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    packed = pack_grouped_params(
        {k: v.to(device) for k, v in state.items()}, dtype=dtype)
    wrapped = cem_wrap(
        lambda pk, x, z: rrdbnet_apply_fast(None, x, z, upscale=scale,
                                            dtype=dtype, packed=pk),
        cem.device_filters(3, device=device), upscale=scale)

    @torch.inference_mode()
    def forward(lr, z_hr=None):
        lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
        if z_hr is not None:
            z_hr = torch.as_tensor(z_hr, dtype=torch.float32, device=device)
        out = wrapped(packed, lr, z_hr, cem.invalidity_margins_lr,
                      pre_pad=True)
        return out.clamp(0.0, 1.0)

    return cem, forward


def bucketed_sweep(fwd, lr, zs, table=None):
    """One batched forward over a Z sweep, padded to the fastest bucket
    (:func:`exsr_torch.utils.serve.best_bucket`); returns one
    ``[1, H, W, 3]`` output per Z."""
    n = len(zs)
    lr_rep = torch.as_tensor(lr).repeat_interleave(n, 0)
    z_cat = torch.cat([torch.as_tensor(z) for z in zs], 0)
    bucket = best_bucket(n, table)
    if bucket > n:
        (lr_rep, z_cat), _ = pad_batch([lr_rep, z_cat], bucket)
    batched = fwd(lr_rep, z_cat)
    return [batched[j:j + 1] for j in range(n)]
