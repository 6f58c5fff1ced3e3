"""Explorable-JPEG evaluation CLI.

Counterpart of ``exsr/apps/eval_jpeg.py``.  Per image and quality factor
it decodes the quantised DCT coefficients of the image's Y channel through
the DnCNN generator at Z = 0 and reports the PSNR against the uncompressed
Y, the PSNR of plain JPEG decoding (the baseline the generator must beat),
and the quantisation-bin consistency of the output coefficients; with
``--num_z`` > 1 also the per-pixel STD across Z samples.  The optimizer
latent modes instead optimise Z per image through
:class:`exsr_torch.apps.jpeg_session.JPEGEditSession` before scoring.

Usage::

  python -m exsr_torch.apps.eval_jpeg --data_dir DIR --qf 10 30 50 \\
      [--checkpoint CKPT] [--num_z 8] [--save_images] [--out_dir results]

It runs on the current CUDA device unless ``--device cpu`` is given, in
fp32 with TF32 off.  ``--checkpoint`` is a directory of the port's
checkpoints (:class:`exsr_torch.train.checkpoints.CheckpointManager`, the
DnCNN's state dict under ``'g_params'``, running statistics included) or
``exsr``'s ``g_params`` exported as ``.npz``
(:func:`exsr_torch.train.checkpoints.load_exsr_npz`).  Without one the
generator runs on seeded random weights.  Each (image, QF) decodes its Z
samples and GIF frames in one batch under ``torch.no_grad()`` on the
device and moves the results to the host once; ``time_s`` is that
decode's time (the optimiser's, in the optimizer modes).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

OPTIMIZER_MODES = {'desired_im': 'l1', 'undesired_im': 'max_l1',
                   'max_std': 'max_STD', 'min_std': 'min_STD'}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data_dir', required=True)
    p.add_argument('--qf', type=int, nargs='+', default=[10])
    p.add_argument('--nf', type=int, default=320)
    p.add_argument('--nb', type=int, default=10)
    p.add_argument('--latent_channels', type=int, default=64)
    p.add_argument('--checkpoint',
                   help="a directory of the port's checkpoints, or exsr's "
                        'g_params exported as .npz')
    p.add_argument('--step', type=int, default=None,
                   help='checkpoint step to load (default: latest)')
    p.add_argument('--out_dir', default='results_jpeg')
    p.add_argument('--max_images', type=int, default=None)
    p.add_argument('--num_z', type=int, default=1,
                   help='Z samples of the diversity sweep: Z=0 and '
                        'num_z-1 random uniform Zs, constant over the image '
                        'per channel; reports the per-pixel STD across the '
                        'decodings')
    p.add_argument('--latent', default='rand_uniform',
                   choices=['rand_uniform', *OPTIMIZER_MODES],
                   help='eval-time latent mode: the *_im and *_std modes '
                        'optimise Z per image (toward or away from the '
                        'uncompressed Y, or to an STD extremum) before '
                        'scoring')
    p.add_argument('--num_z_iters', type=int, default=250,
                   help='Z-optimisation iterations of the optimizer modes')
    p.add_argument('--save_images', action='store_true',
                   help='save the decoded Y images (plain JPEG and the '
                        'model decode) per image and QF')
    p.add_argument('--z_sweep_gif', type=int, default=0, metavar='N',
                   help='export an N-frame GIF sweeping the first 3-channel '
                        'Z control from -1 to 1 per image (the latent '
                        'channels tiled from it)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the current CUDA device); "
                        "'cpu' runs on the CPU")
    return p


def load_generator_params(checkpoint: str, step: int | None = None) -> dict:
    """The DnCNN's state dict from ``checkpoint``: ``exsr``'s ``g_params``
    as ``.npz`` (through :func:`~exsr_torch.models.convert.
    dncnn_from_exsr_vars`) or a directory of the port's checkpoints
    (``step``'s ``'g_params'``, the latest when None)."""
    from exsr_torch.models.convert import dncnn_from_exsr_vars
    from exsr_torch.train.checkpoints import CheckpointManager, load_exsr_npz
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f'no checkpoint at {checkpoint}')
    if checkpoint.endswith('.npz'):
        return dncnn_from_exsr_vars(load_exsr_npz(checkpoint))
    return CheckpointManager(checkpoint).restore_raw(step)['g_params']


def _sweep_zs(num_z: int, zshape, seed: int) -> list:
    """Z = 0, then ``num_z - 1`` uniform draws, each constant over the
    image per channel, from ``default_rng(seed)``."""
    zs = [np.zeros(zshape, np.float32)]
    rng = np.random.default_rng(seed)
    for _ in range(num_z - 1):
        v = rng.uniform(-1, 1, (1, 1, 1, zshape[-1]))
        zs.append(np.broadcast_to(v, zshape).astype(np.float32))
    return zs


def _gif_zs(frames: int, zshape) -> list:
    """The first 3-channel control swept from -1 to 1, tiled onto the
    latent channels."""
    from exsr_torch.train.decomp import repeat_z_3_channels
    zs = []
    for v in np.linspace(-1.0, 1.0, frames):
        z3 = torch.zeros(1, 1, 1, 3)
        z3[..., 0] = float(v)
        z = repeat_z_3_channels(z3, zshape[-1]).numpy()
        zs.append(np.broadcast_to(z, zshape).astype(np.float32))
    return zs


def _save_png(arr: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def main(argv=None):
    args = _parser().parse_args(argv)
    from exsr_torch.data.datasets import list_images, read_img
    from exsr_torch.device import full_fp32, resolve_device
    from exsr_torch.jpeg.codec import JPEGCodec
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    from exsr_torch.utils.color import rgb2ycbcr
    from exsr_torch.utils.metrics import calculate_psnr

    device = resolve_device(args.device)
    codec = JPEGCodec()
    g = DnCNN(DnCNNConfig(n_channels=args.nf, depth=args.nb,
                          num_latent_channels=args.latent_channels), seed=0)
    if args.checkpoint:
        g.load_state_dict(load_generator_params(args.checkpoint, args.step))
        print(f'loaded generator from {args.checkpoint}')
    g = g.to(device).eval().requires_grad_(False)

    opt_objective = OPTIMIZER_MODES.get(args.latent)
    session = None
    if opt_objective:
        from exsr_torch.apps.jpeg_session import JPEGEditSession
        session = JPEGEditSession(nf=args.nf, nb=args.nb,
                                  latent_channels=args.latent_channels,
                                  device=device)
        session.load_params(g)

    paths = list_images(args.data_dir)
    if args.max_images:
        paths = paths[:args.max_images]
    os.makedirs(args.out_dir, exist_ok=True)
    nz = max(1, args.num_z)
    gif = (args.z_sweep_gif if args.z_sweep_gif > 1
           and args.latent_channels > 0 and not opt_objective else 0)
    results = []
    for img_idx, path in enumerate(paths):
        img = read_img(path)
        y = rgb2ycbcr(img.astype(np.float32), only_y=True) * 255.0
        h, w = (y.shape[0] // 8) * 8, (y.shape[1] // 8) * 8
        y = y[:h, :w][None, ..., None].astype(np.float32)
        base = os.path.splitext(os.path.basename(path))[0]
        for qf in args.qf:
            qf_arr = torch.tensor([float(qf)], device=device)
            t0 = time.perf_counter()
            with torch.no_grad(), full_fp32():
                comp = codec.compress(torch.as_tensor(y, device=device),
                                      qf_arr, quantize=True)
                plain_dev = codec.extract(comp, qf_arr)
            rec = {'name': os.path.basename(path), 'qf': qf}
            decoded_y = frames = None
            if opt_objective:
                # per-image Z optimisation before scoring
                session.open_image(img[:h, :w], qf=qf)
                data = ({'desired': session.y_image / 255.0}
                        if 'l1' in opt_objective else {})
                res = session.optimize(opt_objective, data=data,
                                       max_iters=args.num_z_iters)
                plain = plain_dev.cpu().numpy()
                rec['time_s'] = time.perf_counter() - t0
                decoded_y = session.out[0, ..., 0] * 255.0
                rec['psnr_decomp'] = calculate_psnr(decoded_y, y[0, ..., 0])
                losses = np.asarray(res['losses'])
                losses = losses[np.isfinite(losses)]
                if losses.size:
                    rec['final_loss'] = float(losses[-1])
            else:
                zshape = comp.shape[:3] + (args.latent_channels,)
                zs = _sweep_zs(nz, zshape, img_idx * 1009 + qf)
                if gif:
                    zs += _gif_zs(gif, zshape)
                n = len(zs)
                with torch.no_grad(), full_fp32():
                    comp_b = comp.repeat(n, 1, 1, 1)
                    coeffs = g(comp_b, torch.as_tensor(np.concatenate(zs),
                                                       device=device))
                    out = codec.extract(coeffs, qf_arr)
                    bins = torch.abs(coeffs[:nz] - comp_b[:nz]).max()
                    # one transfer: plain decode, outputs, bin consistency
                    host = torch.cat([plain_dev.reshape(-1), out.reshape(-1),
                                      bins.reshape(1)]).cpu().numpy()
                rec['time_s'] = time.perf_counter() - t0
                plain = host[:h * w].reshape(1, h, w, 1)
                out = host[h * w:-1].reshape(n, h, w, 1)
                decoded_y = out[0, ..., 0]
                rec['psnr_decomp'] = calculate_psnr(decoded_y, y[0, ..., 0])
                rec['bin_consistency_max'] = float(host[-1])
                if nz > 1:
                    # pixel-space diversity across the Z samples
                    rec['per_pixel_std'] = float(out[:nz].std(axis=0).mean())
                frames = out[nz:, ..., 0]
            rec['psnr_jpeg'] = calculate_psnr(plain[0, ..., 0], y[0, ..., 0])
            if gif:
                from PIL import Image
                ims = [Image.fromarray(np.clip(f, 0, 255).astype(np.uint8))
                       for f in frames]
                ims[0].save(os.path.join(args.out_dir,
                                         f'{base}_qf{qf}_Zsweep.gif'),
                            save_all=True, append_images=ims[1:],
                            duration=150, loop=0)
            if args.save_images:
                _save_png(plain[0, ..., 0],
                          os.path.join(args.out_dir, f'{base}_qf{qf}_jpeg.png'))
                _save_png(decoded_y, os.path.join(
                    args.out_dir, f'{base}_qf{qf}_decomp.png'))
            results.append(rec)
            print(json.dumps(rec))
    summary = {}
    for key in ('psnr_jpeg', 'psnr_decomp', 'per_pixel_std', 'final_loss'):
        vals = [r[key] for r in results if key in r]
        if vals:
            summary[f'avg_{key}'] = float(np.mean(vals))
    with open(os.path.join(args.out_dir, 'summary.json'), 'w') as f:
        json.dump({'summary': summary, 'per_image': results}, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
