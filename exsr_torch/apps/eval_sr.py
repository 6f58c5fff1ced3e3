"""Batch evaluation CLI of the explorable generator.

Counterpart of ``exsr/apps/eval_sr.py``.  Per test image it computes the SR
output at the scored Z (PSNR and SSIM against the ground truth, border
cropped), its LR consistency (the mean ``|imresize(SR, 1/scale) - LR|``
inside the CEM's margins), and across a sweep of Z samples the per-pixel
standard deviation (diversity) and the high-frequency deviations of the
ground truth and of the SR outputs.  The optimizer latent modes instead
optimize Z per image through :class:`exsr_torch.apps.session.EditSession`.

Usage::

  python -m exsr_torch.apps.eval_sr --hr_dir DIR [--lr_dir DIR] --scale 4 \\
      [--checkpoint CKPT] [--num_z 1] [--out_dir results] [--save_images]

It runs on the current CUDA device unless ``--device cpu`` is given.
``--checkpoint`` is a directory of the port's checkpoints
(:class:`exsr_torch.train.checkpoints.CheckpointManager`, its
``'g_params'``) or an ``exsr`` generator exported as ``.npz``
(:func:`exsr_torch.train.checkpoints.load_exsr_npz`).  Without one the
generator runs on seeded random weights (PSNR then reflects the CEM's
analytic low-frequency reconstruction only).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.models.classifiers import MSRResNet, SRResNet
from exsr_torch.models.convert import from_exsr_flat_params, \
    from_exsr_params
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.models.rrdb_fast import pack_grouped_params, \
    rrdbnet_apply_fast
from exsr_torch.train.checkpoints import CheckpointManager, load_exsr_npz
from exsr_torch.utils.serve import best_bucket, pad_batch

PLAIN_ARCHS = {'MSRResNet': MSRResNet, 'sr_resnet': SRResNet}


def load_generator_params(checkpoint: str, arch: str = 'RRDB_net') -> dict:
    """The generator's state dict from ``checkpoint``: an ``exsr`` ``.npz``
    (through the weight bridge of ``arch``) or a directory of the port's
    checkpoints (the latest step's ``'g_params'``)."""
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f'no checkpoint at {checkpoint}')
    if checkpoint.endswith('.npz'):
        tree = load_exsr_npz(checkpoint)
        if arch in PLAIN_ARCHS:
            return from_exsr_flat_params(tree)
        return from_exsr_params(tree)
    return CheckpointManager(checkpoint).restore()['g_params']


def build_model(scale: int, nb: int = 23, latent_channels: int = 3,
                nf: int = 64, device=None, dtype=torch.float32, *,
                params=None, checkpoint: str | None = None,
                upscale_kernel=None, arch: str = 'RRDB_net',
                use_cem: bool = True):
    """Build the CEM and the serving forward: ``(cem, forward)``.

    ``forward(lr, z_hr)`` takes NHWC ``lr`` ``[N, h, w, 3]`` and
    ``z_hr`` ``[N, h*scale, w*scale, latent_channels]`` (arrays or
    tensors) and returns the output clipped to [0, 1], as an fp32 tensor
    on ``device``.  ``arch`` is ``exsr``'s vocabulary: ``'RRDB_net'``, the
    explorable generator, runs the grouped trunk in ``dtype`` (fp32 by
    default, as ``exsr``'s ``build_model``; bf16 for fast serving) with
    the stage-4 epilogue kernel; ``'MSRResNet'`` and ``'sr_resnet'`` are the
    plain generators, with ``latent_channels == 0`` (their forward ignores
    ``z_hr``).  With ``use_cem`` the generator is CEM-wrapped: the fp32 CEM
    chain through the separable filter kernels, the inputs replicate-padded
    by the CEM's invalidity margins (``pre_pad``), for the downscaling
    kernel ``upscale_kernel`` (``CEM.create``'s: None for bicubic, an
    estimated ndarray, or ``'blurry_cubic_<sigma>'``); without it ``cem``
    is None and the bare generator's output is clipped.  The forward runs
    with TF32 off (:func:`exsr_torch.device.full_fp32`): fp32 convolutions
    in full fp32, whatever the process's flags.

    Weights are ``params`` (the port's module or a state dict, e.g. from
    :mod:`exsr_torch.models.convert`), else ``checkpoint``
    (:func:`load_generator_params`), else random weights from seed 0.
    """
    device = resolve_device(device)
    nz = latent_channels
    cem = CEM.create(CEMConf(scale_factor=scale),
                     upscale_kernel=upscale_kernel) if use_cem else None
    if params is None and checkpoint is not None:
        params = load_generator_params(checkpoint, arch)
    if arch in PLAIN_ARCHS:
        if nz != 0:
            raise ValueError(f'{arch} has no latent input: pass '
                             'latent_channels=0')
        net = PLAIN_ARCHS[arch](nf=nf, nb=nb, upscale=scale)
        if params is not None:
            net.load_state_dict(params.state_dict()
                                if isinstance(params, torch.nn.Module)
                                else params)
        net = net.to(device).requires_grad_(False)
        weights = None

        def g_apply(_, x, z):
            return net(x.to(dtype)).float()
    elif arch == 'RRDB_net':
        if params is None:
            params = RRDBNet(nf=nf, nb=nb, upscale=scale,
                             latent_channels=nz)
        state = params.state_dict() \
            if isinstance(params, torch.nn.Module) else params
        weights = pack_grouped_params(
            {k: v.to(device) for k, v in state.items()}, dtype=dtype)

        def g_apply(pk, x, z):
            return rrdbnet_apply_fast(None, x, z if nz else None,
                                      upscale=scale, dtype=dtype, packed=pk)
    else:
        raise ValueError(f'unknown arch {arch!r}: RRDB_net, MSRResNet or '
                         'sr_resnet')
    if use_cem:
        wrapped = cem_wrap(g_apply, cem.device_filters(3, device=device),
                           upscale=scale)

        def run(lr, z_hr):
            return wrapped(weights, lr, z_hr, cem.invalidity_margins_lr,
                           pre_pad=True)
    else:
        def run(lr, z_hr):
            return g_apply(weights, lr, z_hr)

    @torch.inference_mode()
    def forward(lr, z_hr=None):
        lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
        if z_hr is not None:
            z_hr = torch.as_tensor(z_hr, dtype=torch.float32, device=device)
        with full_fp32():
            return run(lr, z_hr).clamp(0.0, 1.0)

    return cem, forward


#: --latent modes realized by per-image Z optimization, mapped to the
#: session's objectives ('undesired' and 'max' maximize the distance)
OPTIMIZER_MODES = {
    'desired_im': 'l1', 'undesired_im': 'max_l1',
    'desired_im_vgg': 'VGG', 'undesired_im_vgg': 'max_VGG',
    'desired_im_hist': 'hist',
    'max_std': 'max_STD', 'min_std': 'min_STD',
}


def sweep_values(mode: str, num: int, z_range: float = 1.0) -> list:
    """Symmetric single-channel sweep values, 0 included; the Gaussian
    spacing covers ``z_range`` of the probability mass."""
    if mode == 'uniform_sweep':
        half = list(np.linspace(-z_range, 0.0, int(np.ceil(num / 2))))[:-1]
        return half + [0.0] + [-v for v in half[::-1]]
    from scipy.stats import norm
    optional = np.arange(-2.0, 0.0, 0.001)
    keep = np.argwhere(norm.cdf(optional) >= (1 - z_range) / 2)
    optional = optional[int(keep[0][0]):]
    n_half = int((num - 1) / 2)
    if n_half == 0:       # num <= 2: the 0 sample alone
        return [0.0]
    half = [float(optional[int(i * len(optional) / n_half)])
            for i in range(n_half)]
    return half + [0.0] + [-v for v in half[::-1]]


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


def build_zs(args, hr_hw, rng, nz: int = 3):
    """Z samples of the non-optimizer latent modes, and the index of the
    sample that PSNR and SSIM score (the swept value 0)."""
    h, w = hr_hw
    shape = (1, h, w, max(nz, 1))
    if args.latent == 'rand_uniform':
        # constant over the image per channel: the diversity statistics
        # measure global latent shifts, not spatial noise
        zs = [np.zeros(shape, np.float32)]
        for _ in range(args.num_z - 1):
            v = rng.uniform(-1, 1, size=(1, 1, 1, shape[-1]))
            zs.append(np.broadcast_to(v, shape).astype(np.float32))
        return zs, 0
    if args.latent in ('uniform_sweep', 'gaussian_sweep'):
        vals = sweep_values(args.latent, args.num_z)
        zs = []
        for v in vals:
            z = np.full(shape, args.other_channels_val, np.float32)
            z[..., args.latent_channel] = v
            zs.append(z)
        return zs, vals.index(0.0)
    if args.latent == 'unit_circle':
        # theta sweep onto channels (1, 2) as (cos, sin)
        if nz < 3:
            raise ValueError('unit_circle needs a 3-channel latent')
        thetas = np.linspace(0.0, 2 * np.pi * (args.num_z - 1)
                             / max(args.num_z, 1), args.num_z)
        zs = []
        for t in thetas:
            z = np.full(shape, args.other_channels_val, np.float32)
            z[..., 1] = np.cos(t)
            z[..., 2] = np.sin(t)
            zs.append(z)
        return zs, 0
    if args.latent == 'z_image':
        if not args.z_image:
            raise ValueError('--latent z_image needs --z_image')
        if nz not in (1, 3):
            raise ValueError('z_image takes 1- or 3-channel latents')
        from exsr_torch.data.datasets import read_img
        from exsr_torch.utils.misc import im_to_z_input
        paths = ([os.path.join(args.z_image, f)
                  for f in sorted(os.listdir(args.z_image))]
                 if os.path.isdir(args.z_image) else [args.z_image])
        zs = [im_to_z_input(read_img(p), (h, w),
                            single_channel=nz == 1)[None] for p in paths]
        return zs, 0
    raise ValueError(args.latent)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--hr_dir', help='ground-truth HR image dir')
    p.add_argument('--lr_dir', help='LR dir (default: synthesize from HR)')
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--nb', type=int, default=23)
    p.add_argument('--nf', type=int, default=64)
    p.add_argument('--latent_channels', type=int, default=3,
                   help='generator latent (Z) channels; must match the '
                        'checkpoint being evaluated')
    p.add_argument('--checkpoint',
                   help="a directory of the port's checkpoints, or an exsr "
                        'generator exported as .npz')
    p.add_argument('--num_z', type=int, default=1,
                   help='Z samples for the diversity sweep')
    p.add_argument('--latent', default='rand_uniform',
                   choices=['rand_uniform', 'uniform_sweep',
                            'gaussian_sweep', 'unit_circle', 'z_image',
                            *OPTIMIZER_MODES],
                   help='eval-time latent distribution: rand_uniform = Z=0 '
                        'and random samples; uniform_sweep / gaussian_sweep'
                        ' = symmetric sweep of one Z channel; unit_circle ='
                        ' (cos, sin) sweep on channels 1-2; z_image = Z maps'
                        ' from images; desired_im*/max_std/min_std = '
                        'per-image Z optimization')
    p.add_argument('--latent_channel', type=int, default=0,
                   help='swept channel of the sweep modes')
    p.add_argument('--other_channels_val', type=float, default=0.0,
                   help='value of the channels not swept')
    p.add_argument('--z_image',
                   help='image file or dir for --latent z_image')
    p.add_argument('--desired_im',
                   help='desired image of the desired_im* modes; defaults '
                        'to the ground-truth HR (how closely the consistent'
                        ' manifold can reach it)')
    p.add_argument('--num_z_iters', type=int, default=250,
                   help='Z-optimization iterations of the optimizer modes')
    p.add_argument('--out_dir', default='results')
    p.add_argument('--save_images', action='store_true')
    p.add_argument('--save_std_map', action='store_true',
                   help='with --save_images and num_z > 1, also save the '
                        'normalized per-pixel diversity heatmap')
    p.add_argument('--max_images', type=int, default=None)
    p.add_argument('--z_sweep_gif', type=int, default=0, metavar='N',
                   help='export an N-frame GIF sweeping Z channel 0 from -1 '
                        'to 1 per image')
    p.add_argument('--kernel', choices=['bicubic', 'estimated'],
                   default='bicubic',
                   help="'estimated' estimates the kernel per image with "
                        'KernelGAN and rebuilds the CEM around it')
    p.add_argument('--kernelgan_iters', type=int, default=3000)
    p.add_argument('--opt', help='reference-style test options JSON: fills '
                                 'scale, nb, nf, the latent channels, the '
                                 'architecture and the data roots; explicit '
                                 'flags win')
    p.add_argument('--device', default=None,
                   help="torch device (default: the current CUDA device); "
                        "'cpu' runs on the CPU")
    return p


def _apply_opt(args, argv):
    """``(arch, use_cem, nf, nz)`` with ``--opt``'s values filled into
    ``args`` where no flag gave them."""
    arch, use_cem, nf, nz = 'RRDB_net', True, args.nf, args.latent_channels
    if not args.opt:
        return arch, use_cem, nf, nz
    from exsr_torch.options.config import num_latent_channels
    from exsr_torch.options.config import parse as parse_opt
    opt = parse_opt(args.opt, is_train=False)
    given = {a[2:].split('=')[0]
             for a in (argv if argv is not None else sys.argv[1:])
             if a.startswith('--')}
    if 'scale' not in given and opt['scale']:
        args.scale = int(opt['scale'])
    if 'nb' not in given and opt['network_G'] and opt['network_G']['nb']:
        args.nb = int(opt['network_G']['nb'])
    if not args.hr_dir and not args.lr_dir and opt['datasets']:
        first = next(iter(opt['datasets'].values()))
        args.hr_dir = first.get('dataroot_HR')
        args.lr_dir = first.get('dataroot_LR')
    # the configured generator: the plain ESRGAN / SRResNet variants
    # evaluate without the CEM and without Z
    g_opt = opt['network_G'] or {}
    arch = g_opt['which_model_G'] or 'RRDB_net'
    cem_flag = g_opt['CEM_arch']
    if cem_flag is None:
        cem_flag = g_opt['DTE_arch']  # the key's older name
    use_cem = bool(1 if cem_flag is None else cem_flag)
    if 'latent_channels' not in given:
        nz_opt = g_opt['latent_channels']
        if g_opt['latent_input'] == 'None':
            nz_opt = 0
        if nz_opt is not None:
            nz = num_latent_channels(nz_opt)
    if g_opt['nf'] and 'nf' not in given:
        nf = int(g_opt['nf'])
    return arch, use_cem, nf, nz


def _desired(args, item, hr_hw, objective):
    """The optimizer's data: the desired image (``--desired_im`` resized
    to the HR size, or the ground truth)."""
    if not any(k in objective for k in ('l1', 'VGG', 'hist')):
        return {}
    if args.desired_im:
        from scipy.ndimage import zoom
        from exsr_torch.data.datasets import read_img
        d = read_img(args.desired_im)
        d = zoom(d, (hr_hw[0] / d.shape[0], hr_hw[1] / d.shape[1], 1),
                 order=1)[:hr_hw[0], :hr_hw[1]]
    else:
        if 'hr' not in item:
            raise ValueError('desired_im modes need --desired_im or a '
                             'ground-truth HR')
        d = item['hr']
    return {'desired': [d]} if objective == 'hist' else {'desired': d[None]}


def _save_png(arr: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(arr).save(path)


def main(argv=None):
    args = _parser().parse_args(argv)
    arch, use_cem, nf, nz = _apply_opt(args, argv)
    if nz == 0:
        if args.latent != 'rand_uniform':
            raise ValueError('latent modes need a latent-input generator')
        args.num_z = 1
    device = resolve_device(args.device)

    from exsr_torch.data.datasets import LRDataset, LRHRDataset
    from exsr_torch.kernelgan.kernelgan import estimate_sr_kernel
    from exsr_torch.ops.resize import imresize
    from exsr_torch.utils.color import tensor2img
    from exsr_torch.utils.metrics import (calculate_psnr, calculate_ssim,
                                          crop_border)

    opt_objective = OPTIMIZER_MODES.get(args.latent)
    if opt_objective and not args.z_sweep_gif:
        # the EditSession below scores; no generator forward is needed
        cem, forward = CEM.create(CEMConf(scale_factor=args.scale)), None
    else:
        cem, forward = build_model(args.scale, args.nb, latent_channels=nz,
                                   nf=nf, device=device,
                                   checkpoint=args.checkpoint, arch=arch,
                                   use_cem=use_cem)
    session = None
    if opt_objective:
        if args.kernel == 'estimated':
            raise ValueError('optimizer latent modes use the bicubic CEM')
        if not (use_cem and arch == 'RRDB_net'):
            raise ValueError('optimizer latent modes need the CEM-wrapped '
                             'explorable RRDB generator')
        from exsr_torch.apps.session import EditSession
        session = EditSession(scale=args.scale, nb=args.nb, nf=nf,
                              latent_channels=nz, device=device)
        if args.checkpoint:
            session.load_params(load_generator_params(args.checkpoint))
        else:
            session.init_random_params(0)
        if 'VGG' in opt_objective:
            # the feature net of the VGG-space distance, on seeded random
            # weights (models/vgg.py load_torch_vgg19_features converts
            # pretrained ones)
            from exsr_torch.models.vgg import VGG19Features
            session.vgg_apply = VGG19Features(seed=1).to(device)

    if args.hr_dir:
        ds = LRHRDataset(hr_root=args.hr_dir, lr_root=args.lr_dir,
                         scale=args.scale, train=False, patch_size=None)
    elif args.lr_dir:
        ds = LRDataset(args.lr_dir)
    else:
        raise ValueError('need --hr_dir or --lr_dir')
    os.makedirs(args.out_dir, exist_ok=True)

    results = []
    n = len(ds) if args.max_images is None else min(len(ds), args.max_images)
    for i in range(n):
        item = ds[i]
        lr = item['lr'][None]
        name = os.path.splitext(os.path.basename(item['path']))[0]
        cem_i, fwd = cem, forward
        if args.kernel == 'estimated':
            # the image's blind kernel, and the CEM rebuilt around it
            cem_i, fwd = build_model(
                args.scale, args.nb, latent_channels=nz, nf=nf,
                device=device, checkpoint=args.checkpoint,
                upscale_kernel=estimate_sr_kernel(
                    item['lr'], args.scale, args.kernelgan_iters, device))
        t0 = time.time()
        hr_hw = (lr.shape[1] * args.scale, lr.shape[2] * args.scale)
        rec = {'name': name}
        if opt_objective:
            session.open_image(item['lr'], is_hr=False)
            res = session.optimize(
                opt_objective, data=_desired(args, item, hr_hw,
                                             opt_objective),
                max_iters=args.num_z_iters, time_budget_s=1e9)
            outs = [torch.as_tensor(session.sr, device=device)]
            psnr_idx = 0
            rec['final_loss'] = float(res['final_loss'])
        else:
            rng = np.random.default_rng(i)
            zs, psnr_idx = build_zs(args, hr_hw, rng, nz=nz)
            outs = bucketed_sweep(fwd, lr, zs)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        sr0 = tensor2img(outs[psnr_idx])
        rec['time_s'] = dt
        if 'hr' in item:
            gt = tensor2img(item['hr'][None])
            b = args.scale
            rec['psnr'] = calculate_psnr(
                crop_border(sr0.astype(np.float64), b),
                crop_border(gt.astype(np.float64), b))
            rec['ssim'] = calculate_ssim(
                crop_border(sr0.astype(np.float64), b),
                crop_border(gt.astype(np.float64), b))
        # LR consistency of imresize(SR) inside the invalidity margins,
        # clamped so that a tiny image keeps >= 1 pixel: only the
        # CEM-wrapped generator carries the guarantee
        if use_cem:
            sr_host = outs[psnr_idx][0].cpu().numpy()
            down = imresize(sr_host.astype(np.float64), 1.0 / args.scale)
            m = max(int(cem_i.invalidity_margins_lr), 1)
            m = min(m, (min(down.shape[0], down.shape[1]) - 1) // 2)
            m = max(m, 1)
            if down.shape[0] > 2 * m and down.shape[1] > 2 * m:
                rec['consistency_mae'] = float(
                    np.mean(np.abs(down - item['lr'])[m:-m, m:-m]))
        if len(outs) > 1:
            stack = torch.cat(outs).double()
            std_map = stack.std(0, unbiased=False)
            rec['per_pixel_std'] = float(std_map.mean())
            if 'hr' in item and use_cem:
                # the ground truth's and the outputs' deviation from the
                # projection onto the space orthogonal to the null space:
                # the component that exploring Z can vary
                proj = cem_i.project_2_ortho_2_ns(
                    item['hr'].astype(np.float64))
                rec['hr_std'] = float(
                    255 * (item['hr'] - proj).std(axis=(0, 1)).mean())
                hf = stack - torch.as_tensor(proj, device=device)
                rec['sr_high_freq_std'] = float(
                    255 * hf.std(0, unbiased=False).mean())
        results.append(rec)
        if args.save_images:
            _save_png(sr0, os.path.join(args.out_dir, f'{name}_SR.png'))
            if len(outs) > 1 and args.save_std_map:
                # the per-pixel diversity heatmap, normalized
                sm = std_map.mean(-1)
                sm = (sm / max(float(sm.max()), 1e-12)).cpu().numpy()
                _save_png((sm * 255).round().astype('uint8'),
                          os.path.join(args.out_dir, f'{name}_STDmap.png'))
        if args.z_sweep_gif > 1 and nz > 0:
            from PIL import Image
            frames = []
            for v in np.linspace(-1.0, 1.0, args.z_sweep_gif):
                z = np.zeros((1,) + hr_hw + (nz,), np.float32)
                z[..., 0] = v
                frames.append(Image.fromarray(tensor2img(fwd(lr, z))))
            frames[0].save(
                os.path.join(args.out_dir, f'{name}_Zsweep.gif'),
                save_all=True, append_images=frames[1:], duration=150,
                loop=0)
        print(json.dumps(rec))

    summary = {'num_images': len(results)}
    for key in ('psnr', 'ssim', 'consistency_mae', 'per_pixel_std',
                'hr_std', 'sr_high_freq_std', 'final_loss'):
        vals = [r[key] for r in results if key in r]
        if vals:
            summary[f'avg_{key}'] = float(np.mean(vals))
    with open(os.path.join(args.out_dir, 'summary.json'), 'w') as f:
        json.dump({'summary': summary, 'per_image': results}, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
