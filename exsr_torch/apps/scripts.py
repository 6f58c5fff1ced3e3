"""Dataset preparation, checkpoint and result tooling.

Counterpart of ``exsr/apps/scripts.py``; subcommands (``python -m
exsr_torch.apps.scripts <cmd> ...``):

  extract_subimages   crop large HR images into training sub-images on a
                      sliding grid (a process pool)
  generate_mod_lr     HR cropped to a multiple of the scale + LR pairs
  gaussian_kernel     a Gaussian kernel as .npy
  net_interp          interpolate the generators of two of the port's
                      checkpoints into a new one
  make_gif            a GIF from a folder of frames
  color2gray          grey copies of a folder
  pack                pack a folder of images into one blob + index
  results_2_video     validation-progress animation of <step>_PSNR*.png
  fft_comparison      mean log-spectrum of a folder, or the log ratio of
                      two folders' spectra
  transfer_files      copy the files matching patterns into a new folder
  convert_torch_g     a reference generator .pth -> the port's checkpoint
  official_parity     convert a .pth, then eval_sr on an HR folder
  psnr_ssim           folder-against-folder PSNR / SSIM table
  export_g            the generator of a train_sr / train_jpeg checkpoint
                      -> a generator-only checkpoint

The checkpoints read and written are the port's
(:class:`exsr_torch.train.checkpoints.CheckpointManager`, the generator's
state dict under ``'g_params'``), which ``eval_sr --checkpoint``,
``eval_jpeg --checkpoint`` and ``web --checkpoint`` load; ``exsr``'s
``net_interp`` and ``export_g`` read numpy and Orbax trees instead.  Only
``official_parity`` runs a model: on the current CUDA device unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import re
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from exsr_torch.data.datasets import list_images


def _extract_one(args):
    """Worker of :func:`extract_subimages`: one image's crops; returns
    their count."""
    path, output_dir, crop_size, step, threshold = args
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im.convert('RGB'))
    h, w = img.shape[:2]
    if h < crop_size or w < crop_size:
        return 0
    name = os.path.splitext(os.path.basename(path))[0]
    ys = list(range(0, h - crop_size + 1, step))
    xs = list(range(0, w - crop_size + 1, step))
    if h - (ys[-1] + crop_size) > threshold:
        ys.append(h - crop_size)
    if w - (xs[-1] + crop_size) > threshold:
        xs.append(w - crop_size)
    n = 0
    for y in ys:
        for x in xs:
            n += 1
            Image.fromarray(img[y:y + crop_size, x:x + crop_size]).save(
                os.path.join(output_dir, f'{name}_s{n:03d}.png'))
    return n


def extract_subimages(input_dir, output_dir, crop_size=480, step=240,
                      threshold=48, workers=8):
    """Crop every image on a grid of ``step``, adding a last row or column
    flush with the border when more than ``threshold`` pixels would be
    left; images smaller than the crop are skipped."""
    os.makedirs(output_dir, exist_ok=True)
    paths = list_images(input_dir)
    jobs = [(p, output_dir, crop_size, step, threshold) for p in paths]
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context('spawn')) as ex:
        total = sum(ex.map(_extract_one, jobs))
    print(f'extracted {total} sub-images from {len(paths)} images')
    return total


def generate_mod_lr(input_dir, output_dir, scale=4):
    """HR images cropped to a multiple of ``scale`` and their LR images by
    the CEM's bicubic ``imresize``, as ``HRx<scale>/`` and
    ``LRx<scale>/``."""
    from PIL import Image
    from exsr_torch.data.datasets import read_img
    from exsr_torch.ops.resize import imresize
    from exsr_torch.utils.color import modcrop
    hr_dir = os.path.join(output_dir, f'HRx{scale}')
    lr_dir = os.path.join(output_dir, f'LRx{scale}')
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)
    for path in list_images(input_dir):
        name = os.path.basename(path)
        hr = modcrop(read_img(path), scale)
        lr = imresize(hr, 1.0 / scale)
        Image.fromarray((hr * 255).round().astype(np.uint8)).save(
            os.path.join(hr_dir, name))
        Image.fromarray(np.clip(lr * 255, 0, 255).round().astype(
            np.uint8)).save(os.path.join(lr_dir, name))
    print(f'wrote pairs to {output_dir}')


def gaussian_kernel(sigma, out_path):
    """A normalized 2-D Gaussian of ``sigma`` as ``.npy``."""
    from exsr_torch.ops.resize import gaussian_2d
    np.save(out_path, gaussian_2d(sigma))
    print(f'saved gaussian kernel sigma={sigma} to {out_path}')


def _latest_g(ckpt_dir: str) -> tuple[int, dict]:
    """``(step, 'g_params')`` of the newest step in a directory of the
    port's checkpoints."""
    from exsr_torch.train.checkpoints import CheckpointManager
    src = CheckpointManager(ckpt_dir)
    step = src.latest_step()
    if step is None:
        raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    return step, src.restore_raw(step)['g_params']


def _save_g(out_dir: str, step: int, g_params: dict) -> bool:
    from exsr_torch.train.checkpoints import CheckpointManager
    return CheckpointManager(out_dir).save(step, {'g_params': g_params},
                                           force=True)


def net_interp(ckpt_a, ckpt_b, alpha, out_dir):
    """``(1 - alpha) * A + alpha * B`` of the generators of two directories
    of the port's checkpoints (their newest steps), written as step 0 of
    a new one."""
    _, a = _latest_g(ckpt_a)
    _, b = _latest_g(ckpt_b)
    if set(a) != set(b):
        raise ValueError(f'{ckpt_a} and {ckpt_b} hold different '
                         'generators')
    out = {k: (1 - alpha) * a[k] + alpha * b[k] if a[k].is_floating_point()
           else a[k] for k in a}
    _save_g(out_dir, 0, out)
    print(f'interpolated (alpha={alpha}) -> {out_dir}')


def make_gif(frames_dir, out_path, duration_ms=200):
    """A looping GIF of a folder's images in name order."""
    from PIL import Image
    frames = [Image.open(p) for p in list_images(frames_dir)]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    print(f'wrote {len(frames)}-frame GIF to {out_path}')


def color2gray(input_dir, output_dir):
    """Grey (PIL ``'L'``) copies of a folder's images."""
    from PIL import Image
    os.makedirs(output_dir, exist_ok=True)
    for p in list_images(input_dir):
        with Image.open(p) as im:
            im.convert('L').save(os.path.join(output_dir,
                                              os.path.basename(p)))
    print('done')


_STEP = re.compile(r'(\d)+(?=_PSNR)')


def results_2_video(images_dir, out_path, fps=5, blink_seconds=40):
    """Validation progress as an animated GIF: the ``<step>_PSNR*.png``
    frames in step order, each labelled with its step, then
    ``blink_seconds`` of the first and the final frame in turns."""
    from PIL import Image, ImageDraw

    names = [f for f in os.listdir(images_dir) if f.endswith('.png')
             and _STEP.search(f)]
    names.sort(key=lambda x: int(_STEP.search(x).group(0)))
    if not names:
        raise FileNotFoundError(f'no <step>_PSNR*.png frames in '
                                f'{images_dir}')

    def labeled(name, text):
        im = Image.open(os.path.join(images_dir, name)).convert('RGB')
        ImageDraw.Draw(im).text((4, 4), text, fill=(255, 255, 255))
        return im

    frames = [labeled(n, _STEP.search(n).group(0)) for n in names]
    first = frames[0]
    final = labeled(names[-1], f'Final ({_STEP.search(names[-1]).group(0)})')
    for sec in range(blink_seconds):
        frames.extend([final if sec % 2 else first] * fps)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    print(f'wrote {len(frames)}-frame video to {out_path}')


def fft_comparison(folder_a, out_path, folder_b=None):
    """Mean log-spectrum ``log|FFT|`` of a folder's grey images, or, with
    ``folder_b``, the mean log ratio of the spectra of images matched by
    their leading name; each spectrum is resized (bilinear, fp32) to the
    largest.  Writes ``.npz`` (``mean_log_spectrum``, ``scale``,
    ``n_images``) and a PNG heatmap; returns the mean spectrum."""
    import torch
    from PIL import Image
    from exsr_torch.ops.filters import bilinear_resize

    def key(p):
        return os.path.basename(p).split('.')[0].split('_')[0]

    by_name_b = ({key(p): p for p in list_images(folder_b)} if folder_b
                 else {})

    def gray(path):
        with Image.open(path) as im:
            return np.asarray(im.convert('L'), np.float64) / 255.0

    eps = np.finfo(np.float64).eps
    specs = []
    for p in list_images(folder_a):
        fa = np.abs(np.fft.fft2(gray(p)))
        if folder_b:
            if key(p) not in by_name_b:
                continue
            fb = np.abs(np.fft.fft2(gray(by_name_b[key(p)])))
            specs.append(np.log(fa / (eps + fb)))
        else:
            specs.append(np.log(np.maximum(fa, eps)))
    if not specs:
        raise FileNotFoundError('no comparable images found')
    h = max(s.shape[0] for s in specs)
    w = max(s.shape[1] for s in specs)
    resized = [bilinear_resize(torch.as_tensor(s, dtype=torch.float32)
                               [None, :, :, None], h, w)[0, :, :, 0].numpy()
               for s in specs]
    mean_spec = np.mean(np.stack(resized), 0)
    scale = np.percentile(np.abs(mean_spec), 99) or 1.0
    np.savez(out_path if out_path.endswith('.npz') else out_path + '.npz',
             mean_log_spectrum=mean_spec, scale=scale,
             n_images=len(resized))
    vis = np.fft.fftshift(mean_spec / scale)
    if folder_b:    # signed: red where B is stronger, green where A is
        rgb = np.stack([np.clip(-vis, 0, 1), np.clip(vis, 0, 1),
                        np.zeros_like(vis)], -1)
    else:
        v = np.clip((vis + 1) / 2, 0, 1)
        rgb = np.stack([v, v, v], -1)
    png = out_path.rsplit('.', 1)[0] + '.png'
    Image.fromarray((rgb * 255).astype(np.uint8)).save(png)
    print(f'wrote spectrum ({len(resized)} images) to {png}')
    return mean_spec


def transfer_files(source_dir: str, target_dir: str,
                   pattern: str = 's00.png,s00_LR.png'):
    """Copy the files whose names contain any of the comma-separated
    ``pattern`` into a new ``target_dir``; an existing one raises
    ``FileExistsError``.  Returns the count."""
    if os.path.isdir(target_dir):
        raise FileExistsError(f'target folder already exists: {target_dir}')
    pats = [p for p in pattern.split(',') if p]
    names = [n for n in sorted(os.listdir(source_dir))
             if any(p in n for p in pats)]
    os.makedirs(target_dir)
    for n in names:
        shutil.copyfile(os.path.join(source_dir, n),
                        os.path.join(target_dir, n))
    print(f'copied {len(names)} files to {target_dir}')
    return len(names)


def convert_torch_g(pth: str, out_dir: str, nb: int = 23,
                    latent_channels: int = 3, scale: int = 4,
                    nf: int = 64, gc: int = 32, arch: str = 'rrdb'):
    """A reference generator ``.pth`` -> step 0 of a directory of the
    port's checkpoints (``{'g_params'}``), which ``eval_sr --checkpoint``
    and ``web --checkpoint`` load.  ``arch``: ``'rrdb'`` (plain ESRGAN,
    whose Z input channels are zero-initialised, or a trained explorable
    generator) or ``'msrresnet'`` (``latent_channels`` 0).  Returns the
    state dict written."""
    from exsr_torch.models.convert import (align_params_to,
                                           convert_esrgan_rrdb,
                                           convert_msrresnet,
                                           load_torch_checkpoint)
    state = load_torch_checkpoint(pth)
    if arch == 'msrresnet':
        from exsr_torch.models.classifiers import MSRResNet
        if latent_channels != 0:
            raise ValueError('MSRResNet has no latent input: pass '
                             '--latent_channels 0')
        g = align_params_to(MSRResNet(nf=nf, nb=nb, upscale=scale),
                            convert_msrresnet(state, nf=nf, nb=nb,
                                              upscale=scale))
    elif arch == 'rrdb':
        from exsr_torch.models.rrdb import RRDBNet
        g = align_params_to(
            RRDBNet(nb=nb, nf=nf, gc=gc, upscale=scale,
                    latent_channels=latent_channels),
            convert_esrgan_rrdb(state, nb=nb,
                                latent_channels=latent_channels))
    else:
        raise ValueError(f"unknown arch {arch!r}: 'rrdb' or 'msrresnet'")
    params = g.state_dict()
    if not _save_g(out_dir, 0, params):
        raise FileExistsError(f'{out_dir} already holds step 0')
    n = sum(v.numel() for v in params.values())
    print(f'converted {pth} -> {out_dir} ({n:,} params)')
    return params


def official_parity(pth: str, hr_dir: str, out_dir: str, nb: int = 23,
                    latent_channels: int = 3, scale: int = 4,
                    nf: int = 64, gc: int = 32, num_z: int = 1,
                    max_images: int | None = None, device=None):
    """One command from the paper's released ``.pth`` to its PSNR / SSIM /
    consistency / diversity table: :func:`convert_torch_g` into
    ``out_dir/converted_ckpt``, then ``eval_sr`` at Z = 0 (and ``num_z -
    1`` random Zs) on a Set5-style HR folder; returns ``eval_sr``'s
    summary::

        python -m exsr_torch.apps.scripts official_parity \\
            --pth trained_model.pth --hr_dir Set5_HR --out results/parity
    """
    ckpt = os.path.join(out_dir, 'converted_ckpt')
    convert_torch_g(pth, ckpt, nb=nb, latent_channels=latent_channels,
                    scale=scale, nf=nf, gc=gc)
    from exsr_torch.apps import eval_sr
    argv = ['--hr_dir', hr_dir, '--checkpoint', ckpt,
            '--scale', str(scale), '--nb', str(nb), '--nf', str(nf),
            '--latent_channels', str(latent_channels),
            '--latent', 'rand_uniform', '--num_z', str(num_z),
            '--out_dir', out_dir]
    if max_images:
        argv += ['--max_images', str(max_images)]
    if device is not None:
        argv += ['--device', str(device)]
    return eval_sr.main(argv)


def psnr_ssim(gt_dir: str, gen_dir: str, crop: int = 4,
              y_only: bool = False, suffix: str = ''):
    """Folder-against-folder MATLAB-style PSNR / SSIM: each ground-truth
    image is matched by its base name (plus ``suffix``, ``.png``, ``.jpg``
    or ``.bmp``) in ``gen_dir``, its border of ``crop`` pixels cropped,
    optionally on the YCbCr Y channel only.  Returns ``(mean PSNR, mean
    SSIM)``."""
    from PIL import Image
    from exsr_torch.utils.color import rgb2ycbcr
    from exsr_torch.utils.metrics import calculate_psnr, calculate_ssim
    psnrs, ssims = [], []
    for i, name in enumerate(sorted(os.listdir(gt_dir))):
        base, _ = os.path.splitext(name)
        gen_path = next((c for c in (os.path.join(gen_dir, base + suffix
                                                  + ext)
                                     for ext in ('.png', '.jpg', '.bmp'))
                         if os.path.exists(c)), None)
        if gen_path is None:
            print(f'--- {base}: no Gen image, skipped')
            continue
        with Image.open(os.path.join(gt_dir, name)) as im:
            gt = np.asarray(im.convert('RGB'), np.float64) / 255.0
        with Image.open(gen_path) as im:
            gen = np.asarray(im.convert('RGB'), np.float64) / 255.0
        if y_only:
            gt, gen = rgb2ycbcr(gt), rgb2ycbcr(gen)
        if crop:
            gt = gt[crop:-crop, crop:-crop]
            gen = gen[crop:-crop, crop:-crop]
        psnrs.append(calculate_psnr(gt * 255, gen * 255))
        ssims.append(calculate_ssim(gt * 255, gen * 255))
        print(f'{i + 1:3d} - {base:25s}\tPSNR: {psnrs[-1]:.6f} dB, '
              f'\tSSIM: {ssims[-1]:.6f}')
    mp = float(np.mean(psnrs)) if psnrs else float('nan')
    ms = float(np.mean(ssims)) if ssims else float('nan')
    print(f'Average: PSNR: {mp:.6f} dB, SSIM: {ms:.6f}')
    return mp, ms


def export_g(train_ckpt: str, out_dir: str):
    """The generator (``'g_params'``) of the newest step of a ``train_sr``
    or ``train_jpeg`` checkpoint directory -> a generator-only checkpoint
    at the same step, which ``eval_sr`` / ``eval_jpeg`` / ``web`` load.
    Re-exporting after more training writes a new step; the same step
    again leaves it unchanged."""
    step, g_params = _latest_g(train_ckpt)
    n = sum(v.numel() for v in g_params.values())
    if not _save_g(out_dir, step, g_params):
        print(f'step {step} already exported in {out_dir}: unchanged')
    else:
        print(f'exported step-{step} generator ({n:,} params) -> {out_dir}')


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest='cmd', required=True)
    s = sub.add_parser('extract_subimages')
    s.add_argument('--input_dir', required=True)
    s.add_argument('--output_dir', required=True)
    s.add_argument('--crop_size', type=int, default=480)
    s.add_argument('--step', type=int, default=240)
    s = sub.add_parser('generate_mod_lr')
    s.add_argument('--input_dir', required=True)
    s.add_argument('--output_dir', required=True)
    s.add_argument('--scale', type=int, default=4)
    s = sub.add_parser('gaussian_kernel')
    s.add_argument('--sigma', type=float, required=True)
    s.add_argument('--out', required=True)
    s = sub.add_parser(
        'net_interp', help="interpolate two of the port's checkpoint "
                           'directories (not numpy files)')
    s.add_argument('--ckpt_a', required=True,
                   help="a directory of the port's checkpoints")
    s.add_argument('--ckpt_b', required=True,
                   help="a directory of the port's checkpoints")
    s.add_argument('--alpha', type=float, default=0.5)
    s.add_argument('--out', required=True,
                   help="the port's checkpoint directory to write")
    s = sub.add_parser('make_gif')
    s.add_argument('--frames_dir', required=True)
    s.add_argument('--out', required=True)
    s = sub.add_parser('color2gray')
    s.add_argument('--input_dir', required=True)
    s.add_argument('--output_dir', required=True)
    s = sub.add_parser('pack')
    s.add_argument('--input_dir', required=True)
    s.add_argument('--out', required=True)
    s = sub.add_parser('results_2_video')
    s.add_argument('--images_dir', required=True)
    s.add_argument('--out', required=True)
    s.add_argument('--fps', type=int, default=5)
    s.add_argument('--blink_seconds', type=int, default=40)
    s = sub.add_parser('fft_comparison')
    s.add_argument('--folder_a', required=True)
    s.add_argument('--folder_b')
    s.add_argument('--out', required=True)
    s = sub.add_parser('transfer_files')
    s.add_argument('--source_dir', required=True)
    s.add_argument('--target_dir', required=True)
    s.add_argument('--pattern', default='s00.png,s00_LR.png')
    for name in ('convert_torch_g', 'official_parity'):
        s = sub.add_parser(name)
        s.add_argument('--pth', required=True,
                       help='reference generator checkpoint (.pth; plain '
                            'ESRGAN or trained explorable, DataParallel or '
                            'CEM-wrapped keys accepted)')
        s.add_argument('--out', required=True,
                       help="the port's checkpoint directory to write "
                            '(eval_sr / web --checkpoint)' if name ==
                            'convert_torch_g' else 'results directory')
        s.add_argument('--nb', type=int, default=23)
        s.add_argument('--latent_channels', type=int, default=3)
        s.add_argument('--scale', type=int, default=4)
        s.add_argument('--nf', type=int, default=64)
        s.add_argument('--gc', type=int, default=32)
    s = sub.choices['convert_torch_g']
    s.add_argument('--arch', choices=['rrdb', 'msrresnet'], default='rrdb',
                   help="'rrdb' (ESRGAN / explorable) or 'msrresnet' "
                        '(needs --latent_channels 0)')
    s = sub.choices['official_parity']
    s.add_argument('--hr_dir', required=True,
                   help='Set5-style ground-truth HR folder')
    s.add_argument('--num_z', type=int, default=1)
    s.add_argument('--max_images', type=int, default=None)
    s.add_argument('--device', default=None,
                   help='torch device (default: the current CUDA device); '
                        "'cpu' runs on the CPU")
    s = sub.add_parser('psnr_ssim')
    s.add_argument('--gt_dir', required=True)
    s.add_argument('--gen_dir', required=True)
    s.add_argument('--crop_border', type=int, default=4)
    s.add_argument('--y_only', action='store_true')
    s.add_argument('--suffix', default='')
    s = sub.add_parser(
        'export_g', help="the generator of one of the port's train_sr / "
                         'train_jpeg checkpoint directories (not Orbax)')
    s.add_argument('--train_ckpt', required=True,
                   help="the port's train_sr / train_jpeg checkpoint "
                        'directory (EXP/ckpt)')
    s.add_argument('--out', required=True,
                   help="the port's checkpoint directory to write "
                        '(eval_sr / eval_jpeg / web --checkpoint)')
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd == 'extract_subimages':
        return extract_subimages(args.input_dir, args.output_dir,
                                 args.crop_size, args.step)
    if args.cmd == 'generate_mod_lr':
        return generate_mod_lr(args.input_dir, args.output_dir, args.scale)
    if args.cmd == 'gaussian_kernel':
        return gaussian_kernel(args.sigma, args.out)
    if args.cmd == 'net_interp':
        return net_interp(args.ckpt_a, args.ckpt_b, args.alpha, args.out)
    if args.cmd == 'make_gif':
        return make_gif(args.frames_dir, args.out)
    if args.cmd == 'color2gray':
        return color2gray(args.input_dir, args.output_dir)
    if args.cmd == 'pack':
        from exsr_torch.data.packed import pack_images
        n = pack_images(args.input_dir, args.out)
        print(f'packed {n} images into {args.out}')
        return n
    if args.cmd == 'results_2_video':
        return results_2_video(args.images_dir, args.out, args.fps,
                               args.blink_seconds)
    if args.cmd == 'fft_comparison':
        return fft_comparison(args.folder_a, args.out, args.folder_b)
    if args.cmd == 'transfer_files':
        return transfer_files(args.source_dir, args.target_dir, args.pattern)
    if args.cmd == 'convert_torch_g':
        return convert_torch_g(args.pth, args.out, args.nb,
                               args.latent_channels, args.scale, args.nf,
                               args.gc, args.arch)
    if args.cmd == 'official_parity':
        return official_parity(args.pth, args.hr_dir, args.out, args.nb,
                               args.latent_channels, args.scale, args.nf,
                               args.gc, args.num_z, args.max_images,
                               args.device)
    if args.cmd == 'psnr_ssim':
        return psnr_ssim(args.gt_dir, args.gen_dir, args.crop_border,
                         args.y_only, args.suffix)
    return export_g(args.train_ckpt, args.out)


if __name__ == '__main__':
    main()
