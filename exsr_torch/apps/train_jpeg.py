"""Explorable-JPEG training CLI.

Counterpart of ``exsr/apps/train_jpeg.py``.  The Y phase trains the DnCNN
generator against the DCT-domain critic
(:class:`exsr_torch.train.decomp.DecompTrainer`) on crops of the images
under ``--data_dir``, each at a quality factor drawn from
``[--qf_min, --qf_max]``, gated by the host controller's
``'initial_gradual'`` D verification (the JPEG recipe: the lax 0.1 share
of correctly distinguished images); the G steps run the dual MAP step once
the generator has started learning.  It validates at Z in {0, -0.5, 0.5}
with eval-mode batch norm (``psnr_val``, ``per_pix_STD_val``), keeps
checkpoints with the controller's state (``--resume``) and ``logs.npz``.
``--chroma`` trains the chroma generator conditioned on a frozen Y
generator (``--y_ckpt``: a directory of this CLI's checkpoints or
``exsr``'s ``g_params`` exported as ``.npz``; seeded random weights
without it) through :class:`exsr_torch.train.decomp_chroma.
ChromaDecompTrainer`.

Usage::

  python -m exsr_torch.apps.train_jpeg --data_dir DIR [--val_dir DIR] \\
      [--niter N] [--exp_dir EXP] [--resume]
  python -m exsr_torch.apps.train_jpeg --data_dir DIR --chroma --nf 160 \\
      --y_nf 320 --y_ckpt EXP/ckpt

It runs on the current CUDA device unless ``--device cpu`` is given, in
fp32 with TF32 off.  A Y checkpoint loads in ``eval_jpeg --checkpoint``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data_dir', required=True,
                   help='uncompressed training image dir')
    p.add_argument('--val_dir')
    p.add_argument('--patch', type=int, default=256)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--nf', type=int, default=320)
    p.add_argument('--nb', type=int, default=10)
    p.add_argument('--latent_channels', default='64')
    p.add_argument('--qf_min', type=int, default=5)
    p.add_argument('--qf_max', type=int, default=50)
    p.add_argument('--niter', type=int, default=2_000_000)
    p.add_argument('--exp_dir', default='experiments/explorable_jpeg')
    p.add_argument('--print_freq', type=int, default=100)
    p.add_argument('--val_freq', type=int, default=1000)
    p.add_argument('--ckpt_freq', type=int, default=1000)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--d_verification', default='initial_gradual',
                   choices=['past', 'current', 'convergence', 'initial',
                            'initial_gradual'],
                   help='the D verification that gates G steps; the JPEG '
                        "recipe's 'initial_gradual' lets G steps flow once "
                        'the D first verifies, and re-verifies over a '
                        '100x window before locking')
    p.add_argument('--min_d_correct', type=float, default=0.1,
                   help='the least share of correctly distinguished images '
                        'over the verification window (the JPEG recipe: '
                        '0.1)')
    p.add_argument('--chroma', action='store_true',
                   help='train the chroma generator conditioned on a '
                        '(frozen) Y generator')
    p.add_argument('--y_ckpt',
                   help="the conditioning Y generator: a directory of this "
                        "CLI's checkpoints or exsr's g_params as .npz; "
                        'seeded random Y weights when omitted')
    p.add_argument('--y_latent_channels', type=int, default=64,
                   help='latent width of the conditioning Y generator')
    p.add_argument('--y_nf', type=int, default=None,
                   help='width of the conditioning Y generator (default: '
                        '--nf); the chroma model trains at nf 160 under a '
                        '320-wide Y model')
    p.add_argument('--y_nb', type=int, default=None,
                   help='depth of the conditioning Y generator '
                        '(default: --nb)')
    p.add_argument('--device', default=None,
                   help="torch device; the current CUDA device by default, "
                        "'cpu' to train on the CPU")
    return p


def _ctl_snapshot(ctl) -> dict:
    # the initial / initial_gradual gate stays verified once it is: it
    # must survive a resume
    return {'step': ctl.step,
            'generator_started_learning': ctl.generator_started_learning,
            'verified_d_saved': ctl.verified_d_saved,
            'd_verified': ctl.d_verified}


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ('uncomp', 'qf')}


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.chroma:
        return _main_chroma(args)
    from exsr_torch.data.datasets import DataLoader, JPEGDataset
    from exsr_torch.device import full_fp32, resolve_device
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, \
        DnCNNDiscriminator
    from exsr_torch.train.checkpoints import CheckpointManager
    from exsr_torch.train.controller import GANController
    from exsr_torch.train.decomp import DecompConfig, DecompTrainer
    from exsr_torch.utils.logging import MetricLog
    from exsr_torch.utils.metrics import calculate_psnr
    from exsr_torch.utils.misc import (install_sigint_stop, read_scalars,
                                       stage_scalars)

    device = resolve_device(args.device)
    latent_channels = (int(args.latent_channels)
                       if args.latent_channels.isdigit()
                       else args.latent_channels)
    cfg = DecompConfig(patch_size=args.patch,
                       latent_channels=latent_channels, niter=args.niter)
    nz = cfg.num_latent_channels
    g = DnCNN(DnCNNConfig(n_channels=args.nf, depth=args.nb,
                          num_latent_channels=nz), seed=args.seed)
    d = DnCNNDiscriminator(n_channels=args.nf, depth=args.nb,
                           expected_input_size=args.patch // 8,
                           norm='layer', seed=args.seed + 1)
    trainer = DecompTrainer(cfg)
    state = trainer.init_state(g, d, seed=args.seed + 2, device=device)
    ctl = GANController(d_update_ratio=10, d_valid_steps_4_g=10,
                        d_verification=args.d_verification,
                        min_mean_d_correct=args.min_d_correct)
    os.makedirs(args.exp_dir, exist_ok=True)
    mlog = MetricLog()
    log_path = os.path.join(args.exp_dir, 'logs.npz')
    ckpts = CheckpointManager(os.path.join(args.exp_dir, 'ckpt'),
                              max_to_keep=3,
                              save_interval_steps=args.ckpt_freq)
    if args.resume and ckpts.latest_step() is not None:
        state, ctl_state = ckpts.restore(state, with_controller=True)
        ctl.step = int(state.step)
        if ctl_state:
            ctl.step = ctl_state['step']
            ctl.generator_started_learning = \
                ctl_state['generator_started_learning']
            ctl.verified_d_saved = ctl_state['verified_d_saved']
            ctl.d_verified = bool(ctl_state.get('d_verified', False))
        if os.path.exists(log_path):
            mlog.load(log_path, max_step=ctl.step)
        print('resumed at step', ctl.step)

    qf_spec = (((args.qf_min, args.qf_max), 1.0),)
    ds = JPEGDataset(root=args.data_dir, patch_size=args.patch,
                     qf_spec=qf_spec, train=True)
    loader = DataLoader(ds, batch_size=args.batch, seed=args.seed)
    val_ds = None
    if args.val_dir:
        val_ds = JPEGDataset(root=args.val_dir, patch_size=args.patch,
                             qf_spec=qf_spec, train=False)

    @full_fp32()
    def validate(state):
        """Each validation crop decoded at Z in {0, -0.5, 0.5} with
        eval-mode batch norm: the mean Y PSNR over the sweep and the
        per-pixel STD across it."""
        z_vals = [0.0, -0.5, 0.5] if nz else [0.0]
        psnrs, stds = [], []
        for i in range(min(len(val_ds), 8)):
            item = val_ds[i]
            uncomp = torch.from_numpy(item['uncomp'][None]).to(device)
            qf = torch.tensor([float(item['qf'])], device=device)
            comp = trainer.codec.compress(uncomp, qf, quantize=True)
            outs = []
            for zv in z_vals:
                z = torch.full(comp.shape[:3] + (nz,), zv, device=device)
                out = trainer.decode(state.g, comp, z, qf).clamp(0, 255)
                outs.append(out[0, :, :, 0].cpu().numpy())
                psnrs.append(calculate_psnr(outs[-1], item['uncomp'][:, :, 0]))
            if len(outs) > 1:
                stds.append(float(np.std(np.stack(outs), 0).mean()))
        rec = {'step': ctl.step,
               'psnr_val': round(float(np.mean(psnrs)), 4)}
        if stds:
            rec['per_pix_STD_val'] = round(float(np.mean(stds)), 5)
        print(json.dumps(rec))
        mlog.append(ctl.step, **{k: v for k, v in rec.items()
                                 if k != 'step'})

    t0 = time.time()
    log_accum = {}
    pending = (None, None)   # the staged (D, G) metrics of the last step

    def apply_pending():
        d_st, g_st = pending
        if d_st is not None:
            dm = read_scalars(d_st)
            ctl.record_d(dm)
            log_accum.update(dm)
        if g_st is not None:
            log_accum.update(read_scalars(g_st))
            ctl.record_g()

    # the first SIGINT stops at the next step boundary, after which the
    # final checkpoint is still written
    stop_requested = install_sigint_stop()
    for batch in loader.stream(0):
        if ctl.step >= cfg.niter or stop_requested():
            break
        batch = _to_device(batch, device)
        dual = (cfg.optimal_z_weight is not None
                and ctl.generator_started_learning)
        d_staged = g_staged = None
        if ctl.want_d_step():
            state, dm = trainer.d_step(state, batch, dual=dual)
            d_staged = stage_scalars(dm)
        if ctl.want_g_step():
            state, gm = trainer.g_step(state, batch, dual=dual,
                                       use_gan=True)
            g_staged = stage_scalars(gm)
        # the metrics of step t are read after step t + 1 is enqueued, so
        # the gating sees records one step later than a synchronous loop
        apply_pending()
        pending = (d_staged, g_staged)
        state = trainer.advance(state)
        ctl.tick()
        if ctl.step % args.print_freq == 0:
            rate = args.print_freq / max(time.time() - t0, 1e-9)
            t0 = time.time()
            print(json.dumps({'step': ctl.step,
                              'steps_per_s': round(rate, 3)}))
            mlog.append(ctl.step, **log_accum)
            mlog.save(log_path)
        if val_ds is not None and ctl.step % args.val_freq == 0:
            validate(state)
        ckpts.save(ctl.step, state, controller_state=_ctl_snapshot(ctl))
    stop_requested.restore()
    apply_pending()
    ckpts.save(ctl.step, state, controller_state=_ctl_snapshot(ctl),
               force=True)
    ckpts.wait()
    mlog.save(log_path)
    mlog.dashboard(os.path.join(args.exp_dir, 'dashboards'))
    print('JPEG training done at step', ctl.step)


def _main_chroma(args):
    """The chroma phase: the 2 x 64 low-frequency chroma generator,
    conditioned on the frozen Y generator, the critic's Y a per-image mix
    of real and generated."""
    from exsr_torch.apps.eval_jpeg import load_generator_params
    from exsr_torch.data.datasets import DataLoader, JPEGDataset
    from exsr_torch.device import full_fp32, resolve_device
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, \
        DnCNNDiscriminator
    from exsr_torch.train.checkpoints import CheckpointManager
    from exsr_torch.train.decomp import DecompConfig
    from exsr_torch.train.decomp_chroma import ChromaDecompTrainer
    from exsr_torch.utils.logging import MetricLog
    from exsr_torch.utils.metrics import calculate_psnr
    from exsr_torch.utils.misc import fetch_scalars

    device = resolve_device(args.device)
    cfg = DecompConfig(patch_size=args.patch, latent_channels=0,
                       chroma_mode=True, niter=args.niter)
    gy = DnCNN(DnCNNConfig(n_channels=args.y_nf or args.nf,
                           depth=args.y_nb or args.nb,
                           num_latent_channels=args.y_latent_channels),
               seed=args.seed + 7)
    if args.y_ckpt:
        gy.load_state_dict(load_generator_params(args.y_ckpt))
        print(f'conditioning on Y generator from {args.y_ckpt}')
    else:
        print('no --y_ckpt: conditioning on RANDOM Y weights '
              '(pipeline checks only)')
    gc = DnCNN(DnCNNConfig(n_channels=args.nf, depth=args.nb,
                           in_nc=256 + 128, out_nc=2 * 64,
                           chroma_generator=True, block_size=8,
                           num_latent_channels=0), seed=args.seed)
    d = DnCNNDiscriminator(n_channels=args.nf, depth=args.nb,
                           expected_input_size=args.patch // 16,
                           norm='layer', in_nc=256 + 128,
                           seed=args.seed + 1)
    trainer = ChromaDecompTrainer(cfg, gy)
    state = trainer.init_state(gc, d, seed=args.seed + 2, device=device)
    os.makedirs(args.exp_dir, exist_ok=True)
    mlog = MetricLog()
    log_path = os.path.join(args.exp_dir, 'logs.npz')
    ckpts = CheckpointManager(os.path.join(args.exp_dir, 'ckpt'),
                              max_to_keep=3,
                              save_interval_steps=args.ckpt_freq)
    if args.resume and ckpts.latest_step() is not None:
        state = ckpts.restore(state)
        if os.path.exists(log_path):
            mlog.load(log_path, max_step=state.step)
        print('resumed at step', state.step)

    qf_spec = (((args.qf_min, args.qf_max), 1.0),)
    ds = JPEGDataset(root=args.data_dir, patch_size=args.patch, chroma=True,
                     qf_spec=qf_spec, train=True)
    loader = DataLoader(ds, batch_size=args.batch, seed=args.seed)
    val_ds = None
    if args.val_dir:
        val_ds = JPEGDataset(root=args.val_dir, patch_size=args.patch,
                             chroma=True, qf_spec=qf_spec, train=False)

    @full_fp32()
    def validate():
        """The CbCr PSNR of the chroma decoding, conditioned on the Y
        generator's output (no mixing), against the uncompressed CbCr."""
        psnrs = []
        for i in range(min(len(val_ds), 8)):
            item = val_ds[i]
            ycbcr = torch.from_numpy(item['uncomp'][None]).to(device)
            qf = torch.tensor([float(item['qf'])], device=device)
            y_cond = trainer.fake_y(ycbcr[..., :1], qf)
            packed, _ = trainer.chroma_inputs(ycbcr, y_cond, qf)
            chroma = trainer.decode(state.g, packed, qf).clamp(0, 255)
            psnrs.append(calculate_psnr(chroma[0].cpu().numpy(),
                                        item['uncomp'][:, :, 1:]))
        rec = {'step': state.step,
               'psnr_chroma_val': round(float(np.mean(psnrs)), 4)}
        print(json.dumps(rec))
        mlog.append(state.step, psnr_chroma_val=rec['psnr_chroma_val'])

    t0 = time.time()
    log_accum = {}
    for batch in loader.stream(0):
        if state.step >= cfg.niter:
            break
        state, metrics = trainer.step(state, _to_device(batch, device),
                                      use_gan=True)
        log_accum.update(fetch_scalars(metrics))
        step = state.step
        if step % args.print_freq == 0:
            rate = args.print_freq / max(time.time() - t0, 1e-9)
            t0 = time.time()
            print(json.dumps({'step': step, 'steps_per_s': round(rate, 3),
                              **{k: round(v, 5)
                                 for k, v in log_accum.items()}}))
            mlog.append(step, **log_accum)
            mlog.save(log_path)
        if val_ds is not None and step % args.val_freq == 0:
            validate()
        ckpts.save(step, state)
    ckpts.save(state.step, state, force=True)
    ckpts.wait()
    mlog.save(log_path)
    mlog.dashboard(os.path.join(args.exp_dir, 'dashboards'))
    print('chroma training done at step', state.step)


if __name__ == '__main__':
    main()
