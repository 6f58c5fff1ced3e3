"""Explorable-SR training CLI.

Counterpart of ``exsr/apps/train_sr.py``.  It wires the datasets, the
threaded loader, the trainer's D and G steps, the host controller (step
gating, the instability rollbacks), the port's checkpoints and periodic
validation at Z in {0, -1, 1} (PSNR and per-pixel STD diversity).

Usage::

  python -m exsr_torch.apps.train_sr --hr_dir DIR [--val_hr_dir DIR] \\
      --scale 4 [--opt options.json] [--niter N] [--batch 16] ...

It runs on the current CUDA device unless ``--device cpu`` is given, in
fp32 with TF32 off, as ``exsr`` trains.  ``--warm_g`` and ``--checkpoint``
style inputs are a directory of the port's checkpoints or an ``exsr``
generator exported as ``.npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def default_collapse_guard(gan_type: str | None) -> bool:
    """Whether the collapse guard is armed when the flag is not given: for
    the wgan losses, whose critic failure it detects and on whose loss
    scales its thresholds are set; not for the sigmoid losses, whose
    ~0.69 at chance sits inside those thresholds."""
    return bool(gan_type) and gan_type.startswith('wgan')


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--opt', help='reference-style options JSON (optional)')
    p.add_argument('--hr_dir', required=True)
    p.add_argument('--lr_dir')
    p.add_argument('--val_hr_dir')
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--patch', type=int, default=208)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--nb', type=int, default=23)
    p.add_argument('--nf', type=int, default=64)
    p.add_argument('--gc', type=int, default=32,
                   help='RRDB dense-growth channels (network_G.gc)')
    p.add_argument('--d_nb', type=int, default=10)
    p.add_argument('--d_nf', type=int, default=64)
    p.add_argument('--d_strides', type=int, default=5)
    p.add_argument('--niter', type=int, default=None)
    p.add_argument('--accum_g', type=int, default=1,
                   help='G-step gradient-accumulation microbatches of the '
                        'virtual batch')
    p.add_argument('--accum_d', type=int, default=1,
                   help='D-step gradient-accumulation microbatches')
    p.add_argument('--exp_dir', default='experiments/explorable_sr')
    p.add_argument('--val_freq', type=int, default=500)
    p.add_argument('--ckpt_freq', type=int, default=1000)
    p.add_argument('--max_keep', type=int, default=3,
                   help='checkpoints retained; raise it when arming the '
                        'rollback guards, so that the step to restore '
                        'before survives pruning')
    p.add_argument('--print_freq', type=int, default=100)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--tensorboard', action='store_true',
                   help='also write TensorBoard event files (when a '
                        'backend is installed)')
    p.add_argument('--vgg_pth',
                   help='torchvision vgg19 weights (.pth/.npz) for the '
                        'perceptual feature loss when the config sets '
                        'feature_weight; seeded random VGG when omitted')
    p.add_argument('--warm_g',
                   help='warm-start the generator from a directory of the '
                        "port's checkpoints (its 'g_params') or an exsr "
                        'generator exported as .npz, with a fresh D and '
                        'optimizers; ignored when --resume finds '
                        'checkpoints')
    p.add_argument('--collapse_guard', action=argparse.BooleanOptionalAction,
                   default=None,
                   help='arm the symmetric critic-collapse rollback '
                        '(GANController.check_critic_collapse); default: '
                        'on for the wgan losses, off otherwise')
    p.add_argument('--init_phase', action='store_true',
                   help='pixel + range pretraining without the GAN and D '
                        '(the stand-in for a pretrained ESRGAN warm start); '
                        'resume without it for the GAN phase')
    p.add_argument('--device', default=None,
                   help="torch device; the current CUDA device by default, "
                        "'cpu' to train on the CPU")
    return p


def main(argv=None):
    from exsr_torch.apps.eval_sr import PLAIN_ARCHS, load_generator_params
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.data.datasets import DataLoader, LRHRDataset
    from exsr_torch.device import full_fp32, resolve_device
    from exsr_torch.models.discriminators import (DiscriminatorVGG128,
                                                  PatchGANDiscriminator)
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.train.checkpoints import CheckpointManager
    from exsr_torch.train.controller import GANController
    from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
    from exsr_torch.utils.color import tensor2img
    from exsr_torch.utils.logging import MetricLog, TensorboardWriter
    from exsr_torch.utils.metrics import calculate_psnr, crop_border
    from exsr_torch.utils.misc import (install_sigint_stop, read_scalars,
                                       stage_scalars)

    p = _parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig(scale=args.scale, patch_size=args.patch)
    use_cem, exp = True, None
    if args.opt:
        from exsr_torch.options.config import (experiment_from_reference_json,
                                               parse)
        exp = experiment_from_reference_json(parse(args.opt, is_train=True))
        cfg = exp.train
        # the steps take the whole virtual batch and split it into
        # grad_accum_* microbatches themselves
        args.batch = exp.train_data.batch_size
        # the JSON's architecture unless a flag overrides it; CEM_arch 0
        # with no latent channels is the plain ESRGAN / SRGAN variant
        net_g, net_d = exp.network_g, exp.network_d
        if args.nb == p.get_default('nb'):
            args.nb = net_g.nb
        if args.nf == p.get_default('nf'):
            args.nf = net_g.nf
        if net_g.gc and args.gc == p.get_default('gc'):
            args.gc = net_g.gc
        use_cem = net_g.cem_arch
        if net_d.n_layers and args.d_nb == p.get_default('d_nb'):
            args.d_nb = net_d.n_layers
        if net_d.nf and args.d_nf == p.get_default('d_nf'):
            args.d_nf = net_d.nf
        if net_d.num_2_strides is not None and \
                args.d_strides == p.get_default('d_strides'):
            args.d_strides = net_d.num_2_strides
    if args.niter:
        cfg = TrainConfig(**{**cfg.__dict__, 'niter': args.niter})
    if args.accum_g > 1 or args.accum_d > 1:
        # each field only when its own flag is set: the JSON may have set
        # the other one
        cfg = TrainConfig(**{
            **cfg.__dict__,
            'grad_accum_g': (args.accum_g if args.accum_g > 1
                             else cfg.grad_accum_g),
            'grad_accum_d': (args.accum_d if args.accum_d > 1
                             else cfg.grad_accum_d)})
    if args.init_phase:
        # L1 pixel and range only, a higher LR, no MAP, latent or GAN terms
        cfg = TrainConfig(**{**cfg.__dict__, 'pixel_weight': 1.0,
                             'feature_weight': None, 'gan_weight': 0.0,
                             'optimal_z_weight': None,
                             'latent_weight': None, 'lr_g': 2e-4})
    if args.collapse_guard is None:
        args.collapse_guard = default_collapse_guard(cfg.gan_type)
    print(f'collapse_guard armed: {args.collapse_guard} '
          f'(gan_type={cfg.gan_type})', flush=True)

    nz = cfg.num_latent_channels
    if use_cem:
        cem = CEM.create(CEMConf(scale_factor=cfg.scale))
        filt = cem.device_filters(3, device=device)
        margins_hr = cem.invalidity_margins_hr
        margins_lr = cem.invalidity_margins_lr
    else:
        margins_hr = margins_lr = 0
    d_input = cfg.patch_size - 2 * margins_hr
    if d_input <= 0:
        raise SystemExit(
            f'patch_size {cfg.patch_size} leaves the D no input after '
            f'cropping 2x{margins_hr} CEM invalidity margins: use '
            f'patch_size > {2 * margins_hr}')
    decomposed_d = bool(exp and exp.network_d.decomposed_input and use_cem)
    if decomposed_d:
        # network_D.decomposed_input: a two-stream PatchGAN judging the
        # CEM's (low, high) pair; the JSON's n_layers when set, else the
        # 3-layer default (--d_nb's default is the VGG critic's depth)
        d_kwargs = dict(ndf=args.d_nf, decomposed_input=True,
                        pre_clipping=exp.network_d.pre_clipping,
                        seed=args.seed + 1)
        if exp.network_d.n_layers:
            d_kwargs['n_layers'] = args.d_nb
        d = PatchGANDiscriminator(**d_kwargs)
        cfg = TrainConfig(**{**cfg.__dict__, 'decomposed_d': True})
    else:
        d = DiscriminatorVGG128(base_nf=args.d_nf, nb=args.d_nb,
                                num_2_strides=args.d_strides,
                                input_patch_size=d_input, seed=args.seed + 1)
    which_g = exp.network_g.which_model if exp else 'RRDB_net'
    if which_g in PLAIN_ARCHS:
        # the Z-less SRGAN-era generators
        if nz != 0:
            raise SystemExit(f'{which_g} has no latent input')
        g = PLAIN_ARCHS[which_g](nf=args.nf, nb=args.nb, upscale=cfg.scale,
                                 seed=args.seed)

        def raw_apply(m, x, z):
            return m(x)
    else:
        g = RRDBNet(nb=args.nb, nf=args.nf, gc=args.gc, upscale=cfg.scale,
                    latent_channels=nz, seed=args.seed)

        def raw_apply(m, x, z):
            return m(x, z if nz else None)
    if use_cem:
        wrapped = cem_wrap(raw_apply, filt, upscale=cfg.scale)
    else:
        def wrapped(m, x, z, margins, pre_pad=True, decompose=False):
            return raw_apply(m, x, z)

    def g_apply(m, x, z):
        return wrapped(m, x, z, 0, pre_pad=False)

    def g_apply_decomp(m, x, z):
        return wrapped(m, x, z, 0, pre_pad=False, decompose=True)
    f_apply = None
    if cfg.feature_weight:
        from exsr_torch.models.vgg import (VGG19Features,
                                           load_torch_vgg19_features)
        vgg = VGG19Features(seed=args.seed + 9)
        if args.vgg_pth:
            vgg.load_state_dict(load_torch_vgg19_features(args.vgg_pth))
        else:
            print('feature loss active with RANDOM VGG weights: pass '
                  '--vgg_pth for the reference behavior')
        f_apply = vgg.to(device)

    trainer = SRRaGANTrainer(
        cfg, g_apply, margins_hr=margins_hr, f_apply=f_apply,
        g_apply_decomp=g_apply_decomp if decomposed_d else None)
    state = trainer.init_state(g, d, seed=args.seed + 2, device=device)
    ctl = GANController(
        d_update_ratio=cfg.d_update_ratio,
        d_valid_steps_4_g=cfg.d_valid_steps_4_g_update,
        min_d_prob_ratio_4_g=cfg.min_d_prob_ratio_4_g,
        min_mean_d_correct=cfg.min_mean_d_correct,
        d_init_iters=cfg.d_init_iters,
        steps_4_loss_std=cfg.steps_4_loss_std,
        std_4_lr_drop=cfg.std_4_lr_drop,
        lr_gamma=cfg.lr_gamma,
        base_lr=min(cfg.lr_g, cfg.lr_d))

    os.makedirs(args.exp_dir, exist_ok=True)
    mlog = MetricLog()
    log_path = os.path.join(args.exp_dir, 'logs.npz')
    tb = (TensorboardWriter(os.path.join(args.exp_dir, 'tb'))
          if args.tensorboard else None)
    ckpts = CheckpointManager(os.path.join(args.exp_dir, 'ckpt'),
                              max_to_keep=args.max_keep,
                              save_interval_steps=args.ckpt_freq)
    if args.resume and ckpts.latest_step() is not None:
        state, ctl_state = ckpts.restore(state, with_controller=True)
        if ctl_state:
            ctl.step = ctl_state['step']
            ctl.generator_started_learning = \
                ctl_state['generator_started_learning']
            ctl.verified_d_saved = ctl_state['verified_d_saved']
            ctl.lr_scale = ctl_state['lr_scale']
            state.lr_scale = ctl.lr_scale
        if os.path.exists(log_path):
            # drop the curve points past the restored step
            mlog.load(log_path, max_step=ctl.step)
        print(f'resumed at step {ctl.step}')
    elif args.warm_g:
        # a pretrained generator with a fresh D and optimizers
        state.g.load_state_dict(load_generator_params(args.warm_g, which_g))
        print(f'warm-started G from {args.warm_g}')

    ds = LRHRDataset(hr_root=args.hr_dir, lr_root=args.lr_dir,
                     scale=cfg.scale, patch_size=cfg.patch_size, train=True)
    loader = DataLoader(ds, batch_size=args.batch, seed=args.seed)
    val_ds = None
    if args.val_hr_dir:
        val_ds = LRHRDataset(hr_root=args.val_hr_dir, scale=cfg.scale,
                             train=False, patch_size=None)

    @torch.no_grad()
    def val_forward(lr_in, z):
        with full_fp32():
            return wrapped(state.g, lr_in, z, margins_lr,
                           pre_pad=True).clamp(0, 1)

    def validate(step):
        psnrs, stds = [], []
        for i in range(min(len(val_ds), 8)):
            item = val_ds[i]
            lr_in = torch.from_numpy(item['lr'][None]).to(device)
            zh, zw = lr_in.shape[1] * cfg.scale, lr_in.shape[2] * cfg.scale
            outs = torch.stack([
                val_forward(lr_in, torch.full((1, zh, zw, nz), zval,
                                              device=device))
                for zval in ((0.0, -1.0, 1.0) if nz else (0.0,))])
            psnrs.append(calculate_psnr(
                crop_border(tensor2img(outs[0]).astype(np.float64),
                            cfg.scale),
                crop_border(tensor2img(item['hr'][None])
                            .astype(np.float64), cfg.scale)))
            stds.append(float(outs.std(dim=0, correction=0).mean()))
        rec = {'psnr_val': float(np.mean(psnrs)),
               'per_pix_STD_val': float(np.mean(stds))}
        print(json.dumps({'step': step, **rec}))
        mlog.append(step, **rec)
        if tb is not None:
            tb.log(step, **rec)

    def ctl_snapshot():
        # one snapshot for the periodic and the final forced save
        return {'step': ctl.step,
                'generator_started_learning':
                    ctl.generator_started_learning,
                'verified_d_saved': ctl.verified_d_saved,
                'lr_scale': ctl.lr_scale}

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
    # host time per step: the batch feed, the steps' enqueueing, and the
    # one metric fetch (which waits for the device)
    tacc = {'t_data': 0.0, 't_step': 0.0, 't_fetch': 0.0}
    t_last = time.perf_counter()
    stop_requested = install_sigint_stop()
    for batch in loader.stream(0):
        if ctl.step >= cfg.niter or stop_requested():
            break
        batch = {k: torch.from_numpy(batch[k]).to(device)
                 for k in ('lr', 'hr')}
        t_now = time.perf_counter()
        tacc['t_data'] += t_now - t_last
        t_last = t_now
        dual = (cfg.optimal_z_weight is not None
                and ctl.generator_started_learning)
        if args.init_phase:
            do_d, do_g = False, True  # no D in the pretraining phase
        else:
            do_d = ctl.want_d_step()
            do_g = ctl.want_g_step()
        d_staged = g_staged = None
        if do_d:
            state, d_metrics = trainer.d_step(state, batch, dual=dual)
            d_staged = stage_scalars(d_metrics)
        if do_g:
            state, g_metrics = trainer.g_step(state, batch, dual=dual,
                                              use_gan=not args.init_phase)
            g_staged = stage_scalars(g_metrics)
        t_now = time.perf_counter()
        tacc['t_step'] += t_now - t_last
        t_last = t_now
        # the metrics of step t are read after step t + 1 is enqueued, so
        # the gating sees records one step later than a synchronous loop
        apply_pending()
        pending = (d_staged, g_staged)
        t_now = time.perf_counter()
        tacc['t_fetch'] += t_now - t_last
        t_last = t_now
        state = trainer.advance(state)
        ctl.tick()

        if ctl.step % cfg.steps_4_loss_std == 0:
            rollback, too_low = ctl.check_lr_drop()
            if ctl.log['D_loss_STD']:
                s_, v_ = ctl.log['D_loss_STD'][-1]
                mlog.append(s_, D_loss_STD=v_)
            if too_low:
                print('LR below 1e-8: stopping (instability).')
                return
            if not rollback and args.collapse_guard and \
                    ctl.check_critic_collapse():
                too_low = ctl.halve_lr()
                rollback = True
                print('critic collapse detected '
                      '(|D_logits_diff| ~ 0 with inflating |l_d|)')
                if too_low:
                    print('LR below 1e-8: stopping (instability).')
                    return
            if rollback:
                # the discarded step's staged metrics must not reach the
                # gating window after the rollback
                pending = (None, None)
                mlog.append(ctl.step, rollback_lr_scale=ctl.lr_scale)
                back_step, state = ckpts.restore_before(
                    state, ctl.step - cfg.steps_4_loss_std)
                state.lr_scale = ctl.lr_scale
                print(f'instability rollback to step {back_step}, '
                      f'lr_scale={ctl.lr_scale}')
        if ctl.step % args.print_freq == 0:
            log_accum['steps_per_s'] = args.print_freq / max(
                time.time() - t0, 1e-9)
            t0 = time.time()
            for k in tacc:
                log_accum[k + '_ms'] = 1e3 * tacc[k] / args.print_freq
                tacc[k] = 0.0
            print(json.dumps({'step': ctl.step, **{
                k: round(v, 5) for k, v in log_accum.items()}}))
            mlog.append(ctl.step, **log_accum)
            if tb is not None:
                tb.log(ctl.step, **log_accum)
            mlog.save(log_path)
        if val_ds and ctl.step % args.val_freq == 0:
            validate(ctl.step)
        ckpts.save(ctl.step, state, controller_state=ctl_snapshot())
    stop_requested.restore()
    apply_pending()
    ckpts.save(ctl.step, state, force=True, controller_state=ctl_snapshot())
    ckpts.wait()
    mlog.save(log_path)
    mlog.dashboard(os.path.join(args.exp_dir, 'dashboards'))
    if tb is not None:
        tb.close()
    print('training done at step', ctl.step)


if __name__ == '__main__':
    main()
