"""Training driver: the explorable-SR GAN trainer's dual D and G steps in
steady state.

Set-up builds the trainer (``SRRaGANTrainer`` with the configuration's
copy of the flagship options, the CEM-wrapped ``RRDBNet`` and the VGG-128
critic) on weights made from the seed, makes a pool of device batches
(HR patches with their bicubic LR) and drives the one train state through
its first three steps, D, G and D, through the same public calls the
window makes: it keeps what the comparison needs (each step's loss, the
first gradient of each optimizer from its Adam state, the parameters
after the three).  The window then runs iterations of one dual D step
and one dual G step, each fed the next batch of the pool and draws made
from the seed, until ``seconds`` have passed.  Once the window has closed
and the program is freed, the plain reference follows the first three
steps from the same weights, batches and draws.

The compared steps are set-up's and not the window's: the contract of
a training cell has set-up drive the one train state through its first
steps with the window's own calls and feed and hand it on, and a step
inside the window starts from a state that only the program has made.

With ``trace`` the profiler records one whole iteration (after one that
it drops); the host clock times each of the others whole, from the top
of the loop to the synchronize that ends it, and CUDA events time each
of their steps.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from benchmark import trace as T
from benchmark import traffic, weights
from benchmark.counts import models as MC
from benchmark.counts.peaks import FP32_FLOPS
from benchmark.reference import cem as rcem
from benchmark.reference import srgan_train as R
from benchmark.reference.precision import flags

SPAN = 'bench.iteration'


class Program:
    """The system under test: the port's trainer, generator, critic and
    CEM, imported when a run starts."""

    def __init__(self):
        from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
        from exsr_torch.models.discriminators import DiscriminatorVGG128
        from exsr_torch.models.rrdb import RRDBNet
        from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
        self.CEM, self.CEMConf, self.cem_wrap = CEM, CEMConf, cem_wrap
        self.critic, self.generator = DiscriminatorVGG128, RRDBNet
        self.Trainer, self.TrainConfig = SRRaGANTrainer, TrainConfig

    def build(self, cfg: dict, g_state: dict, d_state: dict, seed: int,
              device):
        """``(trainer, state)`` on ``device``."""
        t = cfg['train']
        tcfg = self.TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in t.items()})
        cem = self.CEM.create(self.CEMConf(scale_factor=cfg['scale']))
        wrapped = self.cem_wrap(lambda m, x, z: m(x, z),
                                cem.device_filters(3, device=device),
                                upscale=cfg['scale'])
        margins = cem.invalidity_margins_hr
        trainer = self.Trainer(
            tcfg, lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False),
            margins)
        g = self.generator(nf=cfg['nf'], nb=cfg['nb'], gc=cfg['gc'],
                           upscale=cfg['scale'],
                           latent_channels=cfg['latent_channels'])
        g.load_state_dict(g_state)
        c = cfg['critic']
        d = self.critic(base_nf=c['nf'], nb=c['n_layers'],
                        num_2_strides=c['num_2_strides'],
                        input_patch_size=t['patch_size'] - 2 * margins)
        d.load_state_dict(d_state)
        return trainer, trainer.init_state(g, d, seed=0, device=device)

    def d_step(self, trainer, state, batch, draws):
        return trainer.d_step(state, batch, dual=True, draws=draws)

    def g_step(self, trainer, state, batch, draws):
        return trainer.g_step(state, batch, dual=True, use_gan=True,
                              draws=draws)


def batches(cfg: dict, cell: dict, seed: int, device) -> list:
    """The pool: HR patches (smooth random fields with fine noise) and
    their LR, the bicubic downscale with edge borders."""
    t, tr = cfg['train'], cell['traffic']
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    cem = rcem.PlainCem(rcem.cem_taps(cfg['scale']))
    out = []
    for _ in range(tr['pool']):
        hr = np.concatenate([traffic.lr_image(t['patch_size'],
                                              t['patch_size'], rng)
                             for _ in range(tr['batch'])])
        hr = torch.as_tensor(hr, device=device)
        out.append({'lr': cem.down(hr.double()).float().contiguous(),
                    'hr': hr})
    return out


class Draws:
    """The random numbers of each step, from a generator on the device
    seeded from the run's seed: ``u`` per image, the MAP loop's start
    ``theta0`` (Xavier-uniform, gain 100) and, in a D step, the penalty's
    ``alpha`` for each fake."""

    def __init__(self, cfg: dict, batch: int, seed: int, device):
        s = int(np.random.SeedSequence([seed, 3]).generate_state(
            1, np.uint64)[0]) >> 1
        self.gen = torch.Generator(device=device).manual_seed(s)
        self.b, self.p = batch, cfg['train']['patch_size']
        self.nz, self.device = cfg['latent_channels'], device

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def __call__(self, kind: str) -> dict:
        b, p, nz = self.b, self.p, self.nz
        a = 100.0 * math.sqrt(6.0 / (nz * p * p + b * p * p))
        out = {'u': self._rand(b, 1, 1, nz),
               'theta0': [(self._rand(b, p, p, nz) * 2 - 1) * a]}
        if kind == 'd':
            out['alpha'] = [[self._rand(b, 1, 1, 1) for _ in range(2)]]
        return out


def iteration_flops(cfg: dict, batch: int) -> float:
    """Model operations of one dual D step and one dual G step, from the
    shapes, a backward counted as twice its forward (the input gradient
    alone once): per MAP iteration a generator forward and input
    gradient; the D step's two fakes, the critic's three passes with
    their backward and two gradient penalties (forward, input gradient,
    and the backward of both, 6 passes each); the G step's two forwards
    with their backward and the critic's input gradient for each."""
    t = cfg['train']
    lr = t['patch_size'] // cfg['scale']
    f_g = MC.forward_flops(cfg, batch, lr, lr)
    f_d = critic_flops(cfg, batch)
    iters = t['optimal_z_iters']
    d_step = 2 * iters * f_g + 2 * f_g + 3 * 3 * f_d + 2 * 6 * f_d
    g_step = 2 * iters * f_g + 2 * 3 * f_g + 2 * 2 * f_d
    return d_step + g_step


def critic_flops(cfg: dict, batch: int) -> float:
    """The critic's forward at the kept patch (CEM margins cropped)."""
    t, c = cfg['train'], cfg['critic']
    size = t['patch_size'] - 2 * cfg['scale'] * rcem.cem_taps(
        cfg['scale']).margins_lr
    flops = 0
    for name, shape in R.critic_shapes(c['nf'], 3, size).items():
        if name.endswith('conv.weight'):
            co, ci, k, _ = shape
            if k == 4:
                size //= 2
            flops += 2 * k * k * ci * co * size * size
        elif name.startswith('fc') and name.endswith('weight'):
            flops += 2 * shape[0] * shape[1]
    return batch * flops


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def static_terms(cfg: dict, m_d: dict, m_g: dict) -> list:
    """The terms of the drawn Z in the first D step's and the first G
    step's losses, from the trainer's metrics: the D step's adversarial
    terms and penalty of its second fake, the G step's range, adversarial
    and latent terms (the metrics of the last Z, the drawn one)."""
    t = cfg['train']
    d = (float(m_d['l_d_real_1']) + float(m_d['l_d_fake_1'])) / 2 + \
        t['gp_weight'] * float(m_d['l_d_gp_1'])
    g = (t['range_weight'] * float(m_g['l_g_range'])
         + t['gan_weight'] * float(m_g['l_g_gan'])) / 2 + \
        t['latent_weight'] * float(m_g['l_g_latent'])
    return [d, g]


def g_fixed_terms(cfg: dict, m_g: dict) -> list:
    """The first G step's range and latent terms of the drawn Z, as the
    loss weighs them: the generator's forward through the CEM and
    L_struct on the whole batch, which neither the MAP loop nor the
    critic's first update reaches."""
    t = cfg['train']
    return [t['range_weight'] * float(m_g['l_g_range']) / 2,
            t['latent_weight'] * float(m_g['l_g_latent'])]


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _first_grads(module, opt) -> dict:
    """The gradient the optimizer got at its one step, from Adam's first
    moment: ``exp_avg / (1 - beta1)``."""
    b1 = opt.param_groups[0]['betas'][0]
    return {k: opt.state[p]['exp_avg'] / (1 - b1) if 'exp_avg' in
            opt.state[p] else torch.zeros_like(p)
            for k, p in module.named_parameters()}


def run(cell: dict, cfg: dict, ref_mod, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None,
        tmpdir: str | None = None) -> dict:
    """One run of a training cell."""
    program = program or Program()
    t = cfg['train']
    bsz = cell['traffic']['batch']
    g_state = weights.make(ref_mod.shapes(cfg), cfg['init'], seed, device)
    d_shapes = R.critic_shapes(cfg['critic']['nf'], 3, t['patch_size'] -
                               2 * cfg['scale'] * rcem.cem_taps(
                                   cfg['scale']).margins_lr)
    d_state = weights.make(d_shapes, cfg['critic']['init'], seed, device,
                           stream=1)
    pool = batches(cfg, cell, seed, device)
    draws = Draws(cfg, bsz, seed, device)
    trainer, state = program.build(cfg, g_state, d_state, seed, device)

    # the first three steps, kept for the comparison
    first = {'g0': _params(state.g), 'd0': _params(state.d),
             'draws': [draws('d'), draws('g'), draws('d')]}
    _, m1 = program.d_step(trainer, state, pool[0], first['draws'][0])
    first['d_grad'] = {k: v.clone() for k, v in
                       _first_grads(state.d, state.d_opt).items()}
    _, m2 = program.g_step(trainer, state, pool[1 % len(pool)],
                           first['draws'][1])
    first['g_grad'] = {k: v.clone() for k, v in
                       _first_grads(state.g, state.g_opt).items()}
    trainer.advance(state)
    _, m3 = program.d_step(trainer, state, pool[2 % len(pool)],
                           first['draws'][2])
    trainer.advance(state)
    first['g3'], first['d3'] = _params(state.g), _params(state.d)
    first['loss'] = [float(m1['l_d_total']), float(m2['l_g_total']),
                     float(m3['l_d_total'])]
    first['static'] = static_terms(cfg, m1, m2)
    first['g_terms'] = g_fixed_terms(cfg, m2)
    first['logits'] = [float(m1['D_real_1']), float(m1['D_fake_1'])]
    _sync(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)

    n_step = 3
    iters, d_ms, g_ms, iter_ms = 0, [], [], []
    prof = None
    if trace:
        trace_path = f'{tmpdir}/bench_trace.json'
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
    timed = device.type == 'cuda' and trace
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    t_now = t_window
    while t_now - t_window < seconds:
        profiling = prof is not None
        t_iter = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if timed and not profiling else None
        with torch.profiler.record_function(SPAN) if profiling \
                else contextlib.nullcontext():
            if ev:
                ev[0].record()
            program.d_step(trainer, state, pool[n_step % len(pool)],
                           draws('d'))
            if ev:
                ev[1].record()
            program.g_step(trainer, state, pool[(n_step + 1) % len(pool)],
                           draws('g'))
            if ev:
                ev[2].record()
            trainer.advance(state)
            _sync(device)
        if not profiling:
            iter_ms.append(1e3 * (time.perf_counter() - t_iter))
        n_step += 2
        iters += 1
        if ev:
            d_ms.append(ev[0].elapsed_time(ev[1]))
            g_ms.append(ev[1].elapsed_time(ev[2]))
        if profiling:
            prof.step()
            if iters == 2:
                prof.stop()
                prof = None
        t_now = time.perf_counter()
    window_s = t_now - t_window
    if prof is not None:
        prof.stop()
    result = {
        'setup_s': setup_s, 'attempted': iters, 'failed': 0,
        'e2e': {'train_iter_ms': 1e3 * window_s / iters},
        'memory_peak_bytes': (torch.cuda.max_memory_allocated(device)
                              if device.type == 'cuda' else 0),
    }
    if trace:
        tr = T.load(trace_path, SPAN)
        result['trace'] = tr
        result['layer_ctx'] = {
            'trace': tr, 'requests': 1, 'd_step_ms': d_ms, 'g_step_ms': g_ms,
            'iter_ms': iter_ms,
            'counts': {'model_flops': iteration_flops(cfg, bsz),
                       'peak_flops': FP32_FLOPS}}
    del trainer, state
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    result['check'], result['readings'] = check(
        cell, cfg, ref_mod, g_state, d_state, pool, first)
    return result


def reference_steps(cfg, ref_mod, g_state, d_state, pool, draws,
                    precision: str = 'float32') -> dict:
    """The plain reference's first three steps (D, G, D) from the given
    weights: losses, first gradients, parameters after the three."""
    steps = R.Steps(cfg, lambda gp, prec: ref_mod.generator(gp, cfg, prec),
                    precision)
    gp = {k: v.detach().clone().requires_grad_() for k, v in g_state.items()}
    dp = {k: v.detach().clone().requires_grad_() for k, v in d_state.items()
          if 'running_' not in k}
    lr_g, lr_d = cfg['train']['lr_g'], cfg['train']['lr_d']
    sg, sd = {}, {}
    with flags(precision):
        l1, s1, gd, logits = steps.d_step(gp, dp, pool[0], draws[0])
        R.adam(dp, gd, sd, lr_d)
        l2, s2, gg, g_terms = steps.g_step(gp, dp, pool[1 % len(pool)],
                                           draws[1])
        R.adam(gp, gg, sg, lr_g)
        l3, _, gd3, _ = steps.d_step(gp, dp, pool[2 % len(pool)], draws[2])
        R.adam(dp, gd3, sd, lr_d)
    return {'loss': [float(l1), float(l2), float(l3)],
            'static': [float(s1), float(s2)], 'g_terms': g_terms,
            'logits': logits, 'd_grad': gd, 'g_grad': gg,
            'g3': {k: v.detach() for k, v in gp.items()},
            'd3': {k: v.detach() for k, v in dp.items()}}


def compare(cfg, prog: dict, ref: dict, g0: dict, d0: dict) -> dict:
    """The numbers of a run against the reference's: the relative gap of
    the G step's loss and of the worst D step's, and of the first D and G
    steps' terms of the drawn Z (which the MAP loop does not reach:
    :func:`static_terms`); the gap of the first D step's mean critic logits
    on the real crop and on the drawn Z's fake (the generator, the CEM and
    the critic's forward), over their sizes; the same of the first G
    step's range and latent terms of the drawn Z (:func:`g_fixed_terms`);
    the gap of first-gradient norms
    (:func:`~benchmark.reference.srgan_train.leaf_gaps`) of the median and
    of the worst leaf, the larger of D's and G's; the same for the norms
    of the change over the three steps, leaving out the leaves whose
    reference gradient is under a thousandth of the median leaf's, which
    move by round-off alone."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog['loss'], ref['loss'])]
    static = [abs(p - r) / abs(r) for p, r in zip(prog['static'],
                                                  ref['static'])]
    lp, lr = prog['logits'], ref['logits']
    tp, tr = prog['g_terms'], ref['g_terms']
    out = {'g_loss_gap': loss[1], 'd_loss_gap': max(loss[0], loss[2]),
           'd_static_gap': static[0], 'g_static_gap': static[1],
           'd_logit_gap': (abs(lp[0] - lr[0]) + abs(lp[1] - lr[1]))
           / (abs(lr[0]) + abs(lr[1])),
           'g_terms_gap': sum(abs(p - r) for p, r in zip(tp, tr))
           / sum(abs(r) for r in tr)}
    for name, side, first in (('grad', 'g', 'g_grad'), ('grad', 'd', 'd_grad'),
                              ('change', 'g', 'g_grad'),
                              ('change', 'd', 'd_grad')):
        if name == 'grad':
            med, worst = R.leaf_gaps(prog[first], ref[first])
        else:
            norms = {k: float(v.norm()) for k, v in ref[first].items()}
            floor = 1e-3 * float(np.median(list(norms.values())))
            start = g0 if side == 'g' else d0
            keep = [k for k, n in norms.items() if n >= floor]
            med, worst = R.leaf_gaps(
                {k: prog[f'{side}3'][k] - start[k] for k in keep},
                {k: ref[f'{side}3'][k] - start[k] for k in keep})
        out[f'{name}_gap'] = max(out.get(f'{name}_gap', 0.0), med)
        out[f'{name}_gap_worst'] = max(out.get(f'{name}_gap_worst', 0.0),
                                       worst)
    return out


def check(cell, cfg, ref_mod, g_state, d_state, pool, first) -> tuple:
    """``(checks, readings)``: the compared numbers with their limits,
    and every number :func:`compare` gives."""
    ref = reference_steps(cfg, ref_mod, g_state, d_state, pool,
                          first['draws'])
    nums = compare(cfg, first, ref, first['g0'], first['d0'])
    nums = {k: v if math.isfinite(v) else math.inf for k, v in nums.items()}
    lim = cell['check']['limits']
    return {k: (nums[k], lim[k]) for k in lim}, nums


def control_reading(cell, cfg, ref_mod, seed: int, device) -> dict:
    """The control's compared numbers: the reference's first three steps
    at the control's precision against the float32 reference's, from the
    weights, batches and draws of ``seed``."""
    t = cfg['train']
    g_state = weights.make(ref_mod.shapes(cfg), cfg['init'], seed, device)
    d_shapes = R.critic_shapes(cfg['critic']['nf'], 3, t['patch_size'] -
                               2 * cfg['scale'] * rcem.cem_taps(
                                   cfg['scale']).margins_lr)
    d_state = weights.make(d_shapes, cfg['critic']['init'], seed, device,
                           stream=1)
    pool = batches(cfg, cell, seed, device)
    draws = Draws(cfg, cell['traffic']['batch'], seed, device)
    first = [draws('d'), draws('g'), draws('d')]
    ref = reference_steps(cfg, ref_mod, g_state, d_state, pool, first)
    ctl = reference_steps(cfg, ref_mod, g_state, d_state, pool, first,
                          precision=cell['check']['control'])
    d0 = {k: v for k, v in d_state.items() if 'running_' not in k}
    return compare(cfg, ctl, ref, g_state, d0)
