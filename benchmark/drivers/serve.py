"""Serving driver: one closed-loop client of ``eval_sr``'s batched Z-sweep
entry point.

Set-up builds the served forward (``build_model``) on weights made from
the seed, makes the cell's requests (the LR on the host, the Z maps on
the card: :mod:`benchmark.traffic`) and runs two of them.
The window then sends one request after another, each the call into
``bucketed_sweep`` with the request's inputs and a
``torch.cuda.synchronize()`` after it, as ``eval_sr`` times an image,
until ``seconds`` have passed.  A reservoir drawn from the seed keeps the
outputs of ``check.sample`` requests; once the window has closed, the peak
memory read and the program freed, the plain reference recomputes them
and each returned image is compared with its reference.

With ``trace`` the profiler records the first requests of the window
(at least 5 and 2 s, after one request that it drops); the rest of the
window runs untraced and gives the host spans.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark import trace as T
from benchmark import traffic, weights
from benchmark.counts import kernels as KC
from benchmark.counts import models as MC
from benchmark.counts.peaks import PEAK_FLOPS
from benchmark.reference import cem as rcem
from benchmark.reference.precision import flags

SPAN = 'bench.request'


class Program:
    """The system under test: ``eval_sr``'s ``build_model`` and
    ``bucketed_sweep``, imported when a run starts."""

    def __init__(self):
        from exsr_torch.apps import eval_sr
        self.build_model = eval_sr.build_model
        self.bucketed_sweep = eval_sr.bucketed_sweep


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def img_rms_errors(outs: list, ref: torch.Tensor) -> list:
    """RMS error of each returned image ``[1, H, W, 3]`` against its
    reference row."""
    return [float((o[0].float() - r.to(o.device)).pow(2).mean().sqrt())
            for o, r in zip(outs, ref)]


def reference_outputs(cell, cfg, ref_mod, state, lr, zs, device,
                      precision: str = 'float32', chunk: int = 8):
    """The plain reference's outputs ``[n, H, W, 3]`` for one request,
    ``chunk`` Z maps at a time."""
    taps = rcem.cem_taps(cfg['scale'])
    g = ref_mod.generator(state, cfg, precision)
    pc = rcem.PlainCem(taps)
    nz = cfg['latent_channels']
    lr_t = torch.as_tensor(lr, device=device)
    outs = []
    with torch.no_grad(), flags(precision):
        for i in range(0, len(zs), chunk):
            z = torch.cat([torch.as_tensor(z, device=device)
                           for z in zs[i:i + chunk]]) if nz else None
            n = len(zs[i:i + chunk])
            outs.append(rcem.serve(pc, g, lr_t.expand(n, *lr_t.shape[1:]),
                                   z))
    return torch.cat(outs)


def _counts(cell, cfg, batch: int) -> dict:
    """Bytes and operations of one request at the generator's size (LR
    pre-padded by the CEM's margins)."""
    tr = cell['traffic']
    taps = rcem.cem_taps(cfg['scale'])
    m, sf = taps.margins_lr, cfg['scale']
    h, w = tr['lr_h'] + 2 * m, tr['lr_w'] + 2 * m
    dtype_bytes = 2 if cell['dtype'] == 'bfloat16' else 4
    out = {
        'model_flops': MC.forward_flops(cfg, batch, h, w),
        'peak_flops': PEAK_FLOPS[cell['dtype']],
        'cem': KC.cem_forward(batch, h, w, 3, taps.ds_kernel.shape[0],
                              taps.inv_hth.shape[0], sf, taps.pre),
        'dtype': cell['dtype'],
    }
    if cfg['arch'] == 'RRDB_net':
        out['stage4'] = KC.stage4(batch * h * w, cfg['nf'], cfg['gc'],
                                  dtype_bytes)
    return out


def run(cell: dict, cfg: dict, ref_mod, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None,
        tmpdir: str | None = None) -> dict:
    """One run of a serving cell; returns the end-to-end numbers, the
    per-layer context, the check and the device's peak memory."""
    program = program or Program()
    tr, check = cell['traffic'], cell['check']
    nz = cfg['latent_channels']
    state = weights.make(ref_mod.shapes(cfg), cfg['init'], seed, device)
    _, fwd = program.build_model(
        cfg['scale'], cfg['nb'], latent_channels=nz, nf=cfg['nf'],
        device=device, dtype=getattr(torch, cell['dtype']), params=state,
        arch=cfg['arch'])
    pool = traffic.to_device(traffic.requests(tr, nz, cfg['scale'], seed),
                             device)
    n_img = len(pool[0][1])
    warm = []
    for lr, zs in pool[:2]:
        t0 = time.perf_counter()
        program.bucketed_sweep(fwd, lr, zs)
        _sync(device)
        warm.append(time.perf_counter() - t0)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)

    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    k = check['sample']
    kept = []                        # reservoir of (request index, outputs)
    lat_ms, host_ms = [], []
    attempted = failed = 0
    prof, n_traced, traced_host = None, 0, []
    if trace:
        n_traced = max(5, math.ceil(2.0 / max(warm[-1], 1e-3)))
        trace_path = f'{tmpdir}/bench_trace.json'
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=n_traced, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    t_now = t_window
    while t_now - t_window < seconds:
        lr, zs = pool[attempted % len(pool)]
        profiling = prof is not None and attempted <= n_traced
        t0 = time.perf_counter()
        try:
            if profiling:
                with torch.profiler.record_function(SPAN):
                    outs = program.bucketed_sweep(fwd, lr, zs)
                    t1 = time.perf_counter()
                    _sync(device)
            else:
                outs = program.bucketed_sweep(fwd, lr, zs)
                t1 = time.perf_counter()
                _sync(device)
        except Exception as e:     # a failed request counts; the run goes on
            failed += 1
            outs, t1 = None, time.perf_counter()
            print(f'request {attempted} failed: {e!r}', flush=True,
                  file=sys.stderr)
        t_now = time.perf_counter()
        lat_ms.append(1e3 * (t_now - t0))
        (traced_host if profiling else host_ms).append(1e3 * (t1 - t0))
        if outs is not None:
            j = attempted if attempted < k else int(rng.integers(attempted + 1))
            if j < k:
                if len(kept) < k:
                    kept.append((attempted, outs))
                else:
                    kept[j] = (attempted, outs)
        attempted += 1
        if prof is not None and profiling:
            prof.step()
            if attempted > n_traced:
                prof.stop()
                prof = None
    window_s = t_now - t_window
    if prof is not None:
        prof.stop()
    done = attempted - failed
    fam = cell['family']
    result = {
        'setup_s': setup_s,
        'attempted': attempted, 'failed': failed,
        'e2e': {f'{fam}_img_per_s': n_img * done / window_s,
                f'{fam}_p95_ms': float(np.percentile(lat_ms, 95))},
        'memory_peak_bytes': (torch.cuda.max_memory_allocated(device)
                              if device.type == 'cuda' else 0),
    }
    if trace:
        tr_ = T.load(trace_path, SPAN)
        result['trace'] = tr_
        result['layer_ctx'] = {
            'trace': tr_, 'requests': n_traced,
            'host_ms': host_ms or traced_host,
            'counts': _counts(cell, cfg, _bucket(n_img)),
        }
    del fwd
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    result['check'] = _check(cell, cfg, ref_mod, state, pool, kept, n_img,
                             device)
    return result


def _bucket(n: int) -> int:
    from exsr_torch.utils.serve import best_bucket
    return best_bucket(n)


def _check(cell, cfg, ref_mod, state, pool, kept, n_img, device) -> dict:
    """The worst image's RMS error against the reference over the kept
    requests, with the limit of the cell's file; a request that returned
    the wrong number or shape of images reads infinite."""
    worst = 0.0 if kept else math.inf
    for idx, outs in kept:
        lr, zs = pool[idx % len(pool)]
        ref = reference_outputs(cell, cfg, ref_mod, state, lr, zs, device)
        if len(outs) != n_img or any(tuple(o.shape) != (1, *ref.shape[1:])
                                     for o in outs):
            worst = math.inf
            continue
        worst = max(worst, max(img_rms_errors(outs, ref)))
    return {'img_rms_err': (worst, cell['check']['limits']['img_rms_err'])}


def control_reading(cell, cfg, ref_mod, seed: int, device) -> dict:
    """The control's compared number: the reference at the control's
    precision in the program's place, on the ``check.sample`` first
    requests of ``seed``."""
    state = weights.make(ref_mod.shapes(cfg), cfg['init'], seed, device)
    pool = traffic.requests(cell['traffic'], cfg['latent_channels'],
                            cfg['scale'], seed)
    worst = 0.0
    for lr, zs in pool[:cell['check']['sample']]:
        ref = reference_outputs(cell, cfg, ref_mod, state, lr, zs, device)
        ctl = reference_outputs(cell, cfg, ref_mod, state, lr, zs, device,
                                precision=cell['check']['control'])
        worst = max(worst, max(img_rms_errors(list(ctl[:, None]), ref)))
    return {'img_rms_err': worst}
