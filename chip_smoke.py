"""Drive the PyTorch/CUDA port (``exsr_torch``) on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, one JSON line each:

1. environment: torch and CUDA versions, nvcc, the card and its power limit;
2. build: every hand-written kernel, compiled from ``exsr_torch/csrc``
   (ptxas's registers, spills and any "wgmma ... serialized" warning);
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (batch 16), with its time, the plain version's time and
   the card's lower bound for the same work (every ``ms`` by CUDA events
   around launches one by one); for the CEM filter's three entry points
   (same-size, polyphase down, polyphase up with and without the combine,
   ``exsr_torch.ops.kernels.measure.sepfilter_kernels``) also their
   equality, bit for bit, with their composition through the same-size
   kernel, the composition's time, their times as CUDA-graph replays
   (``graph_ms``: a short kernel launched one by one waits on the host)
   and ``CEMFilters.enforce`` alone on both routes; for the stage-4
   epilogue also its bytes per second and the time of the same epilogue as
   cuDNN conv plus elementwise ops (``library_chain_ms``); for the fused
   RDB the time of the port's unfused module on the same block (five cuDNN
   convs: ``library_chain_ms``) and the TFLOP/s it executes, halo included;
4. main path: the CEM-wrapped 23-block generator forward at full width
   (LR 128 -> HR 512, x4, bf16 trunk, fp32 CEM, seeded weights) serving
   three requests; CEM consistency, launch counts, time per forward, a
   profile of where the time goes, and a full-width fp32 forward on a small
   input against the same forward on the CPU;
5. fused path: the same generator as the canonical ``RRDBNet`` with
   ``fused_trunk=True`` (bf16 trunk through the fused RDB kernel, 69
   launches per forward), CEM-wrapped, serving three requests with the same
   checks, its difference from the main path's output, and its fp32
   reference check against the CPU;
6. serving entry point: ``build_model(4, dtype=bf16)`` and a
   ``bucketed_sweep``;
7. edit: the Z-edit engine through its entry point,
   ``EditSession(scale=4, nb=23, nf=64, latent_channels=3)`` with seeded
   weights on a 256 x 256 HR image, ``optimize('l1', max_iters=30)`` on LR
   windows of 16, 32 and 48 pixels (crops 40, 56, 64 with the margins),
   fp32 and bf16 trunks: ms per step (forward and backward), launches per
   step of each kernel (the CEM filter's backward through
   ``sepfilter_taps``), the loss falling, CEM consistency of the edited
   crop, every kernel of the step against its plain version at that
   window's shapes (``stage4`` forward and backward in each trunk dtype,
   the CEM filter's entry points and adjoints), one profiled round, and the
   full-width edit gradient on the card against the CPU's (fp32 on a small
   crop; bf16 on the window-16 crop, within twice the CPU's own bf16 gap).
8. eval_cli: the batch-evaluation CLI, ``exsr_torch.apps.eval_sr.main``,
   at full width (nb 23, nf 64, nz 3, x4) on three seeded synthetic
   512 x 512 PNGs with the LR synthesized (128): an 8-sample
   ``uniform_sweep`` with images, diversity maps and 3-frame Z-sweep GIFs
   (launches per forward, every summary key finite, every SR output on the
   card until ``tensor2img``), one image through the ``desired_im``
   optimizer mode (10 steps: 3 ``sepfilter_taps`` a step, a falling loss),
   a port checkpoint round trip through ``build_model`` (bit-equal), and
   ``MSRResNet`` and ``sr_resnet`` at nb 16, nf 64, LR 128 on the card
   against the CPU (1e-4);
9. batch sweep: ms per forward of ``build_model(4)`` (fp32, CEM,
   pre-padded) at LR 128 and batches 1-64, the table that
   ``exsr_torch.utils.serve.MS_PER_FWD`` holds;
10. even taps: the CEM filter's entry points with the 4-tap down and up
   filters of an estimated x3 kernel at LR 128, batch 16, against their
   plain versions (0.0, the shapes equal) and their adjoints (1e-5 of the
   largest output), and ``CEMFilters.enforce`` raising on the grown shape,
   as ``exsr``'s fails.

Phase 3 also checks and times ``sepfilter_taps``, the CEM filter's adjoint
kernel, at the edit shape and at the main path's batch-16 shapes.

Any failed check raises and the script exits non-zero.  The last lines are
the kernels summary, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

from exsr_torch.ops.kernels.measure import (BF16_FLOPS, FP32_FLOPS,
                                            bound_ms, cuda_ms,
                                            sepfilter_kernels,
                                            sepfilter_taps_kernels)

LR, SCALE, BATCH = 128, 4, 16
EDIT_HR, EDIT_WINDOWS, EDIT_ITERS = 256, (16, 32, 48), 30
EDIT_TAPS_LR = 56  # the window-32 crop, where phase 3 times the adjoints
# the CEM filter's entry points on the edit path (the view's forward and
# each step's)
EDIT_FILTER_CASES = ('sepfilter_edge[lr]', 'sepfilter_down',
                     'sepfilter_up[combine]')
# the CEM filter's entry points with the even taps of an estimated x3 kernel
EVEN_CASES = ('sepfilter_edge[hr]', 'sepfilter_edge[lr]', 'sepfilter_down',
              'sepfilter_up[up]', 'sepfilter_up[combine]')
# the even-tap case beside each entry point's row of the kernels line (the
# 4-tap filters: the same-size kernel at HR, the up kernel combined)
EVEN_ROW = {'edge': 'sepfilter_edge[hr]', 'down': 'sepfilter_down',
            'up': 'sepfilter_up[combine]'}
# the evaluation CLI: images, their HR size, the Z sweep, the GIF frames
# and the optimizer mode's iterations; the batch sweep behind MS_PER_FWD
EVAL_IMAGES, EVAL_HR, EVAL_NUM_Z, EVAL_GIF, EVAL_ITERS = 3, 512, 8, 3, 10
SWEEP_BATCHES, SWEEP_REPS = (1, 2, 4, 8, 16, 32, 64), 3
SWEEP_PROFILED = (1, 8)


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def phase_kernels(filt, device):
    import torch
    from exsr_torch.ops.kernels.stage4 import stage4, stage4_plain
    gen = torch.Generator(device=device).manual_seed(0)
    results = sepfilter_kernels(filt, gen, device, BATCH, LR)
    for name, rec in results.items():
        if name == 'cem_enforce':
            emit('cem_enforce', **rec)
        else:
            emit('kernel', name=name, **rec)
    # the CEM filter's backward: its three adjoints at the edit crop (batch
    # 1) and at the main path's shapes (batch 16, for the SR trainer)
    for tag, batch, lr in (('edit', 1, EDIT_TAPS_LR), ('main', BATCH, LR)):
        taps = sepfilter_taps_kernels(filt, gen, device, batch, lr)
        for kind, rec in taps.items():
            results[f'sepfilter_taps[{kind},{tag}]'] = rec
            emit('kernel', name=f'sepfilter_taps[{kind},{tag}]', **rec)

    # kernel 2: the stage-4 epilogue at LR 128, nf 64, gc 32
    nf, gc = 64, 32
    for dtype in (torch.bfloat16, torch.float32):
        args = stage4_inputs(gen, device, dtype, BATCH, LR, nf, gc)
        ref, err, tol = stage4_check(args, dtype)
        ms = cuda_ms(stage4, [args], 40)
        plain = cuda_ms(stage4_plain, [args], 40)
        pix = BATCH * LR * LR
        size = 2 if dtype == torch.bfloat16 else 4
        nbytes = size * pix * (gc + 4 * nf + 2 * nf) + 9 * gc * nf * size \
            + 4 * nf
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        bms, by = bound_ms(nbytes, 2 * 9 * gc * nf * pix, peak)
        tag = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        results[f'stage4_{tag}'] = dict(
            shape=[BATCH, LR, LR, nf], dtype=tag, max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
            gbytes_per_s=nbytes / ms / 1e6)
        if dtype == torch.bfloat16:
            results[f'stage4_{tag}'].update(stage4_chain(args, ref))
        emit('kernel', name=f'stage4[{tag}]', **results[f'stage4_{tag}'])
        del ref, args
    torch.cuda.empty_cache()
    results.update(kernel_rdb(gen, device))
    return results


def stage4_inputs(gen, device, dtype, batch, lr, nf=64, gc=32):
    """Random stage-4 inputs ``(c3, P0..P3, x, w4, b4)`` at LR ``lr``: P
    widths nf + 4gc .. nf + gc, w4 at the trunk's init scale (kaiming
    fan-in x 0.1), fp32 b4."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)
    c3 = rnd(batch, lr, lr, gc)
    ps = [rnd(batch, lr, lr, nf + k * gc) for k in (4, 3, 2, 1)]
    x = rnd(batch, lr, lr, nf)
    w4 = (torch.randn(3, 3, gc, nf, generator=gen, device=device)
          * 0.1 * (2.0 / (9 * gc)) ** 0.5).to(dtype)
    b4 = torch.randn(nf, generator=gen, device=device) * 0.1
    return (c3, *ps, x, w4, b4)


def stage4_check(args, dtype, where=''):
    """The kernel against ``stage4_plain`` on the same inputs: fp32 to
    1e-5, bf16 within one ulp.  Returns ``(plain output, max error,
    tolerance)``."""
    import torch
    from exsr_torch.ops.kernels.stage4 import stage4, stage4_plain
    out = stage4(*args)
    ref = stage4_plain(*args)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        tol = 1e-5
        check(err <= tol, f'stage4[fp32]{where} max error {err} > {tol}')
    else:
        # one bf16 ulp (<= 2^-7 relative): fp32 summation order may move
        # the scaled sum across a bf16 rounding boundary
        tol = '2^-7 * (1 + |ref|)'
        excess = (diff - 2 ** -7 * (1 + ref.float().abs())).max().item()
        check(excess <= 0, f'stage4[bf16]{where} error beyond one ulp: {err}')
    return ref, err, tol


def stage4_backward_check(args, gen, dtype, where=''):
    """The stage-4 Function's input gradients on the card (the kernel's
    forward, cuDNN's transposed conv) against the CPU's on the same inputs
    and cotangent: x and the P buffers exactly (0.2 g in the dtype), c3 to
    1e-5 of its largest in fp32, one bf16 ulp of its largest in bf16."""
    import torch
    from exsr_torch.ops.kernels.stage4 import stage4
    *inputs, w4, b4 = args
    cot = torch.randn(inputs[-1].shape, generator=gen,
                      device=inputs[0].device).to(dtype)
    grads = {}
    for dev in ('cpu', inputs[0].device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in inputs]
        stage4(*leaves, w4.to(dev), b4.to(dev)).backward(cot.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    ref, got = grads['cpu'], grads[str(inputs[0].device)]
    check(all(torch.equal(g, r) for g, r in zip(got[1:], ref[1:])),
          f'stage4[{dtype}]{where} backward: x or P gradient differs')
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    err = ((got[0].float() - ref[0].float()).abs().max()
           / ref[0].float().abs().max()).item()
    check(err <= tol, f'stage4[{dtype}]{where} backward: c3 gradient '
          f'relative error {err} > {tol}')
    return {'c3_grad_max_rel_err': err, 'c3_grad_tol': tol,
            'x_p_grads_equal': True}


def stage4_chain(args, ref):
    """A yardstick, not one call: the stage-4 epilogue as the grouped trunk
    would run it without the kernel, on the same inputs (one cuDNN bf16
    conv of c3 with b4, channels_last, then the four slice adds, the 0.2
    scale and + x in bf16).  The port never runs it."""
    import torch
    import torch.nn.functional as F
    c3, p0, p1, p2, p3, x, w4, b4 = args
    nf = x.shape[-1]
    w = w4.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = b4.to(c3.dtype)

    def chain(c3, p0, p1, p2, p3, x):
        conv = F.conv2d(c3.permute(0, 3, 1, 2), w, b, padding=1) \
            .permute(0, 2, 3, 1)
        acc = conv + p0[..., :nf]
        for p in (p1, p2, p3):
            acc = acc + p[..., :nf]
        return acc * 0.2 + x

    with torch.inference_mode():
        err = (chain(*args[:6]).float() - ref.float()).abs().max().item()
        ms = cuda_ms(chain, [args[:6]], 40)
    return {'library_chain_ms': ms, 'library_chain_max_abs_err': err}


def kernel_rdb(gen, device):
    """Kernel 3: one residual dense block at LR 128, nf 64, gc 32, nz 3."""
    import torch
    from exsr_torch.models.rrdb import ResidualDenseBlock
    from exsr_torch.ops.kernels.rrdb_block import (executed_flops_bf16,
                                                   pack_rdb, rdb, rdb_plain)
    nf, gc, nz = 64, 32, 3
    cins = [nz + nf + i * gc for i in range(5)]
    couts = [gc] * 4 + [nf]
    # fp32 parameters at kaiming fan-in x 0.5, nonzero biases
    ws = [torch.randn(co, ci, 3, 3, generator=gen, device=device)
          * 0.5 * (2.0 / (9 * ci)) ** 0.5 for ci, co in zip(cins, couts)]
    bs = [torch.randn(co, generator=gen, device=device) * 0.1
          for co in couts]
    results = {}
    for dtype, iters in ((torch.bfloat16, 20), (torch.float32, 4)):
        w = pack_rdb(ws, bs, dtype)
        sets = [(torch.randn(BATCH, LR, LR, nf, generator=gen,
                             device=device).to(dtype),
                 (torch.rand(BATCH, LR, LR, nz, generator=gen,
                             device=device) * 2 - 1).to(dtype), w)
                for _ in range(2)]
        out = rdb(*sets[0])
        ref = rdb_plain(*sets[0])
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            tol = 1e-5
            check(err <= tol, f'rdb[fp32] max error {err} > {tol}')
        else:
            # fp32 sums in another order may round a value to the other
            # bf16 neighbour: in the output (one ulp, <= 2^-7 relative) or
            # in an intermediate c_i, whose flip reaches the output diluted
            # but can exceed one ulp of an output close to zero
            tol = '2^-7 * |ref| + 2^-9'
            excess = (diff - (2 ** -7 * ref.float().abs() + 2 ** -9)).max()
            check(excess.item() <= 0, f'rdb[bf16] error {err} beyond {tol}')
        differ = (diff > 0).float().mean().item()
        ms = cuda_ms(rdb, sets, iters)
        plain = cuda_ms(rdb_plain, sets, max(2, iters // 4))
        pix = BATCH * LR * LR
        size = 2 if dtype == torch.bfloat16 else 4
        flops = 2 * 9 * pix * sum(ci * co for ci, co in zip(cins, couts))
        nbytes = size * pix * (nf + nz + nf) + size * sum(
            9 * ci * co for ci, co in zip(cins, couts)) + 4 * sum(couts)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        bms, by = bound_ms(nbytes, flops, peak)
        tag = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        results[f'rdb_{tag}'] = dict(
            shape=[BATCH, LR, LR, nf], dtype=tag, max_abs_err=err, tol=tol,
            share_differing=differ, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, tflops=flops / ms / 1e9)
        if dtype == torch.bfloat16:
            # A yardstick, not one call: the port's unfused module on the
            # same inputs and weights (five cuDNN bf16 convs on the growing
            # concat, leaky_relu, residual).  The fused path never runs it.
            chain = ResidualDenseBlock(nf, gc, nz).to(device)
            with torch.no_grad():
                for i in range(5):
                    conv = getattr(chain, f'conv{i}')
                    conv.weight.copy_(ws[i])
                    conv.bias.copy_(bs[i])
            chain = chain.bfloat16().to(memory_format=torch.channels_last)
            with torch.inference_mode():
                chain_sets = [(x.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2))
                              for x, z, _ in sets]
                results[f'rdb_{tag}'].update(
                    library_chain_ms=cuda_ms(chain, chain_sets, iters),
                    executed_tflops=executed_flops_bf16(BATCH, LR, LR, nf, gc)
                    / ms / 1e9)
            del chain, chain_sets
        emit('kernel', name=f'rdb[{tag}]', **results[f'rdb_{tag}'])
        del sets, out, ref, diff, w
    torch.cuda.empty_cache()
    return results


def _counted():
    from exsr_torch.ops.kernels.rrdb_block import rdb
    from exsr_torch.ops.kernels.sepfilter import (sepfilter_down,
                                                  sepfilter_edge,
                                                  sepfilter_taps,
                                                  sepfilter_up)
    from exsr_torch.ops.kernels.stage4 import stage4
    return {'sepfilter_edge': sepfilter_edge, 'sepfilter_down':
            sepfilter_down, 'sepfilter_up': sepfilter_up, 'stage4': stage4,
            'rdb': rdb, 'sepfilter_taps': sepfilter_taps}


def zero_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in _counted().items()}


def per_forward(forwards: int, stage4: int = 0, rdb: int = 0,
                backwards: int = 0) -> dict:
    """The exact launches of ``forwards`` CEM-wrapped forwards and
    ``backwards`` backwards: per forward 2 same-size filters (inv_hTh),
    1 down, 1 up-combine; per backward 3 adjoints (U^T, E^T, D^T)."""
    return {'sepfilter_edge': 2 * forwards, 'sepfilter_down': forwards,
            'sepfilter_up': forwards, 'stage4': stage4 * forwards,
            'rdb': rdb * forwards, 'sepfilter_taps': 3 * backwards}


def phase_main_path(cem, filt, device, name):
    import torch
    from exsr_torch.cem.cem import cem_wrap
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.models.rrdb_fast import (pack_grouped_params,
                                             rrdbnet_apply_fast)
    net = RRDBNet(nf=64, nb=23, gc=32, upscale=SCALE, latent_channels=3,
                  seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    state = {k: v.to(device) for k, v in net.state_dict().items()}
    packed = pack_grouped_params(state, dtype=torch.bfloat16)
    # the program bench.py times: grouped bf16 trunk, fp32 CEM, no pre-pad
    wrapped = cem_wrap(
        lambda pk, x, z: rrdbnet_apply_fast(None, x, z, packed=pk,
                                            dtype=torch.bfloat16),
        filt, upscale=SCALE)
    margins = cem.invalidity_margins_lr
    gen = torch.Generator(device=device).manual_seed(1)
    lr = torch.rand(BATCH, LR, LR, 3, generator=gen, device=device)
    zs = [torch.rand(BATCH, LR * SCALE, LR * SCALE, 3, generator=gen,
                     device=device) * 2 - 1 for _ in range(3)]

    def serve(z):
        return wrapped(packed, lr, z, margins, pre_pad=False)

    with torch.inference_mode():
        zero_launches()
        serve(zs[0])  # warm-up: first use of every library and kernel
        torch.cuda.synchronize()
        outs, times = [], []
        for z in zs:
            t0 = time.perf_counter()
            outs.append(serve(z))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        launches = read_launches()
        forwards = 1 + len(zs)
        check(launches == per_forward(forwards, stage4=69),
              f'launches {launches} over {forwards} forwards')

        # CUDA-event time of the same forward, back to back
        ms_events = cuda_ms(serve, [(z,) for z in zs], 6)
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        check(finite, 'non-finite output')
        check(all(tuple(o.shape) == (BATCH, LR * SCALE, LR * SCALE, 3)
                  for o in outs), 'output shape')
        cons = max((filt.downscale(o) - lr)[:, margins:-margins,
                                            margins:-margins].abs().max()
                   .item() for o in outs)
        check(cons < 5e-6, f'CEM consistency {cons} >= 5e-6')
        distinct = (outs[0] - outs[1]).abs().max().item()
        check(distinct > 0, 'different Z gave the same output')
        profile = profile_forward(serve, zs[0])
    grouped_out = outs[0]
    del outs
    torch.cuda.empty_cache()
    ms = sorted(times)[len(times) // 2]
    emit('main_path', device=name, batch=BATCH, lr=LR, scale=SCALE, nb=23,
         nf=64, gc=32, nz=3, params=n_params, trunk='bf16', cem='fp32',
         finite=finite, consistency_max=cons, consistency_tol=5e-6,
         launches=launches, forwards=forwards, request_ms=times,
         ms_per_forward=ms, img_per_s=1e3 * BATCH / ms,
         ms_per_forward_events=ms_events,
         img_per_s_events=1e3 * BATCH / ms_events, z_effect=distinct)
    emit('profile', **profile)
    emit('reference', **reference_check(net, cem, device))
    return launches, forwards, (lr, zs, grouped_out)


def phase_fused_path(cem, filt, device, name, inputs):
    """The canonical RRDBNet with the fused trunk, CEM-wrapped, serving
    the main path's requests on the same seeded weights."""
    import torch
    from exsr_torch.cem.cem import cem_wrap
    from exsr_torch.models.rrdb import RRDBNet

    lr, zs, grouped_out = inputs
    net = RRDBNet(nf=64, nb=23, gc=32, upscale=SCALE, latent_channels=3,
                  seed=0, dtype=torch.bfloat16, fused_trunk=True).to(device)
    wrapped = cem_wrap(lambda _, x, z: net(x, z), filt, upscale=SCALE)
    margins = cem.invalidity_margins_lr

    def serve(z):
        return wrapped(None, lr, z, margins, pre_pad=False)

    with torch.inference_mode():
        zero_launches()
        serve(zs[0])  # warm-up, and the trunk's weights packed once
        torch.cuda.synchronize()
        outs, times = [], []
        for z in zs:
            t0 = time.perf_counter()
            outs.append(serve(z))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        launches = read_launches()
        forwards = 1 + len(zs)
        check(launches == per_forward(forwards, rdb=69),
              f'fused launches {launches} over {forwards} forwards')
        ms_events = cuda_ms(serve, [(z,) for z in zs], 6)
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        check(finite, 'non-finite fused output')
        check(all(tuple(o.shape) == (BATCH, LR * SCALE, LR * SCALE, 3)
                  for o in outs), 'fused output shape')
        cons = max((filt.downscale(o) - lr)[:, margins:-margins,
                                            margins:-margins].abs().max()
                   .item() for o in outs)
        check(cons < 5e-6, f'fused CEM consistency {cons} >= 5e-6')
        distinct = (outs[0] - outs[1]).abs().max().item()
        check(distinct > 0, 'different Z gave the same fused output')
        # same weights and inputs through the grouped and the fused bf16
        # trunks: they round in different places, so this is a number to
        # read, not a check
        vs_grouped = (outs[0] - grouped_out).abs()
        profile = profile_forward(serve, zs[0])
    del outs, net
    torch.cuda.empty_cache()
    ms = sorted(times)[len(times) // 2]
    emit('fused_path', device=name, model='RRDBNet(fused_trunk=True)',
         batch=BATCH, lr=LR, scale=SCALE, nb=23, nf=64, gc=32, nz=3,
         trunk='bf16', cem='fp32', finite=finite, consistency_max=cons,
         consistency_tol=5e-6, launches=launches, forwards=forwards,
         request_ms=times, ms_per_forward=ms, img_per_s=1e3 * BATCH / ms,
         ms_per_forward_events=ms_events,
         img_per_s_events=1e3 * BATCH / ms_events, z_effect=distinct,
         max_abs_diff_vs_grouped=vs_grouped.max().item(),
         mean_abs_diff_vs_grouped=vs_grouped.mean().item())
    emit('fused_profile', **profile)
    emit('fused_reference', **fused_reference_check(cem, device))
    return launches, forwards


def profile_forward(serve, z):
    """Device time by kernel over one forward (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(z)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    def self_us(e):
        return getattr(e, 'self_device_time_total', None) or \
            getattr(e, 'self_cuda_time_total', 0)
    # aten:: ops repeat the device time of the kernels they launch, and
    # 'Command Buffer Full' records the host waiting on a full launch queue
    stall = 'Command Buffer Full'
    events = prof.key_averages()
    kernels = sorted(((e.key, self_us(e), e.count) for e in events
                      if self_us(e) > 0 and not e.key.startswith('aten::')
                      and e.key != stall), key=lambda t: -t[1])
    total = sum(t[1] for t in kernels)
    ours = {k: sum(t[1] for t in kernels if k in t[0])
            for k in ('sepfilter_edge_kernel', 'sepfilter_down_kernel',
                      'sepfilter_up_kernel', 'stage4_kernel', 'rdb_kernel',
                      'sepfilter_taps_kernel')}
    return {'device_us_total': total, 'wall_us': wall_us,
            'device_busy_share': total / wall_us,
            'kernel_calls': sum(t[2] for t in kernels),
            'host_waits_on_full_queue_us': sum(
                self_us(e) for e in events if e.key == stall),
            'share': {k: (v / total if total else None)
                      for k, v in ours.items()},
            'top': [{'kernel': k[:90], 'us': us, 'calls': n}
                    for k, us, n in kernels[:16]]}


def reference_check(net, cem, device):
    """Full-width fp32 forward on a small input, on the card (kernels) and
    on the CPU (plain versions); fp32 with TF32 off on both sides."""
    import torch
    from exsr_torch.cem.cem import cem_wrap
    from exsr_torch.models.rrdb_fast import rrdbnet_apply_fast
    gen = torch.Generator().manual_seed(2)
    lr = torch.rand(2, 16, 16, 3, generator=gen)
    z = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    outs = {}
    for dev in ('cpu', device):
        state = {k: v.to(dev) for k, v in net.state_dict().items()}
        wrapped = cem_wrap(
            lambda p, x, zz: rrdbnet_apply_fast(p, x, zz, dtype=None),
            cem.device_filters(3, device=dev), upscale=SCALE)
        with torch.inference_mode():
            outs[str(dev)] = wrapped(state, lr.to(dev), z.to(dev),
                                     cem.invalidity_margins_lr,
                                     pre_pad=True).cpu()
    err = (outs['cpu'] - outs[str(device)]).abs().max().item()
    # fp32 through ~140 convs summed in another order on each side
    check(err < 1e-4, f'card vs CPU max error {err} >= 1e-4')
    return {'shape': [2, 16, 16, 3], 'dtype': 'fp32', 'pre_pad': True,
            'max_abs_err': err, 'tol': 1e-4}


def fused_reference_check(cem, device):
    """The fused-trunk generator, full width, fp32, on a small input: the
    kernels on the card against the plain versions on the CPU."""
    import torch
    from exsr_torch.cem.cem import cem_wrap
    from exsr_torch.models.rrdb import RRDBNet
    net = RRDBNet(nf=64, nb=23, gc=32, upscale=SCALE, latent_channels=3,
                  seed=0, fused_trunk=True)
    gen = torch.Generator().manual_seed(4)
    lr = torch.rand(2, 16, 16, 3, generator=gen)
    z = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    outs = {}
    for dev in ('cpu', device):
        net.to(dev)
        wrapped = cem_wrap(lambda _, x, zz: net(x, zz),
                           cem.device_filters(3, device=dev), upscale=SCALE)
        with torch.inference_mode():
            outs[str(dev)] = wrapped(None, lr.to(dev), z.to(dev),
                                     cem.invalidity_margins_lr,
                                     pre_pad=True).cpu()
    err = (outs['cpu'] - outs[str(device)]).abs().max().item()
    # fp32 through ~350 convs summed in another order on each side
    check(err < 1e-4, f'fused card vs CPU max error {err} >= 1e-4')
    return {'shape': [2, 16, 16, 3], 'dtype': 'fp32', 'pre_pad': True,
            'max_abs_err': err, 'tol': 1e-4}


def _window_mask(w_lr: int):
    """An HR region mask: a centred square of ``w_lr`` LR pixels."""
    import numpy as np
    mask = np.zeros((EDIT_HR, EDIT_HR), np.float32)
    lo = (EDIT_HR - SCALE * w_lr) // 2
    mask[lo:lo + SCALE * w_lr, lo:lo + SCALE * w_lr] = 1.0
    return mask


def phase_edit(device, name):
    """The Z-edit engine at full width through EditSession: l1 edits on
    three windows in fp32 and bf16, each step a forward and a backward of
    the CEM-wrapped grouped 23-block generator on the window's crop."""
    import numpy as np
    import torch
    from exsr_torch.apps.session import EditSession
    img = np.random.default_rng(5).uniform(size=(EDIT_HR, EDIT_HR, 3)) \
        .astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(7)
    runs, profiles = [], {}
    for tag, dtype in (('fp32', None), ('bf16', torch.bfloat16)):
        sess = EditSession(scale=SCALE, nb=23, nf=64, latent_channels=3,
                           edit_dtype=dtype, device=device,
                           time_budget_s=600.0)
        sess.init_random_params(0)
        sess.open_image(img)
        margins = sess.cem.invalidity_margins_lr
        for w in EDIT_WINDOWS:
            mask = _window_mask(w)
            sess.set_region(mask)
            desired = sess.sr.copy()
            desired[:, mask > 0] = 0.7
            data = {'desired': desired}
            # warm-up: the crop's first forward and backward
            sess.optimize('l1', data=data, max_iters=5)
            sess.undo()
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            res = sess.optimize('l1', data=data, max_iters=EDIT_ITERS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            steps = len(res['losses'])
            # optimize ends with one no-grad forward of the whole view
            check(launches == per_forward(steps + 1, stage4=69,
                                          backwards=steps),
                  f'edit launches {launches} over {steps} steps')
            view = per_forward(1, stage4=69)
            t0 = time.perf_counter()
            sess.recompute()
            torch.cuda.synchronize()
            view_s = time.perf_counter() - t0
            losses = res['losses']
            check(steps == EDIT_ITERS and all(map(np.isfinite, losses)),
                  f'edit losses {losses}')
            check(losses[-1] < losses[0], f'edit loss did not fall: '
                  f'{losses[0]} -> {losses[-1]}')
            y0, y1, x0, x1 = sess._crop_box()
            with torch.no_grad():
                lr_crop = torch.as_tensor(sess.lr_image[:, y0:y1, x0:x1],
                                          device=device)
                z_crop = torch.as_tensor(
                    sess.cur_z[:, SCALE * y0:SCALE * y1,
                               SCALE * x0:SCALE * x1], device=device)
                out = sess._wrapped(sess.eff_params, lr_crop, z_crop,
                                    margins, pre_pad=False)
                cons = (sess.filters.downscale(out) - lr_crop)[
                    :, margins:-margins, margins:-margins].abs().max().item()
            check(cons < 5e-6, f'edited crop consistency {cons} >= 5e-6')
            crop = int(y1 - y0)
            check(crop == x1 - x0, f'edit crop {(y0, y1, x0, x1)} not square')
            emit('edit_kernels', trunk=tag, window_lr=w, crop_lr=crop,
                 **edit_kernel_checks(sess.filters, gen, device, crop, dtype,
                                      filters=tag == 'fp32'))
            parts = {}
            if w == 32:
                # one round of 5 steps (and the view's forward) profiled
                profiles[tag] = profile_forward(
                    lambda _: sess.optimize('l1', data=data, max_iters=5),
                    None)
                sess.undo()
                parts = step_parts(sess, lr_crop, z_crop, desired,
                                   (y0, y1, x0, x1))
            sess.undo()
            sess.clear_region()
            run = dict(trunk=tag, window_lr=w, crop_lr=int(y1 - y0),
                       steps=steps, ms_per_step=1e3 * (wall - view_s) / steps,
                       optimize_s=wall, view_forward_s=view_s,
                       launches=launches,
                       launches_per_step={
                           k: (v - view[k]) / steps
                           for k, v in launches.items()},
                       first_loss=losses[0], last_loss=losses[-1],
                       rounds=res['rounds'], consistency_max=cons,
                       consistency_tol=5e-6, **parts)
            runs.append(run)
            emit('edit', device=name, **run)
        del sess
        torch.cuda.empty_cache()
    for tag, prof in profiles.items():
        emit('edit_profile', trunk=tag, window_lr=32,
             what='one round of 5 steps and the view forward', **prof)
    emit('edit_reference', **edit_gradient_check(device))
    return runs


def edit_kernel_checks(filt, gen, device, crop, dtype, filters):
    """The kernels of an edit step at its window's shapes (batch 1, LR
    ``crop``), each against its plain version at phase 3's tolerances: the
    stage-4 epilogue forward and backward in the trunk's dtype and, with
    ``filters``, the CEM filter's entry points and its three adjoints
    (fp32 in both trunks, so checked once a window)."""
    import torch
    from exsr_torch.ops.kernels.stage4 import stage4
    dtype = dtype or torch.float32
    keep = ('shape', 'shape_in', 'max_abs_err', 'max_rel_err', 'tol', 'ms',
            'graph_ms')
    where = f' at edit crop {crop}'
    args = stage4_inputs(gen, device, dtype, 1, crop)
    _, err, tol = stage4_check(args, dtype, where)
    out = {'stage4': {'shape': [1, crop, crop, 64], 'max_abs_err': err,
                      'tol': tol, 'ms': cuda_ms(stage4, [args], 20),
                      **stage4_backward_check(args, gen, dtype, where)}}
    del args
    if filters:
        recs = sepfilter_kernels(filt, gen, device, 1, crop,
                                 cases=EDIT_FILTER_CASES, references=False)
        recs.update({f'sepfilter_taps[{k}]': r for k, r in
                     sepfilter_taps_kernels(filt, gen, device, 1,
                                            crop).items()})
        out.update({name: {k: v for k, v in rec.items() if k in keep}
                    for name, rec in recs.items()})
    return out


def step_parts(sess, lr_crop, z_crop, desired, box, reps=5):
    """Host time of an edit step's parts on its crop, each ending in a
    synchronize: the forward without autograd, the forward recording it
    (to the loss), and the backward; and the device memory that one step
    adds at its peak (what autograd keeps alive for the backward)."""
    import torch
    y0, y1, x0, x1 = box
    m = torch.as_tensor(sess.region_mask_hr[SCALE * y0:SCALE * y1,
                                            SCALE * x0:SCALE * x1],
                        device=z_crop.device)[None, :, :, None]
    d = torch.as_tensor(desired[:, SCALE * y0:SCALE * y1,
                                SCALE * x0:SCALE * x1], device=z_crop.device)
    fwd = sess._crop_fwd[False]
    times = {'forward_nograd_ms': 0.0, 'forward_ms': 0.0,
             'backward_ms': 0.0}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        with torch.no_grad():
            fwd(sess.eff_params, lr_crop, z_crop)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        z = z_crop.clone().requires_grad_(True)
        loss = (fwd(sess.eff_params, lr_crop, z) * m - d * m).abs().mean()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[k] += 1e3 * dt / reps
        del loss, z
    times['step_peak_mb'] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return times


def edit_gradients(runs, crop, lo, hi, seed):
    """d(masked l1)/dZ of an edit window's forward, ``EditSession``'s own
    (the clipped CEM-wrapped grouped 23-block generator at full width on
    seeded weights, no pre-pad), on an LR ``crop`` input made from
    ``seed`` with the HR mask ``[lo:hi, lo:hi]``, for each ``(device,
    edit_dtype)`` of ``runs``, as CPU tensors."""
    import numpy as np
    import torch
    from exsr_torch.apps.session import EditSession
    rng = np.random.default_rng(seed)
    hr = SCALE * crop
    lr = rng.uniform(size=(1, crop, crop, 3)).astype(np.float32)
    z = rng.uniform(-0.9, 0.9, size=(1, hr, hr, 3)).astype(np.float32)
    desired = rng.uniform(size=(1, hr, hr, 3)).astype(np.float32)
    mask = np.zeros((1, hr, hr, 1), np.float32)
    mask[:, lo:hi, lo:hi] = 1.0
    grads = []
    for dev, dtype in runs:
        sess = EditSession(scale=SCALE, nb=23, nf=64, latent_channels=3,
                           edit_dtype=dtype, device=dev)
        sess.init_random_params(0)
        zt = sess._t(z).requires_grad_(True)
        m, d = sess._t(mask), sess._t(desired)
        out = sess._crop_fwd[False](sess.eff_params, sess._t(lr), zt)
        (out * m - d * m).abs().mean().backward()
        grads.append(zt.grad.cpu())
        del sess, zt, out
    return grads


def edit_gradient_check(device):
    """The edit gradient on the card against the CPU's (plain versions),
    TF32 off: in fp32 on a small crop (LR 24) to 1e-4 of its largest; in
    bf16 on the window-16 crop (LR 40) by the gap method: the card's bf16
    gradient is no further from the CPU's fp32 one than twice the CPU's
    own bf16 gradient is (each relative to the largest fp32 value)."""
    import torch
    bf16 = torch.bfloat16

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.abs().max()).item()
    ref, got = edit_gradients([('cpu', None), (device, None)], 24, 40, 56, 6)
    err = rel(got, ref)
    # fp32 through ~140 convs and their transposes, summed in another
    # order on each side
    check(err < 1e-4, f'edit gradient card vs CPU relative error {err}')
    fp32 = {'shape': [1, 24, 24, 3], 'dtype': 'fp32', 'pre_pad': False,
            'max_rel_err': err, 'tol': 1e-4,
            'grad_max': ref.abs().max().item()}
    # the window-16 crop: 16 LR pixels in the middle, the margins around
    # them, bucketed to 8
    crop = 40
    ref, cpu16, card16 = edit_gradients(
        [('cpu', None), ('cpu', bf16), (device, bf16)], crop, 48, 112, 8)
    gap, err = rel(cpu16, ref), rel(card16, ref)
    check(err <= 2 * gap, f'bf16 edit gradient: card {err} from fp32, '
          f'beyond 2x the CPU bf16 gap {gap}')
    bf16_rec = {'shape': [1, crop, crop, 3], 'dtype': 'bf16',
                'pre_pad': False, 'card_vs_cpu_fp32_rel': err,
                'cpu_bf16_vs_cpu_fp32_rel': gap, 'tol': '2x the CPU gap',
                'card_vs_cpu_bf16_rel': rel(card16, cpu16),
                'grad_max': ref.abs().max().item()}
    return {'fp32': fp32, 'bf16': bf16_rec}


def phase_serving():
    import torch
    from exsr_torch.apps.eval_sr import bucketed_sweep, build_model
    cem, forward = build_model(SCALE, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    lr = torch.rand(1, 64, 64, 3, generator=gen)
    zs = [torch.full((1, 256, 256, 3), v) for v in (-1.0, -0.5, 0.0, 0.5,
                                                     1.0)]
    zero_launches()
    t0 = time.perf_counter()
    outs = bucketed_sweep(forward, lr, zs)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    check(launches == per_forward(1, stage4=69),
          f'serving launches {launches}')
    check(len(outs) == len(zs), 'one output per Z')
    for o in outs:
        check(tuple(o.shape) == (1, 256, 256, 3), f'shape {o.shape}')
        check(o.device.type == 'cuda' and bool(torch.isfinite(o).all()),
              'finite CUDA output')
        check(0.0 <= o.min().item() and o.max().item() <= 1.0, 'clip')
    emit('serving',
         entry='exsr_torch.apps.eval_sr.build_model(4, dtype=bfloat16)',
         sweep=len(zs), lr=64, pre_pad=True,
         margins_lr=cem.invalidity_margins_lr, launches=launches,
         ms_first_call=ms)
    return launches


def phase_even_taps(device):
    """The CEM filter's entry points and adjoints with even tap counts, on
    the card against their plain versions: the x3 CEM of an estimated
    13 x 13 Gaussian kernel (sigma 1), whose down and up filters have 4
    taps, at LR 128 and batch 16.  An even tap count grows the same-size
    and up filters' outputs by one pixel, as exsr's filters do; exsr's
    enforce then fails on the shapes, and so does the port's."""
    import torch
    from exsr_torch.cem.cem import CEM, CEMConf
    from exsr_torch.ops.resize import gaussian_2d
    cem = CEM.create(CEMConf(scale_factor=3),
                     upscale_kernel=gaussian_2d(1.0, 13))
    filt = cem.device_filters(3, device=device)
    taps = {k: [t.numel() for t in getattr(filt, k)]
            for k in ('w_down_1d', 'w_up_1d', 'w_inv_hth_1d')}
    check(taps['w_down_1d'] == [4, 4] and taps['w_up_1d'] == [4, 4],
          f'expected 4-tap down and up filters, got {taps}')
    gen = torch.Generator(device=device).manual_seed(9)
    kern = sepfilter_kernels(filt, gen, device, BATCH, LR,
                             cases=EVEN_CASES, graph_hr=True)
    for name, rec in kern.items():
        # the kernels take the taps in the plain version's order
        check(rec['max_abs_err'] <= 0.0,
              f'even taps: {name} differs from its plain version by '
              f'{rec["max_abs_err"]}')
        emit('even_taps', name=name, **rec)
    adj = sepfilter_taps_kernels(filt, gen, device, BATCH, LR)
    for kind, rec in adj.items():
        emit('even_taps', name=f'sepfilter_taps[{kind}]', **rec)
    lr = torch.rand(1, LR, LR, 3, generator=gen, device=device)
    g = torch.rand(1, 3 * LR, 3 * LR, 3, generator=gen, device=device)
    try:
        filt.enforce(lr, g)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None, 'enforce took a g of another size than the '
          'even up filter\'s output')
    emit('even_taps', name='cem_enforce', raises=raised[:120],
         taps=taps)
    return kern, adj


def _write_pngs(directory, n, size, seed):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    for i in range(n):
        # smooth content plus noise: a test image, not white noise
        yy, xx = np.mgrid[:size, :size] / size
        base = np.stack([np.sin(2 * np.pi * (f * yy + g * xx))
                         for f, g in rng.uniform(0.5, 4, size=(3, 2))], -1)
        img = 0.5 + 0.35 * base + 0.1 * rng.standard_normal(base.shape)
        Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(
            np.uint8)).save(f'{directory}/im{i}.png')


def phase_eval_cli(device, name):
    """The batch-evaluation CLI at full width on the card: a Z sweep over
    three 512 x 512 images, one image through the optimizer latent mode, a
    checkpoint round trip, the plain SR architectures against the CPU, and
    the batch sweep behind ``MS_PER_FWD``."""
    import json as _json
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from exsr_torch.apps import eval_sr
    from exsr_torch.apps.session import EditSession
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    from exsr_torch.utils import color
    seen, tensor2img = [], color.tensor2img

    def recording(x, *a, **k):
        seen.append(x.device.type if isinstance(x, torch.Tensor)
                    else 'host')
        return tensor2img(x, *a, **k)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        hr_dir, out = f'{tmp}/hr', f'{tmp}/out'
        os.makedirs(hr_dir)
        _write_pngs(hr_dir, EVAL_IMAGES, EVAL_HR, seed=11)
        color.tensor2img = recording
        try:
            zero_launches()
            t0 = time.perf_counter()
            summary = eval_sr.main([
                '--hr_dir', hr_dir, '--latent', 'uniform_sweep',
                '--num_z', str(EVAL_NUM_Z), '--save_images',
                '--save_std_map', '--z_sweep_gif', str(EVAL_GIF),
                '--out_dir', out])
            sweep_s = time.perf_counter() - t0
        finally:
            color.tensor2img = tensor2img
        launches = read_launches()
        forwards = EVAL_IMAGES * (1 + EVAL_GIF)
        check(launches == per_forward(forwards, stage4=69),
              f'eval_cli launches {launches} over {forwards} forwards')
        keys = ('num_images', 'avg_psnr', 'avg_ssim', 'avg_consistency_mae',
                'avg_per_pixel_std', 'avg_hr_std', 'avg_sr_high_freq_std')
        check(all(k in summary and math.isfinite(summary[k]) for k in keys),
              f'eval_cli summary {summary}')
        check(summary['num_images'] == EVAL_IMAGES, 'eval_cli image count')
        check(summary['avg_consistency_mae'] < 1e-5,
              f'eval_cli consistency {summary["avg_consistency_mae"]}')
        # SR outputs and GIF frames reach tensor2img on the card; the
        # ground truth comes from the dataset, on the host
        check(seen.count('cuda') == EVAL_IMAGES * (1 + EVAL_GIF)
              and seen.count('host') == EVAL_IMAGES
              and len(seen) == EVAL_IMAGES * (2 + EVAL_GIF),
              f'tensor2img inputs {seen}')
        for i in range(EVAL_IMAGES):
            for suffix in ('_SR.png', '_STDmap.png', '_Zsweep.gif'):
                check(os.path.exists(f'{out}/im{i}{suffix}'),
                      f'missing im{i}{suffix}')
        with open(f'{out}/summary.json') as f:
            per_image = _json.load(f)['per_image']
        results['sweep'] = dict(
            images=EVAL_IMAGES, hr=EVAL_HR, num_z=EVAL_NUM_Z,
            gif_frames=EVAL_GIF, launches=launches, forwards=forwards,
            ms_per_image=[1e3 * r['time_s'] for r in per_image],
            wall_s=sweep_s, summary=summary)

        # the optimizer latent mode on one image; its result is read
        # through a wrapper around EditSession.optimize
        runs = []
        optimize = EditSession.optimize

        def recorded(self, *a, **k):
            runs.append(optimize(self, *a, **k))
            return runs[-1]
        EditSession.optimize = recorded
        try:
            zero_launches()
            t0 = time.perf_counter()
            opt_summary = eval_sr.main([
                '--hr_dir', hr_dir, '--latent', 'desired_im',
                '--num_z_iters', str(EVAL_ITERS), '--max_images', '1',
                '--out_dir', f'{tmp}/optimizer'])
            opt_s = time.perf_counter() - t0
        finally:
            EditSession.optimize = optimize
        launches = read_launches()
        losses = runs[0]['losses']
        steps = len(losses)
        # open_image's view forward, the steps, optimize's view forward
        check(launches == per_forward(steps + 2, stage4=69,
                                      backwards=steps),
              f'eval_cli optimizer launches {launches} over {steps} steps')
        check(steps == EVAL_ITERS and losses[-1] < losses[0],
              f'eval_cli optimizer losses {losses}')
        with open(f'{tmp}/optimizer/summary.json') as f:
            opt_ms = 1e3 * _json.load(f)['per_image'][0]['time_s']
        results['optimizer'] = dict(
            latent='desired_im', steps=steps, launches=launches,
            taps_per_step=launches['sepfilter_taps'] / steps,
            first_loss=losses[0], last_loss=losses[-1], ms_per_image=opt_ms,
            ms_per_step=opt_ms / steps, wall_s=opt_s, summary=opt_summary)

        # checkpoint round trip on the card
        net = RRDBNet(nf=64, nb=23, upscale=SCALE, latent_channels=3,
                      seed=3)
        CheckpointManager(f'{tmp}/ckpt').save(0, {'g_params':
                                                  net.state_dict()})
        gen = torch.Generator().manual_seed(13)
        lr = torch.rand(1, 64, 64, 3, generator=gen)
        z = torch.rand(1, 256, 256, 3, generator=gen) * 2 - 1
        _, f_ckpt = eval_sr.build_model(SCALE, checkpoint=f'{tmp}/ckpt')
        _, f_net = eval_sr.build_model(SCALE, params=net)
        # cuDNN may pick convolution algorithms whose sums run in another
        # order from one call to the next: bit-equality is asked of
        # deterministic ones; the default's spread is recorded beside it
        spread = (f_net(lr, z) - f_net(lr, z)).abs().max().item()
        torch.backends.cudnn.deterministic = True
        try:
            a, b = f_ckpt(lr, z), f_net(lr, z)
        finally:
            torch.backends.cudnn.deterministic = False
        check(a.device.type == 'cuda' and torch.equal(a, b),
              'checkpoint round trip differs')
        results['checkpoint'] = dict(bit_equal=True, shape=list(a.shape),
                                     cudnn_deterministic=True,
                                     default_repeat_max_abs_diff=spread)
        del f_ckpt, f_net, a, b, net

    # the plain SR architectures at their full width, card against CPU
    plain = {}
    gen = torch.Generator().manual_seed(17)
    lr = torch.rand(1, LR, LR, 3, generator=gen)
    for arch, cls in eval_sr.PLAIN_ARCHS.items():
        net = cls(nf=64, nb=16, upscale=SCALE, seed=5)
        outs = {}
        for dev in ('cpu', device):
            _, fwd = eval_sr.build_model(SCALE, nb=16, nf=64,
                                         latent_channels=0, device=dev,
                                         params=net, arch=arch,
                                         use_cem=False)
            outs[str(dev)] = fwd(lr)
        check(outs[str(device)].device.type == 'cuda', f'{arch} off card')
        err = (outs[str(device)].cpu() - outs['cpu']).abs().max().item()
        check(err <= 1e-4, f'{arch} card vs CPU max error {err} > 1e-4')
        plain[arch] = dict(shape=list(outs['cpu'].shape), max_abs_err=err,
                           tol=1e-4)
    results['plain_archs'] = plain
    results['phase_s'] = time.perf_counter() - t_phase
    emit('eval_cli', device=name, **results)
    return results


def phase_batch_sweep(name):
    """ms per forward of ``build_model(4)`` as served by default (fp32
    trunk, CEM, pre-padded) at LR 128, by batch: the host clock around
    each request ending in a synchronize, the median of warm repetitions.
    This table is ``exsr_torch.utils.serve.MS_PER_FWD``.  The forwards at
    batches 1 and 8 are also profiled: where the fp32 forward's time
    goes."""
    import torch
    from exsr_torch.apps.eval_sr import build_model
    _, forward = build_model(SCALE)
    gen = torch.Generator(device='cuda').manual_seed(19)
    table, profiles = {}, {}
    for b in SWEEP_BATCHES:
        lr = torch.rand(b, LR, LR, 3, generator=gen, device='cuda')
        z = torch.rand(b, LR * SCALE, LR * SCALE, 3, generator=gen,
                       device='cuda') * 2 - 1
        forward(lr, z)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(SWEEP_REPS):
            t0 = time.perf_counter()
            forward(lr, z)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        table[b] = sorted(times)[len(times) // 2]
        if b in SWEEP_PROFILED:
            profiles[b] = profile_forward(lambda zz: forward(lr, zz), z)
        del lr, z
    torch.cuda.empty_cache()
    emit('batch_sweep', device=name, lr=LR, scale=SCALE, trunk='fp32',
         cem='fp32', pre_pad=True, reps=SWEEP_REPS, what='median ms per '
         'forward', ms_per_fwd=table,
         img_per_s={b: 1e3 * b / t for b, t in table.items()})
    for b, prof in profiles.items():
        emit('batch_sweep_profile', batch=b, **prof)
    return table


def taps_row(kern, edit_runs):
    """The CEM filter's adjoint kernel on the edit path: its three launches
    of one backward (U^T, E^T, D^T) at the window-32 crop, summed; the
    launches are those of the fp32 window-32 edit run."""
    run = next(r for r in edit_runs if r['trunk'] == 'fp32'
               and r['window_lr'] == 32)
    parts = {k: kern[f'sepfilter_taps[{k},edit]'] for k in 'UED'}
    bms = sum(p['bound_ms'] for p in parts.values())
    return {'name': 'sepfilter_taps', 'route': 'cuda', 'library_ms': None,
            'source': 'exsr_torch/csrc/sepfilter.cu',
            'replaces': 'exsr/ops/pallas/sepfilter.py:76 (its adjoint: '
                        'the TPU kernel has no backward)',
            'path': 'edit', 'steps': run['steps'],
            'launches': run['launches']['sepfilter_taps'],
            'launches_per_step': run['launches']['sepfilter_taps']
            / run['steps'],
            'max_abs_err': max(p['max_abs_err'] for p in parts.values()),
            'ms': sum(p['ms'] for p in parts.values()),
            'graph_ms': sum(p['graph_ms'] for p in parts.values()),
            'plain_ms': sum(p['plain_ms'] for p in parts.values()),
            'bound_ms': bms,
            'bound_by': 'bytes' if all(p['bound_by'] == 'bytes'
                                       for p in parts.values())
            else 'operations',
            'shape': parts['E']['shape_in']}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from exsr_torch.cem.cem import CEM, CEMConf
    from exsr_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit('environment', torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=build.nvcc_path(), device=name, nvidia_smi=smi,
         device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    report = build.build()
    emit('build', seconds=time.perf_counter() - t0,
         built={k: v['seconds'] for k, v in report.items()},
         ptxas=[ln.strip() for v in report.values()
                for ln in v['ptxas'].splitlines()
                if 'registers' in ln or 'spill' in ln or 'C75' in ln])

    cem = CEM.create(CEMConf(scale_factor=SCALE))
    filt = cem.device_filters(3, device=device)
    kern = phase_kernels(filt, device)
    launches, forwards, inputs = phase_main_path(cem, filt, device, name)
    fused_launches, fused_forwards = phase_fused_path(cem, filt, device,
                                                      name, inputs)
    del inputs
    phase_serving()
    edit_runs = phase_edit(device, name)
    phase_eval_cli(device, name)
    phase_batch_sweep(name)
    even, even_taps = phase_even_taps(device)

    # launches: the total over the forwards of the path that runs the
    # kernel (the main path; the fused path for rdb)
    common = {'route': 'cuda', 'library_ms': None}
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'shape')
    sep = {'source': 'exsr_torch/csrc/sepfilter.cu',
           'replaces': 'exsr/ops/pallas/sepfilter.py:76', 'path': 'main'}

    def row(name, kern_key, path_launches, forwards, **extra):
        n = path_launches[name]
        return {'name': name, **common, **extra, 'forwards': forwards,
                'launches': n, 'launches_per_forward': n // forwards,
                **{k: kern[kern_key][k] for k in keys}}
    # the same-size filter runs at LR on the main path: its row is timed
    # there, with its HR times (not on the path since the polyphase
    # kernels) beside them
    hr = kern['sepfilter_edge[hr]']
    summary = [
        row(f'sepfilter_{k}', key, launches, forwards, **sep, **extra,
            graph_ms=kern[key]['graph_ms'],
            **{f'even_taps_{f}': even[EVEN_ROW[k]][f] for f in (
                'taps', 'shape', 'max_abs_err', 'ms', 'graph_ms',
                'bound_ms')})
        for k, key, extra in (
            ('edge', 'sepfilter_edge[lr]', {
                'hr_ms': hr['ms'], 'hr_plain_ms': hr['plain_ms'],
                'hr_bound_ms': hr['bound_ms']}),
            ('down', 'sepfilter_down', {}),
            ('up', 'sepfilter_up[combine]', {'mode': 'combine'}))] + [
        row('stage4', 'stage4_bf16', launches, forwards,
            source='exsr_torch/csrc/stage4.cu',
            replaces='exsr/ops/pallas/stage4.py:82', path='main'),
        row('rdb', 'rdb_bf16', fused_launches, fused_forwards,
            source='exsr_torch/csrc/rdb.cu',
            replaces='exsr/ops/pallas/rrdb_block.py:145', path='fused'),
        dict(taps_row(kern, edit_runs),
             even_taps_max_rel_err=max(r['max_rel_err']
                                       for r in even_taps.values()),
             even_taps_ms=sum(r['ms'] for r in even_taps.values()),
             even_taps_graph_ms=sum(r['graph_ms']
                                    for r in even_taps.values()),
             even_taps_bound_ms=sum(r['bound_ms']
                                    for r in even_taps.values())),
    ]
    print(json.dumps({'kernels': summary}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
