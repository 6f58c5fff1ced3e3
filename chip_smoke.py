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
   as ``exsr``'s fails;
11. train: the SR trainer (``exsr_torch.train.srragan``) at the flagship
   configuration, ``artifacts/run_flagship_r5/opt.json`` read through the
   port's ``parse`` and ``experiment_from_reference_json`` (RRDBNet nf 64,
   nb 23, gc 32, SVDinNormedOut Z; DiscriminatorVGG128 nf 64, nb 10, five
   stride-2 stages on 128 x 128; batch 16, patch 208, wgan-gp, ten inner
   MAP iterations; fp32, TF32 off) on seeded weights and a seeded
   synthetic batch: a non-dual D step, a non-dual G step, a dual D step
   and a dual G step, each a warm-up and two timed calls; host ms per
   step, the MAP loop's device share, CEM-kernel launches against the
   prediction, peak memory, what each step moves (G or D, D's running
   statistics only in the D step, the L_struct ring only in the G step),
   one profiled dual G step, and the CEM filter's entry points and
   adjoints at the training shapes (LR 52, HR 208, batch 16) against
   their plain versions;
12. train_reference: one non-dual G step's gradients at full width, batch
   2, patch 208, on the card against the CPU on the same draws, the
   flagship D carried across (1e-4 of the largest element; beyond it, the
   step in float64 on the CPU decides);
13. train_cli: ``python -m exsr_torch.apps.train_sr``'s ``main`` at full
   width on 16 synthetic 256 x 256 PNGs: two ``--init_phase`` G steps, then
   a GAN-phase ``--resume`` with the flagship options (two dual D steps;
   its controller holds G back) with validation and checkpoints; launches,
   ``logs.npz``, the resumed step, and ``eval_sr`` loading the result;
14. jpeg_codec: the explorable-JPEG codec at batch 16, 512 x 512, on the
   card against the CPU (luma and chroma, every packed layout; quantised
   coefficients equal except at float64 ties), the QF tables against
   numpy's float32 recipe, and the JFIF reader's C++ scan against its
   Python reader on PIL-encoded files (colour 4:2:0 at QF 10, grey, 4:4:4,
   restart markers), each timed;
15. jpeg_edit: ``JPEGEditSession`` at full width (nf 320, nb 10, 64 latent
   channels) on a 512 x 512 image at QF 10: ``recompute``, an l1 edit (ms
   a step, the loss falling, a profile), random alternatives, the imprint
   search, a colour JPEG file, the chroma generator; bin consistency after
   each call; the generator on the card against the CPU; and
   ``build_model(4)``'s fp32 check against the CPU;
16. jpeg_eval_cli: ``exsr_torch.apps.eval_jpeg.main`` at its defaults on
   three 512 x 512 PNGs at QF 10, 30, 50 (8 Z samples, images, 3-frame
   GIFs; ms per decoded image), one ``desired_im`` image and a checkpoint
   round trip (bit-equal).  Phases 15 and 16 run with TF32 switched on
   (:func:`tf32_on`): the entry points must turn it off themselves.  No
   hand-written kernel lies on the JPEG path;
17. train_jpeg_step: the explorable-JPEG Y trainer
   (``exsr_torch.train.decomp``) at ``train_jpeg``'s defaults (DnCNN nf
   320, nb 10, 64 latent channels; critic nf 320, nb 10 on the 32 x 32
   grid; batch 16, patch 256, wgan-gp, ten inner MAP iterations, QF in
   5-50) on seeded weights and images: each step kind (non-dual and dual D
   and G) a warm-up and two timed calls, host ms, the MAP loop's share,
   device launches and busy share per step, peak memory, what each step
   moves (the generator's running statistics only in the G step), a
   profile of one dual G step;
18. train_jpeg_reference: a non-dual D step and a dual G step (two inner
   iterations) at full width, batch 2, on the card against the CPU on the
   same draws (phase 12's rule), the generator's running statistics within
   1e-5; one ``ChromaDecompTrainer`` step at the chroma CLI's width (nf
   160 under the 320-wide Y generator, batch 16), timed;
19. train_jpeg_cli: ``exsr_torch.apps.train_jpeg.main`` at its defaults on
   16 synthetic 256 x 256 PNGs (two steps, a validation, checkpoints, a
   resume), ``--chroma --y_ckpt`` on its checkpoint, and ``eval_jpeg
   --checkpoint`` on it;
20. kernelgan: ``KernelGAN.estimate`` at its default configuration (3000
   iterations) on the in-repo 276 x 276 face degraded by a known
   anisotropic Gaussian x2 kernel: seconds, launches per iteration, busy
   share, kernel quality (reported, not gated); its first iterations
   against the CPU; ``EditSession.estimate_kernel`` at full width against
   the same session on the CPU; and ``eval_sr --kernel estimated`` on a
   128 x 128 LR image.  Phases 17-20 run with TF32 switched on.

Phase 3 also checks and times ``sepfilter_taps``, the CEM filter's adjoint
kernel, at the edit shape and at the main path's batch-16 shapes; the
kernels line gives each CEM kernel's training launches and times beside
its serving ones (``train``).

Any failed check raises and the script exits non-zero.  The last lines are
the kernels summary, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
TRAIN_OPT = 'artifacts/run_flagship_r5/opt.json'
# the trainer's four step kinds, in the order they run, and the timed
# repeats of each after its warm-up call
TRAIN_KINDS = (('d', False), ('g', False), ('d', True), ('g', True))
TRAIN_REPS = 2
# the CEM filter's entry points on the training path (no pre-pad: the
# inv_hTh filter at LR, down and up-combine at HR) and the plain up kernel
# of the decomposed D
TRAIN_FILTER_CASES = ('sepfilter_edge[lr]', 'sepfilter_down',
                      'sepfilter_up[up]', 'sepfilter_up[combine]')
# the card-against-CPU check of one G step's gradients
TRAIN_REF_BATCH = 2
# the training CLI: synthetic training images (>= the flagship batch) and
# validation images, their sizes, and the steps of each phase
CLI_TRAIN_IMAGES, CLI_TRAIN_HR, CLI_VAL_IMAGES, CLI_VAL_HR = 16, 256, 2, 128
CLI_INIT_STEPS, CLI_GAN_STEPS = 2, 2
# explorable JPEG: the codec's batch and image size, the l1 edit's steps and
# the random alternatives' steps
JPEG_BATCH, JPEG_HW, JPEG_EDIT_ITERS, JPEG_ALT_ITERS = 16, 512, 30, 10
# the generators' width and depth: eval_jpeg's defaults
JPEG_NF, JPEG_NB = 320, 10
# JPEG training: train_jpeg's batch; the card-against-CPU check's batch and
# inner MAP iterations; the chroma CLI's width under the 320-wide Y model
JPEG_TRAIN_BATCH, JPEG_REF_BATCH, JPEG_REF_ITERS, CHROMA_NF = 16, 2, 2, 160
# KernelGAN: the in-repo image it estimates on, the iterations held to the
# CPU (and profiled), eval_sr's LR image size and KernelGAN iterations
KG_IMAGE = 'artifacts/convergence_r3/face_SR.png'
# (eval_sr's estimation at 300 iterations: at 3000 it took 82 s on an H100
# 80GB HBM3 at 700 W, which put the whole script past 600 s)
KG_CHECK_ITERS, KG_EVAL_LR, KG_EVAL_ITERS = 20, 128, 300


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


def train_setup(device, models: bool = True):
    """The flagship configuration (``TRAIN_OPT``, through the port's
    ``parse`` and ``experiment_from_reference_json``): its trainer on
    ``device``, the CEM filters and, with ``models``, a seeded generator
    and D."""
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.models.discriminators import DiscriminatorVGG128
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.options.config import (experiment_from_reference_json,
                                           parse)
    from exsr_torch.train.srragan import SRRaGANTrainer
    exp = experiment_from_reference_json(parse(TRAIN_OPT, is_train=True))
    cfg, net_g, net_d = exp.train, exp.network_g, exp.network_d
    cem = CEM.create(CEMConf(scale_factor=cfg.scale))
    filt = cem.device_filters(3, device=device)
    wrapped = cem_wrap(lambda m, x, z: m(x, z), filt, upscale=cfg.scale)
    margins = cem.invalidity_margins_hr
    trainer = SRRaGANTrainer(
        cfg, lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False), margins)
    if not models:
        return exp, filt, trainer, None, None
    g = RRDBNet(nf=net_g.nf, nb=net_g.nb, gc=net_g.gc, upscale=cfg.scale,
                latent_channels=cfg.num_latent_channels, seed=0)
    d = DiscriminatorVGG128(base_nf=net_d.nf, nb=net_d.n_layers,
                            num_2_strides=net_d.num_2_strides,
                            input_patch_size=cfg.patch_size - 2 * margins,
                            seed=1)
    return exp, filt, trainer, g, d


def train_batch(cfg, batch, device, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    hr, lr = cfg.patch_size, cfg.patch_size // cfg.scale
    return {'lr': torch.from_numpy(rng.uniform(size=(batch, lr, lr, 3))
                                   .astype(np.float32)).to(device),
            'hr': torch.from_numpy(rng.uniform(size=(batch, hr, hr, 3))
                                   .astype(np.float32)).to(device)}


def train_launches(kind: str, dual: bool, iters: int) -> dict:
    """The CEM-kernel launches of one step: a D step runs a forward per
    fake (no backward: the fakes are detached), a G step a forward and a
    backward per Z; a dual step adds the MAP loop's ``iters`` forwards and
    backwards."""
    fwd = 2 if dual else 1
    inner = iters if dual else 0
    return per_forward(fwd + inner,
                       backwards=inner + (fwd if kind == 'g' else 0))


def phase_train(device, name):
    """The SR trainer's four step kinds at the flagship configuration on
    the card: host ms per step, the MAP loop's device share, CEM-kernel
    launches against the prediction, peak memory, what each step moves,
    one profiled dual G step, and the CEM filter's entry points and
    adjoints at the training shapes against their plain versions."""
    import math
    import torch
    from exsr_torch.utils.misc import fetch_scalars
    t_phase = time.perf_counter()
    exp, filt, trainer, g, d = train_setup(device)
    cfg = exp.train
    batch_size = exp.train_data.batch_size
    state = trainer.init_state(g, d, seed=2, device=device)
    batch = train_batch(cfg, batch_size, device, seed=21)
    map_events = []
    optimal_z = trainer._optimal_z

    def timed_optimal_z(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = optimal_z(*a, **k)
        end.record()
        map_events.append((start, end))
        return out
    trainer._optimal_z = timed_optimal_z

    def snapshot(module, buffers=False):
        src = module.buffers() if buffers else module.parameters()
        return [t.detach().clone() for t in src]

    def moved(module, before, buffers=False):
        src = module.buffers() if buffers else module.parameters()
        return any(not torch.equal(a, b) for a, b in zip(src, before))

    records = {}
    for kind, dual in TRAIN_KINDS:
        key = f'{kind}_{"dual" if dual else "single"}'
        want = train_launches(kind, dual, cfg.optimal_z_iters)
        rec = records[key] = dict(ms=[], map_ms=[], peak_gib=[])
        for rep in range(1 + TRAIN_REPS):
            g0, d0 = snapshot(state.g), snapshot(state.d)
            stats0 = snapshot(state.d, buffers=True)
            count0 = int(state.ratio_stats.count)
            map_events.clear()
            torch.cuda.reset_peak_memory_stats(device)
            zero_launches()
            t0 = time.perf_counter()
            if kind == 'd':
                state, metrics = trainer.d_step(state, batch, dual=dual)
            else:
                state, metrics = trainer.g_step(state, batch, dual=dual)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = read_launches()
            check(launches == want,
                  f'train {key} launches {launches}, predicted {want}')
            metrics = fetch_scalars(metrics)
            check(all(math.isfinite(v) for v in metrics.values()),
                  f'train {key} metrics {metrics}')
            check(moved(state.d, d0) == (kind == 'd')
                  and moved(state.g, g0) == (kind == 'g'),
                  f'train {key} moved the wrong parameters')
            check(moved(state.d, stats0, buffers=True) == (kind == 'd'),
                  f'train {key}: D running statistics')
            count = int(state.ratio_stats.count)
            check(count == count0 + (batch_size if kind == 'g' else 0),
                  f'train {key}: ring count {count0} -> {count}')
            state = trainer.advance(state)
            if rep == 0:
                rec.update(launches=launches, predicted=want,
                           metrics=metrics)
                continue
            rec['ms'].append(ms)
            rec['map_ms'].append(sum(s.elapsed_time(e)
                                     for s, e in map_events))
            rec['peak_gib'].append(torch.cuda.max_memory_allocated(device)
                                   / 2 ** 30)
        rec['map_share'] = sum(rec['map_ms']) / sum(rec['ms'])
        emit('train_step', device=name, step=key, **rec)
    trainer._optimal_z = optimal_z
    iteration = {k: (records[f'd_{k}']['ms'][-1]
                     + records[f'g_{k}']['ms'][-1]) for k in ('single',
                                                              'dual')}
    profile = profile_forward(
        lambda _: trainer.g_step(state, batch, dual=True), None)
    emit('train_profile', device=name, step='g_dual', **profile)
    d_state = {k: v.cpu() for k, v in state.d.state_dict().items()}
    del state, batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device=device).manual_seed(23)
    lr_size = cfg.patch_size // cfg.scale
    kern = sepfilter_kernels(filt, gen, device, batch_size, lr_size,
                             cases=TRAIN_FILTER_CASES)
    taps = sepfilter_taps_kernels(filt, gen, device, batch_size, lr_size)
    for k, rec in kern.items():
        emit('train_kernel', name=k, batch=batch_size, lr=lr_size, **rec)
    for k, rec in taps.items():
        emit('train_kernel', name=f'sepfilter_taps[{k}]', batch=batch_size,
             lr=lr_size, **rec)
    emit('train', device=name, opt=TRAIN_OPT, batch=batch_size,
         patch=cfg.patch_size, lr=lr_size, nb=exp.network_g.nb,
         nf=exp.network_g.nf, gc=exp.network_g.gc,
         nz=cfg.num_latent_channels, latent=cfg.latent_channels,
         d_nf=exp.network_d.nf, d_nb=exp.network_d.n_layers,
         d_strides=exp.network_d.num_2_strides, gan=cfg.gan_type,
         optimal_z_iters=cfg.optimal_z_iters, tf32=False,
         ms_per_iteration=iteration,
         phase_s=time.perf_counter() - t_phase)
    return records, kern, taps, d_state


def _reference_grads(where, g, d, batch, draws):
    """One non-dual G step's gradients (with the GAN term) on ``where``:
    a device, or ``'float64'`` for the CPU in float64."""
    import copy
    from exsr_torch.ops.kernels.sepfilter import float64_reference
    from exsr_torch.device import full_fp32
    f64 = where == 'float64'
    dev = 'cpu' if f64 else where
    _, _, trainer, _, _ = train_setup(dev, models=False)
    state = trainer.init_state(copy.deepcopy(g), copy.deepcopy(d), seed=3,
                               device=dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    draws = {k: v.to(dev) for k, v in draws.items()}
    ctx = full_fp32()
    if f64:
        state.g.double()
        state.d.double()
        state.ratio_stats.buffer = state.ratio_stats.buffer.double()
        batch = {k: v.double() for k, v in batch.items()}
        draws = {k: v.double() for k, v in draws.items()}
        ctx = float64_reference()
    t0 = time.perf_counter()
    with ctx:
        grads, _, _ = trainer.g_grads(state, batch['lr'], batch['hr'],
                                      draws, False, True)
    names = [n for n, _ in state.g.named_parameters()]
    grads = dict(zip(names, (t.detach().cpu().double() for t in grads)))
    return grads, time.perf_counter() - t0


def phase_train_reference(device, name, d_state):
    """One non-dual G step with the GAN term at full width, batch 2,
    patch 208, on the card and on the CPU on the same draws, the flagship
    D carried across: the gradients against each other, within 1e-4 of
    the largest element.  Where cuDNN's sums leave a larger gap, the same
    step in float64 on the CPU (the plain CEM filters,
    ``sepfilter.float64_reference``) says how far each fp32 gradient is
    from exact: the card's must be no farther than three times the
    CPU's."""
    t_phase = time.perf_counter()
    exp, _, trainer, g, d = train_setup(device)
    d.load_state_dict(d_state)
    cfg = exp.train
    batch = train_batch(cfg, TRAIN_REF_BATCH, 'cpu', seed=25)
    state = trainer.init_state(g, d, seed=3, device=device)
    draws = {k: v.cpu() for k, v in trainer.draw_g(
        state, batch['hr'].shape, dual=False).items()}
    g, d = state.g.cpu(), state.d.cpu()
    del state, trainer
    card, card_s = _reference_grads(device, g, d, batch, draws)
    cpu, cpu_s = _reference_grads('cpu', g, d, batch, draws)
    rec = dict(batch=TRAIN_REF_BATCH, patch=cfg.patch_size,
               nb=exp.network_g.nb, nf=exp.network_g.nf, dual=False,
               use_gan=True, tol=1e-4, max_rel_err=_grad_gap(card, cpu),
               worst=_worst(card, cpu), card_s=card_s, cpu_s=cpu_s)
    if rec['max_rel_err'] > 1e-4:
        exact, rec['float64_s'] = _reference_grads('float64', g, d, batch,
                                                   draws)
        rec.update(card_vs_float64=_grad_gap(card, exact),
                   cpu_vs_float64=_grad_gap(cpu, exact),
                   card_worst=_worst(card, exact),
                   cpu_worst=_worst(cpu, exact))
        check(rec['card_vs_float64'] <= max(1e-4,
                                            3 * rec['cpu_vs_float64']),
              f'train gradients card vs float64 {rec}')
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('train_reference', device=name, **rec)
    return rec


def _grad_gap(a: dict, b: dict) -> float:
    """The largest difference over all elements, as a share of the largest
    element of ``b``."""
    return max(_grad_gaps(a, b).values())


def _grad_gaps(a: dict, b: dict) -> dict:
    """Each parameter's largest difference, as a share of the largest
    element of ``b`` over all parameters."""
    scale = max(float(y.abs().max()) for y in b.values())
    return {k: float((a[k] - b[k]).abs().max()) / scale for k in b}


def _worst(a: dict, b: dict, n: int = 3) -> dict:
    gaps = _grad_gaps(a, b)
    return {k: gaps[k] for k in sorted(gaps, key=gaps.get)[-n:]}


def phase_train_cli(device, name):
    """The training CLI at full width on the card: an ``--init_phase`` run
    (G steps), then a GAN-phase ``--resume`` with the flagship options (its
    controller runs D steps and holds G back), a validation pass and the
    checkpoints; ``logs.npz``, the resumed step and ``eval_sr``'s loading
    of the result."""
    import contextlib
    import io
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from exsr_torch.apps import eval_sr, train_sr
    from exsr_torch.options.config import (experiment_from_reference_json,
                                           parse)
    from exsr_torch.train.checkpoints import CheckpointManager
    from exsr_torch.utils.logging import MetricLog
    t_phase = time.perf_counter()
    iters = experiment_from_reference_json(
        parse(TRAIN_OPT, is_train=True)).train.optimal_z_iters
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        hr_dir, val_dir, exp = f'{tmp}/hr', f'{tmp}/val', f'{tmp}/exp'
        os.makedirs(hr_dir)
        os.makedirs(val_dir)
        _write_pngs(hr_dir, CLI_TRAIN_IMAGES, CLI_TRAIN_HR, seed=31)
        _write_pngs(val_dir, CLI_VAL_IMAGES, CLI_VAL_HR, seed=37)
        base = ['--hr_dir', hr_dir, '--exp_dir', exp, '--print_freq', '1']
        runs = (('init', base + ['--init_phase', '--niter',
                                 str(CLI_INIT_STEPS), '--ckpt_freq', '1'],
                 per_forward(CLI_INIT_STEPS, backwards=CLI_INIT_STEPS)),
                ('gan', base + ['--opt', TRAIN_OPT, '--resume', '--niter',
                                str(CLI_INIT_STEPS + CLI_GAN_STEPS),
                                '--val_hr_dir', val_dir, '--val_freq',
                                str(CLI_INIT_STEPS + CLI_GAN_STEPS),
                                '--ckpt_freq', '1'],
                 # dual D steps, then one validation forward per Z (0, -1,
                 # 1) per validation image
                 per_forward(CLI_GAN_STEPS * (2 + iters)
                             + 3 * CLI_VAL_IMAGES,
                             backwards=CLI_GAN_STEPS * iters)))
        for tag, argv, want in runs:
            out = io.StringIO()
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train_sr.main(argv)
            wall = time.perf_counter() - t0
            launches = read_launches()
            text = out.getvalue()
            check(launches == want,
                  f'train_cli {tag} launches {launches}, predicted {want}')
            lines = [json.loads(ln) for ln in text.splitlines()
                     if ln.startswith('{')]
            results[tag] = dict(launches=launches, wall_s=wall,
                                steps=[ln for ln in lines
                                       if 'steps_per_s' in ln])
        check(f'resumed at step {CLI_INIT_STEPS}' in text,
              'train_cli did not resume at the init phase\'s last step')
        log = MetricLog().load(f'{exp}/logs.npz')
        last = CLI_INIT_STEPS + CLI_GAN_STEPS
        check(log.last('l_g_pix') is not None
              and log.last('l_d_total') is not None
              and log.last('psnr_val') is not None,
              f'train_cli logs {sorted(log.series)}')
        check(all(math.isfinite(v) for s in log.series.values()
                  for _, v in s), 'train_cli non-finite log value')
        # a step's metrics are read after the next step is enqueued and
        # logged with it; the last step's are read after the loop
        d_steps = [s for s, _ in log.series['l_d_total']]
        check(d_steps == list(range(CLI_INIT_STEPS + 2, last + 1)),
              f'train_cli D losses logged at steps {d_steps}')
        check(CheckpointManager(f'{exp}/ckpt').latest_step() == last,
              'train_cli last checkpoint')
        _, fwd = eval_sr.build_model(SCALE, checkpoint=f'{exp}/ckpt')
        lr = np.random.default_rng(41).uniform(
            size=(1, 32, 32, 3)).astype(np.float32)
        sr = fwd(lr, np.zeros((1, 128, 128, 3), np.float32))
        check(sr.device.type == 'cuda' and tuple(sr.shape) == (1, 128, 128, 3)
              and bool(torch.isfinite(sr).all()),
              'eval_sr on the trained checkpoint')
        results.update(psnr_val=log.last('psnr_val'),
                       per_pix_std_val=log.last('per_pix_STD_val'),
                       l_d_total=log.last('l_d_total'),
                       l_g_pix=log.last('l_g_pix'), last_step=last,
                       eval_checkpoint_ok=True)
    results['phase_s'] = time.perf_counter() - t_phase
    emit('train_cli', device=name, images=CLI_TRAIN_IMAGES,
         hr=CLI_TRAIN_HR, **results)
    return results


@contextlib.contextmanager
def tf32_on():
    """cuDNN's and CUDA matmul's TF32 switched on (PyTorch's default for
    cuDNN; matmul's default is off, on here to cover the DCT's products)
    within the block, the harness's flags restored after: what the JPEG
    entry points see in a process that sets neither."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield {'cudnn.allow_tf32': True, 'cuda.matmul.allow_tf32': True}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _y_images(n, size, seed):
    """``[n, size, size, 1]`` float32 Y images in [0, 255]: smooth content
    plus noise, so that quantisation ties and every frequency occur."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    out = []
    for _ in range(n):
        base = sum(np.sin(2 * np.pi * (f * yy + g * xx + p))
                   for f, g, p in rng.uniform(0.5, 12, size=(3, 3)))
        img = 128 + 30 * base + 12 * rng.standard_normal((size, size))
        out.append(np.clip(img, 0, 255))
    return np.stack(out)[..., None].astype(np.float32)


def _tie_check(card_q, cpu_q, unq64, what):
    """Quantised coefficients, card against CPU: equal, except where the
    float64 unquantised value lies within 1e-3 of a half-integer, where
    they may differ by exactly 1."""
    import numpy as np
    diff = np.abs(card_q.astype(np.float64) - cpu_q)
    tie = np.abs(np.abs(unq64 - np.floor(unq64)) - 0.5) < 1e-3
    check(diff.max() <= 1 and not (diff[~tie] > 0).any(),
          f'{what}: {int((diff[~tie] > 0).sum())} quantised coefficients '
          f'differ away from a tie (max {diff.max()})')
    return {'ties': int(tie.sum()), 'flipped_at_ties': int((diff > 0).sum()),
            'coefficients': int(diff.size)}


def phase_jpeg_codec(device, name):
    """The DCT codec at batch 16, 512 x 512 on the card against the CPU (luma
    and chroma, every packed layout), the QF tables against numpy's float32
    recipe, and the JFIF reader (C++ scan against the Python reader) on
    PIL-encoded files."""
    import io
    import numpy as np
    import torch
    from PIL import Image
    from exsr_torch.jpeg import codec as C
    from exsr_torch.jpeg.jfif import decode_jfif
    from exsr_torch.native import jfif_native
    t_phase = time.perf_counter()
    rec = {}
    # the QF tables: every integer QF and fractional ones, on the card,
    # against numpy's float32 arithmetic
    qfs = np.concatenate([np.arange(1, 101), np.random.default_rng(5)
                          .uniform(1, 100, 200)]).astype(np.float32)
    f32 = np.float32
    factor = np.where(qfs < 50, f32(5000) / qfs, f32(200) - f32(2) * qfs)
    for tag, base in (('luma', C.LUMA_Q_TABLE),
                      ('luma16', C.pad_q_table(C.LUMA_Q_TABLE, 16)),
                      ('chroma16', C.pad_q_table(C.CHROMA_Q_TABLE, 16))):
        ref = np.clip(np.round(factor[:, None] * (base.reshape(-1) / 100.0)
                               .astype(f32)[None]), 1, 255)
        got = C.scaled_q_table(qfs, base, device).cpu().numpy()
        check(np.array_equal(got.reshape(ref.shape), ref),
              f'QF table {tag} differs from the float32 recipe')
    rec['q_tables'] = {'qfs': len(qfs), 'bit_equal': True}

    ys = _y_images(JPEG_BATCH, JPEG_HW, seed=21)
    qf_rows = np.linspace(5, 95, JPEG_BATCH).round()
    codec, chroma = C.JPEGCodec(), C.JPEGCodec(chroma_mode=True,
                                               block_size=16)
    y_cpu = torch.from_numpy(ys)
    y_dev = y_cpu.to(device)
    qf_cpu, qf_dev = torch.from_numpy(qf_rows), torch.from_numpy(qf_rows) \
        .to(device)
    unq64 = codec.compress(y_cpu.double(), qf_cpu, quantize=False).numpy()
    card_q = codec.compress(y_dev, qf_dev).cpu().numpy()
    cpu_q = codec.compress(y_cpu, qf_cpu).numpy()
    luma = {'shape': list(ys.shape), 'qfs': qf_rows.tolist()}
    luma['card_vs_cpu'] = _tie_check(card_q, cpu_q.astype(np.float64),
                                     unq64, 'luma compress')
    luma['cpu_vs_float64'] = _tie_check(cpu_q, np.round(unq64), unq64,
                                        'luma compress (CPU)')
    comp = torch.from_numpy(cpu_q)
    ext_cpu = codec.extract(comp, qf_cpu)
    ext_dev = codec.extract(comp.to(device), qf_dev).cpu()
    luma['extract_max_abs_err'] = (ext_dev - ext_cpu).abs().max().item()
    check(luma['extract_max_abs_err'] <= 1e-3, f'luma extract {luma}')
    nbytes = 2 * ys.nbytes
    luma['compress_ms'] = cuda_ms(lambda: codec.compress(y_dev, qf_dev),
                                  [()], 20)
    luma['extract_ms'] = cuda_ms(
        lambda c=comp.to(device): codec.extract(c, qf_dev), [()], 20)
    # two bs x bs products per block: 4 bs operations per sample
    luma['bound_ms'], luma['bound_by'] = bound_ms(
        nbytes, 4 * 8 * ys.size, FP32_FLOPS)
    rec['luma'] = luma

    rgb = np.concatenate([ys, _y_images(JPEG_BATCH, JPEG_HW, seed=22) - 128,
                          _y_images(JPEG_BATCH, JPEG_HW, seed=23) - 128], -1)
    img_cpu = torch.from_numpy(rgb)
    img_dev = img_cpu.to(device)
    chroma_rec = {'shape': list(rgb.shape)}
    unq = chroma.compress_ycbcr(img_cpu.double(), qf_cpu, 'downsample_only')
    for mode in (True, 'downsample_only', False):
        a = chroma.compress_ycbcr(img_dev, qf_dev, mode).cpu()
        b = chroma.compress_ycbcr(img_cpu, qf_cpu, mode)
        if mode is True:
            # Y unquantised, chroma's low frequencies rounded
            chroma_rec['packed_y_max_abs_err'] = \
                (a[..., :256] - b[..., :256]).abs().max().item()
            chroma_rec['card_vs_cpu'] = _tie_check(
                a[..., 256:].numpy(), b[..., 256:].double().numpy(),
                unq[..., 256:].numpy(), 'chroma compress')
        else:
            chroma_rec[f'max_rel_err[{mode}]'] = (
                (a - b).abs().max() / b.abs().max()).item()
            check(chroma_rec[f'max_rel_err[{mode}]'] <= 1e-5,
                  f'chroma compress {mode}: {chroma_rec}')
    packed = chroma.compress_ycbcr(img_cpu, qf_cpu, True)
    full = chroma.compress_ycbcr(img_cpu, qf_cpu, False)
    for layout, x in (('y+low', packed), ('low', packed[..., 256:]),
                      ('full', full[..., 256:])):
        a = chroma.extract_ycbcr(x.to(device), qf_dev).cpu()
        b = chroma.extract_ycbcr(x, qf_cpu)
        err = (a - b).abs().max().item()
        check(err <= 1e-3, f'chroma extract {layout}: {err}')
        chroma_rec[f'extract_max_abs_err[{layout}]'] = err
    chroma_rec['compress_ms'] = cuda_ms(
        lambda: chroma.compress_ycbcr(img_dev, qf_dev), [()], 20)
    rec['chroma'] = chroma_rec

    # the JFIF reader: the C++ scan against the Python reader
    rgb8 = np.concatenate(list(_y_images(3, JPEG_HW, seed=24)), -1) \
        .round().astype(np.uint8)
    files = {}
    for tag, arr, kw in (
            ('color_420_qf10', rgb8, dict(quality=10, subsampling=2)),
            ('grey_qf75', rgb8[..., 0], dict(quality=75)),
            ('color_444_qf60', rgb8, dict(quality=60, subsampling=0)),
            ('restart_qf80', rgb8, dict(quality=80, restart_marker_rows=1))):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format='JPEG', **kw)
        files[tag] = buf.getvalue()
    t0 = time.perf_counter()
    jfif_native.load()     # g++ builds the C++ scan here
    jfif = {'native_build_ms': 1e3 * (time.perf_counter() - t0)}
    for tag, data in files.items():
        t = {}
        decs = {}
        for native in (True, False):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                decs[native] = decode_jfif(data, native=native)
                times.append(1e3 * (time.perf_counter() - t0))
            t[native] = float(np.median(times))
        for a, b in zip(decs[True]['components'],
                        decs[False]['components']):
            check(np.array_equal(a.coeffs, b.coeffs)
                  and np.array_equal(a.q_table, b.q_table),
                  f'JFIF {tag}: native and Python readers differ')
        jfif[tag] = {'bytes': len(data),
                     'components': len(decs[True]['components']),
                     'native_ms': t[True], 'python_ms': t[False]}
    rec['jfif'] = jfif
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('jpeg_codec', device=name, batch=JPEG_BATCH, hw=JPEG_HW, **rec)
    return files['color_420_qf10']


def _bin_check(sess, what):
    """The generator's coefficients at the current Z within half a bin of
    the quantised input."""
    import torch
    with torch.no_grad():
        c = sess.generator(sess.comp, sess._t(sess.cur_z))
    gap = (c - sess.comp).abs().max().item()
    check(gap <= 0.5 + 1e-6, f'{what}: bin consistency {gap}')
    return gap


def _coefficients_during(sess, call):
    """The generator's output coefficients inside ``call()`` and the inputs
    they came from, read by a forward hook (the entry point sets its own
    precision)."""
    seen = []
    h = sess.generator.register_forward_hook(
        lambda m, a, out: seen.append((out.detach().cpu(), a)))
    try:
        call()
    finally:
        h.remove()
    return seen[-1]


def phase_jpeg_edit(device, name, jpeg_bytes):
    """``JPEGEditSession`` at full width (nf 320, nb 10, 64 latent
    channels) on a seeded 512 x 512 image at QF 10, with TF32 on
    (:func:`tf32_on`): the entry points must turn it off themselves."""
    import os
    import tempfile
    import numpy as np
    import torch
    from exsr_torch.apps.eval_sr import build_model
    from exsr_torch.apps.jpeg_session import JPEGEditSession
    from exsr_torch.device import full_fp32
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    t_phase = time.perf_counter()
    rec = {}
    rng = np.random.default_rng(31)
    rgb = np.concatenate([_y_images(1, JPEG_HW, 32)[0]] * 3, -1) / 255.0
    rgb = np.clip(rgb + 0.05 * rng.standard_normal(rgb.shape), 0, 1) \
        .astype(np.float32)
    zero_launches()
    with tf32_on() as flags:
        rec['flags'] = flags
        sess = JPEGEditSession(nf=JPEG_NF, nb=JPEG_NB, latent_channels=64, qf=10,
                               seed=0)
        sess.init_random_params(0)
        t0 = time.perf_counter()
        sess.open_image(rgb)
        torch.cuda.synchronize()
        rec['open_image_ms'] = 1e3 * (time.perf_counter() - t0)
        bins = {'open_image': _bin_check(sess, 'open_image')}
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            sess.recompute()
            times.append(1e3 * (time.perf_counter() - t0))
        rec['recompute_ms'] = float(np.median(times))

        desired = sess.y_image / 255.0
        # a warm-up edit (cuDNN loads its backward kernels on first use),
        # undone
        sess.optimize('l1', data={'desired': desired}, max_iters=2)
        sess.undo()
        t0 = time.perf_counter()
        res = sess.optimize('l1', data={'desired': desired},
                            max_iters=JPEG_EDIT_ITERS)
        dt = time.perf_counter() - t0
        losses = res['losses']
        check(len(losses) == JPEG_EDIT_ITERS and losses[-1] < losses[0],
              f'l1 edit losses {losses}')
        bins['l1'] = _bin_check(sess, 'l1')
        rec['l1'] = {'steps': len(losses), 'ms_per_step':
                     1e3 * dt / len(losses), 'first_loss': float(losses[0]),
                     'last_loss': float(losses[-1])}
        # where an edit step's time goes: three steps, and a batch of 11
        # (eval_jpeg's 8 Z samples and 3 GIF frames) through the generator
        rec['l1_profile'] = profile_forward(
            lambda _: sess.optimize('l1', data={'desired': desired},
                                    max_iters=3), None)
        sess.undo()
        z11 = sess._t(np.random.default_rng(4).uniform(
            -1, 1, (11,) + sess.cur_z.shape[1:]))
        comp11 = sess.comp.repeat(11, 1, 1, 1)

        with full_fp32(), torch.no_grad():   # warm-up at the new batch
            sess.generator(comp11, z11)
            rec['batch11_profile'] = profile_forward(
                lambda _: sess.generator(comp11, z11), None)
        sess.optimize('random_VGG', n_alternatives=4, max_iters=1)
        sess.undo()
        t0 = time.perf_counter()
        res = sess.optimize('random_VGG', n_alternatives=4,
                            max_iters=JPEG_ALT_ITERS)
        dt = time.perf_counter() - t0
        check(res['n_alternatives'] == 3 and all(np.isfinite(
            res['losses'])), f'random_VGG {res["losses"]}')
        alt = sess.alternative_out(2)
        check(alt.shape == sess.out.shape, 'alternative shape')
        bins['random_VGG'] = _bin_check(sess, 'random_VGG')
        rec['random_VGG'] = {'alternatives': 4, 'steps': len(res['losses']),
                             'ms_per_step': 1e3 * dt / len(res['losses'])}

        des = np.full((JPEG_HW // 4, JPEG_HW // 4), 60.0, np.float32)
        des[20:100, 24:104] = 220.0
        mask = np.zeros(des.shape, np.float32)
        mask[20:100, 24:104] = 1.0
        t0 = time.perf_counter()
        best, refined = sess.find_optimal_imprint_mask(
            des, mask, [20, 16, 84, 88], top_left=(200, 200),
            target_dims=(80, 80))
        rec['imprint'] = {'ms': 1e3 * (time.perf_counter() - t0),
                          'best_rect': [int(v) for v in best],
                          'refined_sum': float(refined.sum())}
        check(refined.sum() > 0, 'imprint mask empty')

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'c.jpg')
            with open(path, 'wb') as f:
                f.write(jpeg_bytes)
            t0 = time.perf_counter()
            sess.open_jpeg_file(path)
            rec['open_jpeg_file_ms'] = 1e3 * (time.perf_counter() - t0)
        check(sess.file_chroma is not None and 5 <= sess.qf <= 20,
              f'open_jpeg_file: qf {sess.qf}')
        bins['open_jpeg_file'] = _bin_check(sess, 'open_jpeg_file')
        chroma = DnCNN(DnCNNConfig(
            n_channels=JPEG_NF, depth=JPEG_NB, in_nc=384, out_nc=128,
            chroma_generator=True, block_size=8, num_latent_channels=0),
            seed=1)
        t0 = time.perf_counter()
        sess.attach_chroma(chroma, nf=JPEG_NF, nb=JPEG_NB)
        rec['attach_chroma_ms'] = 1e3 * (time.perf_counter() - t0)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            rgb_out = sess.compose_rgb()
            times.append(1e3 * (time.perf_counter() - t0))
        rec['compose_rgb_ms'] = {'first': times[0],
                                 'median_warm': float(np.median(times[1:]))}
        check(rgb_out.shape == (JPEG_HW, JPEG_HW, 3)
              and np.isfinite(rgb_out).all(), 'compose_rgb')
        rec['bin_consistency'] = bins

        # the full-width generator on a small image: card against CPU,
        # each through the session's recompute
        small = rgb[:64, :64]
        coeffs, outs, inputs = {}, {}, {}
        for dev in (device, 'cpu'):
            s = JPEGEditSession(nf=JPEG_NF, nb=JPEG_NB, latent_channels=64, qf=10,
                                device=dev)
            s.load_params(sess.params)
            s.open_image(small)
            s.cur_z = np.random.default_rng(3).uniform(
                -1, 1, s.cur_z.shape).astype(np.float32)
            coeffs[str(dev)], inputs[str(dev)] = _coefficients_during(
                s, s.recompute)
            outs[str(dev)] = s.out
            comp = s.comp.cpu()
            if dev is device:
                card_generator = s.generator
        a, b = coeffs[str(device)], coeffs['cpu']
        rec['reference'] = {
            'shape': list(b.shape),
            'max_abs_err': (a - b).abs().max().item(),
            'rel_to_largest_coefficient':
                ((a - b).abs().max() / b.abs().max()).item(),
            'rel_to_largest_correction':
                ((a - b).abs().max() / (b - comp).abs().max()).item(),
            'out_max_abs_err': float(np.abs(outs[str(device)]
                                            - outs['cpu']).max()),
            'tol': 1e-4}
        check(rec['reference']['rel_to_largest_coefficient'] <= 1e-4
              and rec['reference']['rel_to_largest_correction'] <= 1e-4,
              f'JPEG generator card vs CPU {rec["reference"]}')
        # control, recorded and not checked: the same generator call on the
        # same inputs with TF32 reaching the convs (the entry point's
        # full_fp32 bypassed), read by the same two measures beside the
        # 1e-4 limit
        with torch.no_grad():
            t = card_generator(*inputs[str(device)]).cpu()
        rec['tf32_control'] = {
            'rel_to_largest_coefficient':
                ((t - b).abs().max() / b.abs().max()).item(),
            'rel_to_largest_correction':
                ((t - b).abs().max() / (b - comp).abs().max()).item(),
            'tol': 1e-4}

        # the fp32 serving entry point under the same flags
        net_out = {}
        gen = torch.Generator().manual_seed(2)
        lr = torch.rand(2, 16, 16, 3, generator=gen)
        z = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
        for dev in ('cpu', device):
            _, fwd = build_model(SCALE, device=dev)
            net_out[str(dev)] = fwd(lr, z).cpu()
        err = (net_out['cpu'] - net_out[str(device)]).abs().max().item()
        check(err < 1e-4, f'build_model(4) fp32 card vs CPU with TF32 on: '
              f'{err}')
        rec['serving_fp32'] = {'shape': [2, 16, 16, 3], 'max_abs_err': err,
                               'tol': 1e-4}
    launches = read_launches()
    # no hand-written kernel lies on the JPEG path; the serving check's
    # two forwards launch the CEM's and stage 4's
    check(launches == per_forward(1, stage4=69),
          f'jpeg_edit launches {launches}')
    rec['launches'] = launches
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('jpeg_edit', device=name, nf=JPEG_NF, nb=JPEG_NB, latent_channels=64,
         hw=JPEG_HW, qf=10, **rec)
    return rec


def phase_jpeg_eval_cli(device, name):
    """``exsr_torch.apps.eval_jpeg.main`` at its defaults (nf 320, nb 10,
    64 latent channels) on three seeded 512 x 512 PNGs, with TF32 on: the
    Z sweep with images and GIFs, one image in the desired_im mode, and a
    port checkpoint round trip."""
    import json as _json
    import math
    import os
    import tempfile
    import torch
    from exsr_torch.apps import eval_jpeg
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    from exsr_torch.train.checkpoints import CheckpointManager
    t_phase = time.perf_counter()
    rec = {}
    qfs = ['10', '30', '50']
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp, tf32_on() as flags:
        rec['flags'] = flags
        data, out = f'{tmp}/data', f'{tmp}/out'
        os.makedirs(data)
        _write_pngs(data, EVAL_IMAGES, JPEG_HW, seed=41)
        t0 = time.perf_counter()
        width = ['--nf', str(JPEG_NF), '--nb', str(JPEG_NB)]
        summary = eval_jpeg.main([
            *width, '--data_dir', data, '--qf', *qfs, '--num_z', str(EVAL_NUM_Z),
            '--save_images', '--z_sweep_gif', str(EVAL_GIF),
            '--out_dir', out])
        sweep_s = time.perf_counter() - t0
        check(all(math.isfinite(v) for v in summary.values())
              and {'avg_psnr_jpeg', 'avg_psnr_decomp', 'avg_per_pixel_std'}
              <= set(summary), f'eval_jpeg summary {summary}')
        with open(f'{out}/summary.json') as f:
            per_image = _json.load(f)['per_image']
        check(len(per_image) == EVAL_IMAGES * len(qfs), 'records')
        check(all(r['bin_consistency_max'] <= 0.5 for r in per_image),
              f'bin consistency {[r["bin_consistency_max"] for r in per_image]}')
        for i in range(EVAL_IMAGES):
            for qf in qfs:
                for suffix in ('_jpeg.png', '_decomp.png', '_Zsweep.gif'):
                    check(os.path.exists(f'{out}/im{i}_qf{qf}{suffix}'),
                          f'missing im{i}_qf{qf}{suffix}')
        decoded = EVAL_NUM_Z + EVAL_GIF
        rec['sweep'] = dict(
            images=EVAL_IMAGES, hw=JPEG_HW, qfs=qfs, num_z=EVAL_NUM_Z,
            gif_frames=EVAL_GIF, wall_s=sweep_s, summary=summary,
            bin_consistency_max=max(r['bin_consistency_max']
                                    for r in per_image),
            ms_per_decoded_image=[1e3 * r['time_s'] / decoded
                                  for r in per_image])

        t0 = time.perf_counter()
        opt = eval_jpeg.main([
            *width, '--data_dir', data, '--qf', '10', '--latent', 'desired_im',
            '--num_z_iters', str(EVAL_ITERS), '--max_images', '1',
            '--out_dir', f'{tmp}/opt'])
        with open(f'{tmp}/opt/summary.json') as f:
            r = _json.load(f)['per_image'][0]
        check(math.isfinite(opt['avg_final_loss']), f'desired_im {opt}')
        rec['desired_im'] = dict(steps=EVAL_ITERS, summary=opt,
                                 ms_per_step=1e3 * r['time_s'] / EVAL_ITERS,
                                 wall_s=time.perf_counter() - t0)

        # a port checkpoint of the default weights decodes bit-equal to
        # them (deterministic cuDNN algorithms on both runs)
        g = DnCNN(DnCNNConfig(n_channels=JPEG_NF, depth=JPEG_NB,
                              num_latent_channels=64), seed=0)
        CheckpointManager(f'{tmp}/ckpt').save(0, {'g_params': g.state_dict()})
        runs = {}
        torch.backends.cudnn.deterministic = True
        try:
            for tag, extra in (('seeded', []),
                               ('checkpoint', ['--checkpoint',
                                               f'{tmp}/ckpt'])):
                eval_jpeg.main([*width, '--data_dir', data, '--qf', '10',
                                '--num_z', '2', '--max_images', '1',
                                '--out_dir', f'{tmp}/{tag}', *extra])
                with open(f'{tmp}/{tag}/summary.json') as f:
                    runs[tag] = [{k: v for k, v in r.items()
                                  if k != 'time_s'}
                                 for r in _json.load(f)['per_image']]
        finally:
            torch.backends.cudnn.deterministic = False
        check(runs['seeded'] == runs['checkpoint'],
              f'checkpoint round trip {runs}')
        rec['checkpoint'] = {'bit_equal': True, 'records': runs['seeded']}
    launches = read_launches()
    check(not any(launches.values()), f'jpeg_eval_cli launches {launches}')
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('jpeg_eval_cli', device=name, **rec)
    return rec


def _moved(tensors, before) -> bool:
    import torch
    return any(not torch.equal(a, b) for a, b in zip(tensors, before))


def _snap(tensors) -> list:
    return [t.detach().clone() for t in tensors]


def _running(module) -> list:
    return [b for n, b in module.named_buffers() if 'running' in n]


def jpeg_train_setup(batch, seed, optimal_z_iters=10):
    """The Y trainer at train_jpeg's defaults (nf 320, nb 10, 64 latent
    channels, patch 256, wgan-gp, QF in 5-50), seeded modules and a
    seeded host batch."""
    import numpy as np
    import torch
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, \
        DnCNNDiscriminator
    from exsr_torch.train.decomp import DecompConfig, DecompTrainer
    cfg = DecompConfig(optimal_z_iters=optimal_z_iters)
    g = DnCNN(DnCNNConfig(n_channels=JPEG_NF, depth=JPEG_NB,
                          num_latent_channels=cfg.num_latent_channels),
              seed=0)
    d = DnCNNDiscriminator(n_channels=JPEG_NF, depth=JPEG_NB,
                           expected_input_size=cfg.patch_size // 8,
                           norm='layer', seed=1)
    rng = np.random.default_rng(seed)
    data = {'uncomp': torch.from_numpy(_y_images(batch, cfg.patch_size,
                                                 seed)),
            'qf': torch.from_numpy(rng.integers(5, 51, size=batch)
                                   .astype(np.int32))}
    return DecompTrainer(cfg), g, d, data


def phase_train_jpeg_step(device, name):
    """The explorable-JPEG Y trainer at train_jpeg's defaults on the card,
    with TF32 switched on around it: each step kind (a warm-up and two
    timed calls), host ms ending in a synchronize, the MAP loop's share by
    CUDA events, device launches and busy share per step (profiler),
    peak memory, what each step moves, and a profile of one dual G
    step."""
    import math
    import torch
    from exsr_torch.utils.misc import fetch_scalars
    t_phase = time.perf_counter()
    trainer, g, d, data = jpeg_train_setup(JPEG_TRAIN_BATCH, seed=51)
    state = trainer.init_state(g, d, seed=2, device=device)
    batch = {k: v.to(device) for k, v in data.items()}
    map_events = []
    optimal_z = trainer._optimal_z

    def timed_optimal_z(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = optimal_z(*a, **k)
        end.record()
        map_events.append((start, end))
        return out
    trainer._optimal_z = timed_optimal_z

    def step(kind, dual):
        if kind == 'd':
            return trainer.d_step(state, batch, dual=dual)
        return trainer.g_step(state, batch, dual=dual)
    records = {}
    with tf32_on() as flags:
        for kind, dual in TRAIN_KINDS:
            key = f'{kind}_{"dual" if dual else "single"}'
            rec = records[key] = dict(ms=[], map_ms=[], peak_gib=[])
            for rep in range(1 + TRAIN_REPS):
                g0, d0 = _snap(state.g.parameters()), \
                    _snap(state.d.parameters())
                bn0 = _snap(_running(state.g))
                map_events.clear()
                torch.cuda.reset_peak_memory_stats(device)
                zero_launches()
                t0 = time.perf_counter()
                state, metrics = step(kind, dual)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                launches = read_launches()
                check(not any(launches.values()),
                      f'train_jpeg {key}: hand-written kernels {launches}')
                metrics = fetch_scalars(metrics)
                check(all(math.isfinite(v) for v in metrics.values()),
                      f'train_jpeg {key} metrics {metrics}')
                check(_moved(state.d.parameters(), d0) == (kind == 'd')
                      and _moved(state.g.parameters(), g0) == (kind == 'g')
                      and _moved(_running(state.g), bn0) == (kind == 'g'),
                      f'train_jpeg {key} moved the wrong state')
                state = trainer.advance(state)
                if rep == 0:
                    rec['metrics'] = metrics
                    continue
                rec['ms'].append(ms)
                rec['map_ms'].append(sum(s.elapsed_time(e)
                                         for s, e in map_events))
                rec['peak_gib'].append(
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)
            rec['map_share'] = sum(rec['map_ms']) / sum(rec['ms'])
            prof = profile_forward(lambda _: step(kind, dual), None)
            state = trainer.advance(state)
            rec.update(device_launches=prof['kernel_calls'],
                       device_busy_share=prof['device_busy_share'])
            if key == 'g_dual':
                rec['profile'] = {k: prof[k] for k in (
                    'device_us_total', 'wall_us', 'device_busy_share',
                    'kernel_calls')}
                rec['profile']['top10'] = prof['top'][:10]
            emit('train_jpeg_step', device=name, step=key, **rec)
    trainer._optimal_z = optimal_z
    # control: the non-dual D step with its fakes through cuDNN
    control = []
    with tf32_on(), _cudnn_fakes():
        for _ in range(1 + TRAIN_REPS):
            t0 = time.perf_counter()
            state, _ = step('d', False)
            torch.cuda.synchronize()
            control.append(1e3 * (time.perf_counter() - t0))
    iteration = {k: records[f'd_{k}']['ms'][-1] + records[f'g_{k}']['ms'][-1]
                 for k in ('single', 'dual')}
    cfg = trainer.cfg
    emit('train_jpeg', device=name, nf=JPEG_NF, nb=JPEG_NB,
         latent_channels=cfg.latent_channels, patch=cfg.patch_size,
         batch=JPEG_TRAIN_BATCH, gan=cfg.gan_type,
         optimal_z_iters=cfg.optimal_z_iters, qf=[5, 50], flags=flags,
         ms_per_iteration=iteration,
         control_d_single_cudnn_fakes_ms=control[1:],
         phase_s=time.perf_counter() - t_phase)
    del state, batch
    torch.cuda.empty_cache()
    return records


@contextlib.contextmanager
def _cudnn_fakes():
    """The Y trainer's D-step fakes generated through cuDNN: the control
    for the trainer's making them without it."""
    from exsr_torch.train import decomp
    saved = decomp._without_cudnn
    decomp._without_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        decomp._without_cudnn = saved


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _jpeg_reference_grads(where, kind, g, d, data, draws):
    """One Y step's gradients (a non-dual D step, or a dual G step with
    the GAN term) on ``where`` (a device, or ``'float64'`` for the CPU in
    float64), with the generator's running statistics after it."""
    import copy
    from exsr_torch.device import full_fp32
    f64 = where == 'float64'
    dev = 'cpu' if f64 else where
    trainer, *_ = jpeg_train_setup(1, 0, optimal_z_iters=JPEG_REF_ITERS)
    state = trainer.init_state(copy.deepcopy(g), copy.deepcopy(d), seed=3,
                               device=dev)
    batch = {k: v.to(dev) for k, v in data.items()}
    draws = _to(draws, lambda t: t.to(dev))
    if f64:
        state.g.double()
        state.d.double()
        batch['uncomp'] = batch['uncomp'].double()
        draws = _to(draws, lambda t: t.double())
    t0 = time.perf_counter()
    with full_fp32():
        if kind == 'd':
            grads, _ = trainer.d_grads(state, batch, draws, False)
        else:
            grads, _, _ = trainer.g_grads(state, batch, draws, True, True)
    module = state.d if kind == 'd' else state.g
    names = [n for n, _ in module.named_parameters()]
    bn = {n: b.cpu().double() for n, b in state.g.named_buffers()
          if 'running' in n}
    return (dict(zip(names, (t.detach().cpu().double() for t in grads))),
            bn, time.perf_counter() - t0)


def phase_train_jpeg_reference(device, name):
    """The Y trainer at full width, batch 2, on the card against the CPU on
    the same draws: a non-dual D step and a dual G step with two inner
    iterations.  Gradients within 1e-4 of the largest element, else no
    farther from the same step in float64 on the CPU than three times the
    CPU's fp32 run (phase 12's rule); the generator's running statistics
    after the G step within 1e-5 (absolute and relative).  Then one
    ChromaDecompTrainer step at the chroma CLI's width (nf 160 under a
    320-wide Y generator, batch 16), timed."""
    import math
    import torch
    from exsr_torch.utils.misc import fetch_scalars
    t_phase = time.perf_counter()
    trainer, g, d, data = jpeg_train_setup(JPEG_REF_BATCH, seed=53,
                                           optimal_z_iters=JPEG_REF_ITERS)
    state = trainer.init_state(g, d, seed=3, device=device)
    draws = {'d': trainer.draw_d(state, (JPEG_REF_BATCH, 32, 32, 64), False),
             'g': trainer.draw_g(state, (JPEG_REF_BATCH, 32, 32, 64), True)}
    g, d = state.g.cpu(), state.d.cpu()
    del state
    rec = {'batch': JPEG_REF_BATCH, 'inner_iters': JPEG_REF_ITERS}
    with tf32_on():
        for kind in ('d', 'g'):
            card, card_bn, card_s = _jpeg_reference_grads(
                device, kind, g, d, data, draws[kind])
            cpu, cpu_bn, cpu_s = _jpeg_reference_grads(
                'cpu', kind, g, d, data, draws[kind])
            r = rec[kind] = dict(dual=kind == 'g', tol=1e-4,
                                 max_rel_err=_grad_gap(card, cpu),
                                 worst=_worst(card, cpu), card_s=card_s,
                                 cpu_s=cpu_s)
            if r['max_rel_err'] > 1e-4:
                exact, _, r['float64_s'] = _jpeg_reference_grads(
                    'float64', kind, g, d, data, draws[kind])
                r.update(card_vs_float64=_grad_gap(card, exact),
                         cpu_vs_float64=_grad_gap(cpu, exact))
                check(r['card_vs_float64'] <= max(
                    1e-4, 3 * r['cpu_vs_float64']),
                    f'train_jpeg {kind} gradients card vs float64 {r}')
            if kind == 'd':
                # control, recorded: the fakes through cuDNN (its FFT
                # convolutions at these shapes)
                with _cudnn_fakes():
                    ctl, _, _ = _jpeg_reference_grads(device, kind, g, d,
                                                      data, draws[kind])
                exact = exact if 'float64_s' in r else \
                    _jpeg_reference_grads('float64', kind, g, d, data,
                                          draws[kind])[0]
                r['control_cudnn_fakes_vs_float64'] = _grad_gap(ctl, exact)
            if kind == 'g':
                r['bn_max_abs_err'] = max(float((card_bn[k] - v).abs().max())
                                          for k, v in cpu_bn.items())
                r['bn_max_rel_err'] = max(float(((card_bn[k] - v).abs()
                                                 / v.abs().clamp(min=1))
                                                .max())
                                          for k, v in cpu_bn.items())
                for k, v in cpu_bn.items():
                    torch.testing.assert_close(card_bn[k], v, atol=1e-5,
                                               rtol=1e-5, msg=k)
        rec['chroma'] = _chroma_step(device)
    check(all(math.isfinite(v) for v in rec['chroma']['metrics'].values()),
          f'chroma metrics {rec["chroma"]}')
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('train_jpeg_reference', device=name, nf=JPEG_NF, nb=JPEG_NB, **rec)
    return rec


def _chroma_step(device):
    """ChromaDecompTrainer at the chroma CLI's width, batch 16, patch 256:
    ms per step (a warm-up and two timed calls) and peak memory."""
    import numpy as np
    import torch
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, \
        DnCNNDiscriminator
    from exsr_torch.train.decomp import DecompConfig
    from exsr_torch.train.decomp_chroma import ChromaDecompTrainer
    from exsr_torch.utils.misc import fetch_scalars
    patch = 256
    gy = DnCNN(DnCNNConfig(n_channels=JPEG_NF, depth=JPEG_NB,
                           num_latent_channels=64), seed=7)
    gc = DnCNN(DnCNNConfig(n_channels=CHROMA_NF, depth=JPEG_NB,
                           in_nc=384, out_nc=128, chroma_generator=True,
                           block_size=8, num_latent_channels=0), seed=0)
    d = DnCNNDiscriminator(n_channels=CHROMA_NF, depth=JPEG_NB,
                           expected_input_size=patch // 16, in_nc=384,
                           seed=1)
    tr = ChromaDecompTrainer(DecompConfig(latent_channels=0,
                                          chroma_mode=True), gy)
    state = tr.init_state(gc, d, seed=2, device=device)
    rng = np.random.default_rng(57)
    ycbcr = np.concatenate([_y_images(JPEG_TRAIN_BATCH, patch, 58),
                            rng.uniform(60, 200, size=(
                                JPEG_TRAIN_BATCH, patch, patch, 2))],
                           -1).astype(np.float32)
    batch = {'uncomp': torch.from_numpy(ycbcr).to(device),
             'qf': torch.from_numpy(rng.integers(5, 51, JPEG_TRAIN_BATCH)
                                    .astype(np.int32)).to(device)}
    ms = []
    for rep in range(1 + TRAIN_REPS):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, metrics = tr.step(state, batch)
        torch.cuda.synchronize()
        if rep:
            ms.append(1e3 * (time.perf_counter() - t0))
    return dict(nf=CHROMA_NF, y_nf=JPEG_NF, nb=JPEG_NB,
                batch=JPEG_TRAIN_BATCH, patch=patch, ms=ms,
                peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
                metrics=fetch_scalars(metrics))


def phase_train_jpeg_cli(device, name):
    """``python -m exsr_torch.apps.train_jpeg``'s ``main`` at its defaults
    (nf 320, nb 10, batch 16, patch 256) on 16 synthetic 256 x 256 PNGs,
    with TF32 on: two steps with a validation and checkpoints, a resume to
    a third, then ``--chroma --y_ckpt`` on that checkpoint at nf 160, then
    ``eval_jpeg --checkpoint`` on it: its summary finite, every decode
    within half a bin."""
    import contextlib
    import io
    import json as _json
    import math
    import os
    import tempfile
    from exsr_torch.apps import eval_jpeg, train_jpeg
    from exsr_torch.train.checkpoints import CheckpointManager
    from exsr_torch.utils.logging import MetricLog
    t_phase = time.perf_counter()
    rec = {}
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp, tf32_on() as flags:
        rec['flags'] = flags
        data, val, exp = f'{tmp}/data', f'{tmp}/val', f'{tmp}/exp'
        os.makedirs(data)
        os.makedirs(val)
        _write_pngs(data, CLI_TRAIN_IMAGES, 256, seed=61)
        _write_pngs(val, 2, 256, seed=62)
        base = ['--data_dir', data, '--print_freq', '1', '--ckpt_freq', '1']
        runs = (('y', base + ['--exp_dir', exp, '--niter', '2', '--val_dir',
                              val, '--val_freq', '2']),
                ('y_resume', base + ['--exp_dir', exp, '--niter', '3',
                                     '--resume']),
                ('chroma', base + ['--exp_dir', f'{tmp}/chroma', '--chroma',
                                   '--nf', str(CHROMA_NF), '--y_nf',
                                   str(JPEG_NF), '--y_ckpt', f'{exp}/ckpt',
                                   '--niter', '2', '--val_dir', val,
                                   '--val_freq', '2']))
        for tag, argv in runs:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train_jpeg.main(argv)
            text = out.getvalue()
            rec[tag] = dict(wall_s=time.perf_counter() - t0, lines=[
                _json.loads(ln) for ln in text.splitlines()
                if ln.startswith('{')])
            if tag == 'y_resume':
                check('resumed at step 2' in text, 'train_jpeg resume')
            if tag == 'chroma':
                check('conditioning on Y generator from' in text,
                      'train_jpeg --y_ckpt')
        log = MetricLog().load(f'{exp}/logs.npz')
        check(log.last('psnr_val') is not None
              and log.last('l_d_total') is not None,
              f'train_jpeg logs {sorted(log.series)}')
        clog = MetricLog().load(f'{tmp}/chroma/logs.npz')
        check(all(math.isfinite(clog.last(k)) for k in (
            'psnr_chroma_val', 'l_d_total', 'l_g_pix')),
            f'chroma logs {sorted(clog.series)}')
        check(CheckpointManager(f'{exp}/ckpt').latest_step() == 3,
              'train_jpeg last checkpoint')
        summary = eval_jpeg.main(['--data_dir', val, '--qf', '10', '30',
                                  '--checkpoint', f'{exp}/ckpt',
                                  '--out_dir', f'{tmp}/eval'])
        with open(f'{tmp}/eval/summary.json') as f:
            per_image = _json.load(f)['per_image']
        check(all(math.isfinite(v) for v in summary.values()),
              f'eval_jpeg summary {summary}')
        check(all(r['bin_consistency_max'] <= 0.5 for r in per_image),
              'eval_jpeg on the trained checkpoint: bin consistency')
        rec['eval_jpeg'] = dict(summary=summary, bin_consistency_max=max(
            r['bin_consistency_max'] for r in per_image))
        rec['psnr_val'] = log.last('psnr_val')
        rec['psnr_chroma_val'] = clog.last('psnr_chroma_val')
    launches = read_launches()
    check(not any(launches.values()), f'train_jpeg_cli launches {launches}')
    rec['phase_s'] = time.perf_counter() - t_phase
    emit('train_jpeg_cli', device=name, images=CLI_TRAIN_IMAGES, hw=256,
         **rec)
    return rec


def _kg_image():
    """The in-repo 276 x 276 face degraded by a known anisotropic Gaussian
    x2 kernel (stride 2, VALID): ``(HR [3, 1, 276, 276], LR [132, 132, 3],
    the kernel)``."""
    import numpy as np
    import torch
    from PIL import Image
    from exsr_torch.kernelgan.kernelgan import aniso_gaussian_kernel
    img = np.asarray(Image.open(KG_IMAGE).convert('RGB'),
                     np.float32) / 255.0
    k_true = aniso_gaussian_kernel(13, 2.0, 0.8, 0.6, sf=2)
    hr = torch.from_numpy(img).permute(2, 0, 1)[:, None]
    lr = torch.nn.functional.conv2d(
        hr, torch.from_numpy(k_true.astype(np.float32))[None, None],
        stride=2)
    return hr, lr[:, 0].permute(1, 2, 0).numpy(), k_true


def _kg_quality(hr, k_true, k_rec) -> dict:
    """``cov_rel_err`` (the recovered kernel's centred covariance against
    the truth's, over the truth's largest entry) and the x2 downscaling
    action's MAE against the true kernel's, beside the bicubic
    assumption's (``tests/test_kernelgan.py``'s measures)."""
    import numpy as np
    import torch
    from exsr_torch.kernelgan.kernelgan import BICUBIC_K8, kernel_moments
    _, cov_t = kernel_moments(k_true)
    _, cov_r = kernel_moments(k_rec)
    size = max(k_true.shape[0], k_rec.shape[0])
    size += (size - k_true.shape[0]) % 2

    def action(k):
        p = size + (size - k.shape[0]) % 2 - k.shape[0]
        ke = np.pad(k, p // 2)
        return torch.nn.functional.conv2d(
            hr.double(), torch.from_numpy(ke)[None, None].double(),
            stride=2)[:, 0].numpy()
    bic = np.zeros((13, 13))
    bic[2:10, 2:10] = BICUBIC_K8
    lr_t, lr_r, lr_b = action(k_true), action(k_rec), action(bic)
    m = min(lr_t.shape[1], lr_r.shape[1]) - 8
    crop = (slice(None), slice(4, m), slice(4, m))
    return {'cov_rel_err': float(np.abs(cov_r - cov_t).max()
                                 / np.abs(cov_t).max()),
            'action_mae': float(np.abs(lr_t[crop] - lr_r[crop]).mean()),
            'action_mae_bicubic': float(np.abs(lr_t[crop]
                                               - lr_b[crop]).mean())}


def _kg_runs(lr, iters, where):
    """KernelGAN at its default width from seed 0's weights and crops on
    each ``(device, dtype)``: ``{tag: (losses [3, iters], raw kernel)}``."""
    import numpy as np
    import torch
    from exsr_torch.kernelgan.kernelgan import KernelGAN, KernelGANConfig
    out = {}
    for tag, dev, dt in where:
        kg = KernelGAN(KernelGANConfig(max_iters=iters), device=dev)
        kg.g.to(dt)
        kg.d.to(dt)
        kg.estimate(lr)
        out[tag] = (torch.from_numpy(np.stack(kg.losses)).double(),
                    torch.from_numpy(kg.raw_kernel).double())
    return out


def _kg_gaps(a, b) -> list:
    """The losses' largest relative gap, the kernel's over its largest
    entry."""
    return [float(((a[0] - b[0]).abs() / b[0].abs()).max()),
            float((a[1] - b[1]).abs().max() / b[1].abs().max())]


def _consistency(sess) -> float:
    """The largest LR-consistency error of the session's CEM-wrapped view
    before the display clip, inside the invalidity margins
    (``tests/test_session.py``'s measure)."""
    import numpy as np
    import torch
    from exsr_torch.cem.cem import consistent_downsample
    with torch.no_grad():
        out = sess._wrapped(sess.eff_params, sess._t(sess.lr_image),
                            sess._t(sess.cur_z),
                            sess.cem.invalidity_margins_lr, pre_pad=True)
        down = consistent_downsample(
            out, sess.filters, sess.cem.ds_kernel_invalidity_half_size_lr)
    m = int(np.clip(sess.cem.invalidity_margins_lr, 1,
                    sess.lr_image.shape[1] // 2 - 4))
    return float(np.abs(down.cpu().numpy()
                        - sess.lr_image)[:, m:-m, m:-m].max())


def phase_kernelgan(device, name):
    """KernelGAN on the card at its default configuration, TF32 on: one
    estimation on the in-repo face degraded by a known kernel (seconds,
    kernel quality: reported, not gated); its first iterations against the
    CPU (one iteration within 1e-4; twenty no farther from a float64 CPU
    run than three times the CPU's fp32 run); device launches per
    iteration and busy share from a profiled 20-iteration run;
    ``EditSession.estimate_kernel`` at full width (x4), its view and LR
    consistency against the same session on the CPU, and the session's
    1e-4 consistency with the kernel of ``exsr``'s own session test; and
    ``eval_sr --kernel estimated`` on one 128 x 128 LR image, fp32 trunk,
    with its stage-4 launches."""
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from exsr_torch.apps import eval_sr
    from exsr_torch.apps.session import EditSession
    from exsr_torch.kernelgan.kernelgan import (KernelGAN, KernelGANConfig,
                                                analytic_x4_kernel,
                                                post_process_kernel)
    t_phase = time.perf_counter()
    hr, lr, k_true = _kg_image()
    with tf32_on() as flags:
        kg = KernelGAN(KernelGANConfig(), device=device)
        t0 = time.perf_counter()
        k = kg.estimate(lr)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(bool(np.isfinite(k).all()) and abs(k.sum() - 1.0) < 1e-3,
              f'kernelgan kernel sum {k.sum()}')
        f32, f64 = torch.float32, torch.float64
        one = _kg_runs(lr, 1, [('card', device, f32), ('cpu', 'cpu', f32)])
        gaps = _kg_gaps(one['card'], one['cpu'])
        check(max(gaps) < 1e-4, f'kernelgan first iteration {gaps}')
        runs = _kg_runs(lr, KG_CHECK_ITERS, [
            ('card', device, f32), ('cpu', 'cpu', f32),
            ('float64', 'cpu', f64)])
        card = _kg_gaps(runs['card'], runs['float64'])
        cpu = _kg_gaps(runs['cpu'], runs['float64'])
        vs_cpu = dict(first_iteration=gaps, iters=KG_CHECK_ITERS,
                      card_vs_cpu=_kg_gaps(runs['card'], runs['cpu']),
                      card_vs_float64=card, cpu_vs_float64=cpu)
        check(all(c <= max(1e-4, 3 * p) for c, p in zip(card, cpu)),
              f'kernelgan card vs float64 {vs_cpu}')
        short = KernelGAN(KernelGANConfig(max_iters=KG_CHECK_ITERS),
                          device=device)
        prof = profile_forward(lambda _: short.estimate(lr), None)
    emit('kernelgan', device=name, image=KG_IMAGE, lr_shape=list(lr.shape),
         iters=kg.cfg.max_iters, estimate_s=seconds,
         ms_per_iteration=1e3 * seconds / kg.cfg.max_iters, flags=flags,
         kernel_shape=list(k.shape), kernel_sum=float(k.sum()),
         final_losses=[float(v[-1]) for v in kg.losses],
         **_kg_quality(hr, k_true, k), card_vs_cpu=vs_cpu,
         profile=dict(iters=KG_CHECK_ITERS, wall_us=prof['wall_us'],
                      device_busy_share=prof['device_busy_share'],
                      launches_per_iteration=prof['kernel_calls']
                      / KG_CHECK_ITERS, top5=prof['top'][:5]))

    with tf32_on():
        sess = EditSession(scale=4, nb=23, nf=64, latent_channels=3,
                           device=device)
        sess.init_random_params(0)
        sess.open_image(lr, is_hr=False)
        rec = {'consistency_bicubic': _consistency(sess)}
        t0 = time.perf_counter()
        kern = sess.estimate_kernel()
        torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0,
                   kernel_shape=list(kern.shape),
                   margins_lr=sess.cem.invalidity_margins_lr,
                   consistency=_consistency(sess))
        check(sess.estimated_kernel is not None and sess.sr is not None,
              'estimate_kernel did not switch the CEM')
        # the same kernel in the same session on the CPU: the view and its
        # consistency (exsr's estimated-kernel chain is not exact for
        # every kernel; tests/test_torch_kernelgan.py holds the port's to
        # exsr's)
        ref = EditSession(scale=4, nb=23, nf=64, latent_channels=3,
                          device='cpu')
        ref.load_params({k: v.cpu() for k, v in sess.params.items()})
        ref.open_image(lr, is_hr=False)
        ref.set_kernel(kern)
        rec['cpu_consistency'] = _consistency(ref)
        rec['view_vs_cpu'] = float(np.abs(sess.sr - ref.sr).max())
        check(rec['view_vs_cpu'] < 1e-4
              and abs(rec['consistency'] - rec['cpu_consistency']) < 1e-4,
              f'estimate_kernel card vs CPU {rec}')
        del ref
        # the kernel of exsr's session test (13 x 13, isotropic, sigma
        # 1.3, at x4), where the chain holds the session's 1e-4, and the
        # true kernel of the degraded image, composed to x4
        x = np.arange(13) - 6.0
        g1 = np.exp(-x ** 2 / (2 * 1.3 ** 2))
        sess.set_kernel(np.outer(g1, g1) / np.outer(g1, g1).sum())
        rec['consistency_exsr_test_kernel'] = _consistency(sess)
        check(rec['consistency_exsr_test_kernel'] < 1e-4,
              f'estimated-kernel CEM consistency {rec}')
        sess.set_kernel(analytic_x4_kernel(post_process_kernel(
            k_true.astype(np.float64), 2)))
        rec['consistency_true_kernel_x4'] = _consistency(sess)
        del sess
    emit('kernelgan_session', device=name, scale=4, nb=23, nf=64, **rec)

    with tf32_on(), tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f'{tmp}/lr')
        img = np.asarray(Image.open(KG_IMAGE).convert('RGB'))
        Image.fromarray(img[:KG_EVAL_LR, :KG_EVAL_LR]).save(
            f'{tmp}/lr/face.png')
        zero_launches()
        t0 = time.perf_counter()
        summary = eval_sr.main([
            '--lr_dir', f'{tmp}/lr', '--kernel', 'estimated',
            '--kernelgan_iters', str(KG_EVAL_ITERS), '--num_z', '2',
            '--out_dir', f'{tmp}/out'])
        wall = time.perf_counter() - t0
        launches = read_launches()
        with open(f'{tmp}/out/summary.json') as f:
            per_image = json.load(f)['per_image']
    check(all(math.isfinite(v) for v in summary.values()),
          f'eval_sr estimated {summary}')
    # one batched forward of the grouped fp32 trunk; the estimated
    # kernel's CEM takes the plain 2-D path
    check(launches['stage4'] == 69 and launches['rdb'] == 0,
          f'eval_sr estimated launches {launches}')
    emit('kernelgan_eval_sr', device=name, lr=KG_EVAL_LR,
         kernelgan_iters=KG_EVAL_ITERS, num_z=2,
         time_s=per_image[0]['time_s'], wall_s=wall, launches=launches,
         summary=summary, phase_s=time.perf_counter() - t_phase)

def train_rows(records, kern, taps) -> dict:
    """The training path's fields of each CEM kernel's row of the kernels
    line: launches per step kind and per iteration (D then G step), and
    the kernel at the training shapes (the adjoints' three launches of one
    backward summed)."""
    entries = {'sepfilter_edge': [kern['sepfilter_edge[lr]']],
               'sepfilter_down': [kern['sepfilter_down']],
               'sepfilter_up': [kern['sepfilter_up[combine]']],
               'sepfilter_taps': list(taps.values())}
    rows = {}
    for counter, recs in entries.items():
        per_step = {k: r['launches'][counter] for k, r in records.items()}
        rows[counter] = dict(
            launches_per_step=per_step,
            launches_per_iteration={
                k: per_step[f'd_{k}'] + per_step[f'g_{k}']
                for k in ('single', 'dual')},
            shape=recs[0].get('shape', recs[0].get('shape_in')),
            max_abs_err=max(r['max_abs_err'] for r in recs),
            **{f: sum(r[f] for r in recs) for f in (
                'ms', 'graph_ms', 'plain_ms', 'bound_ms')})
    return rows


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
    train_records, train_kern, train_taps, d_state = phase_train(device,
                                                                 name)
    phase_train_reference(device, name, d_state)
    phase_train_cli(device, name)
    jpeg_bytes = phase_jpeg_codec(device, name)
    phase_jpeg_edit(device, name, jpeg_bytes)
    phase_jpeg_eval_cli(device, name)
    phase_train_jpeg_step(device, name)
    phase_train_jpeg_reference(device, name)
    phase_train_jpeg_cli(device, name)
    phase_kernelgan(device, name)
    train = train_rows(train_records, train_kern, train_taps)

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
            graph_ms=kern[key]['graph_ms'], train=train[f'sepfilter_{k}'],
            **{f'even_taps_{f}': even[EVEN_ROW[k]][f] for f in (
                'taps', 'shape', 'max_abs_err', 'ms', 'graph_ms',
                'bound_ms')})
        for k, key, extra in (
            ('edge', 'sepfilter_edge[lr]', {
                'hr_ms': hr['ms'], 'hr_plain_ms': hr['plain_ms'],
                'hr_bound_ms': hr['bound_ms']}),
            ('down', 'sepfilter_down', {}),
            ('up', 'sepfilter_up[combine]', {'mode': 'combine'}))] + [
        # library_ms stays None (no one call computes either function);
        # the library chain beside it is phase 3's yardstick
        row('stage4', 'stage4_bf16', launches, forwards,
            source='exsr_torch/csrc/stage4.cu',
            replaces='exsr/ops/pallas/stage4.py:82', path='main',
            library_chain_ms=kern['stage4_bf16']['library_chain_ms']),
        row('rdb', 'rdb_bf16', fused_launches, fused_forwards,
            source='exsr_torch/csrc/rdb.cu',
            replaces='exsr/ops/pallas/rrdb_block.py:145', path='fused',
            library_chain_ms=kern['rdb_bf16']['library_chain_ms']),
        dict(taps_row(kern, edit_runs), train=train['sepfilter_taps'],
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
