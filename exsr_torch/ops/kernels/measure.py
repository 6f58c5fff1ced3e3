"""Timing and checking the port's kernels on the card.

Shared by ``chip_smoke.py`` and the probes in ``exsr_torch/scripts``.
Every time is a mean in ms per call.  A key ending in ``_ms`` is measured
by CUDA events around calls launched one by one (:func:`cuda_ms`); a
``graph_ms`` key is the same calls captured in one CUDA graph and replayed
(:func:`graph_ms`), which leaves out the host's launch overhead: it is the
device's time for a kernel shorter than its own launch from Python.
"""
from __future__ import annotations

import torch

from exsr_torch.ops import filters
from exsr_torch.ops.kernels import sepfilter as K

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published rates (dense)
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 tensor cores


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """The least time for the work, ``(ms, 'bytes' or 'operations')``:
    the larger of the bytes over the memory rate and the operations over
    the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                      else 'operations')


def cuda_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call from CUDA events over ``iters`` calls after a
    warm-up, cycling through ``arg_sets`` so that inputs larger than L2 in
    total arrive cold, as on the main path."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call of ``iters`` calls, cycling through ``arg_sets``,
    captured in one CUDA graph and replayed three times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (3 * iters)


def composed_down(x, kcol, krow, sf, pre):
    """``sepfilter_down``'s function through the same-size kernel: the
    filter at every HR pixel, then the strided subsample."""
    return filters.aliased_subsample(K.sepfilter_edge(x, kcol, krow), sf,
                                     pre).contiguous()


def composed_up(a, kcol, krow, sf, pre, b=None, g=None):
    """``sepfilter_up``'s function through the same-size kernel: zero
    stuffing, the filter at every HR pixel, the combine elementwise."""
    def up(t):
        return K.sepfilter_edge(filters.zero_stuff(t, sf, pre), kcol, krow)
    return up(a) if b is None else up(a) + (g - up(b))


def enforce_composed(filt, lr, g):
    """``CEMFilters.enforce`` through the same-size kernel alone: five
    launches and the zero stuffing, subsample and elementwise ops around
    them.  The same values, bit for bit."""
    inv, sf, pre = filt.w_inv_hth_1d, filt.sf, filt.pre
    a = K.sepfilter_edge(lr.contiguous(), *inv)
    b = K.sepfilter_edge(composed_down(g, *filt.w_down_1d, sf, pre), *inv)
    return composed_up(a, *filt.w_up_1d, sf, pre, b=b, g=g)


SEPFILTER_CASES = ('sepfilter_edge[hr]', 'sepfilter_edge[lr]',
                   'sepfilter_down', 'sepfilter_up[up]',
                   'sepfilter_up[combine]', 'cem_enforce')


def sepfilter_kernels(filt, gen, device, batch: int, lr: int,
                      cases=SEPFILTER_CASES, verify: bool = True,
                      graph_hr: bool = False, references: bool = True
                      ) -> dict:
    """The CEM filter's entry points at LR ``lr`` and HR ``lr * filt.sf``
    (the down and up filters at HR, the inv_hTh filter at LR), by name.
    An even tap count grows the same-size and up filters' outputs by one
    pixel along each axis (``sepfilter.out_len``); the combine's ``g`` has
    the up filter's output size.

    Each record holds the error against the plain version (tolerance
    1e-5), whether the shapes agree, whether the result equals its
    composition through the same-size kernel and itself on a second call,
    bit for bit, the
    kernel's time (``ms``; ``graph_ms`` too, except for the same-size
    kernel at HR unless ``graph_hr``) and its bound from this run's bytes
    and useful operations.  With ``references``, also the composition's
    and the plain version's times (``composed_ms``, ``plain_ms``).
    ``cem_enforce`` times ``CEMFilters.enforce`` on the kernels' route and
    on the composition.  With ``verify`` a failed check raises.  Inputs
    arrive cold: the sets exceed L2 in total."""
    hr, sf, pre = lr * filt.sf, filt.sf, filt.pre
    hr_sets = [torch.rand(batch, hr, hr, 3, generator=gen, device=device)
               for _ in range(3)]
    lr_sets = [torch.rand(batch, lr, lr, 3, generator=gen, device=device)
               for _ in range(12)]
    kd, ku, ki = (filt.w_down_1d[0].numel(), filt.w_up_1d[0].numel(),
                  filt.w_inv_hth_1d[0].numel())
    hr_up = K.out_len(hr, ku)
    g_sets = hr_sets if hr_up == hr else [
        torch.rand(batch, hr_up, hr_up, 3, generator=gen, device=device)
        for _ in range(3)]
    hr_bytes, lr_bytes = 4 * hr_sets[0].numel(), 4 * lr_sets[0].numel()
    up_bytes = 4 * g_sets[0].numel()
    # outputs of the same-size filter at HR and LR, and of the down filter
    edge_hr = 4 * batch * 3 * K.out_len(hr, kd) ** 2
    edge_lr = 4 * batch * 3 * K.out_len(lr, ki) ** 2
    down_lr = 4 * batch * 3 * len(range(pre[0], K.out_len(hr, kd), sf)) ** 2
    # useful fp32 operations (2 a product): the same-size filter at every
    # pixel; down: the column pass at the kept rows, the row pass at the
    # kept pixels; up: the products whose input is data (the tap lists'
    # entries), plus the combine's two adds
    px_hr, px_lr = edge_hr // 4, edge_lr // 4
    up_taps = int((K.polyphase_taps(lr, sf, pre[0], ku) >= 0).sum())
    up_flops = 2 * 2 * batch * 3 * up_taps * (lr + hr_up)
    table = {
        'sepfilter_edge[hr]': (
            K.sepfilter_edge, None, K.sepfilter_edge_plain,
            [(x, *filt.w_down_1d) for x in hr_sets], hr_bytes + edge_hr,
            2 * 2 * kd * px_hr),
        'sepfilter_edge[lr]': (
            K.sepfilter_edge, None, K.sepfilter_edge_plain,
            [(x, *filt.w_inv_hth_1d) for x in lr_sets], lr_bytes + edge_lr,
            2 * 2 * ki * px_lr),
        'sepfilter_down': (
            K.sepfilter_down, composed_down, K.sepfilter_down_plain,
            [(x, *filt.w_down_1d, sf, pre) for x in hr_sets],
            hr_bytes + down_lr, 2 * kd * (px_hr // sf + down_lr // 4)),
        'sepfilter_up[up]': (
            K.sepfilter_up, composed_up, K.sepfilter_up_plain,
            [(lr_sets[i], *filt.w_up_1d, sf, pre) for i in range(3)],
            up_bytes + lr_bytes, up_flops // 2),
        'sepfilter_up[combine]': (
            K.sepfilter_up, composed_up, K.sepfilter_up_plain,
            [(lr_sets[2 * i], *filt.w_up_1d, sf, pre, lr_sets[2 * i + 1],
              g_sets[i]) for i in range(3)], 2 * up_bytes + 2 * lr_bytes,
            up_flops + 2 * up_bytes // 4),
    }
    results = {}
    for name in cases:
        if name == 'cem_enforce':
            continue
        fn, composed, plain, sets, nbytes, flops = table[name]
        out = fn(*sets[0])
        ref = plain(*sets[0])
        comp = out if composed is None else composed(*sets[0])
        again = fn(*sets[0])
        torch.cuda.synchronize()
        same_shape = out.shape == ref.shape == comp.shape
        rec = dict(shape=list(out.shape), shape_equal_plain=same_shape,
                   taps=[sets[0][1].numel(), sets[0][2].numel()],
                   max_abs_err=(out - ref).abs().max().item()
                   if same_shape else float('inf'), tol=1e-5,
                   bit_equal_composition=same_shape and bool(
                       torch.equal(out, comp)),
                   repeat_bit_equal=bool(torch.equal(again, out)))
        del out, ref, comp, again
        if verify:
            _check(same_shape, f'{name} shape differs from the plain '
                   'version\'s')
            _check(rec['max_abs_err'] <= 1e-5,
                   f'{name} max error {rec["max_abs_err"]} > 1e-5')
            _check(rec['bit_equal_composition'], f'{name} differs from its '
                   'composition through the same-size kernel')
            _check(rec['repeat_bit_equal'], f'{name} did not repeat itself')
        rec['ms'] = cuda_ms(fn, sets, 40)
        if graph_hr or name != 'sepfilter_edge[hr]':
            rec['graph_ms'] = graph_ms(fn, sets, 40)
        if references:
            if composed is not None:
                rec['composed_ms'] = cuda_ms(composed, sets, 20)
            rec['plain_ms'] = cuda_ms(plain, sets, 10)
        rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops,
                                                    FP32_FLOPS)
        results[name] = rec
    if 'cem_enforce' in cases:
        with torch.inference_mode():
            sets = [(lr_sets[i], hr_sets[i]) for i in range(3)]
            new = filt.enforce(*sets[0])
            old = enforce_composed(filt, *sets[0])
            torch.cuda.synchronize()
            equal = bool(torch.equal(new, old))
            if verify:
                _check(equal, 'CEM enforce differs from the composition '
                       'through the same-size kernel')

            def composed(lr_, g):
                return enforce_composed(filt, lr_, g)
            results['cem_enforce'] = dict(
                shape=list(new.shape), bit_equal_composition=equal,
                cem_enforce_ms=cuda_ms(filt.enforce, sets, 12),
                cem_enforce_graph_ms=graph_ms(filt.enforce, sets, 12),
                cem_enforce_composed_ms=cuda_ms(composed, sets, 12),
                cem_enforce_composed_graph_ms=graph_ms(composed, sets, 12))
            del new, old
    del hr_sets, lr_sets, g_sets
    torch.cuda.empty_cache()
    return results


def taps_inputs(filt, batch: int, lr: int, gen, device):
    """The three adjoints of the CEM filter's backward at LR ``lr`` (HR
    ``lr * sf``), as ``{kind: (input, row table, column table, forward)}``:
    ``U`` (U^T, HR in, LR out), ``E`` (the inv_hTh filter's E^T, LR) and
    ``D`` (D^T, LR in, HR out), in the order a backward runs them, on
    tables tiled for ``batch`` images.  Each input has the size of its
    forward map's output (one pixel more along an axis with an even tap
    count); ``forward`` is that map's plain version, library calls whose
    autograd backward is the adjoint's library chain."""
    sf, pre = filt.sf, filt.pre
    cases = {'U': (filt.adj_up, lr, filt.w_up_1d, K.sepfilter_up_plain),
             'E': (filt.adj_inv_hth, lr, filt.w_inv_hth_1d,
                   K.sepfilter_edge_plain),
             'D': (filt.adj_down, lr * sf, filt.w_down_1d,
                   K.sepfilter_down_plain)}
    out = {}
    for kind, (tables, n_fwd, taps, plain) in cases.items():
        rows, cols = tables.get(kind, n_fwd, n_fwd, sf, pre, device,
                                batch=batch)
        y = torch.rand(batch, rows.n_in, cols.n_in, 3, generator=gen,
                       device=device)
        extra = () if kind == 'E' else (sf, pre)

        def forward(x, taps=taps, plain=plain, extra=extra):
            return plain(x, *taps, *extra)
        out[kind] = (y, rows, cols, forward)
    return out


def taps_library_chain(forward, y, out, iters: int) -> dict:
    """A yardstick, not one call: the adjoint as autograd computes it for
    its forward map written from library calls (replicate ``F.pad``, the
    two depthwise 1-D ``F.conv2d``s; the zero stuffing or the strided
    slice around them), ``torch.autograd.grad`` of ``y`` on a retained
    graph, fp32 with TF32 off; its ms and its largest distance to the
    kernel's ``out``, relative to the largest output.  The port never
    runs it."""
    from exsr_torch.device import full_fp32
    x = torch.zeros(out.shape, device=out.device, requires_grad=True)
    with full_fp32():
        fx = forward(x)

        def chain(g):
            return torch.autograd.grad(fx, x, g, retain_graph=True)[0]
        err = ((chain(y) - out).abs().max() / out.abs().max()).item()
        ms = cuda_ms(chain, [(y,)], iters)
    return {'library_chain_ms': ms, 'library_chain_max_rel_err': err}


def sepfilter_taps_kernels(filt, gen, device, batch: int, lr: int,
                           verify: bool = True, references: bool = True
                           ) -> dict:
    """``sepfilter_taps`` against its plain version (tolerance 1e-5 of the
    largest output: the sums run in another order) for each adjoint of
    the CEM filter's backward at one shape, with its time by events and by
    graph replay, its output tile and band widths, and its bound: bytes
    (input, output and both axes' bands, once) or useful operations (2 a
    table entry, column pass at every input column, row pass at every
    output row).  With ``references``, also the plain version's time and
    the library chain's (:func:`taps_library_chain`)."""
    results = {}
    for kind, (y, rows, cols, forward) in taps_inputs(
            filt, batch, lr, gen, device).items():
        sets = [(y, rows, cols)] + [
            (torch.rand(y.shape, generator=gen, device=device), rows, cols)
            for _ in range(2)]
        out = K.sepfilter_taps(*sets[0])
        ref = K.sepfilter_taps_plain(*sets[0])
        torch.cuda.synchronize()
        abs_err = (out - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        if verify:
            _check(out.shape == ref.shape, f'sepfilter_taps[{kind}] shape '
                   f'{tuple(out.shape)} differs from the plain version\'s')
            _check(err <= 1e-5, f'sepfilter_taps[{kind}] relative error '
                   f'{err} > 1e-5')
        b, hi, wi, c = y.shape
        ho, wo = out.shape[1:3]
        tables = sum(4 * (t.base.numel() + t.band.numel())
                     for t in (rows, cols))
        nbytes = 4 * (y.numel() + out.numel()) + tables
        nnz_r = int((rows.idx >= 0).sum())
        nnz_c = int((cols.idx >= 0).sum())
        flops = 2 * b * c * (nnz_r * wi + nnz_c * ho)
        bms, by = bound_ms(nbytes, flops, FP32_FLOPS)
        rec = dict(
            shape_in=list(y.shape), shape_out=list(out.shape),
            entries=[rows.idx.shape[0], cols.idx.shape[0]],
            band_width=[rows.width, cols.width],
            tile=[rows.tile, cols.tile],
            max_abs_err=abs_err, max_rel_err=err, tol=1e-5,
            ms=cuda_ms(K.sepfilter_taps, sets, 30),
            graph_ms=graph_ms(K.sepfilter_taps, sets, 30),
            bound_ms=bms, bound_by=by)
        if references:
            rec['plain_ms'] = cuda_ms(K.sepfilter_taps_plain, sets, 5)
            rec.update(taps_library_chain(forward, y, ref, 10))
            if verify:
                _check(rec['library_chain_max_rel_err'] <= 1e-5,
                       f'sepfilter_taps[{kind}]: the library chain is '
                       f'{rec["library_chain_max_rel_err"]} from the plain '
                       'version')
        results[kind] = rec
        del out, ref, sets
    torch.cuda.empty_cache()
    return results


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')
