"""The program's spans and counters (``exsr_torch.utils.logging``) on the
CPU: a span is one shared null context while nothing records, the serving
entry point's spans nest under one root, its pixel counters match the
shapes, and the profiler's trace holds the spans as ranges."""
import json

import numpy as np
import pytest
import torch

from exsr_torch.apps import eval_sr
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.utils import logging as L
from exsr_torch.utils.serve import best_bucket

LR, NZ = 8, 3


@pytest.fixture(scope='module')
def served():
    """A tiny CEM-wrapped generator and one sweep's inputs: LR 8², three
    Z maps."""
    torch.manual_seed(0)
    cem, fwd = eval_sr.build_model(4, nb=1, nf=8, device='cpu',
                                   params=RRDBNet(nf=8, nb=1, upscale=4,
                                                  latent_channels=NZ))
    rng = np.random.default_rng(0)
    lr = rng.uniform(size=(1, LR, LR, 3)).astype(np.float32)
    zs = [np.full((1, 4 * LR, 4 * LR, NZ), v, np.float32)
          for v in (-0.5, 0.0, 0.5)]
    return cem, fwd, lr, zs


def test_span_is_one_shared_null_context_while_nothing_records(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('called while nothing records')
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.cuda, 'Event', boom)
    L.reset()
    first = L.span('exsr.sweep')
    assert first is L.span('exsr.generator')
    with first:
        L.count('px.returned', 5)
    assert L.recorded() == {'spans': [], 'counters': {}}


def test_sweep_spans_nest_under_one_root_and_count_pixels(served):
    cem, fwd, lr, zs = served
    L.reset()
    with L.recording():
        outs = eval_sr.bucketed_sweep(fwd, lr, zs)
    rec = L.recorded()
    spans = sorted(rec['spans'], key=lambda s: s['start_ns'])
    names = [s['name'] for s in spans]
    assert names == ['exsr.sweep', 'exsr.forward', 'exsr.cem',
                     'exsr.generator', 'exsr.cem']
    sweep, forward = spans[:2]
    assert sweep['parent'] is None
    assert forward['parent'] == sweep['id']
    assert all(s['parent'] == forward['id'] for s in spans[2:])
    assert {s['root'] for s in spans} == {sweep['id']}
    assert all(s['device_ms'] is None and s['end_ns'] >= s['start_ns']
               for s in spans)
    # the bucket's rows at the pre-padded HR size, and the images returned
    m, n = cem.invalidity_margins_lr, len(zs)
    hr_pad = 4 * (LR + 2 * m)
    assert rec['counters'] == {
        'px.generated': best_bucket(n) * hr_pad * hr_pad,
        'px.returned': n * (4 * LR) ** 2}
    assert len(outs) == n
    # recorded() leaves the records; reset() clears them
    assert len(L.recorded()['spans']) == 5
    L.reset()
    assert L.recorded() == {'spans': [], 'counters': {}}


def test_profiler_records_the_spans_in_its_active_steps_only():
    from torch.profiler import ProfilerActivity, profile, schedule
    L.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for i in range(4):
            with L.span(f'step{i}'):
                torch.ones(2).sum()
            prof.step()
    assert [s['name'] for s in L.recorded()['spans']] == ['step1', 'step2']
    L.reset()


def test_profile_trace_holds_the_spans_as_ranges(served, tmp_path):
    _, fwd, lr, zs = served
    L.reset()
    with L.profile_trace(str(tmp_path)):
        eval_sr.bucketed_sweep(fwd, lr, zs)
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    ranges = {e['name'] for e in events
              if e.get('cat') == 'user_annotation'}
    assert {'exsr.sweep', 'exsr.forward', 'exsr.cem',
            'exsr.generator'} <= ranges
    assert [s['name'] for s in L.recorded()['spans']][-1] == 'exsr.sweep'
    L.reset()
