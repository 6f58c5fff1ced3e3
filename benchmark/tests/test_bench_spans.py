"""The readers of the program's spans and counters, on synthetic records
and a synthetic trace: self time, idle time put down to the innermost
program range, and None where the program recorded nothing."""
import pytest

from benchmark import spans as S
from benchmark.run import HERE, load_module
from benchmark.trace import Trace


def _span(sid, name, parent, device_ms, root=1):
    return {'name': name, 'id': sid, 'parent': parent, 'root': root,
            'start_ns': 0, 'end_ns': 0, 'device_ms': device_ms}


# one request of the serving entry point, as the program nests it
SWEEP = [_span(3, 'exsr.cem', 2, 0.25), _span(4, 'exsr.generator', 2, 6.0),
         _span(5, 'exsr.cem', 2, 0.5), _span(2, 'exsr.forward', 1, 9.0),
         _span(1, 'exsr.sweep', None, 10.0)]


def _read(name, ctx):
    return load_module(HERE / 'metrics' / f'{name}.py').read(ctx)


def test_self_time_subtracts_the_nested_spans():
    rec = {'spans': SWEEP, 'counters': {}}
    assert S.span_ms(rec, {'exsr.generator'}) == 6.0
    assert S.span_ms(rec, {'exsr.cem'}) == 0.75
    # sweep 10 less forward 9; forward 9 less 6.75
    assert S.span_ms(rec, {'exsr.sweep', 'exsr.forward'}) == \
        pytest.approx(3.25)
    assert S.span_ms(rec, {'exsr.sweep'}, whole=True) == 10.0
    assert S.span_ms(rec, {'exsr.adam'}) is None
    # without a card no span has a device time
    cpu = {'spans': [dict(s, device_ms=None) for s in SWEEP],
           'counters': {}}
    assert S.span_ms(cpu, {'exsr.sweep'}) is None


@pytest.mark.parametrize('cell', ['serve', 'photo'])
def test_serving_readers_divide_by_the_traced_requests(cell):
    ctx = {'requests': 2, S.KEY: {
        'spans': SWEEP + [dict(s, id=s['id'] + 10, root=11,
                               parent=s['parent'] and s['parent'] + 10)
                          for s in SWEEP],
        'counters': {'px.generated': 16 * 592 * 592,
                     'px.returned': 15 * 512 * 512}}}
    assert _read(f'generator_span_ms.{cell}', ctx) == 6.0
    assert _read(f'cem_span_ms.{cell}', ctx) == 0.75
    assert _read(f'entry_span_ms.{cell}', ctx) == pytest.approx(3.25)
    # 15 images of 512² from a bucket of 16 at 592²: 70.12 %
    assert _read(f'useful_px_share.{cell}', ctx) == pytest.approx(
        100 * 15 * 512 ** 2 / (16 * 592 ** 2))


def test_training_readers_take_whole_spans():
    step = [_span(3, 'exsr.generator', 2, 40.0),
            _span(2, 'exsr.map_loop', 1, 100.0),
            _span(4, 'exsr.backward', 1, 30.0),
            _span(5, 'exsr.adam', 1, 2.0), _span(1, 'exsr.d_step', None, 140)]
    ctx = {'requests': 1, S.KEY: {'spans': step, 'counters': {}}}
    assert _read('map_ms.train', ctx) == 100.0
    assert _read('backward_ms.train', ctx) == 30.0
    assert _read('adam_ms.train', ctx) == 2.0


def _trace():
    """Program ranges: a sweep 0-100 around a forward 10-90 around a
    generator 20-60, and a map loop 100-200 around a generator 120-160.
    The device leaves gaps 0-12 (middle 6: the sweep, for ``aten::cat`` is
    not the program's), 15-25 (middle 20: the generator, just begun),
    40-50 (the generator), 85-95 (middle 90: the forward has ended, the
    sweep), 102-106 (the map loop) and 130-140 (the map loop's
    generator)."""
    host = [('exsr.sweep', 0, 100, 1), ('exsr.forward', 10, 90, 1),
            ('exsr.generator', 20, 60, 1), ('aten::cat', 1, 11, 1),
            ('exsr.map_loop', 100, 200, 1), ('exsr.generator', 120, 160, 1),
            ('bench.request', 0, 200, 1)]
    device = [('k', 'kernel', 12, 15), ('k', 'kernel', 25, 40),
              ('k', 'kernel', 50, 85), ('k', 'kernel', 95, 102),
              ('k', 'kernel', 106, 130), ('k', 'kernel', 140, 200)]
    return Trace(device=device, host=host, window=(0.0, 200.0))


def test_idle_goes_to_the_innermost_program_range():
    ctx = {'trace': _trace(), 'requests': 2}
    # 0-12 and 85-95: 22 us over 2 requests
    assert _read('entry_idle_ms.serve', ctx) == pytest.approx(22e-3 / 2)
    assert _read('entry_idle_ms.photo', ctx) == pytest.approx(22e-3 / 2)
    # 102-106 and 130-140: the map loop's generator counts as the loop's
    ctx['requests'] = 1
    assert _read('map_idle_ms.train', ctx) == pytest.approx(14e-3)


def test_nothing_recorded_reads_none():
    from exsr_torch.utils.logging import reset
    reset()
    bare = Trace(device=[('k', 'kernel', 0, 5)],
                 host=[('bench.request', 0, 10, 1)], window=(0.0, 10.0))
    ctx = {'trace': bare, 'requests': 1}
    for name in ('generator_span_ms.serve', 'cem_span_ms.serve',
                 'entry_span_ms.serve', 'entry_idle_ms.serve',
                 'useful_px_share.serve', 'map_ms.train', 'backward_ms.train',
                 'adam_ms.train', 'map_idle_ms.train'):
        assert _read(name, ctx) is None, name
    assert ctx[S.KEY] is None


def test_records_are_taken_from_the_program_once():
    import exsr_torch.utils.logging as L
    L.reset()
    with L.recording():
        with L.span('exsr.sweep'):
            L.count('px.returned', 3)
    ctx = {}
    rec = S.records(ctx)
    assert [s['name'] for s in rec['spans']] == ['exsr.sweep']
    assert rec['counters'] == {'px.returned': 3}
    # taken and cleared there: later readers of the run read the context
    assert L.recorded() == {'spans': [], 'counters': {}}
    assert S.records(ctx) is rec


def test_a_program_without_spans_reads_none(monkeypatch):
    """As on a commit older than the program's spans."""
    import exsr_torch.utils.logging as L
    monkeypatch.delattr(L, 'recorded')
    ctx = {'requests': 1}
    assert _read('generator_span_ms.serve', ctx) is None
    assert _read('useful_px_share.photo', ctx) is None
