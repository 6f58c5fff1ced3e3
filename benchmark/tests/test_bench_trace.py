"""Busy and idle time from the union of device intervals."""
import json

import pytest

from benchmark import trace as T

SPAN = 'bench.request'


def _write(tmp_path, events):
    p = tmp_path / 'trace.json'
    p.write_text(json.dumps({'traceEvents': [
        dict(ph='X', pid=1, tid=1, **e) for e in events]}))
    return str(p)


EVENTS = [
    {'name': SPAN, 'cat': 'user_annotation', 'ts': 0, 'dur': 100},
    {'name': 'aten::conv2d', 'cat': 'cpu_op', 'ts': 2, 'dur': 30},
    {'name': 'cudaStreamSynchronize', 'cat': 'cuda_runtime', 'ts': 60,
     'dur': 40},
    # an autograd range laid on the device's timeline over stage4
    {'name': '_Stage4', 'cat': 'gpu_user_annotation', 'ts': 10, 'dur': 20},
    {'name': 'void stage4_kernel<64, 2>(Args)', 'cat': 'kernel', 'ts': 10,
     'dur': 20},
    # two kernels that overlap on two streams
    {'name': 'cudnn_conv', 'cat': 'kernel', 'ts': 40, 'dur': 20},
    {'name': 'elementwise', 'cat': 'kernel', 'ts': 50, 'dur': 20},
    {'name': 'Memcpy HtoD', 'cat': 'gpu_memcpy', 'ts': 80, 'dur': 5},
    # outside the window
    {'name': 'late', 'cat': 'kernel', 'ts': 200, 'dur': 50},
]


def test_busy_is_the_union_not_a_sum(tmp_path):
    tr = T.load(_write(tmp_path, EVENTS), SPAN)
    assert tr.window == (0.0, 100.0)
    # stage4 10-30, convs 40-70, copy 80-85: 55 us
    assert T.busy_us(tr) == 55.0
    # key_averages()-style self times, summed over names, count the
    # range over stage4 and the overlap twice
    summed = sum(e['dur'] for e in EVENTS[3:8])
    assert summed == 85 > T.busy_us(tr)
    assert T.idle_gaps(tr) == [(0.0, 10.0), (30.0, 40.0), (70.0, 80.0),
                               (85.0, 100.0)]


def test_breakdown_names_what_the_host_did(tmp_path):
    tr = T.load(_write(tmp_path, EVENTS), SPAN)
    b = T.breakdown(tr)
    assert b['device_ops'][0] == ['void stage4_kernel<64, 2>(Args)',
                                  pytest.approx(20e-6)]
    assert 'late' not in [n for n, _ in b['device_ops']]
    gaps = dict(b['idle_gaps'])
    # 0-10 and 30-40 inside the conv2d op (2-32; 35 is past it: the span)
    assert gaps['aten::conv2d'] == pytest.approx(10e-6)
    assert gaps[SPAN] == pytest.approx(10e-6)
    assert gaps['cudaStreamSynchronize'] == pytest.approx(25e-6)


@pytest.mark.parametrize('kernel,base', [
    ('void (anonymous namespace)::stage4_kernel<64, 2>((anonymous '
     'namespace)::Args)', 'stage4_kernel'),
    ('void (anonymous namespace)::sepfilter_up_kernel<3>((anonymous '
     'namespace)::UpArgs)', 'sepfilter_up_kernel'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
     'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel>'
     '(int, at::native::gpu_kernel)', 'elementwise_kernel'),
    ('Memset (Device)', 'Memset')])
def test_kernel_base_names(kernel, base):
    from benchmark.metrics.common import base_name
    assert base_name(kernel) == base


def test_kernels_and_readers(tmp_path):
    from benchmark.run import HERE, load_module
    tr = T.load(_write(tmp_path, EVENTS), SPAN)
    assert [k[0] for k in tr.kernels()][0].startswith('void stage4')
    ctx = {'trace': tr, 'requests': 1, 'host_ms': [],
           'counts': {'dtype': 'bfloat16', 'stage4': (65_100.0, 1.0),
                      'model_flops': 1.0, 'peak_flops': 1.0,
                      'cem': {}}}
    read = {n: load_module(HERE / 'metrics' / f'{n}.py').read for n in (
        'idle_share.serve', 'launches_per_req.serve', 'trunk_ms.serve',
        'stage4_roofline', 'cem_ms.serve', 'host_ms.serve')}
    assert read['idle_share.serve'](ctx) == pytest.approx(45.0)
    assert read['launches_per_req.serve'](ctx) == 3
    assert read["trunk_ms.serve"](ctx) == pytest.approx(0.04)
    # 65,100 bytes at 3.35 TB/s is 19.43 ns; the kernel took 20 us
    assert read['stage4_roofline'](ctx) == pytest.approx(
        100 * 65_100 / 3.35e12 / 20e-6)
    assert read['cem_ms.serve'](ctx) is None
    assert read['host_ms.serve'](ctx) is None


def test_cem_readers_use_per_launch_means(tmp_path):
    """One request's two edge launches, one down, one up, of which the
    trace lost the second edge launch: the readers scale the means."""
    from benchmark.run import HERE, load_module
    ev = [{'name': SPAN, 'cat': 'user_annotation', 'ts': 0, 'dur': 100}]
    for name, ts, dur in (('sepfilter_edge_kernel<3>', 10, 4),
                          ('sepfilter_down_kernel<3>', 20, 10),
                          ('sepfilter_up_kernel<3>', 40, 20)):
        ev.append({'name': f'void (anonymous namespace)::{name}((anonymous'
                           ' namespace)::Args)', 'cat': 'kernel', 'ts': ts,
                   'dur': dur})
    tr = T.load(_write(tmp_path, ev), SPAN)
    # bounds of 1, 2 and 4 us a launch: bytes at 3.35 TB/s, no operations
    b = 3.35e6
    ctx = {'trace': tr, 'requests': 1, 'counts': {'cem': {
        'sepfilter_edge': [(1 * b, 0), (1 * b, 0)],
        'sepfilter_down': [(2 * b, 0)], 'sepfilter_up': [(4 * b, 0)]}}}
    cem = load_module(HERE / 'metrics' / 'cem_ms.serve.py').read(ctx)
    assert cem == pytest.approx((2 * 4 + 10 + 20) / 1e3)
    roof = load_module(HERE / 'metrics' / 'sepfilter_roofline.py').read(ctx)
    assert roof == pytest.approx(100 * (1 + 2 + 4) / (4 + 10 + 20))
