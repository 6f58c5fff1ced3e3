"""Every cell, configuration and metric of BENCHMARK.json loads by name,
the file keeps to its contract, and nothing the harness loads is JAX or
the JAX package."""
import json
import re
import subprocess
import sys

import pytest

from benchmark.run import HERE, ROOT, cell_metrics, load_cell, load_module

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('name', CELLS)
def test_cell_loads_by_name(name):
    w = next(w for w in BENCH['workloads'] if w['name'] == name)
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    cell, cfg = load_cell(name)
    assert cell['config'] == w['config'] == cfg['name']
    assert w['name'] == f'{w["config"]}.{w["traffic"]}'
    assert w['chips'] == cell['chips'] == 1
    assert w['why'] == cell['why'] and 1 <= len(w['why']) <= 200
    assert (HERE / 'drivers' / f'{cell["driver"]}.py').exists()
    assert (HERE / 'reference' / f'{cell["config"]}.py').exists()
    for kind in ('end_to_end', 'per_layer'):
        assert cell_metrics(BENCH, name, kind)
    assert 'setup_s' in [m['name'] for m in
                         cell_metrics(BENCH, name, 'end_to_end')]
    # every per-layer metric's end-to-end metric is reported in the cell
    e2e = {m['name'] for m in cell_metrics(BENCH, name, 'end_to_end')}
    assert {m['moves'] for m in cell_metrics(BENCH, name, 'per_layer')} <= e2e


@pytest.mark.parametrize('cfg', BENCH['configs'], ids=lambda c: c['name'])
def test_config_loads_by_name(cfg):
    assert set(cfg) == {'name', 'source', 'file', 'reduced', 'why'}
    data = json.loads((ROOT / cfg['file']).read_text())
    assert data['name'] == cfg['name'] and data['reduced'] == cfg['reduced']
    assert data['source'] == cfg['source']
    assert any(w['config'] == cfg['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('m', METRICS, ids=lambda m: m['name'])
def test_metric_entry(m):
    assert NAME.match(m['name']) and UNIT.match(m['unit'])
    assert m['better'] in ('lower', 'higher')
    for cell in m.get('workloads', []):
        assert cell in CELLS
    if m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    else:
        assert m['moves'] in [e['name'] for e in BENCH['end_to_end']]
        assert callable(load_module(HERE / 'metrics' /
                                    f'{m["name"]}.py').read)
    if 'roofline' in m['name'] or 'mfu' in m['name']:
        assert m['unit'] == '%'


def test_no_jax_in_the_harness_process():
    """Import every module of the harness and the port's serving entry in
    a fresh interpreter; no top-level module name may be JAX's, its
    libraries' or the JAX package's (``exsr_torch`` is not ``exsr``)."""
    code = (
        'import sys, pkgutil, importlib, benchmark\n'
        'for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):\n'
        '    if ".tests" not in m.name:\n'
        '        importlib.import_module(m.name)\n'
        'from benchmark.drivers import serve, train\n'
        'serve.Program(), train.Program()\n'
        'from benchmark.run import forbidden_modules\n'
        'print(forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark.run import forbidden_modules
    assert forbidden_modules(['exsr_torch', 'exsr_torch.apps.eval_sr',
                              'jaxtyping', 'flaxen.x']) == []
    assert forbidden_modules(['exsr.cem', 'jaxlib.xla_client', 'optax',
                              'torch']) == ['exsr', 'jaxlib', 'optax']
