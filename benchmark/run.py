"""Run one cell of the port's benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
``exsr_torch``.  Everything is found by name: the cell in
``benchmark/workloads/<cell>.json`` (its configuration, driver, dtype,
traffic and check), the configuration in ``benchmark/configs/``, its plain
reference in ``benchmark/reference/<config>.py``, the driver in
``benchmark/drivers/<driver>.py`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.  Which metrics a cell reports is read
from ``BENCHMARK.json``: with ``--trace 0`` its end-to-end metrics, with
``--trace 1`` its per-layer metrics.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error repeat the checks.  The run exits
with 2, printing no result, without as many CUDA devices as the cell asks
for, and with 3 if JAX, its libraries or the JAX package were loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'exsr')


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """``(cell, config)`` of a workload, from their files."""
    cell = load_json('workloads', f'{name}.json')
    return cell, load_json('configs', f'{cell["config"]}.json')


def load_module(path: Path):
    """A module from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f'benchmark_file_{path.stem.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The entries of ``bench[kind]`` that the cell reports."""
    return [m for m in bench[kind]
            if 'workloads' not in m or name in m['workloads']]


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole: ``exsr_torch`` is
    not ``exsr``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def device_info(torch, device, chips: int, peak: int) -> dict:
    return {'platform': 'gpu' if device.type == 'cuda' else device.type,
            'kind': (torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
            'count': chips, 'memory_peak_bytes': int(peak)}


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, program=None,
            resize: dict | None = None) -> dict:
    """One run of cell ``name`` on ``device``: the result line's
    object.  Tests pass ``program`` (a stand-in for the system under
    test) and ``resize`` (``{'config': {...}, 'traffic': {...}}`` entries
    that replace the files' for a run small enough for the CPU)."""
    import torch
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell, cfg = load_cell(name)
    if resize:
        cfg.update(resize.get('config', {}))
        cell['traffic'].update(resize.get('traffic', {}))
    ref_mod = importlib.import_module(f'benchmark.reference.{cell["config"]}')
    driver = importlib.import_module(f'benchmark.drivers.{cell["driver"]}')
    with tempfile.TemporaryDirectory() as tmp:
        res = driver.run(cell, cfg, ref_mod, seed, seconds, trace, device,
                         t_start, program=program, tmpdir=tmp)
    metrics = {}
    if trace:
        ctx = res['layer_ctx']
        for m in cell_metrics(bench, name, 'per_layer'):
            value = load_module(HERE / 'metrics' / f'{m["name"]}.py').read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        res['e2e']['setup_s'] = res['setup_s']
        for m in cell_metrics(bench, name, 'end_to_end'):
            metrics[m['name']] = {'value': res['e2e'][m['name']],
                                  'unit': m['unit']}
    # a number that is not finite (no output, NaN) fails and prints null
    checks = {k: {'value': v if math.isfinite(v) else None, 'limit': lim}
              for k, (v, lim) in res['check'].items()}
    out = {'correct': res['failed'] == 0 and all(
               c['value'] is not None and c['value'] <= c['limit']
               for c in checks.values()),
           'attempted': res['attempted'], 'failed': res['failed'],
           'metrics': metrics,
           'device': device_info(torch, device, cell['chips'],
                                 res['memory_peak_bytes'])}
    if trace:
        from benchmark import trace as T
        tr = res['trace']
        out['device']['busy_s'] = T.busy_us(tr) / 1e6
        out['device']['window_s'] = tr.window_us / 1e6
        out['breakdown'] = T.breakdown(tr)
    if 'readings' in res:
        out['readings'] = {k: v if math.isfinite(v) else None
                           for k, v in res['readings'].items()}
    out['checks'] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('USE_JAX', '0')
    import torch
    cell, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device('cuda', 0))
    found = forbidden_modules()
    if found:
        print(f'loaded in this process: {", ".join(found)}', file=sys.stderr)
        return 3
    for k, c in out['checks'].items():
        print(f'check {k}: {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
