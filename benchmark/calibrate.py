"""Readings that a cell's limits are set from, on the card, in one
process.

    python3 -m benchmark.calibrate --workload <cell> [--seeds <n> ...] \\
        [--fault <name>] [--control-seeds <n> ...] [--seconds 3]

For each of ``--seeds`` it runs the cell as ``benchmark.run`` does, with
a short window, and prints the numbers compared in that run (the lower
readings are the largest over the seeds); with ``--fault`` the program
has that fault planted (``benchmark.faults``).  For each of
``--control-seeds`` it puts the reference at the control's precision
(``check.control`` in the cell's file: ``tf32`` below float32, ``fp8``
below bfloat16) in the program's place and prints the same numbers
against the float32 reference (the upper readings are the smallest).
One JSON line a reading.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from benchmark import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--fault', default=None)
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--seconds', type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device('cuda', 0)
    cell, cfg = run.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        program = (faults.PROGRAMS[cell['driver']](args.fault)
                   if args.fault else None)
        out = run.execute(args.workload, seed, args.seconds, False, device,
                          t_start=t0, program=program)
        print(json.dumps({'workload': args.workload, 'side': 'program',
                          'fault': args.fault, 'seed': seed,
                          'correct': out['correct'],
                          'attempted': out['attempted'],
                          'metrics': out['metrics'],
                          'readings': out.get('readings'),
                          'checks': out['checks'],
                          'seconds': time.perf_counter() - t0}), flush=True)
    ref_mod = importlib.import_module(f'benchmark.reference.{cfg["name"]}')
    driver = importlib.import_module(f'benchmark.drivers.{cell["driver"]}')
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        reading = driver.control_reading(cell, cfg, ref_mod, seed, device)
        print(json.dumps({'workload': args.workload, 'side': 'control',
                          'seed': seed, **reading,
                          'seconds': time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
