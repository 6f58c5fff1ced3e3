"""Card against CPU for the auxiliary models whose CUDA tests need a float64
referee: ``EResNet`` and ``ResNet101Features`` as
``tests/test_torch_cuda.py::test_aux_models_on_cuda_match_cpu`` builds them.

Needs CUDA; run from the repository root::

    python3 exsr_torch/scripts/aux_models_probe.py

It prints the card's name and power limit, whether ``EResNet`` builds at
``input_size`` 64 (its 8 x 8 pooling then leaves no features), and one
JSON line per model output: its largest distance card to CPU in fp32,
card and CPU each to the CPU's float64 run, and the card's float64 run to
the CPU's (the same function gives float64 rounding), each relative to
the largest output.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from exsr_torch.device import full_fp32  # noqa: E402
from exsr_torch.models.encoders import EResNet  # noqa: E402
from exsr_torch.models.perceptual import ResNet101Features  # noqa: E402


def gap(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print('aux_models_probe: CUDA is not available', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cuda = torch.device('cuda')
    try:
        EResNet(ndf=8, vae_like=True, input_size=64)
        built = 'built'
    except ZeroDivisionError as e:
        built = f'ZeroDivisionError: {e}'
    print(json.dumps({'model': 'eresnet', 'input_size': 64,
                      'result': built}), flush=True)
    rng = np.random.default_rng(5)

    def x(*shape):
        return torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
    cases = [('eresnet', EResNet(output_nc=8, ndf=8, vae_like=True,
                                 input_size=128), x(2, 128, 128, 3), {}),
             ('resnet101', ResNet101Features(), x(2, 64, 64, 3),
              {'train': True})]
    for name, module, inp, kw in cases:
        runs = {}
        for where, dtype in (('cpu', torch.float32), ('cuda', torch.float32),
                             ('cpu64', torch.float64),
                             ('cuda64', torch.float64)):
            dev = cuda if where.startswith('cuda') else torch.device('cpu')
            m = copy.deepcopy(module).to(dev, dtype)
            with torch.no_grad(), full_fp32():
                out = m(inp.to(dev, dtype), **kw)
            runs[where] = out if isinstance(out, tuple) else (out,)
        for n in range(len(runs['cpu'])):
            r = {k: v[n] for k, v in runs.items()}
            print(json.dumps({
                'model': name, 'output': n, 'shape': list(r['cpu'].shape),
                'card_vs_cpu': gap(r['cuda'], r['cpu']),
                'card_vs_float64': gap(r['cuda'], r['cpu64']),
                'cpu_vs_float64': gap(r['cpu'], r['cpu64']),
                'card_float64_vs_cpu_float64': gap(r['cuda64'],
                                                   r['cpu64'])}),
                flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
