"""Weight bridge from ``exsr``'s RRDBNet parameters to the port's RRDBNet.

The caller hands over ``exsr``'s params as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port never sees JAX.  Conv
kernels go from HWIO to OIHW, and the trunk scan's stacked ``[nb]`` axis is
split per block (``tests/test_torch_parity.py:257-280`` has the same mapping
in reverse).  Names: ``fea_conv`` and ``upconv{i}`` hold ``kernel``/``bias``
directly, while ``trunk_conv`` and ``hr_conv{0,1}`` nest them under
``Conv_0``.
"""
from __future__ import annotations

import numpy as np
import torch


def _conv(entry, index=None) -> dict:
    kernel, bias = np.asarray(entry['kernel']), np.asarray(entry['bias'])
    if index is not None:
        kernel, bias = kernel[index], bias[index]
    return {'weight': torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1))),
            'bias': torch.from_numpy(np.array(bias))}


def from_exsr_params(tree) -> dict:
    """``exsr`` RRDBNet params (numpy tree) -> the port's state dict."""
    p = tree['params'] if 'params' in tree else tree
    convs = {'fea_conv': _conv(p['fea_conv']),
             'trunk_conv': _conv(p['trunk_conv']['Conv_0']),
             'hr_conv0': _conv(p['hr_conv0']['Conv_0']),
             'hr_conv1': _conv(p['hr_conv1']['Conv_0'])}
    for name in p:
        if name.startswith('upconv'):
            convs[name] = _conv(p[name])
    stacked = p['trunk']['RRDB_0']
    nb = np.asarray(stacked['rdb1']['conv0']['Conv_0']['kernel']).shape[0]
    for i in range(nb):
        for r in (1, 2, 3):
            for c in range(5):
                convs[f'trunk.{i}.rdb{r}.conv{c}'] = _conv(
                    stacked[f'rdb{r}'][f'conv{c}']['Conv_0'], i)
    return {f'{name}.{k}': v for name, entry in convs.items()
            for k, v in entry.items()}
