"""Weight bridges from ``exsr``'s parameters to the port's modules: the
RRDBNet (:func:`from_exsr_params`), ``MSRResNet``, ``SRResNet`` and
``VGG19Features`` (:func:`from_exsr_flat_params`), and the two
discriminators of the SR trainer (:func:`d_from_exsr_vars`).

The caller hands over ``exsr``'s params as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``, or
:func:`exsr_torch.train.checkpoints.load_exsr_npz`), so the port never
sees JAX.  Conv kernels go from HWIO to OIHW, and the trunk scan's stacked
``[nb]`` axis is split per block (``tests/test_torch_parity.py:257-280``
has the same mapping in reverse).  Names: ``fea_conv`` and ``upconv{i}``
hold ``kernel``/``bias`` directly, while ``trunk_conv`` and
``hr_conv{0,1}`` nest them under ``Conv_0``.  The plain generators and
VGG name every conv at the top level of their tree, as the port's modules
do.  The discriminators' ``Dense`` kernels go from ``[in, out]`` to
``[out, in]``; the FC head flattens NHWC features on both sides, so its
rows keep their order.
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



def from_exsr_flat_params(tree) -> dict:
    """``exsr`` params whose convs all sit at the top level of the tree
    (``MSRResNet``, ``SRResNet``, ``VGG19Features``; numpy tree) -> the
    state dict of the port's module of the same name."""
    p = tree['params'] if 'params' in tree else tree
    return {f'{name}.{k}': v for name in p
            for k, v in _conv(p[name]).items()}


def _dense(entry) -> dict:
    return {'weight': torch.from_numpy(np.array(
                np.asarray(entry['kernel']).T)),
            'bias': torch.from_numpy(np.array(entry['bias']))}


def _batch_norm(params, stats) -> dict:
    out = {'weight': params['scale'], 'bias': params['bias']}
    if stats is not None:
        out.update(running_mean=stats['mean'], running_var=stats['var'])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def d_from_exsr_vars(d_vars) -> dict:
    """``exsr``'s discriminator variables (``{'params', 'batch_stats'}``,
    numpy trees) -> the state dict of the port's
    :class:`~exsr_torch.models.discriminators.DiscriminatorVGG128` or
    :class:`~exsr_torch.models.discriminators.PatchGANDiscriminator`,
    whichever the tree's names say (``ConvBlock``s hold ``Conv_0`` and
    ``BatchNorm_0``; the PatchGAN's convs hold their kernels directly)."""
    p = d_vars['params']
    stats = d_vars.get('batch_stats') or {}
    out = {}
    for name, entry in p.items():
        if name.startswith('Dense_'):
            mod = {'Dense_0': 'fc0', 'Dense_1': 'fc1'}[name]
            out.update({f'{mod}.{k}': v for k, v in _dense(entry).items()})
        elif 'Conv_0' in entry:
            out.update({f'{name}.conv.{k}': v
                        for k, v in _conv(entry['Conv_0']).items()})
            if 'BatchNorm_0' in entry:
                bn = _batch_norm(entry['BatchNorm_0'], (stats.get(name) or
                                 {}).get('BatchNorm_0'))
                out.update({f'{name}.bn.{k}': v for k, v in bn.items()})
        else:
            out.update({f'{name}.{k}': v for k, v in _conv(entry).items()})
    return out
