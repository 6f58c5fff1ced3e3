"""Reference-style option files: ``//``-commented JSON, the variant
sub-dicts (``PhaseInit``/``PhaseGAN``, ``ModelY``/``ModelChroma``), missing
keys read as None (:class:`NoneDict`), derived experiment paths, and resume
from the saved options with a diff report.

The port's own copy of ``exsr/options/config.py:31-199`` (the parser behind
``--opt``) and of ``num_latent_channels``
(``exsr/losses/filter_loss.py:80-89``).  ``exsr``'s typed training
dataclasses are not ported yet.
"""
from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Any


class NoneDict(dict):
    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def load_commented_json(path: str) -> OrderedDict:
    text = []
    with open(path) as f:
        for line in f:
            text.append(line.split('//')[0])
    return json.loads('\n'.join(text), object_pairs_hook=OrderedDict)


def collapse_variant(d, chosen: str):
    """Collapse {'PhaseInit': ..., 'PhaseGAN': ...}-style sub-dicts by
    picking ``chosen`` (options.py:46-54)."""
    while isinstance(d, dict) and chosen in d:
        d = d[chosen]
        if d == 'None':
            return None
    if isinstance(d, dict):
        for k, v in d.items():
            d[k] = collapse_variant(v, chosen)
    return d


def diff_report(old: Any, new: Any, prefix: str = '') -> list[str]:
    lines = []
    if isinstance(old, dict) and isinstance(new, dict):
        for k in sorted(set(old) | set(new)):
            lines += diff_report(old.get(k), new.get(k), f'{prefix}.{k}')
    elif old != new:
        lines.append(f'{prefix}: {old!r} -> {new!r}')
    return lines


def parse(opt_path: str, is_train: bool = True, name: str | None = None,
          jpeg: bool = False, chroma: bool = False,
          initialization: bool = False,
          batch_size_multiplier: int | None = None) -> NoneDict:
    """Reference-compatible option parsing (options.py:21-172)."""
    opt = _parse_conf(opt_path, is_train, name, jpeg, chroma,
                      initialization, batch_size_multiplier)
    if is_train and opt['train'].get('resume'):
        saved_path = os.path.join(opt['path']['experiments_root'],
                                  'options.json')
        if os.path.isfile(saved_path):
            saved = _parse_conf(saved_path, is_train, name, jpeg, chroma,
                                initialization, batch_size_multiplier)
            for keys in (('train', 'resume'),
                         ('datasets', 'train', 'n_workers')):
                cur, sav = opt, saved
                for k in keys[:-1]:
                    cur, sav = cur.get(k, {}), sav.get(k, {})
                if keys[-1] in cur:
                    sav[keys[-1]] = cur[keys[-1]]
            changes = diff_report(opt, saved)
            if changes:
                print('Using saved configuration values that differ from '
                      'the current ones:')
                for line in changes[:40]:
                    print(' ', line)
            return dict_to_nonedict(saved)
    return dict_to_nonedict(opt)


def _parse_conf(opt_path, is_train, name, jpeg, chroma, initialization,
                batch_size_multiplier):
    opt = load_commented_json(opt_path)
    opt = collapse_variant(opt, 'PhaseInit' if initialization
                           else 'PhaseGAN')
    if jpeg:
        opt = collapse_variant(opt, 'ModelChroma' if chroma else 'ModelY')
        opt['input_downsampling'] = 2 if chroma else 1
        if chroma:
            for ds in opt['datasets'].values():
                if not ds['mode'].endswith('_chroma'):
                    ds['mode'] += '_chroma'
                ds['input_downsampling'] = 2
            tail = opt['name'].split('/')[-1]
            if not tail.startswith('chroma_'):
                opt['name'] = os.path.join(
                    '/'.join(opt['name'].split('/')[:-1]), 'chroma_' + tail)
        if not opt['name'].startswith('JPEG/'):
            opt['name'] = os.path.join('JPEG', opt['name'])
        opt['scale'] = 8 * opt['input_downsampling']
        opt['network_G'].setdefault('residual', 1)
    scale = opt['scale']
    opt['is_train'] = is_train
    if 'datasets' in opt:
        root = opt['path'].get('datasets', opt['path'].get('root', '.'))
        img_key = 'dataroot_Uncomp' if jpeg else 'dataroot_HR'
        for phase, ds in opt['datasets'].items():
            ds['phase'] = phase.split('_')[0]
            ds['scale'] = scale
            for k in (img_key, 'dataroot_LR'):
                if ds.get(k):
                    ds[k] = os.path.expanduser(os.path.join(root, ds[k]))
            ds['data_type'] = 'lmdb' if any(
                str(ds.get(k, '')).endswith('lmdb')
                for k in (img_key, 'dataroot_LR')) else 'img'
    for k, p in list(opt['path'].items()):
        if p:
            opt['path'][k] = os.path.expanduser(p)
    if name is not None and not jpeg:
        opt['name'] = name
    exp_root = os.path.join(opt['path'].get('root', '.'), 'experiments',
                            opt['name'])
    opt['path']['experiments_root'] = exp_root
    opt['path']['models'] = os.path.join(exp_root, 'models')
    opt['path']['log'] = exp_root
    opt['network_G'].setdefault('latent_input', 'None')
    if opt['network_G']['latent_input'] == 'None':
        opt['network_G']['latent_channels'] = 0
    opt['network_G'].setdefault('padding', 1)
    if is_train:
        opt['path']['val_images'] = os.path.join(exp_root, 'val_images')
        tr_ds = opt['datasets']['train']
        tr_ds.setdefault('batch_size_per_GPU', tr_ds.get('batch_size', 1))
        tr_ds['batch_size'] = tr_ds['batch_size_per_GPU']
        if batch_size_multiplier:
            tr_ds['batch_size'] *= batch_size_multiplier
            tr_ds['n_workers'] = tr_ds.get('n_workers', 2) \
                * batch_size_multiplier
        tr_ds.setdefault('batch_size_4_grads_G', tr_ds['batch_size'])
        tr_ds.setdefault('batch_size_4_grads_D', tr_ds['batch_size'])
        while (tr_ds['batch_size_4_grads_G'] % tr_ds['batch_size'] != 0
               or tr_ds['batch_size_4_grads_D'] % tr_ds['batch_size'] != 0):
            tr_ds['batch_size'] -= 1
        assert tr_ds['batch_size'] > 0, 'batch size must be > 0'
        assert tr_ds['batch_size_4_grads_D'] >= \
            tr_ds['batch_size_4_grads_G'], 'G batch > D batch unsupported'
        opt['train']['grad_accumulation_steps_G'] = \
            tr_ds['batch_size_4_grads_G'] // tr_ds['batch_size']
        opt['train']['grad_accumulation_steps_D'] = \
            tr_ds['batch_size_4_grads_D'] // tr_ds['batch_size']
        if 'network_D' in opt:
            if opt['network_D'].get('which_model_D') == 'PatchGAN':
                assert opt['train']['gan_type'] in (
                    'lsgan', 'wgan-gp', 'wgan-sn', 'wgan-sngp')
            else:
                assert opt['train'].get('gan_type') != 'lsgan', \
                    'lsgan requires the Patch discriminator'
    else:
        opt['path']['results_root'] = os.path.join(
            opt['path'].get('root', '.'), 'results', opt['name'])
    opt['network_G']['scale'] = scale
    return opt


def save(opt, path: str | None = None) -> None:
    """Dump the resolved options next to the experiment
    (options.py:174-178)."""
    if path is None:
        root = opt['path']['experiments_root'] if opt['is_train'] \
            else opt['path']['results_root']
        path = os.path.join(root, 'options.json')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(opt, f, indent=2, default=str)


def num_latent_channels(latent_channels: str | int) -> int:
    """The latent channels a ``latent_channels`` option names: an int as
    it is, ``'STD_1dir'`` 2, else the first digits in the string, or 3."""
    if isinstance(latent_channels, int):
        return latent_channels
    if latent_channels == 'STD_1dir':
        return 2
    m = re.search(r'(\d)+', latent_channels)
    return int(m.group(0)) if m else 3
