"""Reference-style option files: ``//``-commented JSON, the variant
sub-dicts (``PhaseInit``/``PhaseGAN``, ``ModelY``/``ModelChroma``), missing
keys read as None (:class:`NoneDict`), derived experiment paths, and resume
from the saved options with a diff report.

The port's own copy of ``exsr/options/config.py``: the parser behind
``--opt`` and the typed layer over it (:class:`ExperimentConfig` with its
generator, discriminator and dataset configs, and the port's
:class:`~exsr_torch.train.srragan.TrainConfig`), which
:func:`experiment_from_reference_json` fills from parsed options.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict
from typing import Any

from exsr_torch.losses.filter_loss import num_latent_channels  # noqa: F401
from exsr_torch.train.srragan import TrainConfig


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


# --------------------------------------------------------------- typed layer
@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    which_model: str = 'RRDB_net'
    cem_arch: bool = True
    sigmoid_range_limit: bool = False
    latent_input: str | None = 'all_layers'
    latent_input_domain: str = 'HR_downscaled'
    latent_channels: str | int = 'SVDinNormedOut_structure_tensor'
    nf: int = 64
    nb: int = 23
    gc: int = 32
    in_nc: int = 3
    out_nc: int = 3


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    which_model: str = 'discriminator_vgg_128'
    relativistic: bool = False
    decomposed_input: bool = False
    pre_clipping: bool = False
    add_quantization_noise: bool = False
    norm_type: str | None = 'batch'
    n_layers: int = 10
    nf: int = 64
    in_nc: int = 3
    num_2_strides: int = 5


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    mode: str = 'LRHR'
    dataroot_hr: str | None = None
    dataroot_lr: str | None = None
    patch_size: int = 208
    batch_size: int = 16
    use_flip: bool = True
    use_rot: bool = True
    n_workers: int = 4


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = 'experiment'
    scale: int = 4
    root: str = '.'
    network_g: GeneratorConfig = GeneratorConfig()
    network_d: DiscriminatorConfig = DiscriminatorConfig()
    train_data: DatasetConfig = DatasetConfig()
    val_data: DatasetConfig | None = None
    train: TrainConfig = TrainConfig()


def experiment_from_reference_json(opt) -> ExperimentConfig:
    """Parsed reference options (:func:`parse`) as the typed config;
    absent keys take ``exsr``'s defaults."""
    g = opt['network_G']
    d = opt.get('network_D') or {}
    t = opt.get('train') or {}
    tr_ds = (opt.get('datasets') or {}).get('train') or {}

    def val(x, default):
        return default if x is None else x

    net_g = GeneratorConfig(
        which_model=val(g['which_model_G'], 'RRDB_net'),
        # older option files name the CEM flag DTE_arch
        cem_arch=bool(val(g['CEM_arch'], val(g['DTE_arch'], 1))),
        sigmoid_range_limit=bool(val(g['sigmoid_range_limit'], 0)),
        latent_input=g['latent_input'],
        latent_input_domain=val(g['latent_input_domain'], 'HR_downscaled'),
        latent_channels=val(g['latent_channels'], 0),
        nf=val(g['nf'], 64), nb=val(g['nb'], 23), gc=val(g['gc'], 32),
        in_nc=val(g['in_nc'], 3), out_nc=val(g['out_nc'], 3))
    net_d = DiscriminatorConfig(
        which_model=val(d.get('which_model_D'), 'discriminator_vgg_128'),
        relativistic=bool(val(d.get('relativistic'), 0)),
        decomposed_input=bool(val(d.get('decomposed_input'), 0)),
        pre_clipping=bool(val(d.get('pre_clipping'), 0)),
        add_quantization_noise=bool(val(d.get('add_quantization_noise'),
                                        0)),
        norm_type=d.get('norm_type', 'batch'),
        n_layers=val(d.get('n_layers'), 10), nf=val(d.get('nf'), 64),
        in_nc=val(d.get('in_nc'), 3),
        num_2_strides=val(d.get('num_2_strides'), 5))
    train_cfg = TrainConfig(
        scale=opt['scale'],
        patch_size=val(tr_ds.get('patch_size'), 208),
        lr_g=val(t.get('lr_G'), 1e-5), lr_d=val(t.get('lr_D'), 1e-5),
        beta1_g=val(t.get('beta1_G'), 0.9),
        beta1_d=val(t.get('beta1_D'), 0.9),
        lr_steps=tuple(val(t.get('lr_steps'), ())),
        lr_gamma=val(t.get('lr_gamma'), 0.5),
        gan_type=val(t.get('gan_type'), 'wgan-gp'),
        gan_weight=val(t.get('gan_weight'), 1.0),
        gp_weight=val(t.get('gp_weight'), 10.0),
        range_weight=t.get('range_weight'),
        latent_weight=t.get('latent_weight'),
        pixel_weight=t.get('pixel_weight'),
        feature_weight=t.get('feature_weight'),
        optimal_z_weight=t.get('optimalZ_loss_weight'),
        latent_channels=val(g['latent_channels'], 0),
        relativistic=bool(val(d.get('relativistic'), 0)),
        add_quantization_noise=bool(val(d.get('add_quantization_noise'),
                                        0)),
        hinge_threshold=t.get('hinge_threshold'),
        d_update_ratio=val(t.get('D_update_ratio'), 1),
        d_valid_steps_4_g_update=val(t.get('D_valid_Steps_4_G_update'), 0),
        min_d_prob_ratio_4_g=val(t.get('min_D_prob_ratio_4_G'), 1.0),
        min_mean_d_correct=val(t.get('min_mean_D_correct'), 0.0),
        d_init_iters=val(t.get('D_init_iters'), 0),
        steps_4_loss_std=val(t.get('steps_4_loss_std'), 500),
        std_4_lr_drop=t.get('std_4_lr_drop'),
        niter=val(t.get('niter'), 510_000),
        grad_accum_g=val(t.get('grad_accumulation_steps_G'), 1),
        grad_accum_d=val(t.get('grad_accumulation_steps_D'), 1))
    return ExperimentConfig(
        name=opt['name'], scale=opt['scale'],
        root=val((opt.get('path') or {}).get('root'), '.'),
        network_g=net_g, network_d=net_d,
        train_data=DatasetConfig(
            mode=val(tr_ds.get('mode'), 'LRHR'),
            dataroot_hr=tr_ds.get('dataroot_HR'),
            dataroot_lr=tr_ds.get('dataroot_LR'),
            patch_size=val(tr_ds.get('patch_size'), 208),
            batch_size=val(tr_ds.get('batch_size_4_grads_G',
                                     tr_ds.get('batch_size')), 16),
            use_flip=bool(val(tr_ds.get('use_flip'), 1)),
            use_rot=bool(val(tr_ds.get('use_rot'), 1)),
            n_workers=val(tr_ds.get('n_workers'), 4)),
        train=train_cfg)
