"""Weight bridges from ``exsr``'s parameters to the port's modules: the
RRDBNet (:func:`from_exsr_params`), ``MSRResNet``, ``SRResNet``,
``VGG19Features`` and ``MINCNet`` (:func:`from_exsr_flat_params`), the
critics (:func:`d_from_exsr_vars`: the SR trainer's two and the three
fixed-size ones), the explorable-JPEG DnCNN generator and discriminator
(:func:`dncnn_from_exsr_vars`, :func:`dncnn_d_from_exsr_vars`),
KernelGAN's generator and critic (:func:`kernelgan_g_from_exsr_vars`,
:func:`kernelgan_d_from_exsr_vars`), the SVHN digit classifier
(:func:`svhn_from_exsr_vars`), and ``SFTNet``, ``SegNet``, ``EResNet``
and ``ResNet101Features`` (:func:`sft_from_exsr_vars`,
:func:`segnet_from_exsr_vars`, :func:`eresnet_from_exsr_vars`,
:func:`resnet101_from_exsr_vars`).  All but the RRDBNet's go through
:func:`_flax_state`, which maps a flax variable tree onto the port's
module names.

The reference's own torch checkpoints (``.pth``) convert straight to the
port's state dicts: :func:`load_torch_checkpoint` reads one,
:func:`convert_esrgan_rrdb` maps a plain ESRGAN or a trained explorable
RRDB generator onto :class:`~exsr_torch.models.rrdb.RRDBNet` (zero Z input
channels prepended to every conv that takes Z when the checkpoint has
none), :func:`convert_msrresnet` maps an ``MSRResNet``, and
:func:`align_params_to` checks a converted state dict against a module
and loads it.

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

import re

import numpy as np
import torch


def _conv(entry, index=None) -> dict:
    kernel, bias = np.asarray(entry['kernel']), np.asarray(entry['bias'])
    if index is not None:
        kernel, bias = kernel[index], bias[index]
    return {'weight': torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1))),
            'bias': torch.from_numpy(np.array(bias))}


def _flax_state(variables, rename=lambda path: path) -> dict:
    """A state dict from a flax variable tree whose module paths name the
    port's modules after ``rename`` (a function of the dotted path): a
    module holding ``kernel`` is a conv (HWIO -> OIHW) or a dense layer
    (``[in, out]`` -> ``[out, in]``), one holding ``scale`` a batch norm;
    ``batch_stats`` give its running statistics and ``spectral`` a
    spectral-norm conv's ``u``."""
    out = {}

    def walk(tree, path, collection):
        leaf = {'kernel', 'scale', 'mean', 'u'} & set(tree)
        if not leaf:
            for k, v in tree.items():
                walk(v, path + [k], collection)
            return
        name = rename('.'.join(path))
        if collection == 'batch_stats':
            part = {'running_mean': tree['mean'], 'running_var': tree['var']}
        elif collection == 'spectral':
            part = {'u': tree['u']}
        elif 'kernel' in tree:
            k = np.asarray(tree['kernel'])
            part = {'weight': k.transpose(3, 2, 0, 1) if k.ndim == 4
                    else k.T}
            if 'bias' in tree:
                part['bias'] = tree['bias']
        else:
            part = {'weight': tree['scale'], 'bias': tree['bias']}
        out.update({f'{name}.{k}': torch.from_numpy(np.array(v))
                    for k, v in part.items()})

    for collection in ('params', 'batch_stats', 'spectral'):
        walk(variables.get(collection) or {}, [], collection)
    return out


def _renamer(*rules):
    """``rename`` for :func:`_flax_state`: ``re.sub`` of each ``(pattern,
    replacement)`` in turn."""
    def rename(path):
        for pattern, repl in rules:
            path = re.sub(pattern, repl, path)
        return path
    return rename


_CONV_BLOCK = (r'\bConv_0\b', 'conv'), (r'\bBatchNorm_0\b', 'bn')


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
    (``MSRResNet``, ``SRResNet``, ``VGG19Features``, ``MINCNet``,
    ``KGGenerator``; numpy tree) -> the state dict of the port's module
    of the same name."""
    return _flax_state({'params': tree['params'] if 'params' in tree
                        else tree})


def d_from_exsr_vars(d_vars) -> dict:
    """``exsr``'s discriminator variables (``params`` and ``batch_stats``
    or ``spectral``, numpy trees) -> the state dict of the port's critic
    of the same name: ``DiscriminatorVGG128``, ``PatchGANDiscriminator``,
    ``DiscriminatorVGG``, ``DiscriminatorVGG128SN`` or ``ACDVGGBN96``
    (``ConvBlock``s hold ``Conv_0`` and ``BatchNorm_0``, ``Dense_0`` /
    ``Dense_1`` are ``fc0`` / ``fc1``, every other module keeps its
    name)."""
    return _flax_state(d_vars, _renamer(*_CONV_BLOCK,
                                        (r'^Dense_(\d)$', r'fc\1')))


_DNCNN = (r'^BatchNorm_(\d+)$', r'bns.\1'), (r'^Dense_0$', 'fc')


def dncnn_from_exsr_vars(variables) -> dict:
    """``exsr``'s DnCNN generator variables (``{'params'[,
    'batch_stats']}``, numpy trees) -> the state dict of
    :class:`exsr_torch.models.dncnn.DnCNN`: ``conv{i}`` (with or without
    a bias), ``BatchNorm_{j}`` as ``bns.{j}`` with its running
    statistics."""
    return _flax_state(variables, _renamer(*_DNCNN))


def dncnn_d_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``DnCNNDiscriminator`` variables (``params``, and
    ``batch_stats`` and ``spectral`` where it has them) -> the state dict
    of :class:`exsr_torch.models.dncnn.DnCNNDiscriminator`: the FC head's
    ``Dense_0`` and spectral norm's ``u`` vectors besides the convs."""
    return _flax_state(variables, _renamer(*_DNCNN))


def kernelgan_g_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``KGGenerator`` variables (numpy tree) -> the state dict
    of :class:`exsr_torch.kernelgan.kernelgan.KGGenerator`."""
    return from_exsr_flat_params(variables)


def kernelgan_d_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``KGDiscriminator`` variables (``params``, ``spectral``
    and ``batch_stats``, numpy trees) -> the state dict of
    :class:`exsr_torch.kernelgan.kernelgan.KGDiscriminator`: each
    spectral-norm conv's weight, bias and ``u``, each batch norm's scale,
    bias and running statistics."""
    return _flax_state(variables)


def svhn_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``SVHNClassifier`` variables (``params`` and
    ``batch_stats``, numpy trees) -> the state dict of
    :class:`exsr_torch.models.classifiers.SVHNClassifier`."""
    return _flax_state(variables)


def sft_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``SFTNet`` variables (numpy tree) -> the state dict of
    :class:`exsr_torch.models.sft.SFTNet`: the scanned blocks' stacked
    ``[n_blocks]`` parameters split into ``blocks.<i>``."""
    p = dict(variables['params'] if 'params' in variables else variables)
    stacked = p.pop('sft_blocks')['block']
    n = np.asarray(stacked['conv0']['kernel']).shape[0]

    def take(tree, i):
        return ({k: take(v, i) for k, v in tree.items()}
                if isinstance(tree, dict) else np.asarray(tree)[i])
    p['blocks'] = {str(i): take(stacked, i) for i in range(n)}
    return _flax_state({'params': p})


def segnet_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``SegNet`` variables (``params``, ``batch_stats``) -> the
    state dict of :class:`exsr_torch.models.encoders.SegNet`."""
    return _flax_state(variables, _renamer(
        (r'ConvBNRelu_(\d+)', r'layers.\1'), *_CONV_BLOCK))


def eresnet_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``EResNet`` variables -> the state dict of
    :class:`exsr_torch.models.encoders.EResNet`."""
    return _flax_state(variables, _renamer(
        (r'^Conv_0$', 'stem'), (r'BasicBlock_(\d+)', r'blocks.\1'),
        (r'Conv_0$', 'conv0'), (r'Conv_1$', 'conv1'),
        (r'Conv_2$', 'shortcut'), (r'^fcVar$', 'fc_var')))


def resnet101_from_exsr_vars(variables) -> dict:
    """``exsr``'s ``ResNet101Features`` variables (``params``,
    ``batch_stats``) -> the state dict of
    :class:`exsr_torch.models.perceptual.ResNet101Features`."""
    return _flax_state(variables, _renamer(
        (r'^Conv_0$', 'conv1'), (r'^BatchNorm_0$', 'bn1'),
        (r'BottleneckBlock_(\d+)', r'blocks.\1'),
        (r'Conv_3$', 'proj'), (r'BatchNorm_3$', 'proj_bn'),
        (r'Conv_(\d)$', r'conv\1'), (r'BatchNorm_(\d)$', r'bn\1')))


# ----------------------------------------------- the reference's .pth files
def load_torch_checkpoint(path: str) -> dict:
    """A reference ``.pth`` state dict on the CPU, unwrapped: a
    ``'state_dict'`` entry, the ``module.`` (DataParallel) and
    ``generated_image_model.`` (CEM wrapper) prefixes; the CEM's frozen
    ``Filter_OP`` weights are dropped (the port builds them
    analytically).  Read with ``weights_only=True``: tensors and plain
    containers only."""
    raw = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'state_dict' in raw:
        raw = raw['state_dict']
    out = {}
    for k, v in raw.items():
        k = re.sub(r'^module\.', '', k)
        k = re.sub(r'^generated_image_model\.', '', k)
        if 'Filter_OP' not in k:
            out[k] = v
    return out


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def convert_esrgan_rrdb(state: dict, nb: int = 23,
                        latent_channels: int = 3) -> dict:
    """A torch ESRGAN-layout RRDB state dict -> the state dict of the
    port's :class:`~exsr_torch.models.rrdb.RRDBNet` with
    ``latent_channels`` Z channels.

    Keys: ``model.0`` (``fea_conv``), ``model.1.sub.{i}.RDB{r}.conv{c}.0``
    (trunk block ``i``), ``model.1.sub.{nb}`` (``trunk_conv``),
    ``model.3`` / ``model.6`` (``upconv0`` / ``upconv1``), ``model.8`` /
    ``model.10`` (``hr_conv0`` / ``hr_conv1``).  The widths ``nf`` and
    ``gc`` are read off the checkpoint, so each conv's input width without
    Z is known exactly.  A conv of that width (plain ESRGAN) gets
    ``latent_channels`` zero input channels prepended, the Z of the
    port's ``cat([z, x])``; a conv that already has them (a trained
    explorable checkpoint) is kept; any other width raises ``ValueError``.
    The upconvs take no Z."""
    nz = latent_channels
    nf = int(_array(state['model.0.weight']).shape[0])
    gc = int(_array(state['model.1.sub.0.RDB1.conv1.0.weight']).shape[0])
    out = {}

    def conv(name, key, z, expect_in):
        w = _array(state[f'{key}.weight'])
        if z:
            if w.shape[1] == expect_in:
                w = np.concatenate([np.zeros((w.shape[0], z) + w.shape[2:],
                                             w.dtype), w], axis=1)
            elif w.shape[1] != expect_in + z:
                raise ValueError(
                    f'{key}.weight: input width {w.shape[1]} matches '
                    f'neither the no-z width {expect_in} nor the explorable '
                    f'width {expect_in + z} (nz={z})')
        out[f'{name}.weight'] = torch.from_numpy(np.array(w))
        if f'{key}.bias' in state:
            out[f'{name}.bias'] = torch.from_numpy(np.array(
                _array(state[f'{key}.bias'])))

    conv('fea_conv', 'model.0', nz, 3)
    for i in range(nb):
        for r in (1, 2, 3):
            for c in range(5):
                conv(f'trunk.{i}.rdb{r}.conv{c}',
                     f'model.1.sub.{i}.RDB{r}.conv{c + 1}.0', nz, nf + gc * c)
    conv('trunk_conv', f'model.1.sub.{nb}', nz, nf)
    conv('upconv0', 'model.3', 0, nf)
    conv('upconv1', 'model.6', 0, nf)
    conv('hr_conv0', 'model.8', nz, nf)
    conv('hr_conv1', 'model.10', nz, nf)
    return out


def convert_msrresnet(state: dict, nf: int = 64, nb: int = 16,
                      upscale: int = 4) -> dict:
    """A torch ``MSRResNet`` state dict (``conv_first``,
    ``recon_trunk.<i>.conv1|2``, ``upconv<k>``, ``HRconv``, ``conv_last``)
    -> the state dict of the port's
    :class:`~exsr_torch.models.classifiers.MSRResNet`.

    Torch's ``PixelShuffle`` reads output channel ``c * f * f + a * f + b``
    for sub-pixel ``(a, b)``; the port's ``pixel_shuffle_nhwc`` reads
    ``(a * f + b) * C + c``, ``exsr``'s order.  So each upconv's output
    channels (weight and bias) are permuted as ``exsr`` permutes them."""
    state = {k.replace('module.', ''): v for k, v in state.items()}
    out = {}

    def conv(name, key, index=None):
        w, b = _array(state[f'{key}.weight']), _array(state[f'{key}.bias'])
        if index is not None:
            w, b = w[index], b[index]
        out[f'{name}.weight'] = torch.from_numpy(np.array(w))
        out[f'{name}.bias'] = torch.from_numpy(np.array(b))

    conv('conv_first', 'conv_first')
    for i in range(nb):
        conv(f'rb{i}_conv1', f'recon_trunk.{i}.conv1')
        conv(f'rb{i}_conv2', f'recon_trunk.{i}.conv2')
    n_up = 1 if upscale == 3 else int(np.log2(upscale))
    f = 3 if upscale == 3 else 2
    for u in range(n_up):
        o = _array(state[f'upconv{u + 1}.weight']).shape[0]
        # port slot a*f*C + b*C + ch holds torch channel ch*f*f + a*f + b
        idx = np.arange(o).reshape(o // (f * f), f, f).transpose(1, 2, 0) \
            .reshape(-1)
        conv(f'upconv{u + 1}', f'upconv{u + 1}', idx)
    conv('HRconv', 'HRconv')
    conv('conv_last', 'conv_last')
    return out


def align_params_to(module: torch.nn.Module, converted: dict
                    ) -> torch.nn.Module:
    """Load a converted state dict into ``module`` after checking it: each
    tensor takes the dtype of the module's entry of the same name, and a
    shape that differs raises ``ValueError`` naming the key and both
    shapes; then ``load_state_dict(strict=True)``, which names missing and
    unexpected keys.  Returns ``module``."""
    template = module.state_dict()
    cast = {}
    for k, v in converted.items():
        v = torch.as_tensor(v)
        if k in template:
            if tuple(v.shape) != tuple(template[k].shape):
                raise ValueError(
                    f'shape mismatch at {k}: module {tuple(template[k].shape)}'
                    f' vs converted {tuple(v.shape)}')
            v = v.to(template[k].dtype)
        cast[k] = v
    module.load_state_dict(cast, strict=True)
    return module
