"""The port's converters of the reference's torch checkpoints and its SVHN
classifier, held to exsr's on the same seeded state dicts.

Forwards of the converted generators agree within 1e-5 (absolute, fp32,
outputs of order 1); SVHN logits within 1e-5 and their input gradient
within 1e-4 of its largest element."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.models import convert as xconv
from exsr_torch.models import convert as tconv


def _rrdb_state(seed, nf, nb, gc, nz_in, std=0.05):
    """A seeded torch ESRGAN-layout RRDB state dict whose Z-taking convs
    have ``nz_in`` extra input channels in front (0: plain ESRGAN)."""
    rng = np.random.default_rng(seed)
    state = {}

    def add(key, cin, cout):
        state[f'{key}.weight'] = torch.from_numpy(rng.normal(
            0, std, size=(cout, cin, 3, 3)).astype(np.float32))
        state[f'{key}.bias'] = torch.from_numpy(rng.normal(
            0, 0.01, size=(cout,)).astype(np.float32))

    add('model.0', 3 + nz_in, nf)
    for i in range(nb):
        for r in (1, 2, 3):
            for c in range(5):
                add(f'model.1.sub.{i}.RDB{r}.conv{c + 1}.0',
                    nf + c * gc + nz_in, gc if c < 4 else nf)
    add(f'model.1.sub.{nb}', nf + nz_in, nf)
    add('model.3', nf, nf)
    add('model.6', nf, nf)
    add('model.8', nf + nz_in, nf)
    add('model.10', nf + nz_in, 3)
    return state


def _exsr_rrdb(state, nb, nf, gc, nz, lr, z):
    from exsr.models.rrdb import RRDBNet
    g = RRDBNet(nb=nb, nf=nf, gc=gc, latent_channels=nz)
    zj = None if z is None else jnp.asarray(z)
    template = g.init(jax.random.PRNGKey(0), jnp.asarray(lr), zj)
    params = xconv.align_params_to(
        template, xconv.convert_esrgan_rrdb(state, nb=nb,
                                            latent_channels=nz))
    return np.asarray(g.apply(params, jnp.asarray(lr), zj))


def _port_rrdb(state, nb, nf, gc, nz, lr, z):
    from exsr_torch.models.rrdb import RRDBNet
    g = tconv.align_params_to(
        RRDBNet(nb=nb, nf=nf, gc=gc, latent_channels=nz),
        tconv.convert_esrgan_rrdb(state, nb=nb, latent_channels=nz))
    with torch.no_grad():
        out = g(torch.from_numpy(lr),
                None if z is None else torch.from_numpy(z))
    return out.numpy()


@pytest.mark.parametrize('nz_in,nz', [(0, 0), (0, 3), (3, 3)],
                         ids=['esrgan_nz0', 'esrgan_to_nz3', 'explorable'])
def test_rrdb_converter_matches_exsr(nz_in, nz):
    """Plain ESRGAN (zero Z inputs prepended) and a trained explorable
    checkpoint (Z inputs kept): both packages' conversions give the same
    forward on the same LR image and Z."""
    nb, nf, gc = 2, 16, 8
    state = _rrdb_state(0, nf, nb, gc, nz_in)
    rng = np.random.default_rng(1)
    lr = rng.uniform(size=(1, 12, 12, 3)).astype(np.float32)
    z = (rng.uniform(-1, 1, size=(1, 48, 48, nz)).astype(np.float32)
         if nz else None)
    ref = _exsr_rrdb(state, nb, nf, gc, nz, lr, z)
    out = _port_rrdb(state, nb, nf, gc, nz, lr, z)
    assert out.shape == ref.shape == (1, 48, 48, 3)
    assert np.abs(out - ref).max() <= 1e-5
    if nz_in == 0 and nz:
        # the prepended Z weights are zeros: Z changes nothing
        plain = _port_rrdb(state, nb, nf, gc, 0, lr, None)
        assert np.abs(out - plain).max() <= 1e-6


def test_rrdb_converter_prepends_zeros_in_front():
    state = _rrdb_state(2, 8, 1, 4, 0)
    conv = tconv.convert_esrgan_rrdb(state, nb=1, latent_channels=3)
    for key in ('fea_conv', 'trunk.0.rdb2.conv3', 'trunk_conv', 'hr_conv0',
                'hr_conv1'):
        w = conv[f'{key}.weight']
        assert not w[:, :3].any()
        np.testing.assert_array_equal(w[:, 3:].numpy(), {
            'fea_conv': state['model.0.weight'],
            'trunk.0.rdb2.conv3': state['model.1.sub.0.RDB2.conv4.0.weight'],
            'trunk_conv': state['model.1.sub.1.weight'],
            'hr_conv0': state['model.8.weight'],
            'hr_conv1': state['model.10.weight']}[key].numpy())
    for key in ('upconv0', 'upconv1'):   # the upconvs take no Z
        assert conv[f'{key}.weight'].shape[1] == 8


def test_rrdb_converter_nz_a_multiple_of_gc():
    """nz a multiple of gc (every Z-carrying width also a multiple of gc):
    recognised as explorable, not padded twice; an inconsistent width
    raises in both packages."""
    nb, nf, gc, nz = 1, 32, 32, 32
    state = _rrdb_state(1, nf, nb, gc, nz)
    conv = tconv.convert_esrgan_rrdb(state, nb=nb, latent_channels=nz)
    ref = xconv.convert_esrgan_rrdb(state, nb=nb, latent_channels=nz)
    assert conv['fea_conv.weight'].shape[1] == 3 + nz
    assert conv['trunk.0.rdb1.conv2.weight'].shape[1] == nf + 2 * gc + nz
    assert conv['hr_conv1.weight'].shape[1] == nf + nz
    np.testing.assert_array_equal(
        conv['trunk.0.rdb3.conv4.weight'].numpy(),
        ref['params']['trunk']['RRDB_0']['rdb3']['conv4']['Conv_0'][
            'kernel'][0].transpose(3, 2, 0, 1))
    state['model.8.weight'] = torch.zeros(nf, nf + 7, 3, 3)
    for pkg in (tconv, xconv):
        with pytest.raises(ValueError, match='model.8.weight'):
            pkg.convert_esrgan_rrdb(state, nb=nb, latent_channels=nz)


def test_align_params_to_names_the_key_and_both_shapes():
    from exsr_torch.models.rrdb import RRDBNet
    state = _rrdb_state(3, 16, 1, 8, 0)
    conv = tconv.convert_esrgan_rrdb(state, nb=1, latent_channels=3)
    with pytest.raises(ValueError) as e:   # gc 4 where the checkpoint has 8
        tconv.align_params_to(RRDBNet(nb=1, nf=16, gc=4, latent_channels=3),
                              conv)
    msg = str(e.value)
    assert 'trunk.0.rdb1.conv0.weight' in msg
    assert '(4, 19, 3, 3)' in msg and '(8, 19, 3, 3)' in msg
    with pytest.raises(RuntimeError, match='trunk.1'):   # nb 2, not 1
        tconv.align_params_to(RRDBNet(nb=2, nf=16, gc=8, latent_channels=3),
                              conv)
    g = RRDBNet(nb=1, nf=16, gc=8, latent_channels=3)
    conv64 = {k: v.double() for k, v in conv.items()}
    assert tconv.align_params_to(g, conv64) is g
    assert g.fea_conv.weight.dtype == torch.float32
    torch.testing.assert_close(g.fea_conv.weight, conv['fea_conv.weight'],
                               rtol=0, atol=0)


def test_load_torch_checkpoint_unwraps_like_exsr(tmp_path):
    rng = np.random.default_rng(4)
    inner = {
        'module.generated_image_model.model.0.weight':
            torch.from_numpy(rng.normal(size=(4, 6, 3, 3)).astype('f4')),
        'module.generated_image_model.model.0.bias': torch.zeros(4),
        'module.Filter_OP.0.weight': torch.ones(3, 1, 5, 5),
        'generated_image_model.model.3.weight': torch.ones(4, 4, 3, 3),
    }
    cases = {'wrapped.pth': {'state_dict': inner, 'iter': 7},
             'bare.pth': inner}
    for name, payload in cases.items():
        path = str(tmp_path / name)
        torch.save(payload, path)
        got = tconv.load_torch_checkpoint(path)
        ref = xconv.load_torch_checkpoint(path)
        assert list(got) == list(ref) == ['model.0.weight', 'model.0.bias',
                                          'model.3.weight']
        for k in got:
            assert torch.equal(got[k], ref[k])


def _msrresnet_state(seed, nf, nb, upscale):
    rng = np.random.default_rng(seed)
    state = {}

    def add(key, cin, cout):
        state[f'{key}.weight'] = torch.from_numpy(rng.normal(
            0, 0.05, size=(cout, cin, 3, 3)).astype(np.float32))
        state[f'{key}.bias'] = torch.from_numpy(rng.normal(
            0, 0.01, size=(cout,)).astype(np.float32))

    add('conv_first', 3, nf)
    for i in range(nb):
        add(f'recon_trunk.{i}.conv1', nf, nf)
        add(f'recon_trunk.{i}.conv2', nf, nf)
    f = 3 if upscale == 3 else 2
    for u in range(1 if upscale == 3 else int(np.log2(upscale))):
        add(f'upconv{u + 1}', nf, nf * f * f)
    add('HRconv', nf, nf)
    add('conv_last', nf, 3)
    return state


@pytest.mark.parametrize('upscale', [4, 3])
def test_msrresnet_converter_matches_exsr(upscale):
    from exsr.models.classifiers import MSRResNet as XMSRResNet
    from exsr_torch.models.classifiers import MSRResNet
    nf, nb = 8, 2
    state = _msrresnet_state(5, nf, nb, upscale)
    x = np.random.default_rng(6).uniform(size=(1, 10, 10, 3)) \
        .astype(np.float32)
    xm = XMSRResNet(nf=nf, nb=nb, upscale=upscale)
    template = xm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = xconv.align_params_to(template, jax.tree.map(
        jnp.asarray, xconv.convert_msrresnet(state, nf=nf, nb=nb,
                                             upscale=upscale)))
    ref = np.asarray(xm.apply(params, jnp.asarray(x)))
    g = tconv.align_params_to(
        MSRResNet(nf=nf, nb=nb, upscale=upscale),
        tconv.convert_msrresnet(state, nf=nf, nb=nb, upscale=upscale))
    with torch.no_grad():
        out = g(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 10 * upscale, 10 * upscale, 3)
    assert np.abs(out - ref).max() <= 1e-5


# ------------------------------------------------------------------- SVHN
def _svhn_pth(path, seed):
    """A seeded state dict in the reference SVHN checkpoint's layout."""
    rng = np.random.default_rng(seed)
    feats = [3, 48, 64, 128, 160, 192, 192, 192, 192]
    state = {}

    def t(*shape, lo=-0.05, hi=0.05):
        return torch.from_numpy(rng.uniform(lo, hi, size=shape)
                                .astype(np.float32))
    for i in range(8):
        state[f'_hidden{i + 1}.0.weight'] = t(feats[i + 1], feats[i], 5, 5)
        state[f'_hidden{i + 1}.0.bias'] = t(feats[i + 1])
        state[f'_hidden{i + 1}.1.weight'] = t(feats[i + 1], lo=0.5, hi=1.5)
        state[f'_hidden{i + 1}.1.bias'] = t(feats[i + 1])
        state[f'_hidden{i + 1}.1.running_mean'] = t(feats[i + 1],
                                                    lo=-0.1, hi=0.1)
        state[f'_hidden{i + 1}.1.running_var'] = t(feats[i + 1],
                                                   lo=0.5, hi=1.5)
        state[f'_hidden{i + 1}.1.num_batches_tracked'] = torch.tensor(5)
    state['_hidden9.0.weight'] = t(3072, 192 * 7 * 7, lo=-0.01, hi=0.01)
    state['_hidden9.0.bias'] = t(3072)
    state['_hidden10.0.weight'] = t(3072, 3072, lo=-0.02, hi=0.02)
    state['_hidden10.0.bias'] = t(3072)
    state['_digit_length.0.weight'] = t(7, 3072)
    state['_digit_length.0.bias'] = t(7)
    for d in range(1, 6):
        state[f'_digit{d}.0.weight'] = t(11, 3072)
        state[f'_digit{d}.0.bias'] = t(11)
    torch.save(state, path)
    return path


@pytest.fixture(scope='module')
def svhn_pth(tmp_path_factory):
    return _svhn_pth(str(tmp_path_factory.mktemp('svhn') / 'svhn.pth'), 7)


def _svhn_input(seed, n=2):
    return (np.random.default_rng(seed).uniform(size=(n, 54, 54, 3)) * 2
            - 1).astype(np.float32)


def _head_gap(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


def test_svhn_from_reference_pth_matches_exsr(svhn_pth):
    from exsr.models.classifiers import SVHNClassifier as XSVHN
    from exsr.models.classifiers import load_svhn_torch_state_dict as xload
    from exsr_torch.models.classifiers import (SVHNClassifier,
                                               load_svhn_torch_state_dict)
    x = _svhn_input(8)
    ref = XSVHN().apply(xload(svhn_pth), jnp.asarray(x))
    clf = SVHNClassifier()
    clf.load_state_dict(load_svhn_torch_state_dict(svhn_pth))
    with torch.no_grad():
        out = clf(torch.from_numpy(x))
    assert [tuple(h.shape) for h in out] == [(2, 7)] + [(2, 11)] * 5
    assert _head_gap(out, ref) <= 1e-5


def test_svhn_from_exsr_vars_logits_and_input_gradient():
    """exsr's own initialisation through ``svhn_from_exsr_vars``: fp32
    logits within 1e-5; the input gradient of a seeded weighting of all
    six heads against jax.grad within 1e-4 of its largest element.

    The gradient is compared in float64 on both sides: a max-pool's
    gradient jumps where two inputs of a window nearly tie, and fp32
    rounding decides such a tie one way or the other (the port's fp32
    gradient on the CPU is 1.7e-2 of the largest element from float64 on
    this input, through two such flips in the last stage; exsr's 6e-7)."""
    from exsr.models.classifiers import SVHNClassifier as XSVHN
    from exsr_torch.models.classifiers import SVHNClassifier
    x = _svhn_input(9)
    xm = XSVHN()
    variables = jax.tree.map(np.asarray, xm.init(jax.random.PRNGKey(3),
                                                 jnp.asarray(x)))
    # running statistics away from (0, 1), so that they are exercised
    rng = np.random.default_rng(10)
    for st in variables['batch_stats'].values():
        st['mean'] = rng.uniform(-0.1, 0.1, st['mean'].shape).astype('f4')
        st['var'] = rng.uniform(0.5, 1.5, st['var'].shape).astype('f4')
    cot = [rng.normal(size=(2, 7 if i == 0 else 11)) for i in range(6)]
    ref = xm.apply(variables, jnp.asarray(x))
    clf = SVHNClassifier()
    clf.load_state_dict(tconv.svhn_from_exsr_vars(variables))
    with torch.no_grad():
        assert _head_gap(clf(torch.from_numpy(x)), ref) <= 1e-5

    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        gref = np.asarray(jax.grad(lambda xx: sum(
            (h * c).sum() for h, c in zip(xm.apply(v64, xx), cot)))(
                jnp.asarray(x, jnp.float64)))
    assert gref.dtype == np.float64
    clf = clf.double()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    sum((h * torch.from_numpy(c)).sum() for h, c in zip(clf(xt), cot)) \
        .backward()
    g = xt.grad.numpy()
    assert np.abs(g - gref).max() <= 1e-4 * np.abs(gref).max()


def test_svhn_pooling_at_the_ragged_edge():
    """Torch's padded max-pool equals exsr's -inf pad + VALID pool at every
    size the classifier meets (54 -> 28 -> 29 -> 15 -> 16 -> 9 -> 10 -> 6
    -> 7), negative inputs included."""
    import torch.nn.functional as F
    from exsr.models.classifiers import _maxpool_torch
    rng = np.random.default_rng(11)
    for i, size in enumerate((54, 28, 29, 15, 16, 9, 10, 6)):
        x = rng.normal(size=(1, size, size, 2)).astype(np.float32) - 3
        stride = 2 if i % 2 == 0 else 1
        ref = np.asarray(_maxpool_torch(jnp.asarray(x), stride))
        out = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 2,
                           stride=stride, padding=1).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(out.numpy(), ref)
