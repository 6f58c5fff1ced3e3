"""The port's auxiliary models against exsr's, on the CPU: SFT-GAN, SegNet,
E_ResNet, MINCNet, ResNet101Features, the feature-extractor factory and
the three fixed-size critics (``exsr/models/{sft,encoders,perceptual,
factory}.py``, ``exsr/models/discriminators.py:125-196``).

exsr's seeded variables are carried across by the converters of
``exsr_torch.models.convert``; both packages take the same numpy-seeded
inputs.  Forwards are held within 1e-5 of the largest element of exsr's
output, the running statistics after one train-mode forward within 1e-5
absolute.  Batch-norm forwards in train mode are compared in float64 on
both sides: flax normalises by ``E[x^2] - E[x]^2``, the port by the
two-pass variance, and a batch of a few values per channel (ResNet101's
last stage at 64 x 64) turns that fp32 difference into 1e-3 of the
output.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr_torch.models import convert as C

TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stats_err(module, convert, variables) -> float:
    """Largest difference between the module's running statistics (or
    spectral norm's ``u``) and ``variables``' after ``convert``."""
    want = {k: v for k, v in convert(_np(variables)).items()
            if 'running' in k or k.endswith('.u')}
    assert want
    sd = module.state_dict()
    return max(float((sd[k].double() - v.double()).abs().max())
               for k, v in want.items())


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@contextlib.contextmanager
def _float64():
    with jax.enable_x64(True):
        yield


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        tree)


# ------------------------------------------------------------------- SFT
def test_sftnet_matches_exsr_and_counts_reference_params():
    from exsr.models.sft import SFTNet as JSFT
    from exsr_torch.models.sft import SFTNet
    assert sum(p.numel() for p in SFTNet().parameters()) == 1_833_763
    img, seg = _x((2, 8, 8, 3)), _x((2, 32, 32, 8), 1)
    jm = JSFT(n_blocks=2)
    v = jm.init(jax.random.PRNGKey(0), img, seg)
    want = jm.apply(v, img, seg)
    m = SFTNet(n_blocks=2)
    m.load_state_dict(C.sft_from_exsr_vars(_np(v)))
    with torch.no_grad():
        got = m(torch.from_numpy(img), torch.from_numpy(seg))
    assert _rel(got, want) < TOL


def test_pixel_shuffle_is_exsr_depth_to_space():
    """The port's sub-pixel step (torch's ``pixel_shuffle`` on the NCHW
    view) reads the channels as ``exsr``'s ``_depth_to_space`` does."""
    from exsr.models.sft import _depth_to_space
    x = np.random.default_rng(3).normal(size=(2, 3, 4, 12)).astype('f')
    want = np.asarray(_depth_to_space(jnp.asarray(x), 2))
    got = torch.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------- SegNet
def test_max_pool_argmax_ties_match_exsr():
    """Cells with tied maxima (integers drawn from {0, 1, 2}) pick the
    first element of the cell in row-major order, as exsr's do."""
    from exsr.models.encoders import max_pool_argmax as jpool, \
        max_unpool as junpool
    from exsr_torch.models.encoders import max_pool_argmax, max_unpool
    x = np.random.default_rng(4).integers(0, 3, size=(2, 8, 10, 3)) \
        .astype(np.float32)
    jp, jsel = jpool(jnp.asarray(x))
    p, sel = max_pool_argmax(torch.from_numpy(x))
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(sel.numpy(), np.asarray(jsel))
    # ties exist, and every cell selects exactly one element
    assert (sel.sum(dim=3) == 1).all()
    cells = torch.from_numpy(x).reshape(2, 4, 2, 5, 2, 3)
    n_max = (cells == p[:, :, None, :, None, :]).sum(dim=(2, 4))
    assert (n_max > 1).any()
    up = max_unpool(p, sel)
    assert np.array_equal(up.numpy(), np.asarray(junpool(jp, jsel)))


@pytest.mark.parametrize('kind', ['encoder', 'autoencoder'])
def test_segnet_matches_exsr_eval_and_train(kind):
    from exsr.models.encoders import SegNet as JSeg
    from exsr_torch.models.encoders import SegNet
    kw = (dict(encode_only=True, num_layers=4, batch_norm_ds=False)
          if kind == 'encoder' else dict(num_layers=5))
    x = _x((2, 32, 32, 3), 5)
    jm = JSeg(**kw)
    v = jm.init(jax.random.PRNGKey(0), x)
    m = SegNet(**kw)
    m.load_state_dict(C.segnet_from_exsr_vars(_np(v)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert _rel(got, jm.apply(v, x)) < TOL
    # train mode: batch statistics, the running ones moved once
    with _float64():
        want, new = jm.apply(_f64(v), _f64(x), train=True,
                             mutable=['batch_stats'])
    m.double()
    with torch.no_grad():
        got = m(torch.from_numpy(x).double(), train=True)
    assert _rel(got, want) < TOL
    if kind == 'autoencoder':     # the encoder has no batch norm
        assert _stats_err(m, C.segnet_from_exsr_vars,
                          {'params': v['params'], **new}) < TOL
    else:
        assert 'batch_stats' not in new


# --------------------------------------------------------------- EResNet
@pytest.mark.parametrize('vae_like', [False, True])
def test_eresnet_matches_exsr(vae_like):
    from exsr.models.encoders import EResNet as JE
    from exsr_torch.models.encoders import EResNet
    x = _x((2, 128, 128, 3), 6)
    jm = JE(output_nc=8, ndf=8, vae_like=vae_like)
    v = jm.init(jax.random.PRNGKey(0), x)
    want = jm.apply(v, x)
    m = EResNet(output_nc=8, ndf=8, vae_like=vae_like, input_size=128)
    m.load_state_dict(C.eresnet_from_exsr_vars(_np(v)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    if vae_like:
        assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL
    else:
        assert _rel(got, want) < TOL


# ------------------------------------------------------------ perceptual
def test_mincnet_matches_exsr():
    from exsr.models.perceptual import MINCNet as JM
    from exsr_torch.models.perceptual import MINCNet
    x = _x((2, 32, 32, 3), 7)
    jm = JM()
    v = jm.init(jax.random.PRNGKey(0), x)
    m = MINCNet()
    m.load_state_dict(C.from_exsr_flat_params(_np(v)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    want = jm.apply(v, x)
    assert got.shape == (2, 2, 2, 512)
    assert _rel(got, want) < TOL
    assert float(got.min()) < 0       # the last conv has no ReLU


@pytest.fixture(scope='module')
def resnet():
    from exsr.models.perceptual import ResNet101Features as JR
    x = _x((2, 64, 64, 3), 8)
    jm = JR()
    v = jm.init(jax.random.PRNGKey(0), x)
    # random running statistics, so that eval mode differs from train mode
    rng = np.random.default_rng(9)

    def draw(tree):
        return {k: draw(a) if isinstance(a, dict) else
                (rng.normal(0, 0.1, a.shape) if k == 'mean' else
                 rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
                for k, a in tree.items()}
    v = {'params': v['params'], 'batch_stats': draw(_np(v['batch_stats']))}
    return jm, v, x


def test_resnet101_matches_exsr_eval(resnet):
    from exsr_torch.models.perceptual import ResNet101Features
    jm, v, x = resnet
    m = ResNet101Features()
    m.load_state_dict(C.resnet101_from_exsr_vars(_np(v)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 2048)
    assert _rel(got, jm.apply(v, x)) < TOL


def test_resnet101_matches_exsr_train_and_running_stats(resnet):
    from exsr_torch.models.perceptual import ResNet101Features
    jm, v, x = resnet
    with _float64():
        want, new = jm.apply(_f64(v), _f64(x), train=True,
                             mutable=['batch_stats'])
    m = ResNet101Features()
    m.load_state_dict(C.resnet101_from_exsr_vars(_np(v)))
    m.double()
    with torch.no_grad():
        got = m(torch.from_numpy(x).double(), train=True)
    assert _rel(got, want) < TOL
    # flax's momentum 0.99 kept, not the critics' 0.9
    assert _stats_err(m, C.resnet101_from_exsr_vars,
                      {'params': v['params'], **new}) < TOL


# --------------------------------------------------------------- factory
def test_feature_extractor_factory_matches_exsr():
    """exsr's four cases (``tests/test_models.py``): shapes, the pre-ReLU
    sign of a conv cut, and the features on exsr's weights."""
    from exsr.models.factory import make_feature_extractor as jmake
    from exsr_torch.models.factory import make_feature_extractor
    x = _x((1, 64, 64, 3), 2)
    cases = [('vgg19', (1, 4, 4, 512), True),
             ('vgg19_8', (1, 32, 32, 128), False),   # relu cut
             ('vgg19_9', (1, 16, 16, 128), False),   # pool cut
             ('SegNetAE', (1, 4, 4, 512), False)]
    for arch, shape, has_neg in cases:
        jmod, japply = jmake(arch)
        v = jmod.init(jax.random.PRNGKey(0), x)
        mod = make_feature_extractor(arch)
        conv = (C.from_exsr_flat_params if arch.startswith('vgg')
                else C.segnet_from_exsr_vars)
        mod.load_state_dict(conv(_np(v)))
        with torch.no_grad():
            f = mod(torch.from_numpy(x))
        assert f.shape == shape, (arch, f.shape)
        assert (float(f.min()) < 0) == has_neg, arch
        assert _rel(f, japply(v, x)) < TOL, arch
    from exsr_torch.models.perceptual import MINCNet, ResNet101Features
    assert isinstance(make_feature_extractor('minc'), MINCNet)
    assert isinstance(make_feature_extractor('resnet101'),
                      ResNet101Features)
    with pytest.raises(ValueError):
        make_feature_extractor('alexnet')


# --------------------------------------------------------------- critics
CRITICS = {
    'vgg96': (lambda J: J.DiscriminatorVGG(base_nf=8, input_size=96),
              lambda P: P.DiscriminatorVGG(base_nf=8, input_size=96), 96),
    'vgg192': (lambda J: J.DiscriminatorVGG(base_nf=8, input_size=192),
               lambda P: P.DiscriminatorVGG(base_nf=8, input_size=192),
               192),
    'acd96': (lambda J: J.ACDVGGBN96(base_nf=8, num_classes=8),
              lambda P: P.ACDVGGBN96(base_nf=8, num_classes=8), 96),
    'vgg128sn': (lambda J: J.DiscriminatorVGG128SN(nf=8),
                 lambda P: P.DiscriminatorVGG128SN(nf=8), 128),
}


@pytest.mark.parametrize('kind', list(CRITICS))
def test_critic_matches_exsr_in_train_mode(kind):
    """Train mode (batch statistics; the running statistics or spectral
    norm's ``u`` moved once), batch 3."""
    import exsr.models.discriminators as J
    import exsr_torch.models.discriminators as P
    jmake, make, size = CRITICS[kind]
    x = _x((3, size, size, 3), 10)
    jd = jmake(J)
    v = jd.init(jax.random.PRNGKey(0), x)
    d = make(P)
    d.load_state_dict(C.d_from_exsr_vars(_np(v)))
    sn = kind.endswith('sn')
    if sn:
        want, new = jd.apply(v, x, mutable=['spectral'])
    else:
        with _float64():
            want, new = jd.apply(_f64(v), _f64(x), train=True,
                                 mutable=['batch_stats'])
        d.double()
    xt = torch.from_numpy(x).to(next(d.parameters()).dtype)
    with torch.no_grad():
        got = d(xt, update_stats=True)
    if kind == 'acd96':
        assert got[0].shape == (3, 1) and got[1].shape == (3, 8)
        assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL
    else:
        assert got.shape == (3, 1)
        assert _rel(got, want) < TOL
    assert _stats_err(d, C.d_from_exsr_vars,
                      {'params': v['params'], **new}) < TOL


def test_vgg128sn_stride_is_subsampling_not_a_strided_conv():
    """The SN critic's stride-2 stages keep the even positions of a
    stride-1 conv, as exsr's; torch's stride-2 conv on the same padding
    reads other windows."""
    import torch.nn.functional as F
    from exsr_torch.models.discriminators import DiscriminatorVGG128SN
    d = DiscriminatorVGG128SN(nf=8)
    x = torch.from_numpy(_x((1, 3, 16, 16), 11))
    conv = d.conv1
    with torch.no_grad():
        full = conv(F.leaky_relu(d.conv0(x), 0.2))
        strided = F.conv2d(F.leaky_relu(d.conv0(x), 0.2),
                           conv.weight, conv.bias, stride=2, padding=1)
    ours = full[:, :, ::2, ::2]
    assert ours.shape != strided.shape or \
        float((ours - strided).abs().max()) > 1e-3
