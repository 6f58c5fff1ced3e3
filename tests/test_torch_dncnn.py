"""The port's DnCNN generator and discriminator against exsr's, on the CPU,
with exsr's weights carried across by ``dncnn_from_exsr_vars`` and
``dncnn_d_from_exsr_vars`` (nf 16, nb 3): every latent mode and norm, the
chroma generators, batch norm's running statistics, spectral norm's ``u``,
both heads and the latent resize.  Tolerance 2e-5, as
``tests/test_torch_parity.py`` holds exsr's DnCNN to torch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.models import dncnn as E
from exsr_torch.models import dncnn as P
from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                       dncnn_from_exsr_vars)

TOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(variables, seed):
    """Weights moved off their init and batch-norm statistics away from
    (0, 1), so that every term shows."""
    key = jax.random.PRNGKey(seed)
    v = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(key, a.shape),
                     dict(variables))
    if 'batch_stats' in v:
        v['batch_stats'] = jax.tree.map(lambda a: jnp.abs(a) + 0.5,
                                        v['batch_stats'])
    return v


@pytest.mark.parametrize('norm', ['batch', 'instance', 'layer', None])
@pytest.mark.parametrize('latent', ['all_layers', 'first_layer', None])
def test_generator_matches_exsr(latent, norm):
    cfg = dict(n_channels=16, depth=3, num_latent_channels=5,
               latent_input=latent, norm=norm)
    rng = np.random.default_rng(0)
    c = np.round(rng.normal(0, 4, (2, 5, 7, 64))).astype(np.float32)
    z = rng.uniform(-1, 1, (2, 5, 7, 5)).astype(np.float32)
    g = E.DnCNN(E.DnCNNConfig(**cfg))
    v = _perturbed(g.init(jax.random.PRNGKey(0), jnp.asarray(c),
                          jnp.asarray(z)), 1)
    m = P.DnCNN(P.DnCNNConfig(**cfg))
    m.load_state_dict(dncnn_from_exsr_vars(_np(v)))
    ref = np.asarray(jax.jit(lambda a, b: g.apply(v, a, b, train=False))(
        jnp.asarray(c), jnp.asarray(z)))
    out = m(torch.from_numpy(c), torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)
    assert np.abs(out - c).max() <= 0.5
    # train mode: batch statistics, and the running ones moved
    if 'batch_stats' in v:
        ref_t, mut = jax.jit(lambda a, b: g.apply(
            v, a, b, train=True, mutable=['batch_stats']))(
            jnp.asarray(c), jnp.asarray(z))
        out_t = m(torch.from_numpy(c), torch.from_numpy(z), train=True)
        np.testing.assert_allclose(out_t.detach().numpy(),
                                   np.asarray(ref_t), atol=TOL)
        moved = dncnn_from_exsr_vars({'params': _np(v['params']),
                                      'batch_stats': _np(mut['batch_stats'])})
        for k, t in moved.items():
            if 'running' in k:
                np.testing.assert_allclose(m.state_dict()[k].numpy(),
                                           t.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('bs', [8, 16])
def test_chroma_generator_matches_exsr(bs):
    """The chroma head: the low frequencies added onto each block's 8 x 8
    quadrant (the session's 8 x 8 head and the trainer's 16 x 16 one)."""
    cfg = dict(n_channels=16, depth=3, in_nc=384, out_nc=2 * bs * bs,
               chroma_generator=True, block_size=bs, num_latent_channels=0)
    rng = np.random.default_rng(1)
    c = np.round(rng.normal(0, 4, (2, 3, 4, 384))).astype(np.float32)
    g = E.DnCNN(E.DnCNNConfig(**cfg))
    v = _perturbed(g.init(jax.random.PRNGKey(2), jnp.asarray(c),
                          jnp.zeros((2, 3, 4, 0))), 3)
    m = P.DnCNN(P.DnCNNConfig(**cfg))
    m.load_state_dict(dncnn_from_exsr_vars(_np(v)))
    ref = np.asarray(g.apply(v, jnp.asarray(c), jnp.zeros((2, 3, 4, 0)),
                             train=False))
    out = m(torch.from_numpy(c)).detach().numpy()
    assert out.shape == ref.shape == (2, 3, 4, 2 * bs * bs)
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_generator_widths_and_init():
    """The widths flax infers, spelt out; the init's distributions."""
    m = P.DnCNN(P.DnCNNConfig(n_channels=32, depth=4,
                              num_latent_channels=8), seed=3)
    assert m.conv0.weight.shape == (32, 64 + 8, 3, 3)
    assert m.conv1.weight.shape == (32, 32 + 8, 3, 3)
    assert m.conv3.weight.shape == (64, 32 + 8, 3, 3)
    assert m.conv0.bias is not None and m.conv1.bias is None
    assert len(m.bns) == 2
    w = m.conv1.weight.detach().numpy()
    # LeCun normal truncated at 2 std: std sqrt(1 / fan_in), |w| < 2 / ...
    fan_in = 40 * 9
    assert abs(w.std() * np.sqrt(fan_in) - 1) < 0.1
    assert np.abs(w).max() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
    first = P.DnCNN(P.DnCNNConfig(n_channels=8, depth=3,
                                  num_latent_channels=4,
                                  latent_input='first_layer'))
    assert first.conv0.weight.shape[1] == 68
    assert first.conv1.weight.shape[1] == 8


D_CASES = {
    'layer_fc': dict(norm='layer'),
    'batch_fc': dict(norm='batch'),
    'spectral': dict(norm='layer', spectral_norm=True),
    'pooling': dict(norm=None, pooling_no_fc=True),
    'latent_all': dict(norm='layer', latent_input='all_layers',
                       num_latent_channels=3),
    'latent_first': dict(norm='layer', latent_input='first_layer',
                         num_latent_channels=3),
    'resized_z_spectral_batch': dict(norm='batch', spectral_norm=True,
                                     latent_input='all_layers',
                                     num_latent_channels=3,
                                     expected_input_size=12),
}


@pytest.mark.parametrize('case', sorted(D_CASES))
def test_discriminator_matches_exsr(case):
    """Logits, the input gradient, and what ``update_stats`` moves (batch
    norm's running statistics with flax's biased variance, spectral norm's
    ``u``); a 12 x 12 input shrinks under VALID convs, so Z is resized."""
    kw = dict(n_channels=16, depth=4, expected_input_size=8)
    kw.update(D_CASES[case])
    s = kw['expected_input_size']
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, s, s, 64)).astype(np.float32)
    z = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    d = E.DnCNNDiscriminator(**kw)
    v = dict(d.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(z)))
    if 'batch_stats' in v:
        v['batch_stats'] = jax.tree.map(lambda a: jnp.abs(a) + 0.5,
                                        v['batch_stats'])
    mutable = [k for k in v if k != 'params']

    def apply(xx):
        return d.apply(v, xx, jnp.asarray(z), train=True, mutable=mutable)
    ref, mut = jax.jit(apply)(jnp.asarray(x))
    ref_grad = jax.jit(jax.grad(lambda xx: apply(xx)[0].sum()))(
        jnp.asarray(x))
    m = P.DnCNNDiscriminator(**kw)
    m.load_state_dict(dncnn_d_from_exsr_vars(_np(v)))
    u_before = {k: b.clone() for k, b in m.state_dict().items()
                if k.endswith('.u')}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m(xt, torch.from_numpy(z), update_stats=True)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                               atol=TOL * max(1.0, float(np.abs(
                                   ref_grad).max())))
    moved = dncnn_d_from_exsr_vars({'params': _np(v['params']),
                                    **{k: _np(mut[k]) for k in mutable}})
    for k, t in moved.items():
        if 'running' in k or k.endswith('.u'):
            np.testing.assert_allclose(m.state_dict()[k].numpy(),
                                       t.numpy(), rtol=1e-5, atol=1e-5)
    # without update_stats nothing moves
    state = {k: b.clone() for k, b in m.state_dict().items()}
    m(torch.from_numpy(x), torch.from_numpy(z))
    for k, b in m.state_dict().items():
        assert torch.equal(b, state[k]), k
    if u_before:
        assert any(not torch.equal(u_before[k], state[k]) for k in u_before)
