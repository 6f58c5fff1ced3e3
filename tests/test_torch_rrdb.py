"""exsr_torch's generator against exsr's: the weight bridge, the canonical
RRDBNet, the grouped fast path and the folded upconv.  CPU, fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.models import rrdb_fast as JFast
from exsr.models.rrdb import RRDBNet as JNet
from exsr_torch.models import rrdb_fast as TFast
from exsr_torch.models.convert import from_exsr_params
from exsr_torch.models.rrdb import RRDBNet as TNet

NF, GC, NB = 16, 8, 2


def _setup(nz, seed=0, b=2, h=12):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(size=(b, h, h, 3)).astype(np.float32)
    z = (rng.uniform(-1, 1, size=(b, 4 * h, 4 * h, nz)).astype(np.float32)
         if nz else None)
    g = JNet(nf=NF, gc=GC, nb=NB, latent_channels=nz)
    params = g.init(jax.random.PRNGKey(seed), jnp.asarray(lr),
                    None if z is None else jnp.asarray(z))
    tree = jax.tree.map(np.asarray, params)
    net = TNet(nf=NF, gc=GC, nb=NB, latent_channels=nz)
    net.load_state_dict(from_exsr_params(tree))
    return g, params, net, lr, z


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize('nz', [3, 0])
def test_bridge_and_rrdbnet_match_exsr(nz):
    g, params, net, lr, z = _setup(nz)
    ref = g.apply(params, jnp.asarray(lr), None if z is None
                  else jnp.asarray(z))
    with torch.no_grad():
        out = net(_t(lr), _t(z))
    assert tuple(out.shape) == ref.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_rrdbnet_is_differentiable():
    _, _, net, lr, z = _setup(3, b=1, h=6)
    zt = _t(z).requires_grad_(True)
    net(_t(lr), zt).square().mean().backward()
    assert zt.grad is not None and torch.isfinite(zt.grad).all()
    assert net.fea_conv.weight.grad.abs().sum() > 0


def test_full_width_parameter_count():
    net = TNet(nf=64, gc=32, nb=23, upscale=4, latent_channels=3)
    assert sum(p.numel() for p in net.parameters()) == 17_060_948


def test_seeded_init_is_deterministic_and_scaled():
    a, b = TNet(nf=NF, gc=GC, nb=1, seed=3), TNet(nf=NF, gc=GC, nb=1, seed=3)
    w = a.trunk[0].rdb1.conv0.weight
    assert torch.equal(w, b.trunk[0].rdb1.conv0.weight)
    # kaiming fan-in std sqrt(2 / fan_in), scaled by 0.1
    std = 0.1 * np.sqrt(2.0 / w[0].numel())
    assert 0.7 * std < w.std().item() < 1.3 * std
    assert not torch.equal(w, TNet(nf=NF, gc=GC, nb=1, seed=4)
                           .trunk[0].rdb1.conv0.weight)


@pytest.mark.parametrize('tail_chunk', [None, 1])
def test_apply_fast_matches_exsr(tail_chunk):
    g, params, net, lr, z = _setup(3, seed=1)
    ref = JFast.rrdbnet_apply_fast(
        params, jnp.asarray(lr), jnp.asarray(z), nf=NF, gc=GC, nb=NB,
        latent_channels=3, dtype=None, tail_chunk=tail_chunk)
    with torch.no_grad():
        out = TFast.rrdbnet_apply_fast(net, _t(lr), _t(z), dtype=None,
                                       tail_chunk=tail_chunk)
        canon = net(_t(lr), _t(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), canon.numpy(), atol=2e-5)


def test_pack_grouped_params_matches_exsr():
    """Same s4-first packing; the port's conv weights are OIHW, w4 HWIO."""
    _, params, net, _, _ = _setup(3)
    j_trunk, j_rest = JFast.pack_grouped_params(params, nf=NF, gc=GC,
                                                latent_channels=3)
    t_trunk, t_rest = TFast.pack_grouped_params(net)
    assert len(t_trunk) == NB
    for i in range(NB):
        for r in ('rdb1', 'rdb2', 'rdb3'):
            je, te = j_trunk[r], t_trunk[i][r]
            for g in range(4):
                np.testing.assert_array_equal(
                    te[f'w{g}'].permute(2, 3, 1, 0).numpy(),
                    np.asarray(je[f'w{g}'][i]))
            np.testing.assert_array_equal(te['w4'].numpy(),
                                          np.asarray(je['w4'][i]))
            for c in range(5):
                np.testing.assert_array_equal(te[f'b{c}'].numpy(),
                                              np.asarray(je[f'b{c}'][i]))
    assert set(t_rest) == set(j_rest)


@pytest.mark.parametrize('h,w,ci,co', [(7, 9, 5, 4), (1, 1, 3, 2),
                                       (8, 3, 16, 8)])
def test_subpixel_upconv_matches_exsr(h, w, ci, co):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, h, w, ci)).astype(np.float32)
    k = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    ref = JFast.subpixel_upconv(jnp.asarray(x),
                                JFast.fold_upconv_kernel(jnp.asarray(k)),
                                jnp.asarray(b))
    k4 = TFast.fold_upconv_kernel(_t(k))
    np.testing.assert_allclose(
        k4.numpy(), np.asarray(JFast.fold_upconv_kernel(jnp.asarray(k))),
        atol=1e-6)
    out = TFast.subpixel_upconv(_t(x), k4, _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
