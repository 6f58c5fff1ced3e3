"""The whole slice against exsr: the CEM-wrapped grouped forward and the
serving entry point build_model / bucketed_sweep.  CPU, fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.apps import eval_sr as JApp
from exsr.cem import cem as JCem
from exsr.models.rrdb import RRDBNet as JNet
from exsr.models.rrdb_fast import rrdbnet_apply_fast as j_apply_fast
from exsr_torch.apps import eval_sr as TApp
from exsr_torch.cem import cem as TCem
from exsr_torch.models.convert import from_exsr_params
from exsr_torch.models.rrdb import RRDBNet as TNet
from exsr_torch.models.rrdb_fast import rrdbnet_apply_fast as t_apply_fast


def _exsr_params(nf, gc, nb, h, seed=0):
    g = JNet(nf=nf, gc=gc, nb=nb, latent_channels=3)
    params = g.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, h, 3)),
                    jnp.zeros((1, 4 * h, 4 * h, 3)))
    return params, from_exsr_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize('pre_pad', [True, False])
def test_wrapped_grouped_forward_matches_exsr(pre_pad):
    nf, gc, nb = 16, 8, 2
    params, state = _exsr_params(nf, gc, nb, 8, seed=1)
    rng = np.random.default_rng(5)
    lr = rng.uniform(size=(2, 24, 24, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(2, 96, 96, 3)).astype(np.float32)
    jc = JCem.CEM.create(JCem.CEMConf(scale_factor=4))
    tc = TCem.CEM.create(TCem.CEMConf(scale_factor=4))
    ref = JCem.cem_wrap(
        lambda p, x, zz: j_apply_fast(p, x, zz, nf=nf, gc=gc, nb=nb,
                                      dtype=None),
        jc.device_filters(3), 4)(params, jnp.asarray(lr), jnp.asarray(z),
                                 jc.invalidity_margins_lr, pre_pad=pre_pad)
    with torch.no_grad():
        out = TCem.cem_wrap(
            lambda p, x, zz: t_apply_fast(p, x, zz, dtype=None),
            tc.device_filters(3, device='cpu'), 4)(
            state, torch.from_numpy(lr), torch.from_numpy(z),
            tc.invalidity_margins_lr, pre_pad=pre_pad)
    assert tuple(out.shape) == ref.shape == (2, 96, 96, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # and the CEM's invariant holds on the port's output
    down = tc.device_filters(3, device='cpu').downscale(out)
    m = tc.invalidity_margins_lr
    assert (down - torch.from_numpy(lr))[:, m:-m, m:-m].abs().max() < 5e-6


def test_build_model_matches_exsr_build_model():
    """Same weights: exsr's build_model initialises with PRNGKey(0)."""
    _, state = _exsr_params(16, 32, 1, 16, seed=0)
    _, j_fwd = JApp.build_model(4, nb=1, latent_channels=3, nf=16)
    cem, t_fwd = TApp.build_model(4, nb=1, nf=16, device='cpu',
                                  dtype=torch.float32, params=state)
    rng = np.random.default_rng(6)
    lr = rng.uniform(size=(1, 12, 12, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 48, 48, 3)).astype(np.float32)
    out = t_fwd(lr, z)
    assert out.dtype == torch.float32 and out.device.type == 'cpu'
    np.testing.assert_allclose(out.numpy(), j_fwd(lr, z), atol=1e-5)
    assert cem.invalidity_margins_lr == 10


def test_bucketed_sweep_matches_single_forwards():
    net = TNet(nf=16, nb=1, gc=8, latent_channels=3, seed=2)
    _, fwd = TApp.build_model(4, nb=1, nf=16, device='cpu',
                              dtype=torch.float32, params=net)
    rng = np.random.default_rng(7)
    lr = rng.uniform(size=(1, 8, 8, 3)).astype(np.float32)
    zs = [np.full((1, 32, 32, 3), v, np.float32) for v in (-1.0, 0.0, 0.5)]
    outs = TApp.bucketed_sweep(fwd, lr, zs)
    padded = TApp.bucketed_sweep(fwd, lr, zs, table={4: 1.0, 8: 2.0})
    assert len(outs) == len(padded) == 3
    for o, p, z in zip(outs, padded, zs):
        assert tuple(o.shape) == (1, 32, 32, 3)
        single = fwd(lr, z)
        np.testing.assert_allclose(o.numpy(), single.numpy(), atol=1e-6)
        np.testing.assert_allclose(p.numpy(), single.numpy(), atol=1e-6)
    assert not torch.allclose(outs[0], outs[2])


def test_build_model_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TApp.build_model(4, nb=1, nf=16)
    with pytest.raises(NotImplementedError, match='checkpoint'):
        TApp.build_model(4, nb=1, nf=16, device='cpu', checkpoint='ckpt')
