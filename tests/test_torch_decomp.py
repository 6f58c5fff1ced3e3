"""The port's explorable-JPEG Y trainer and JPEG dataset against exsr's, on
the CPU, at exsr's tiny setup (``tests/test_decomp.py``: DnCNN nf 16,
depth 3, patch 64, batch 2, two inner MAP iterations).

Both trainers start from exsr's seeded weights (carried across by
``exsr_torch.models.convert``) and take the same random numbers: exsr's
keys are split as its ``_d_step`` and ``_g_step`` split them, the draws are
made from them, and the port takes them through ``draws``.  exsr's
optimizers are replaced by a transformation that stores the gradients in
the optimizer state, so that its step returns exactly the gradients it
computed.  Tolerances: gradients within 1e-4 of the largest element of
exsr's; metrics within 1e-4 relative (1e-6 absolute); the generator's
running statistics within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from exsr.data.datasets import JPEGDataset as JDataset
from exsr.models.dncnn import DnCNN as JDnCNN, DnCNNConfig as JGConfig, \
    DnCNNDiscriminator as JDisc
from exsr.train.decomp import DecompConfig as JConfig, \
    DecompTrainer as JTrainer, repeat_z_3_channels as j_repeat, \
    z_to_3_channels as j_to3
from exsr.train.srragan import flax_d_adapter
from exsr_torch.data.datasets import JPEGDataset
from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                       dncnn_from_exsr_vars)
from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, DnCNNDiscriminator
from exsr_torch.train.decomp import (DecompConfig, DecompTrainer,
                                     repeat_z_3_channels, z_to_3_channels)
from exsr_torch.zopt.optimizer import xavier_uniform_like

B, PATCH, NF, DEPTH = 2, 64, 16, 3
GRAD_TOL, METRIC_RTOL, STATS_TOL = 1e-4, 1e-4, 1e-5
SVD = 'SVDinNormedOut_structure_tensor'


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _capture():
    """An optimizer whose state after a step is that step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


@functools.lru_cache(maxsize=None)
def _weights(nz: int, d_in: int):
    """exsr's seeded generator and critic variables (numpy trees)."""
    jg = JDnCNN(JGConfig(n_channels=NF, depth=DEPTH, num_latent_channels=nz))
    jd = JDisc(n_channels=NF, depth=DEPTH, expected_input_size=PATCH // 8,
               norm='layer')
    hb = PATCH // 8
    g_vars = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, hb, hb, 64)),
                     jnp.zeros((1, hb, hb, nz)))
    d_vars = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, hb, hb, d_in)))
    return jg, jd, _np(dict(g_vars)), _np(dict(d_vars))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    uncomp = (255 * rng.uniform(size=(B, PATCH, PATCH, 1))).astype(np.float32)
    qf = rng.integers(5, 50, size=(B,)).astype(np.int32)
    return ({'uncomp': jnp.asarray(uncomp), 'qf': jnp.asarray(qf)},
            {'uncomp': torch.from_numpy(uncomp), 'qf': torch.from_numpy(qf)})


def _trainers(overrides):
    """exsr's trainer (gradient-capturing optimizers) and state, and the
    port's on the same weights."""
    jcfg = JConfig(**{'optimal_z_iters': 2, **overrides})
    nz = jcfg.num_latent_channels
    d_in = 64 * (1 + jcfg.concat_d_input) + (nz if jcfg.inject_z_to_d
                                              else 0)
    jg, jd, g_vars, d_vars = _weights(nz, d_in)

    def g_apply(params, coeffs, z):
        return jg.apply(params, coeffs, z, train=True,
                        mutable=['batch_stats'])[0]

    def g_stats_apply(params, coeffs, z):
        out, mut = jg.apply(params, coeffs, z, train=True,
                            mutable=['batch_stats'])
        return out, mut['batch_stats']

    jtr = JTrainer(jcfg, g_apply, flax_d_adapter(jd),
                   g_stats_apply=g_stats_apply)
    jtr.g_tx = jtr.d_tx = _capture()
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, g_vars),
                            jax.tree.map(jnp.asarray, d_vars),
                            jax.random.PRNGKey(7))
    g = DnCNN(DnCNNConfig(n_channels=NF, depth=DEPTH, num_latent_channels=nz))
    g.load_state_dict(dncnn_from_exsr_vars(g_vars))
    d = DnCNNDiscriminator(n_channels=NF, depth=DEPTH,
                           expected_input_size=PATCH // 8, norm='layer',
                           in_nc=d_in)
    d.load_state_dict(dncnn_d_from_exsr_vars(d_vars))
    tr = DecompTrainer(DecompConfig(**jcfg.__dict__))
    return jtr, jstate, tr, tr.init_state(g, d, 0, 'cpu')


def _theta0(rng, shape):
    b, hb, wb, nz = shape
    a = 100.0 * np.sqrt(6.0 / (nz * hb * wb + b * hb * wb))
    return jax.random.uniform(rng, shape, jnp.float32, -a, a)


def _u(cfg, rng):
    nz = 3 if cfg.svd_mode else cfg.num_latent_channels
    return jax.random.uniform(rng, (B, 1, 1, nz))


def _d_draws(cfg, rng, dual):
    """The draws exsr's ``_d_step`` makes from its state's key."""
    _, z_rng, map_rng, gp_rng, gp_rng2 = jax.random.split(rng, 5)
    hb = PATCH // 8
    draws = {'u': _u(cfg, z_rng),
             'alpha': [jax.random.uniform(k, (B, 1, 1, 1))
                       for k in (gp_rng, gp_rng2)[:2 if dual else 1]]}
    if dual:
        draws['theta0'] = _theta0(map_rng, (B, hb, hb,
                                            cfg.num_latent_channels))
    return _to_torch(draws)


def _g_draws(cfg, rng, dual):
    _, z_rng, map_rng = jax.random.split(rng, 3)
    hb = PATCH // 8
    draws = {'u': _u(cfg, z_rng)}
    if dual:
        draws['theta0'] = _theta0(map_rng, (B, hb, hb,
                                            cfg.num_latent_channels))
    return _to_torch(draws)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_grads(named: dict, ref: dict) -> float:
    assert named.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((named[k] - ref[k]).abs().max()) for k in ref) / scale


def _close_metrics(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)


D_CASES = {
    'single': ({}, False),
    'dual': ({}, True),
    'concat_inject_z': ({'concat_d_input': True, 'inject_z_to_d': True},
                        False),
    'relativistic_dual': ({'relativistic': True}, True),
}


@pytest.mark.parametrize('case', list(D_CASES))
def test_d_step_matches_exsr(case):
    overrides, dual = D_CASES[case]
    jtr, jstate, tr, state = _trainers(overrides)
    jbatch, batch = _batch()
    jnew, jm = jtr.d_step(jstate, jbatch, dual=dual)
    got, metrics = tr.d_grads(state, batch,
                              _d_draws(jtr.cfg, jstate.rng, dual), dual)
    names = [n for n, _ in state.d.named_parameters()]
    ref = dncnn_d_from_exsr_vars({'params': _np(jnew.d_opt)})
    assert _close_grads(dict(zip(names, got)), ref) < GRAD_TOL
    _close_metrics(metrics, jm)


G_CASES = {
    'single': ({}, False),
    'dual': ({}, True),
    'svd_latent_dual': ({'latent_channels': SVD}, True),
    'svd_latent_single': ({'latent_channels': SVD}, False),
}


def _exsr_bn(jstate_g) -> dict:
    sd = dncnn_from_exsr_vars(_np(jstate_g))
    return {k: v for k, v in sd.items() if 'running' in k}


def _bn_gap(g, want: dict) -> float:
    sd = g.state_dict()
    return max(float((sd[k] - v).abs().max()) for k, v in want.items())


@pytest.mark.parametrize('case', list(G_CASES))
def test_g_step_matches_exsr(case):
    """Gradients, metrics, the L_struct ring and the generator's running
    statistics (moved by the static-Z forward only)."""
    overrides, dual = G_CASES[case]
    jtr, jstate, tr, state = _trainers(overrides)
    jbatch, batch = _batch(1)
    jnew, jm = jtr.g_step(jstate, jbatch, dual=dual, use_gan=True)
    got, metrics, ring = tr.g_grads(state, batch,
                                    _g_draws(jtr.cfg, jstate.rng, dual),
                                    dual, True)
    names = [n for n, _ in state.g.named_parameters()]
    ref = {k: v for k, v in dncnn_from_exsr_vars(
        {'params': _np(jnew.g_opt['params'])}).items() if k in names}
    assert _close_grads(dict(zip(names, got)), ref) < GRAD_TOL
    _close_metrics(metrics, jm)
    assert _bn_gap(state.g, _exsr_bn(jnew.g_params)) < STATS_TOL
    if tr.latent_loss_active:
        np.testing.assert_allclose(ring.buffer.numpy(),
                                   np.asarray(jnew.ratio_stats.buffer),
                                   atol=STATS_TOL)
        assert int(ring.count) == int(jnew.ratio_stats.count) == B


def test_bn_statistics_control_fails_with_every_forward_moving_them(
        monkeypatch):
    """The control: with every train-mode forward moving the running
    statistics (the generator's behaviour before ``update_stats`` was
    split from ``train``), a dual G step's statistics leave exsr's by far
    more than the tolerance."""
    jtr, jstate, tr, state = _trainers({})
    jbatch, batch = _batch(1)
    jnew, _ = jtr.g_step(jstate, jbatch, dual=True, use_gan=True)
    monkeypatch.setattr(DecompTrainer, 'forward', staticmethod(
        lambda g, comp, z, update_stats=False: g(comp, z, train=True)))
    tr.g_grads(state, batch, _g_draws(jtr.cfg, jstate.rng, True), True, True)
    assert _bn_gap(state.g, _exsr_bn(jnew.g_params)) > 100 * STATS_TOL


def test_steps_apply_adam_and_move_only_their_own_state():
    """A D step moves D only; a G step moves G and its running statistics;
    both through Adam at ``lr`` (the first step is ``lr * sign(g)``)."""
    *_, tr, state = _trainers({})
    _, batch = _batch()

    def snap(m):
        return [t.detach().clone() for t in m.state_dict().values()]

    def moved(m, before):
        return [not torch.equal(a, b)
                for a, b in zip(m.state_dict().values(), before)]
    g0, d0 = snap(state.g), snap(state.d)
    tr.d_step(state, batch, dual=False)
    assert any(moved(state.d, d0)) and not any(moved(state.g, g0))
    d1 = snap(state.d)
    p0 = [p.detach().clone() for p in state.g.parameters()]
    tr.g_step(state, batch, dual=True)
    assert not any(moved(state.d, d1)) and all(moved(state.g, g0))
    step = max(float((p.detach() - q).abs().max())
               for p, q in zip(state.g.parameters(), p0))
    assert step == pytest.approx(tr.cfg.lr_g, rel=1e-3)


def test_theta0_bound_is_exsr_s():
    """The MAP start is uniform in +-100 sqrt(6 / (nz hb wb + b hb wb)),
    exsr's ``_optimal_z`` bound."""
    shape = (2, 8, 8, 64)
    a = 100.0 * np.sqrt(6.0 / (64 * 8 * 8 + 2 * 8 * 8))
    t = xavier_uniform_like(torch.empty(shape),
                            torch.Generator().manual_seed(0))
    assert float(t.abs().max()) <= a and float(t.abs().max()) > 0.99 * a


@pytest.mark.parametrize('svd', [False, True])
def test_sample_z_matches_exsr(svd):
    cfg = JConfig(latent_channels=SVD if svd else 64)
    jtr = JTrainer(cfg, None, None)
    z_rng = jax.random.PRNGKey(3)
    jz, jsvd = jtr.sample_z(z_rng, B, 4, 5)
    u = jax.random.uniform(z_rng, (B, 1, 1, 3 if svd else 64))
    z, tsvd = DecompTrainer(DecompConfig(**cfg.__dict__)).sample_z(
        torch.from_numpy(np.array(u)), 4, 5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    assert (tsvd is None) == (jsvd is None)
    for k in jsvd or {}:
        np.testing.assert_allclose(tsvd[k].numpy(), np.asarray(jsvd[k]),
                                   atol=1e-6)


def test_output_is_bin_consistent_and_matches_exsr():
    """The generator's train-mode coefficients stay within half a bin of
    the quantised input, and equal exsr's."""
    jtr, jstate, tr, state = _trainers({})
    jbatch, batch = _batch(3)
    qf = batch['qf'].float()
    comp = tr.codec.compress(batch['uncomp'], qf, quantize=True)
    z = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, size=comp.shape[:3] + (64,)).astype(np.float32))
    with torch.no_grad():
        out = tr.forward(state.g, comp, z)
    assert float((out - comp).abs().max()) <= 0.5 + 1e-5
    jcomp = jtr.codec.compress(jbatch['uncomp'],
                               jbatch['qf'].astype(jnp.float32))
    want = jtr.g_apply(jstate.g_params, jcomp, jnp.asarray(z.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('nz', [2, 3, 64])
def test_repeat_z_round_trip_matches_exsr(nz):
    z3 = np.random.default_rng(0).uniform(
        -1, 1, size=(1, 4, 4, 3)).astype(np.float32)
    tiled = repeat_z_3_channels(torch.from_numpy(z3), nz)
    np.testing.assert_array_equal(tiled.numpy(),
                                  np.asarray(j_repeat(jnp.asarray(z3), nz)))
    back = z_to_3_channels(tiled)
    np.testing.assert_allclose(back.numpy(), np.asarray(j_to3(
        j_repeat(jnp.asarray(z3), nz))), atol=1e-6)
    if nz >= 3:
        np.testing.assert_allclose(back.numpy(), z3, atol=1e-6)


@pytest.fixture(scope='module')
def image_dir(tmp_path_factory):
    """Five seeded RGB PNGs of different sizes, one smaller than a
    patch."""
    root = tmp_path_factory.mktemp('jpeg_ds')
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(((80, 96), (64, 64), (40, 72), (100, 70),
                                (96, 96))):
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(
            np.uint8)).save(root / f'im{i}.png')
    return str(root)


DS_CASES = {
    'train_y': dict(qf_spec=(((5, 50), 1.0),), train=True),
    'train_mixed_spec': dict(qf_spec=(((5, 20), 0.3), (30, 0.5),
                                      ((40, 60), 0.2)), train=True),
    'eval_cycle': dict(qf_spec=(((5, 50), 1.0), (10, 1.0), (75, 2.0)),
                       train=False),
    'train_chroma': dict(qf_spec=(((5, 50), 1.0),), train=True,
                         chroma=True),
    'min_size': dict(qf_spec=((20, 1.0),), train=True, min_image_size=64),
}


@pytest.mark.parametrize('case', list(DS_CASES))
def test_jpeg_dataset_matches_exsr(image_dir, case):
    """The same items (crops, edge padding, QFs) for the same generator
    state."""
    kw = DS_CASES[case]
    mine = JPEGDataset(root=image_dir, patch_size=64, **kw)
    ref = JDataset(root=image_dir, patch_size=64, **kw)
    assert mine.paths == ref.paths and len(mine) > 0
    for i in range(len(mine)):
        a = mine.__getitem__(i, rng=np.random.default_rng((9, i)))
        b = ref.__getitem__(i, rng=np.random.default_rng((9, i)))
        assert a['qf'] == b['qf'] and a['qf'].dtype == b['qf'].dtype
        assert a['uncomp'].dtype == np.float32
        np.testing.assert_allclose(a['uncomp'], b['uncomp'], atol=1e-4)
        assert a['uncomp'].shape == (64, 64, 3 if kw.get('chroma') else 1)
