"""The port's SR trainer against exsr's, on the CPU: the D and G steps'
gradients, metrics, D's running statistics and the L_struct ring, on
exsr's tiny setup (``tests/test_train.py``: nb 1, nf 16, gc 8, patch 112,
D nb 4 / nf 8 / one stride-2 stage, two inner MAP iterations).

Both trainers start from the same weights (exsr's seeded ones, carried
across by the bridges of ``exsr_torch.models.convert``) and take the same
random numbers: exsr's JAX keys are split as its ``_d_step`` and
``_g_step`` split them, its draws are made from them, and the port takes
those draws through the trainer's ``draws`` argument.  Gradients are
compared, not parameters after Adam, whose first step is nearly
``sign(g)``.  Tolerances: gradients within 1e-4 of the largest element of
exsr's gradient; metrics within 1e-4 relative (1e-6 absolute); running
statistics and the ring within 1e-5 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.cem.cem import CEM as JCEM, CEMConf as JCEMConf, \
    cem_wrap as jcem_wrap
from exsr.models.discriminators import DiscriminatorVGG128 as JVGG, \
    PatchGANDiscriminator as JPatch
from exsr.models.rrdb import RRDBNet as JNet
from exsr.train.srragan import SRRaGANTrainer as JTrainer, \
    TrainConfig as JConfig, flax_d_adapter
from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
from exsr_torch.models.convert import d_from_exsr_vars, from_exsr_params
from exsr_torch.models.discriminators import DiscriminatorVGG128, \
    PatchGANDiscriminator
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig

B = 4
GRAD_TOL, METRIC_RTOL, STATS_TOL = 1e-4, 1e-4, 1e-5


@pytest.fixture(scope='module')
def setup():
    """exsr's tiny setup and the same weights in the port's modules."""
    jcem = JCEM.create(JCEMConf(scale_factor=4))
    jfilt = jcem.device_filters(3)
    cem = CEM.create(CEMConf(scale_factor=4))
    filt = cem.device_filters(3, device='cpu')
    margins = jcem.invalidity_margins_hr
    patch = 4 * (2 * jcem.invalidity_margins_lr + 8)
    lr_size, d_input = patch // 4, patch - 2 * margins
    jg = JNet(nb=1, nf=16, gc=8, latent_channels=3)
    # jitted: one compile in place of one per eager op (~45 s cold)
    g_params = jax.jit(jg.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, lr_size, lr_size, 3)),
                                jnp.zeros((1, patch, patch, 3)))
    jwrapped = jcem_wrap(lambda p, x, z: jg.apply(p, x, z), jfilt, upscale=4)
    wrapped = cem_wrap(lambda m, x, z: m(x, z), filt, upscale=4)
    ds = {}
    for kind, jd, x0 in (
            ('vgg', JVGG(base_nf=8, nb=4, num_2_strides=1,
                         input_patch_size=d_input), None),
            ('patch', JPatch(ndf=8, n_layers=3, decomposed_input=True,
                             pre_clipping=True), 'pair')):
        x = jnp.zeros((1, d_input, d_input, 3))
        ds[kind] = (jd, dict(jax.jit(jd.init)(jax.random.PRNGKey(1),
                                              (x, x) if x0 else x)))
    rng = np.random.default_rng(0)
    batch = {'lr': rng.uniform(size=(B, lr_size, lr_size, 3))
             .astype(np.float32),
             'hr': rng.uniform(size=(B, patch, patch, 3)).astype(np.float32)}
    return dict(
        jg_apply=lambda p, x, z: jwrapped(p, x, z, 0, pre_pad=False),
        jg_decomp=lambda p, x, z: jwrapped(p, x, z, 0, pre_pad=False,
                                           decompose=True),
        g_apply=lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False),
        g_decomp=lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False,
                                         decompose=True),
        g_params=g_params, ds=ds, margins=margins, batch=batch)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trainers(setup, overrides, d_kind='vgg'):
    """exsr's trainer and state, and the port's on the same weights."""
    jcfg = JConfig(**{'optimal_z_iters': 2, 'steps_4_loss_std': 5,
                      **overrides})
    jd, d_vars = setup['ds'][d_kind]
    decomp = jcfg.decomposed_d
    jtr = JTrainer(jcfg, setup['jg_apply'], flax_d_adapter(jd),
                   margins_hr=setup['margins'],
                   g_apply_decomp=setup['jg_decomp'] if decomp else None)
    jstate = jtr.init_state(setup['g_params'], d_vars,
                            jax.random.PRNGKey(7))
    tr = SRRaGANTrainer(TrainConfig(**jcfg.__dict__), setup['g_apply'],
                        setup['margins'],
                        g_apply_decomp=setup['g_decomp'] if decomp else None)
    g = RRDBNet(nb=1, nf=16, gc=8, latent_channels=3)
    g.load_state_dict(from_exsr_params(_np(setup['g_params'])))
    if d_kind == 'vgg':
        d = DiscriminatorVGG128(8, 4, 1, setup['batch']['hr'].shape[1]
                                - 2 * setup['margins'])
    else:
        d = PatchGANDiscriminator(8, 3, decomposed_input=True,
                                  pre_clipping=True)
    d.load_state_dict(d_from_exsr_vars(_np(d_vars)))
    return jtr, jstate, tr, tr.init_state(g, d, 0, 'cpu')


def _theta0(rng, shape):
    """exsr's ``_optimal_z`` start from its key."""
    b, zh, zw, nz = shape
    a = 100.0 * np.sqrt(6.0 / (nz * zh * zw + b * zh * zw))
    return jax.random.uniform(rng, shape, jnp.float32, -a, a)


@functools.partial(jax.jit, static_argnums=(0, 3))
def _exsr_d(jtr, state, batch, dual):
    """exsr's ``_d_step`` up to the optimizer: the averaged gradients,
    metrics, the new batch statistics, and the draws its keys make."""
    cfg = jtr.cfg
    accum = max(1, cfg.grad_accum_d)
    _, z_rng, map_rng, gp_rng, q_rng = jax.random.split(state.rng, 5)
    lr_img, hr = batch['lr'], batch['hr']
    b, hh, wh = hr.shape[:3]
    nz = cfg.num_latent_channels
    draws = {'u': jax.random.uniform(z_rng, (b, 1, 1, nz))}
    z, _ = jtr.sample_z(z_rng, b, hh, wh)
    if cfg.add_quantization_noise:
        draws['noise'] = (jax.random.uniform(q_rng, hr.shape) - 0.5) / 255.0
        hr = hr + draws['noise']
    ref = jtr.unpad(hr)
    stats = {k: v for k, v in state.d_vars.items() if k != 'params'}
    if accum == 1:
        map_rngs, gp_rngs = [map_rng], [jax.random.split(gp_rng, 2)]
    else:
        map_rngs = jax.random.split(map_rng, accum)
        gp_rngs = jax.random.split(gp_rng, (accum, 2))
    bm, n_fakes = b // accum, 2 if dual else 1
    grads, metrics = None, []
    draws['theta0'], draws['alpha'] = [], []
    for i in range(accum):
        sl = slice(i * bm, (i + 1) * bm)
        g, m, new = jtr._d_grads(state, lr_img[sl], ref[sl], z[sl],
                                 map_rngs[i], gp_rngs[i], dual, stats)
        stats = new or stats
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        metrics.append(m)
        draws['theta0'].append(_theta0(map_rngs[i], (bm, hh, wh, nz)))
        draws['alpha'].append([jax.random.uniform(gp_rngs[i][j],
                                                  (bm, 1, 1, 1))
                               for j in range(n_fakes)])
    grads = jax.tree.map(lambda u: u / accum, grads)
    metrics = jax.tree.map(lambda *v: jnp.mean(jnp.stack(v)), *metrics)
    return grads, metrics, stats, draws


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _exsr_g(jtr, state, batch, dual, use_gan):
    """exsr's ``_g_step`` up to the optimizer, and its draws."""
    cfg = jtr.cfg
    accum = max(1, cfg.grad_accum_g)
    _, z_rng, map_rng = jax.random.split(state.rng, 3)
    lr_img, hr = batch['lr'], batch['hr']
    b, hh, wh = hr.shape[:3]
    nz = cfg.num_latent_channels
    z, svd = jtr.sample_z(z_rng, b, hh, wh)
    ref = jtr.unpad(hr)
    map_rngs = [map_rng] if accum == 1 else jax.random.split(map_rng, accum)
    bm = b // accum
    grads, metrics, stats = None, [], state.ratio_stats
    draws = {'u': jax.random.uniform(z_rng, (b, 1, 1, nz)), 'theta0': []}
    for i in range(accum):
        sl = slice(i * bm, (i + 1) * bm)
        svd_i = None if svd is None else {k: v[sl] for k, v in svd.items()}
        g, m, stats = jtr._g_grads(state, lr_img[sl], ref[sl], z[sl], svd_i,
                                   map_rngs[i], stats, dual, use_gan)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        metrics.append(m)
        draws['theta0'].append(_theta0(map_rngs[i], (bm, hh, wh, nz)))
    grads = jax.tree.map(lambda u: u / accum, grads)
    metrics = jax.tree.map(lambda *v: jnp.mean(jnp.stack(v)), *metrics)
    return grads, metrics, stats, draws


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batch(setup):
    return ({k: jnp.asarray(v) for k, v in setup['batch'].items()},
            {k: torch.from_numpy(v) for k, v in setup['batch'].items()})


def _close_grads(named_grads: dict, ref: dict) -> float:
    """Largest difference over every element, as a share of the largest
    element of ``ref``."""
    assert named_grads.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((named_grads[k] - ref[k]).abs().max())
               for k in ref) / scale


def _close_metrics(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)


D_CASES = {
    'wgan-gp': ({}, False, 'vgg'),
    'wgan-gp_dual': ({}, True, 'vgg'),
    'relativistic_noise': ({'relativistic': True,
                            'add_quantization_noise': True}, False, 'vgg'),
    'vanilla_hinge_dual': ({'gan_type': 'vanilla', 'hinge_threshold': 0.5},
                           True, 'vgg'),
    'decomposed_dual': ({'decomposed_d': True}, True, 'patch'),
    'accum2_dual': ({'grad_accum_d': 2}, True, 'vgg'),
}


@pytest.mark.parametrize('case', list(D_CASES))
def test_d_step_matches_exsr(setup, case):
    overrides, dual, d_kind = D_CASES[case]
    jtr, jstate, tr, state = _trainers(setup, overrides, d_kind)
    jbatch, batch = _batch(setup)
    grads, metrics, stats, draws = _exsr_d(jtr, jstate, jbatch, dual)
    draws = _to_torch(draws)
    got, got_metrics = tr.d_grads(state, batch['lr'], batch['hr'], draws,
                                  dual)
    names = [n for n, _ in state.d.named_parameters()]
    ref = d_from_exsr_vars({'params': _np(grads)})
    assert _close_grads(dict(zip(names, got)), ref) < GRAD_TOL
    _close_metrics(got_metrics, metrics)
    # D's running statistics moved as exsr's did (the real pass, then each
    # fake pass; not the penalty's passes)
    if 'batch_stats' in stats:
        want = d_from_exsr_vars({'params': _np(jstate.d_vars['params']),
                                 'batch_stats': _np(stats['batch_stats'])})
        sd = state.d.state_dict()
        for k in want:
            if 'running' in k:
                assert float((sd[k] - want[k]).abs().max()) < STATS_TOL, k


def test_multistep_lr_matches_exsr():
    from exsr.train.srragan import multistep_lr as j_lr
    from exsr_torch.train.srragan import multistep_lr
    for step in (0, 9, 10, 15, 20, 25, 10 ** 6):
        want = float(j_lr(1e-5, (10, 20), 0.5, jnp.asarray(step)))
        assert multistep_lr(1e-5, (10, 20), 0.5, step) == want
    assert multistep_lr(1e-5, (10, 20), 0.5, 25) == pytest.approx(0.25e-5)


def test_lr_scale_scales_the_update_and_the_schedule_applies(setup):
    """Adam's update times ``lr * multistep_lr(step) * lr_scale``: half the
    scale, half the step (an instability rollback); past a milestone, the
    schedule's gamma."""
    _, batch = _batch(setup)
    updates = {}
    for scale, step in ((1.0, 0), (0.5, 0), (1.0, 60_000)):
        *_, tr, state = _trainers(setup, {'range_weight': None,
                                          'pixel_weight': 1.0})
        state.lr_scale, state.step = scale, step
        before = [p.detach().clone() for p in state.g.parameters()]
        draws = tr.draw_g(state, batch['hr'].shape, dual=False)
        tr.g_step(state, batch, dual=False, use_gan=False, draws=draws)
        updates[(scale, step)] = [p.detach() - b for p, b in
                                  zip(state.g.parameters(), before)]
    full = updates[(1.0, 0)]
    for key, ratio in (((0.5, 0), 0.5), ((1.0, 60_000), 0.5)):
        err = max(float((u - ratio * f).abs().max())
                  for u, f in zip(updates[key], full))
        # fp32 parameters (~0.1) hold a ~1e-5 update to ~1e-8
        assert err < 1e-7, key
    assert max(float(f.abs().max()) for f in full) == pytest.approx(
        1e-5, rel=1e-3)


def test_d_and_g_steps_move_their_own_state(setup):
    """A D step moves D, its running statistics and its Adam state only; a
    G step moves G, its Adam state and the ring only."""
    *_, tr, state = _trainers(setup, {})
    _, batch = _batch(setup)

    def snap():
        return {'g': [p.detach().clone() for p in state.g.parameters()],
                'd': [t.detach().clone() for t in state.d.state_dict()
                      .values()],
                'count': int(state.ratio_stats.count),
                'g_opt': len(state.g_opt.state),
                'd_opt': len(state.d_opt.state)}

    def changed(a, b):
        return any(not torch.equal(x, y) for x, y in zip(a, b))
    s0 = snap()
    tr.d_step(state, batch, dual=False)
    s1 = snap()
    assert changed(s0['d'], s1['d']) and not changed(s0['g'], s1['g'])
    assert s1['count'] == 0 and s1['g_opt'] == 0 and s1['d_opt'] > 0
    tr.g_step(state, batch, dual=False)
    s2 = snap()
    assert changed(s1['g'], s2['g']) and not changed(s1['d'], s2['d'])
    assert s2['count'] == B and s2['g_opt'] > 0


def test_checkpoint_round_trip_restore_before_and_controller(setup,
                                                             tmp_path):
    """The train state through the port's checkpoints: everything a step
    carries comes back bit-equal (weights, D's running statistics, both
    Adam states, the ring, the draws' generator, step, lr_scale), with the
    controller state; the save interval, the rollback restore and
    evaluation's loading of the generator."""
    from exsr_torch.apps.eval_sr import load_generator_params
    from exsr_torch.train.checkpoints import CheckpointManager
    *_, tr, state = _trainers(setup, {})
    _, batch = _batch(setup)
    mgr = CheckpointManager(str(tmp_path / 'ck'), max_to_keep=5,
                            save_interval_steps=2)
    saved = {}
    for step in range(1, 6):
        tr.d_step(state, batch, dual=False)
        tr.g_step(state, batch, dual=False)
        tr.advance(state)
        state.lr_scale = 1.0 / step
        ctl = {'step': step, 'generator_started_learning': True,
               'verified_d_saved': step > 2, 'lr_scale': 1.0 / step}
        if mgr.save(step, state, controller_state=ctl):
            saved[step] = _clone(state.state_dict())
    # the first step, then every second one
    assert mgr.all_steps() == [1, 2, 4]
    assert not mgr.save(4, state) and not mgr.save(3, state)
    assert mgr.save(5, state, force=True)
    saved[5] = _clone(state.state_dict())

    *_, tr2, fresh = _trainers(setup, {})
    restored, ctl = mgr.restore(fresh, step=4, with_controller=True)
    assert restored is fresh and ctl['step'] == 4 and ctl['verified_d_saved']
    _assert_equal(fresh.state_dict(), saved[4])
    # the restored generator draws what the saved one would have
    *_, _, again = _trainers(setup, {})
    mgr.restore(again, step=4)
    assert torch.equal(torch.rand(3, generator=fresh.generator),
                       torch.rand(3, generator=again.generator))
    step, fresh = mgr.restore_before(fresh, 3)
    assert step == 2
    _assert_equal(fresh.state_dict(), saved[2])
    step, _ = mgr.restore_before(fresh, 0)
    assert step == 1
    # evaluation takes the generator of the latest step
    params = load_generator_params(str(tmp_path / 'ck'))
    for k, v in saved[5]['g_params'].items():
        assert torch.equal(params[k], v)
    # a step without the controller state warns
    mgr.save(7, state, force=True)
    with pytest.warns(UserWarning, match='controller'):
        _, none = mgr.restore(with_controller=True)
    assert none is None


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_equal(a, b, path=''):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_equal(a[k], b[k], f'{path}/{k}')
    elif isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f'{path}/{i}')
    elif isinstance(b, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path
