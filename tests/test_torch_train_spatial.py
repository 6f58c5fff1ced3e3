"""The port's SR trainer on ``data x spatial`` grids of gloo ranks on the
CPU, against ``exsr``'s trainer on the equivalent mesh
(``SRRaGANTrainer(rules=ShardingRules(make_mesh(data, spatial)))`` over
the conftest's virtual CPU devices, where XLA splits every image's height)
and against the port's one-process step on the whole batch.

``tests/test_torch_train.py``'s tiny setup (RRDBNet nb 1, nf 16, gc 8;
``DiscriminatorVGG128`` base_nf 8 or the pair-input PatchGAN; patch 112,
LR 28, CEM margins 40 HR rows, batch 4, two inner MAP iterations).  The
draws are made from ``exsr``'s keys as its steps split them; every rank
takes the global batch and draws and keeps its slice.  Grids: 2 x 2 (HR
shards of 56 rows, 16 kept on each) and 1 x 4 (28 rows; the margins leave
ranks 0 and 3 no kept row, ranks 1 and 2 sixteen), the latter on the
cases in ``EMPTY_SHARD_CASES``.  Tolerances are
``tests/test_torch_train_ddp.py``'s: gradients within 1e-4 of the largest
element, metrics 1e-4 relative (1e-6 absolute), running statistics and
the L_struct ring 1e-5; every rank ends with the same gradients and
metrics, bit for bit.  Two planted faults must fail those checks: the
losses every rank computes whole taken without their ``1 / spatial``
share, and the pixel means over the rank's own kept count.

``exsr``'s decomposed D step (the pair-input PatchGAN) is wrong on a
mesh whose ``spatial`` axis has four devices, or two beside two on
``data``: its gradients are 19 % (1 x 4) and 560 % (2 x 2) of their
largest element away from its own one-device step, which the port's
one process and its 2 x 1 and 1 x 2 meshes agree with within 5e-6.  The
port's grid step of that case is held to ``exsr``'s one-device step.

The Z-less ``MSRResNet`` (nf 16, nb 2, CEM-wrapped, Z not passed) takes
a non-dual G step on the 2 x 2 grid, held to the port's one process and
to ``exsr``'s one-device step.

One launch of four ranks per grid runs every case, beside ``exsr``'s side
in this process; the ranks import this module, which imports JAX only
inside the parent's functions.
"""
import concurrent.futures
import os
import time

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

GRIDS = {'2x2': (2, 2), '1x4': (1, 4)}
GRAD_TOL, METRIC_RTOL, STATS_TOL = 1e-4, 1e-4, 1e-5
# name: (TrainConfig overrides, step, dual, critic)
CASES = {
    'd_single': ({}, 'd', False, 'vgg'),
    'd_dual': ({}, 'd', True, 'vgg'),
    'g_dual': ({}, 'g', True, 'vgg'),
    'g_relativistic_dual': ({'relativistic': True}, 'g', True, 'vgg'),
    'g_svd_latent_dual': ({'latent_channels': 'SVD_structure_tensor'}, 'g',
                          True, 'vgg'),
    'g_accum2_dual': ({'grad_accum_g': 2}, 'g', True, 'vgg'),
    'd_decomposed_dual': ({'decomposed_d': True}, 'd', True, 'patch'),
    'g_decomposed_dual': ({'decomposed_d': True}, 'g', True, 'patch'),
    'g_msrresnet': ({}, 'g', False, 'vgg'),
}
# the cases of the Z-less MSRResNet generator (the others run RRDBNet)
PLAIN_CASES = ('g_msrresnet',)
PLAIN_NF, PLAIN_NB = 16, 2
# the 1 x 4 grid's cases (the 2 x 2 grid runs all)
EMPTY_SHARD_CASES = ('d_dual', 'g_dual', 'd_decomposed_dual',
                     'g_decomposed_dual')
# exsr's mesh step is wrong here (module docstring): held to its
# one-device step
EXSR_ONE_DEVICE = ('d_decomposed_dual',) + PLAIN_CASES
# the planted faults, run on the 2 x 2 grid's case
FAULT_CASE = 'g_dual'
FAULTS = ('no_share', 'local_count')
# threads compiling exsr's steps
EXSR_THREADS = 4
# an LR height that neither grid's spatial ranks divide
ODD_LR = 27


def _plant(trainer, fault: str) -> None:
    """``no_share``: the whole losses as they are on every rank;
    ``local_count``: a pixel mean over the rank's own kept pixels."""
    grid = trainer.grid
    if fault == 'no_share':
        grid.part = lambda loss: loss
    else:
        grid.share = lambda e, kept: e.sum() / max(e.numel(), 1)


# ------------------------------------------------------------------ ranks
def _build(job: dict, mesh=None):
    """The port's trainer and a fresh state on the CPU from a job's
    options and weights: the CEM-wrapped RRDBNet (or ``MSRResNet``, which
    takes no Z), on the rank's height shards when ``mesh`` is given."""
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.models.classifiers import MSRResNet
    from exsr_torch.models.discriminators import (DiscriminatorVGG128,
                                                  PatchGANDiscriminator)
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.parallel import spatial
    from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
    cem = CEM.create(CEMConf(scale_factor=4))
    filt = cem.device_filters(3, device='cpu')
    plain = job.get('plain', False)
    if mesh is None:
        wrapped = cem_wrap((lambda m, x, z: m(x)) if plain else
                           (lambda m, x, z: m(x, z)), filt, upscale=4)
        g_apply = lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False)
        g_decomp = lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False,
                                           decompose=True)
    else:
        sharded = spatial.cem_wrap(spatial.rrdbnet_module, filt, 4)
        g_apply = lambda m, x, z: sharded(m, x, None if plain else z, 0,
                                          False, mesh)
        g_decomp = lambda m, x, z: sharded(m, x, z, 0, False, mesh,
                                           decompose=True)
    cfg = TrainConfig(**job['cfg'])
    tr = SRRaGANTrainer(cfg, g_apply, cem.invalidity_margins_hr,
                        g_apply_decomp=g_decomp if cfg.decomposed_d
                        else None, mesh=mesh)
    g = (MSRResNet(nf=PLAIN_NF, nb=PLAIN_NB) if plain else
         RRDBNet(nb=1, nf=16, gc=8, latent_channels=3))
    g.load_state_dict(job['g_state'])
    if job['critic'] == 'vgg':
        d = DiscriminatorVGG128(8, 4, 1, job['d_input'])
    else:
        d = PatchGANDiscriminator(8, 3, decomposed_input=True,
                                  pre_clipping=True)
    d.load_state_dict(job['d_state'])
    return tr, tr.init_state(g, d, 0, 'cpu')


def _run(job: dict, mesh=None, fault=None) -> dict:
    """One step's gradients (by name), metrics, the critic's running
    statistics and the ring."""
    tr, state = _build(job, mesh)
    if fault is not None:
        _plant(tr, fault)
    batch, draws, dual = job['batch'], job['draws'], job['dual']
    args = (state, batch['lr'], batch['hr'], draws, dual)
    ring = None
    if job['step'] == 'd':
        grads, metrics = tr.d_grads(*args)
        module = state.d
    else:
        grads, metrics, ring = tr.g_grads(*args, True)
        module = state.g
    names = [n for n, _ in module.named_parameters()]
    out = {'grads': dict(zip(names, (g.clone() for g in grads))),
           'metrics': {k: float(v) for k, v in metrics.items()},
           'running': {k: v.clone() for k, v in state.d.state_dict().items()
                       if 'running' in k}}
    if ring is not None:
        out['ring'] = (ring.buffer.clone(), int(ring.count),
                       int(ring.cursor))
    return out


def _rank(init, rank, world, tmp, grid):
    import torch.distributed as dist
    from exsr_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)  # one a rank; ranks share a worker
    dist.init_process_group('gloo', init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh(*GRIDS[grid], device='cpu')
    jobs = torch.load(f'{tmp}/../jobs.pt', weights_only=False)
    res = {case: _run(job, mesh) for case, job in jobs.items()
           if case in _cases(grid)}
    if grid == '2x2':
        res['faults'] = {f: _run(jobs[FAULT_CASE], mesh, f) for f in FAULTS}
    tr, state = _build(jobs['g_dual'], mesh)
    res['kept'] = tr.grid.heights(jobs['g_dual']['d_input'])
    b = jobs['g_dual']['batch']
    try:
        tr.g_grads(state, b['lr'][:, :ODD_LR], b['hr'][:, :4 * ODD_LR],
                   {'u': jobs['g_dual']['draws']['u']}, False, True)
    except ValueError as e:
        res['odd'] = str(e)
    torch.save(res, f'{tmp}/r{rank}.pt')
    dist.destroy_process_group()


def _cases(grid: str) -> tuple:
    return tuple(CASES) if grid == '2x2' else EMPTY_SHARD_CASES


# ----------------------------------------------------------------- parent
def _plain_trainers(setup, overrides):
    """``exsr``'s trainer and state with the CEM-wrapped ``MSRResNet``, and
    the port's on the same weights (``tests/test_torch_train.py``'s
    ``_trainers`` for the Z-less generator)."""
    import jax
    import jax.numpy as jnp
    import test_torch_train as TS
    from exsr.cem.cem import CEM as JCEM, CEMConf as JCEMConf, \
        cem_wrap as jcem_wrap
    from exsr.models.classifiers import MSRResNet as JMSR
    from exsr_torch.models.classifiers import MSRResNet
    from exsr_torch.models.convert import from_exsr_flat_params
    jtr0, jstate0, tr0, state0 = TS._trainers(setup, overrides)
    jmsr = JMSR(nf=PLAIN_NF, nb=PLAIN_NB, upscale=4)
    lr = setup['batch']['lr']
    params = jmsr.init(jax.random.PRNGKey(3), jnp.zeros((1,) + lr.shape[1:]))
    jwrapped = jcem_wrap(lambda p, x, z: jmsr.apply(p, x),
                         JCEM.create(JCEMConf(scale_factor=4))
                         .device_filters(3), upscale=4)
    jtr = type(jtr0)(jtr0.cfg, lambda p, x, z: jwrapped(p, x, z, 0,
                                                       pre_pad=False),
                     jtr0.d_apply, margins_hr=setup['margins'])
    jstate = jtr.init_state(params, jstate0.d_vars, jax.random.PRNGKey(7))
    g = MSRResNet(nf=PLAIN_NF, nb=PLAIN_NB)
    g.load_state_dict(from_exsr_flat_params(TS._np(params)))
    return jtr, jstate, tr0, tr0.init_state(g, state0.d, 0, 'cpu')


def _draws(jtr, state, hr_shape, step, dual):
    """The draws ``exsr``'s ``_d_step`` / ``_g_step`` make from its key
    (``tests/test_torch_train.py``'s ``_exsr_d`` and ``_exsr_g`` make
    the same inside the step)."""
    import jax
    import test_torch_train as TS
    cfg = jtr.cfg
    b, hh, wh = hr_shape[:3]
    nz = cfg.num_latent_channels
    accum = max(1, cfg.grad_accum_d if step == 'd' else cfg.grad_accum_g)
    bm = b // accum
    if step == 'd':
        _, z_rng, map_rng, gp_rng, _ = jax.random.split(state.rng, 5)
        if accum == 1:
            gp_rngs = [jax.random.split(gp_rng, 2)]
        else:
            gp_rngs = jax.random.split(gp_rng, (accum, 2))
    else:
        _, z_rng, map_rng = jax.random.split(state.rng, 3)
    map_rngs = [map_rng] if accum == 1 else jax.random.split(map_rng, accum)
    draws = {'u': jax.random.uniform(z_rng, (b, 1, 1, nz)),
             'theta0': [TS._theta0(map_rngs[i], (bm, hh, wh, nz))
                        for i in range(accum)]}
    if step == 'd':
        draws['alpha'] = [[jax.random.uniform(gp_rngs[i][j], (bm, 1, 1, 1))
                           for j in range(2 if dual else 1)]
                          for i in range(accum)]
    return TS._to_torch(draws)


def _exsr_side(setup, states):
    """``exsr``'s step on each grid's mesh, per case: gradients, metrics,
    the critic's running statistics and the ring, in the port's names."""
    import jax
    import test_torch_train as TS
    from exsr.parallel.mesh import ShardingRules, make_mesh
    from exsr_torch.models.convert import d_from_exsr_vars, from_exsr_params
    jbatch, _ = TS._batch(setup)
    work = []
    for grid, (data, sp) in [(None, (1, 1))] + list(GRIDS.items()):
        rules = ShardingRules(make_mesh(data=data, spatial=sp,
                                        devices=jax.devices()[:data * sp]))
        sharded = rules.shard_batch(jbatch)
        assert len(sharded['hr'].sharding.device_set) == data * sp
        cases = EXSR_ONE_DEVICE if grid is None else [
            c for c in _cases(grid) if c not in EXSR_ONE_DEVICE]
        work += [(grid, case, rules, sharded) for case in cases]

    def step_of(grid, case, rules, sharded):
        _, step, dual, _ = CASES[case]
        jtr, jstate = states[case]
        jstate = rules.replicate(jstate)
        if case in PLAIN_CASES:
            from exsr_torch.models.convert import from_exsr_flat_params
            grads, metrics, stats, _ = TS._exsr_g(jtr, jstate, sharded, dual,
                                                  True)
            want = {'grads': from_exsr_flat_params(TS._np(grads)),
                    'ring': np.asarray(stats.buffer)}
        elif step == 'd':
            grads, metrics, stats, _ = TS._exsr_d(jtr, jstate, sharded, dual)
            want = {'grads': d_from_exsr_vars({'params': TS._np(grads)})}
            if 'batch_stats' in stats:
                want['running'] = {
                    k: v for k, v in d_from_exsr_vars(
                        {'params': TS._np(jstate.d_vars['params']),
                         'batch_stats': TS._np(stats['batch_stats'])}
                    ).items() if 'running' in k}
        else:
            grads, metrics, stats, _ = TS._exsr_g(jtr, jstate, sharded, dual,
                                                  True)
            want = {'grads': from_exsr_params(TS._np(grads)),
                    'ring': np.asarray(stats.buffer)}
        want['grads'] = {k: torch.as_tensor(v)
                         for k, v in want['grads'].items()}
        want['metrics'] = {k: float(v) for k, v in metrics.items()}
        return want
    # the compiles dominate; XLA's run beside each other
    with concurrent.futures.ThreadPoolExecutor(EXSR_THREADS) as ex:
        futs = {(w[0], w[1]): ex.submit(step_of, *w) for w in work}
        refs = {k: f.result() for k, f in futs.items()}
    for grid in GRIDS:
        for case in EXSR_ONE_DEVICE:
            refs[grid, case] = refs[None, case]
    return refs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import test_torch_train as TS
    setup = TS.setup.__wrapped__()
    d = tmp_path_factory.mktemp('train_spatial')
    _, batch = TS._batch(setup)
    d_input = batch['hr'].shape[1] - 2 * setup['margins']
    jobs, states, one = {}, {}, {}
    for case, (overrides, step, dual, critic) in CASES.items():
        plain = case in PLAIN_CASES
        jtr, jstate, tr, state = (
            _plain_trainers(setup, overrides) if plain else
            TS._trainers(setup, overrides, critic))
        states[case] = (jtr, jstate)
        jobs[case] = {
            'plain': plain, 'cfg': dict(tr.cfg.__dict__),
            'critic': critic,
            'd_input': d_input,
            'g_state': {k: v.clone()
                        for k, v in state.g.state_dict().items()},
            'd_state': {k: v.clone()
                        for k, v in state.d.state_dict().items()},
            'step': step, 'dual': dual, 'batch': batch,
            'draws': _draws(jtr, jstate, batch['hr'].shape, step, dual)}
        one[case] = _run(jobs[case])
    torch.save(jobs, d / 'jobs.pt')
    dirs = {grid: d / grid for grid in GRIDS}
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as ex:
        futs = []
        for grid, sub in dirs.items():
            os.makedirs(sub)
            futs.append(ex.submit(run_ranks, 'test_torch_train_spatial',
                                  '_rank', sub, 4, 300, (grid,)))
        t0 = time.perf_counter()
        refs = _exsr_side(setup, states)
        t_exsr = time.perf_counter() - t0
        for f in futs:
            f.result()
        t_ranks = time.perf_counter() - t0
    print(f'exsr side {t_exsr:.1f} s, ranks {t_ranks:.1f} s')
    ranks = {grid: [torch.load(sub / f'r{r}.pt', weights_only=False)
                    for r in range(4)] for grid, sub in dirs.items()}
    return {'refs': refs, 'one': one, 'ranks': ranks, 'd_input': d_input}


def _close_grads(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((got[k] - ref[k]).abs().max()) for k in ref) / scale


def _check(ref: dict, one: dict, ranks: list) -> None:
    """The ranks' step against ``exsr``'s on the mesh and the port's one
    process."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for k in r0['grads']:
            assert torch.equal(r0['grads'][k], r['grads'][k]), k
        assert r['metrics'] == r0['metrics']
    for want in (ref, one):
        assert _close_grads(r0['grads'], want['grads']) < GRAD_TOL
        assert r0['metrics'].keys() == want['metrics'].keys()
        for k, v in want['metrics'].items():
            np.testing.assert_allclose(r0['metrics'][k], v, rtol=METRIC_RTOL,
                                       atol=1e-6, err_msg=k)
    for k, v in ref.get('running', {}).items():
        for got in ranks + [one]:
            assert float((got['running'][k] - torch.as_tensor(v))
                         .abs().max()) < STATS_TOL, k
    if 'ring' in ref:
        for got in ranks:
            buf, count, cursor = got['ring']
            assert (count, cursor) == one['ring'][1:]
            np.testing.assert_allclose(buf.numpy(), ref['ring'],
                                       atol=STATS_TOL)
            np.testing.assert_allclose(buf.numpy(), one['ring'][0].numpy(),
                                       atol=STATS_TOL)


@pytest.mark.parametrize('grid, case', [(g, c) for g in GRIDS
                                         for c in _cases(g)])
def test_grid_step_matches_exsr_mesh_and_one_process(runs, grid, case):
    _check(runs['refs'][grid, case], runs['one'][case],
           [r[case] for r in runs['ranks'][grid]])


@pytest.mark.parametrize('fault', FAULTS)
def test_planted_fault_fails_the_checks(runs, fault):
    ranks = [r['faults'][fault] for r in runs['ranks']['2x2']]
    # the sound run of the same case passes; the fault does not
    _check(runs['refs']['2x2', FAULT_CASE], runs['one'][FAULT_CASE],
           [r[FAULT_CASE] for r in runs['ranks']['2x2']])
    with pytest.raises(AssertionError):
        _check(runs['refs']['2x2', FAULT_CASE], runs['one'][FAULT_CASE],
               ranks)


def test_kept_rows_and_errors(runs):
    kept = runs['d_input']
    assert [r['kept'] for r in runs['ranks']['1x4']] == [(0, 16, 16, 0)] * 4
    assert [r['kept'] for r in runs['ranks']['2x2']] == [(16, 16)] * 4
    assert kept == 32
    for grid, (_, sp) in GRIDS.items():
        for r in runs['ranks'][grid]:
            assert r['odd'] == (f'{sp} spatial ranks do not divide the LR '
                                f'height {ODD_LR}')


def test_one_process_arguments_and_plain_generators_raise():
    from exsr_torch.models.sft import SFTNet
    from exsr_torch.parallel import spatial
    from exsr_torch.parallel.mesh import Mesh, TrainGrid
    from exsr_torch.parallel.dist import DataParallel
    from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
    mesh = Mesh(1, 4, torch.device('cpu'))
    with pytest.raises(ValueError, match='dp or mesh'):
        SRRaGANTrainer(TrainConfig(), None, 40, dp=DataParallel(0, 2),
                       mesh=mesh)
    with pytest.raises(ValueError, match='spatial > 1'):
        TrainGrid(Mesh(2, 1, torch.device('cpu')), 40)
    rows = spatial.Rows.equal(mesh, 7)
    # MSRResNet and SRResNet have sharded forwards now
    # (tests/test_torch_mesh.py); a generator class without one raises
    with pytest.raises(ValueError, match='no height-sharded forward'):
        spatial.rrdbnet_module(SFTNet(n_blocks=1), torch.zeros(1, 7, 8, 3),
                               None, rows)
