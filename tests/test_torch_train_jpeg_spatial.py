"""The port's JPEG trainers on ``data x spatial`` grids of gloo ranks on
the CPU, against ``exsr``'s trainers on the equivalent mesh
(``DecompTrainer`` / ``ChromaDecompTrainer`` with ``rules=ShardingRules(
make_mesh(data, spatial))`` over the conftest's virtual CPU devices,
where XLA splits every image's height) and against the port's
one-process step on the whole batch.

The Y setup: DnCNN nf 16, depth 4 (a halo of 4 block rows), patch 64
(8 block rows), batch 4, two inner MAP iterations, the layer-norm
critic; ``exsr``'s seeded weights carried across, its draws made from
its keys as its steps split them.  The chroma setup is
``tests/test_torch_decomp_chroma.py``'s (depth 3, batch 2; 4 rows of
16 x 16 cells): its D step, then its G step against ``exsr``'s updated
critic.  Grids: 2 x 2 (Y shards of 4 block rows) and 1 x 4 (2 block
rows against the halo of 4, so it spans two neighbours; the chroma
cells one row against 3).  Every rank takes the global batch and draws
and keeps its slice.

Tolerances are ``tests/test_torch_train_ddp.py``'s: gradients within
1e-4 of the largest element, metrics 1e-4 relative (1e-6 absolute), the
running statistics and the L_struct ring 1e-5; every rank ends with the
same gradients, metrics and statistics, bit for bit.  Two planted faults
must fail those checks: the generator's batch norms reduced over the
data group only (the spatial ranks hold other pixels of the same
images), and L_struct, which every rank computes on the whole image,
taken whole instead of its ``1 / spatial`` share.

One launch of four ranks per grid runs every case, beside ``exsr``'s
side in this process; the ranks import this module, which imports JAX
only inside the parent's functions.
"""
import concurrent.futures
import functools
import os
import time

import numpy as np
import pytest
import torch

from test_torch_parallel import run_job, run_ranks

B, PATCH, NF, DEPTH = 4, 64, 16, 4
GRIDS = {'2x2': (2, 2), '1x4': (1, 4)}
GRAD_TOL, METRIC_RTOL, STATS_TOL = 1e-4, 1e-4, 1e-5
SVD = 'SVD_structure_tensor'
# name: (DecompConfig overrides, step, dual, the generator's norm)
CASES = {
    'd_single': ({}, 'd', False, 'batch'),
    'd_dual': ({}, 'd', True, 'batch'),
    'g_single': ({}, 'g', False, 'batch'),
    'g_dual': ({}, 'g', True, 'batch'),
    'g_svd_latent_dual': ({'latent_channels': SVD}, 'g', True, 'batch'),
    'g_instance_dual': ({}, 'g', True, 'instance'),
    # the critic sees Z and the compressed input, gathered whole
    'd_concat_inject_z_dual': ({'concat_d_input': True,
                                'inject_z_to_d': True}, 'd', True, 'batch'),
    'g_concat_inject_z_dual': ({'concat_d_input': True,
                                'inject_z_to_d': True}, 'g', True, 'batch'),
}
CHROMA = ('chroma_d', 'chroma_g')
# planted fault: the case it runs on (the 2 x 2 grid)
FAULTS = {'data_group_bn': 'g_dual', 'whole_lstruct': 'g_svd_latent_dual'}
# image heights that neither grid's spatial ranks split into whole blocks
ODD = {'jpeg': 56, 'chroma': 48}
EXSR_THREADS = 4


def _plant(fault: str):
    """``data_group_bn``: the generator's batch norms over the data group
    only; ``whole_lstruct``: L_struct's whole value on every rank."""
    def plant(tr, state):
        from exsr_torch.parallel.dist import sync_batch_norm
        from exsr_torch.train import decomp
        if fault == 'data_group_bn':
            sync_batch_norm(state.g, tr.grid.mesh.dp)
        else:
            s, real = tr.grid.mesh.spatial, decomp.filter_loss
            decomp.filter_loss = lambda *a, **k: (
                lambda out: (out[0] * s, out[1]))(real(*a, **k))
    return plant


# ------------------------------------------------------------------ ranks
def _rank(init, rank, world, tmp, grid):
    import torch.distributed as dist
    from exsr_torch.parallel.mesh import make_mesh
    from test_torch_parallel import build_trainer
    torch.set_num_threads(1)  # one a rank; ranks share a worker
    dist.init_process_group('gloo', init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh(*GRIDS[grid], device='cpu')
    jobs = torch.load(f'{tmp}/../jobs.pt', weights_only=False)
    res = {case: run_job(job, mesh=mesh) for case, job in jobs.items()}
    if grid == '2x2':
        res['faults'] = {f: run_job(jobs[case], mesh=mesh, plant=_plant(f))
                         for f, case in FAULTS.items()}
    res['odd'] = {}
    for kind, case in (('jpeg', 'g_single'), ('chroma', 'chroma_d')):
        job = jobs[case]
        tr, state = build_trainer(job, mesh=mesh)
        batch = {**job['batch'],
                 'uncomp': job['batch']['uncomp'][:, :ODD[kind]]}
        try:
            if kind == 'jpeg':
                tr.g_grads(state, batch, job['draws'], False, True)
            else:
                tr.local(batch, job['draws'])
        except ValueError as e:
            res['odd'][kind] = str(e)
    torch.save(res, f'{tmp}/r{rank}.pt')
    dist.destroy_process_group()


# ----------------------------------------------------------------- parent
def _d_in(cfg) -> int:
    """The critic's input channels: ``[z, comp, x]`` as asked for."""
    return 64 * (1 + cfg.concat_d_input) + (cfg.num_latent_channels
                                             if cfg.inject_z_to_d else 0)


@functools.lru_cache(maxsize=None)
def _weights(nz: int, norm: str, d_in: int = 64):
    """``exsr``'s seeded generator and critic and their variables."""
    import jax
    import jax.numpy as jnp
    from exsr.models.dncnn import (DnCNN as JDnCNN, DnCNNConfig as JGConfig,
                                   DnCNNDiscriminator as JDisc)
    import test_torch_decomp as TD
    jg = JDnCNN(JGConfig(n_channels=NF, depth=DEPTH, num_latent_channels=nz,
                         norm=norm))
    jd = JDisc(n_channels=NF, depth=DEPTH, expected_input_size=PATCH // 8,
               norm='layer')
    hb = PATCH // 8
    g_vars = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, hb, hb, 64)),
                     jnp.zeros((1, hb, hb, nz)))
    d_vars = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, hb, hb, d_in)))
    return jg, jd, TD._np(dict(g_vars)), TD._np(dict(d_vars))


def _exsr_trainer(case: str, rules):
    """``exsr``'s Y trainer of a case (gradient-capturing optimizers) and
    its state, the batch sharded by ``rules``."""
    import jax
    import jax.numpy as jnp
    from exsr.train.decomp import (DecompConfig as JConfig,
                                   DecompTrainer as JTrainer)
    from exsr.train.srragan import flax_d_adapter
    import test_torch_decomp as TD
    overrides, _, _, norm = CASES[case]
    jcfg = JConfig(**{'optimal_z_iters': 2, **overrides})
    jg, jd, g_vars, d_vars = _weights(jcfg.num_latent_channels, norm,
                                      _d_in(jcfg))

    def g_apply(params, coeffs, z):
        return jg.apply(params, coeffs, z, train=True,
                        mutable=['batch_stats'])[0]

    def g_stats_apply(params, coeffs, z):
        out, mut = jg.apply(params, coeffs, z, train=True,
                            mutable=['batch_stats'])
        return out, mut['batch_stats']

    jtr = JTrainer(jcfg, g_apply, flax_d_adapter(jd),
                   g_stats_apply=g_stats_apply if norm == 'batch' else None,
                   rules=rules)
    jtr.g_tx = jtr.d_tx = TD._capture()
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, g_vars),
                            jax.tree.map(jnp.asarray, d_vars),
                            jax.random.PRNGKey(7))
    return jtr, jstate


def _batch():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    uncomp = (255 * rng.uniform(size=(B, PATCH, PATCH, 1))).astype(np.float32)
    qf = rng.integers(5, 50, size=(B,)).astype(np.int32)
    return ({'uncomp': jnp.asarray(uncomp), 'qf': jnp.asarray(qf)},
            {'uncomp': torch.from_numpy(uncomp), 'qf': torch.from_numpy(qf)})


def _draws(cfg, key, step: str, dual: bool) -> dict:
    """The draws ``exsr``'s ``_d_step`` / ``_g_step`` make from its key."""
    import jax
    import test_torch_decomp as TD
    hb = PATCH // 8
    keys = jax.random.split(key, 5 if step == 'd' else 3)
    draws = {'u': jax.random.uniform(
        keys[1], (B, 1, 1, 3 if cfg.svd_mode else cfg.num_latent_channels))}
    if dual:
        draws['theta0'] = TD._theta0(keys[2], (B, hb, hb,
                                                cfg.num_latent_channels))
    if step == 'd':
        draws['alpha'] = [jax.random.uniform(k, (B, 1, 1, 1))
                          for k in keys[3:5][:2 if dual else 1]]
    return TD._to_torch(draws)


def _y_jobs() -> dict:
    """The port's jobs of the Y cases (``exsr``'s weights carried
    across)."""
    from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                           dncnn_from_exsr_vars)
    _, batch = _batch()
    jobs = {}
    for case, (_, step, dual, norm) in CASES.items():
        jtr, jstate = _exsr_trainer(case, None)
        nz = jtr.cfg.num_latent_channels
        _, _, g_vars, d_vars = _weights(nz, norm, _d_in(jtr.cfg))
        jobs[case] = {
            'kind': 'jpeg', 'cfg': dict(jtr.cfg.__dict__),
            'g_kw': dict(n_channels=NF, depth=DEPTH,
                         num_latent_channels=nz, norm=norm),
            'g_state': dncnn_from_exsr_vars(g_vars),
            'd_kw': dict(n_channels=NF, depth=DEPTH,
                         expected_input_size=PATCH // 8, norm='layer',
                         in_nc=_d_in(jtr.cfg)),
            'd_state': dncnn_d_from_exsr_vars(d_vars),
            'step': step, 'dual': dual, 'use_gan': True, 'batch': batch,
            'draws': _draws(jtr.cfg, jstate.rng, step, dual)}
    return jobs


def _y_ref(case: str, grid: str) -> dict:
    """``exsr``'s step of a Y case on a grid's mesh, in the port's
    names."""
    import jax
    import test_torch_decomp as TD
    from exsr.parallel.mesh import ShardingRules, make_mesh
    from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                           dncnn_from_exsr_vars)
    data, sp = GRIDS[grid]
    rules = ShardingRules(make_mesh(data=data, spatial=sp,
                                    devices=jax.devices()[:data * sp]))
    _, step, dual, _ = CASES[case]
    jtr, jstate = _exsr_trainer(case, rules)
    jbatch = rules.shard_batch(_batch()[0])
    assert len(jbatch['uncomp'].sharding.device_set) == data * sp
    if step == 'd':
        jnew, jm = jtr.d_step(jstate, jbatch, dual=dual)
        want = {'grads': dncnn_d_from_exsr_vars(
            {'params': TD._np(jnew.d_opt)})}
    else:
        jnew, jm = jtr.g_step(jstate, jbatch, dual=dual, use_gan=True)
        grads = dncnn_from_exsr_vars({'params': TD._np(jnew.g_opt['params'])})
        want = {'grads': {k: v for k, v in grads.items()
                          if 'running' not in k},
                'running': {f'g.{k}': v for k, v in dncnn_from_exsr_vars(
                    TD._np(jnew.g_params)).items() if 'running' in k}}
        if jtr.cfg.latent_weight is not None and \
                isinstance(jtr.cfg.latent_channels, str):
            want['ring'] = np.asarray(jnew.ratio_stats.buffer)
    want['metrics'] = {k: float(v) for k, v in jm.items()}
    return want


def _chroma(grid: str):
    """``exsr``'s chroma step on a grid's mesh: the D and G references,
    and the port's jobs (the G step's against ``exsr``'s updated
    critic)."""
    import jax
    import test_torch_decomp_chroma as TC
    import test_torch_decomp as TD
    from exsr.parallel.mesh import ShardingRules, make_mesh
    from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                           dncnn_from_exsr_vars)
    data, sp = GRIDS[grid]
    s = TC.build(ShardingRules(make_mesh(data=data, spatial=sp,
                                         devices=jax.devices()[:data * sp])))
    jnew, tr, state = s['jnew'], s['tr'], s['state']
    names = [n for n, _ in state.g.named_parameters()]
    refs = {
        'chroma_d': {'grads': dncnn_d_from_exsr_vars(
            {'params': TD._np(jnew.d_opt)})},
        'chroma_g': {
            'grads': {k: v for k, v in dncnn_from_exsr_vars(
                {'params': TD._np(jnew.gc_opt['params'])}).items()
                if k in names},
            'running': {f'g.{k}': v for k, v in dncnn_from_exsr_vars(
                TD._np(jnew.gc_params)).items() if 'running' in k}}}
    for case, ref in refs.items():
        ref['metrics'] = {k: float(v) for k, v in s['jm'].items()
                          if k.startswith('l_d') == (case == 'chroma_d')}
    base = {'kind': 'chroma', 'cfg': dict(tr.cfg.__dict__),
            'gy_kw': s['gy_kw'], 'gy_state': s['gy_state'],
            'g_kw': s['gc_kw'],
            'g_state': {k: v.clone() for k, v in state.g.state_dict().items()},
            'd_kw': s['d_kw'], 'batch': s['batch'], 'draws': s['draws'],
            'dual': False, 'use_gan': True}
    jobs = {'chroma_d': {**base, 'step': 'd', 'd_state': {
                k: v.clone() for k, v in state.d.state_dict().items()}},
            'chroma_g': {**base, 'step': 'g', 'd_state':
                         dncnn_d_from_exsr_vars(
                             {'params': TD._np(jnew.d_vars['params'])})}}
    return refs, jobs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('train_jpeg_spatial')
    chroma = {grid: _chroma(grid) for grid in GRIDS}
    jobs = {**_y_jobs(), **chroma['2x2'][1]}
    torch.save(jobs, d / 'jobs.pt')
    one = {case: run_job(job) for case, job in jobs.items()}
    dirs = {grid: d / grid for grid in GRIDS}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(GRIDS) + EXSR_THREADS) as ex:
        futs = []
        for grid, sub in dirs.items():
            os.makedirs(sub)
            futs.append(ex.submit(run_ranks,
                                  'test_torch_train_jpeg_spatial',
                                  '_rank', sub, 4, 300, (grid,)))
        refs = {(grid, case): ex.submit(_y_ref, case, grid)
                for grid in GRIDS for case in CASES}
        refs = {k: f.result() for k, f in refs.items()}
        for f in futs:
            f.result()
    print(f'ranks and exsr side {time.perf_counter() - t0:.1f} s')
    for grid in GRIDS:
        refs.update({(grid, case): ref
                     for case, ref in chroma[grid][0].items()})
    ranks = {grid: [torch.load(sub / f'r{r}.pt', weights_only=False)
                    for r in range(4)] for grid, sub in dirs.items()}
    return {'refs': refs, 'one': one, 'ranks': ranks}


def _close_grads(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    scale = max(float(torch.as_tensor(v).abs().max()) for v in ref.values())
    return max(float((got[k] - torch.as_tensor(ref[k])).abs().max())
               for k in ref) / scale


def _check(ref: dict, one: dict, ranks: list) -> None:
    """The ranks' step against ``exsr``'s on the mesh and the port's one
    process; every rank equal to every other."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for part in ('grads', 'running'):
            for k in r0[part]:
                assert torch.equal(r0[part][k], r[part][k]), (part, k)
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
                                         for c in list(CASES) + list(CHROMA)])
def test_grid_step_matches_exsr_mesh_and_one_process(runs, grid, case):
    _check(runs['refs'][grid, case], runs['one'][case],
           [r[case] for r in runs['ranks'][grid]])


@pytest.mark.parametrize('fault', list(FAULTS))
def test_planted_fault_fails_the_checks(runs, fault):
    case = FAULTS[fault]
    ref, one = runs['refs']['2x2', case], runs['one'][case]
    # the sound run of the same case passes; the fault does not
    _check(ref, one, [r[case] for r in runs['ranks']['2x2']])
    with pytest.raises(AssertionError):
        _check(ref, one, [r['faults'][fault] for r in runs['ranks']['2x2']])


def test_unaligned_rows_raise(runs):
    for grid, (_, sp) in GRIDS.items():
        for r in runs['ranks'][grid]:
            assert r['odd'] == {
                kind: f'{sp} spatial ranks cannot give each rank whole '
                      f'blocks of {align} rows of the image height {h}'
                for kind, align, h in (('jpeg', 8, ODD['jpeg']),
                                       ('chroma', 16, ODD['chroma']))}


def test_one_process_arguments():
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    from exsr_torch.parallel.dist import DataParallel
    from exsr_torch.parallel.mesh import Mesh
    from exsr_torch.train.decomp import DecompConfig, DecompTrainer
    from exsr_torch.train.decomp_chroma import ChromaDecompTrainer
    mesh = Mesh(1, 2, torch.device('cpu'))
    with pytest.raises(ValueError, match='dp or mesh'):
        DecompTrainer(DecompConfig(), dp=DataParallel(0, 2), mesh=mesh)
    gy = DnCNN(DnCNNConfig(n_channels=8, depth=3))
    with pytest.raises(ValueError, match='dp or mesh'):
        ChromaDecompTrainer(DecompConfig(chroma_mode=True), gy,
                            dp=DataParallel(0, 2), mesh=mesh)
    # a data x 1 grid is data parallelism; one process is the plain code
    one = DecompTrainer(DecompConfig(), mesh=Mesh(1, 1, torch.device('cpu')))
    assert one.grid is None and one.dp is None
    tr = DecompTrainer(DecompConfig(), mesh=mesh)
    assert tr.grid.align == 8 and tr.grid.margins == 0
    assert ChromaDecompTrainer(DecompConfig(chroma_mode=True), gy,
                               mesh=mesh).grid.align == 16
