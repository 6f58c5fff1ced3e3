"""The port's trainers on two gloo ranks (``dp``) against the port's
one-process step on the whole batch and against exsr's step on a
2-device mesh (``ShardingRules(make_mesh(data=2, spatial=1))`` over the
conftest's virtual CPU devices), on the CPU.

SR (``tests/test_torch_train.py``'s tiny setup, batch 4, two per rank):
a D step and a dual G step, with ``grad_accum`` 1 and 2 (one sample per
rank in each microbatch) and with the relativistic loss on and off; the
critic's batch norm, its running statistics and the L_struct ring are
the global batch's.  JPEG (``tests/test_torch_decomp.py``'s setup, batch
2, one per rank): the D step and the dual G step, plain and with the SVD
L_struct ring, DnCNN's batch norm and running statistics global.
Chroma (``tests/test_torch_decomp_chroma.py``'s setup, batch 2, one per
rank, one real and one generated Y): the D step, then the G step against
exsr's updated critic, the chroma DnCNN's batch norm and running
statistics global.

Every rank takes the global batch and the same draws and keeps its
slice.  Tolerances are those the one-process parity tests hold against
exsr: gradients within 1e-4 of the largest element, metrics 1e-4
relative (1e-6 absolute), running statistics and the ring 1e-5.  Both
ranks end with the same gradients, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_decomp as TD
import test_torch_decomp_chroma as TC
import test_torch_train as TS
from exsr.parallel.mesh import ShardingRules, make_mesh
from exsr_torch.models.convert import (d_from_exsr_vars,
                                       dncnn_d_from_exsr_vars,
                                       dncnn_from_exsr_vars, from_exsr_params)
from test_torch_parallel import run_job, run_jobs_on_ranks
from test_torch_train import setup  # noqa: F401

GRAD_TOL, METRIC_RTOL, STATS_TOL = TS.GRAD_TOL, TS.METRIC_RTOL, TS.STATS_TOL

SR_CASES = {
    'd_dual': ({}, 'd', True),
    'd_relativistic': ({'relativistic': True}, 'd', False),
    'd_accum2_relativistic_dual': ({'grad_accum_d': 2, 'relativistic': True},
                                   'd', True),
    'g_dual': ({}, 'g', True),
    'g_relativistic_dual': ({'relativistic': True}, 'g', True),
    'g_accum2_dual': ({'grad_accum_g': 2}, 'g', True),
}
JPEG_CASES = {
    'd_dual': ({}, 'd', True),
    'd_relativistic_dual': ({'relativistic': True}, 'd', True),
    'g_dual': ({}, 'g', True),
    'g_svd_latent_dual': ({'latent_channels': TD.SVD}, 'g', True),
}


CHROMA_STEPS = ('d', 'g')


def _rules():
    return ShardingRules(make_mesh(data=2, spatial=1,
                                   devices=jax.devices()[:2]))


def _weights(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope='module')
def sr_runs(setup, tmp_path_factory):  # noqa: F811
    """Per case: exsr's mesh step, the port's one-process step and each
    rank's step."""
    rules = _rules()
    jbatch, batch = TS._batch(setup)
    jbatch = rules.shard_batch(jbatch)
    d_input = batch['hr'].shape[1] - 2 * setup['margins']
    refs, jobs = {}, {}
    for case, (overrides, step, dual) in SR_CASES.items():
        jtr, jstate, tr, state = TS._trainers(setup, overrides)
        jstate = rules.replicate(jstate)
        if step == 'd':
            grads, metrics, stats, draws = TS._exsr_d(jtr, jstate, jbatch,
                                                      dual)
            want = {'grads': d_from_exsr_vars({'params': TS._np(grads)}),
                    'running': {f'd.{k}': v for k, v in d_from_exsr_vars(
                        {'params': TS._np(jstate.d_vars['params']),
                         'batch_stats': TS._np(stats['batch_stats'])}
                    ).items() if 'running' in k}}
        else:
            grads, metrics, stats, draws = TS._exsr_g(jtr, jstate, jbatch,
                                                      dual, True)
            want = {'grads': from_exsr_params(TS._np(grads)),
                    'ring': np.asarray(stats.buffer)}
        want['metrics'] = {k: float(v) for k, v in metrics.items()}
        refs[case] = want
        jobs[case] = {
            'kind': 'sr', 'cfg': dict(tr.cfg.__dict__),
            'g_kw': dict(nb=1, nf=16, gc=8, latent_channels=3),
            'g_state': _weights(state.g),
            'd_kw': dict(base_nf=8, nb=4, num_2_strides=1,
                         input_patch_size=d_input),
            'd_state': _weights(state.d), 'step': step, 'dual': dual,
            'use_gan': True, 'batch': batch, 'draws': TS._to_torch(draws)}
    ranks = run_jobs_on_ranks(jobs, tmp_path_factory.mktemp('sr_ddp'))
    return {case: (refs[case], run_job(jobs[case]), [r[case] for r in ranks])
            for case in SR_CASES}


def _jpeg_exsr(overrides, rules):
    """exsr's JPEG trainer with the batch sharded on a 2-device mesh
    (``rules``), its optimizers capturing the gradients; the port's
    one-process trainer on the same weights."""
    from exsr.train.decomp import DecompTrainer as JTrainer
    from exsr.train.srragan import flax_d_adapter
    jtr0, jstate0, tr, state = TD._trainers(overrides)
    jtr = JTrainer(jtr0.cfg, jtr0.g_apply, flax_d_adapter(
        TD._weights(*_jpeg_widths(jtr0.cfg))[1]),
        g_stats_apply=jtr0.g_stats_apply, rules=rules)
    jtr.g_tx = jtr.d_tx = TD._capture()
    jstate = jtr.init_state(jstate0.g_params, jstate0.d_vars,
                            jax.random.PRNGKey(7))
    return jtr, jstate, tr, state


def _jpeg_widths(cfg):
    nz = cfg.num_latent_channels
    return nz, 64 * (1 + cfg.concat_d_input) + (nz if cfg.inject_z_to_d
                                                 else 0)


@pytest.fixture(scope='module')
def jpeg_runs(tmp_path_factory):
    rules = _rules()
    refs, jobs = {}, {}
    for case, (overrides, step, dual) in JPEG_CASES.items():
        jtr, jstate, tr, state = _jpeg_exsr(overrides, rules)
        jbatch, batch = TD._batch(0 if step == 'd' else 1)
        draws = (TD._d_draws if step == 'd' else TD._g_draws)(
            jtr.cfg, jstate.rng, dual)
        names = [n for n, _ in (state.d if step == 'd' else state.g)
                 .named_parameters()]
        if step == 'd':
            jnew, jm = jtr.d_step(jstate, rules.shard_batch(jbatch),
                                  dual=dual)
            want = {'grads': dncnn_d_from_exsr_vars(
                {'params': TS._np(jnew.d_opt)})}
        else:
            jnew, jm = jtr.g_step(jstate, rules.shard_batch(jbatch),
                                  dual=dual, use_gan=True)
            want = {'grads': {k: v for k, v in dncnn_from_exsr_vars(
                {'params': TS._np(jnew.g_opt['params'])}).items()
                if k in names},
                'running': {f'g.{k}': v for k, v in dncnn_from_exsr_vars(
                    TS._np(jnew.g_params)).items() if 'running' in k}}
            if tr.latent_loss_active:
                want['ring'] = np.asarray(jnew.ratio_stats.buffer)
        want['metrics'] = {k: float(v) for k, v in jm.items()}
        refs[case] = want
        nz, d_in = _jpeg_widths(jtr.cfg)
        jobs[case] = {
            'kind': 'jpeg', 'cfg': dict(tr.cfg.__dict__),
            'g_kw': dict(n_channels=TD.NF, depth=TD.DEPTH,
                         num_latent_channels=nz),
            'g_state': _weights(state.g),
            'd_kw': dict(n_channels=TD.NF, depth=TD.DEPTH,
                         expected_input_size=TD.PATCH // 8, norm='layer',
                         in_nc=d_in),
            'd_state': _weights(state.d), 'step': step, 'dual': dual,
            'use_gan': True, 'batch': batch, 'draws': draws}
    ranks = run_jobs_on_ranks(jobs, tmp_path_factory.mktemp('jpeg_ddp'))
    return {case: (refs[case], run_job(jobs[case]), [r[case] for r in ranks])
            for case in JPEG_CASES}


@pytest.fixture(scope='module')
def chroma_runs(tmp_path_factory):
    """exsr's chroma step with its batch sharded on the 2-device mesh; the
    port's D step from the same weights and its G step against exsr's
    updated critic (as exsr's G step sees it), in one process and on
    each rank."""
    s = TC.build(rules=_rules())
    jnew, tr, state = s['jnew'], s['tr'], s['state']
    base = {'kind': 'chroma', 'cfg': dict(tr.cfg.__dict__),
            'gy_kw': s['gy_kw'], 'gy_state': s['gy_state'],
            'g_kw': s['gc_kw'], 'g_state': _weights(state.g),
            'd_kw': s['d_kw'], 'batch': s['batch'], 'draws': s['draws'],
            'dual': False, 'use_gan': True}
    names = [n for n, _ in state.g.named_parameters()]
    refs = {
        'd': {'grads': dncnn_d_from_exsr_vars(
                  {'params': TS._np(jnew.d_opt)})},
        'g': {'grads': {k: v for k, v in dncnn_from_exsr_vars(
                  {'params': TS._np(jnew.gc_opt['params'])}).items()
                  if k in names},
              'running': {f'g.{k}': v for k, v in dncnn_from_exsr_vars(
                  TS._np(jnew.gc_params)).items() if 'running' in k}}}
    for step, ref in refs.items():
        ref['metrics'] = {k: float(v) for k, v in s['jm'].items()
                          if k.startswith('l_d') == (step == 'd')}
    jobs = {
        'd': {**base, 'step': 'd', 'd_state': _weights(state.d)},
        'g': {**base, 'step': 'g', 'd_state': dncnn_d_from_exsr_vars(
            {'params': TS._np(jnew.d_vars['params'])})}}
    ranks = run_jobs_on_ranks(jobs, tmp_path_factory.mktemp('chroma_ddp'))
    return {step: (refs[step], run_job(jobs[step]), [r[step] for r in ranks])
            for step in CHROMA_STEPS}


def _check(exsr_ref: dict, one: dict, ranks: list) -> None:
    r0, r1 = ranks
    for k in r0['grads']:
        assert torch.equal(r0['grads'][k], r1['grads'][k]), k
    assert r0['metrics'] == r1['metrics']
    for ref in (exsr_ref, one):
        grads = {k: torch.as_tensor(v) for k, v in ref['grads'].items()}
        assert TS._close_grads(r0['grads'], grads) < GRAD_TOL
        TS._close_metrics(r0['metrics'], ref['metrics'])
    for k, v in exsr_ref.get('running', {}).items():
        for got in (r0, r1, one):
            assert float((got['running'][k] - torch.as_tensor(v))
                         .abs().max()) < STATS_TOL, k
    if 'ring' in exsr_ref:
        for got in (r0, r1):
            buf, count, cursor = got['ring']
            assert (count, cursor) == one['ring'][1:]
            np.testing.assert_allclose(buf.numpy(), exsr_ref['ring'],
                                       atol=STATS_TOL)
            np.testing.assert_allclose(buf.numpy(), one['ring'][0].numpy(),
                                       atol=STATS_TOL)


@pytest.mark.parametrize('case', list(SR_CASES))
def test_sr_step_on_two_ranks_matches_one_process_and_exsr_mesh(sr_runs,
                                                                 case):
    _check(*sr_runs[case])


@pytest.mark.parametrize('case', list(JPEG_CASES))
def test_jpeg_step_on_two_ranks_matches_one_process_and_exsr_mesh(
        jpeg_runs, case):
    _check(*jpeg_runs[case])


@pytest.mark.parametrize('step', CHROMA_STEPS)
def test_chroma_step_on_two_ranks_matches_one_process_and_exsr_mesh(
        chroma_runs, step):
    _check(*chroma_runs[step])


def test_exsr_mesh_step_is_sharded():
    """The reference really runs on two devices: its batch's leaves are
    split over them."""
    rules = _rules()
    jbatch, _ = TD._batch(0)
    sharded = rules.shard_batch(jbatch)
    assert len(sharded['uncomp'].sharding.device_set) == 2
    assert sharded['uncomp'].addressable_shards[0].data.shape[0] == 1
    assert jnp.array_equal(sharded['uncomp'], jbatch['uncomp'])
