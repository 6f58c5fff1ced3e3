"""The training cell's reference against the port's trainer on the CPU at
a small size (one RRDB, batch 2, the flagship's patch and critic), and
the trainer's planted faults against the cell's limits."""
import pytest
import torch

from benchmark import faults, run, weights
from benchmark.drivers import train as D
from benchmark.reference import rrdb_x4
from benchmark.reference import srgan_train as R

CPU = torch.device('cpu')
SMALL = {'config': {'nb': 1}, 'traffic': {'batch': 2, 'pool': 3}}


def _small(iters=None):
    cell, cfg = run.load_cell('rrdb_x4.train_dual')
    cfg['nb'] = 1
    cell['traffic'].update(batch=2, pool=3)
    if iters is not None:
        cfg['train'] = dict(cfg['train'], optimal_z_iters=iters)
    return cell, cfg


def test_critic_shapes_match_the_port():
    from exsr_torch.models.discriminators import DiscriminatorVGG128
    port = DiscriminatorVGG128(base_nf=64, nb=10, num_2_strides=5,
                               input_patch_size=128).state_dict()
    assert R.critic_shapes(64, 3, 128) == {k: tuple(v.shape)
                                           for k, v in port.items()}


def test_steps_match_the_port_without_the_map_loop():
    """With no MAP iterations (Z* is tanh of the drawn start) the port's
    three steps and the reference's agree to float32 rounding; the MAP
    loop's sign-normalised Adam steps are what makes them part.  The
    gradients carry the penalty's second order through ten layers of
    batch norm: a few 1e-4 of a leaf's norm apart in float32."""
    cell, cfg = _small(iters=0)
    seed = 2 ** 31 + 5
    g_state = weights.make(rrdb_x4.shapes(cfg), cfg['init'], seed, CPU)
    d_state = weights.make(R.critic_shapes(64, 3, 128),
                           cfg['critic']['init'], seed, CPU, stream=1)
    pool = D.batches(cfg, cell, seed, CPU)
    draws = D.Draws(cfg, 2, seed, CPU)
    first = [draws('d'), draws('g'), draws('d')]
    prog = D.Program()
    trainer, state = prog.build(cfg, g_state, d_state, seed, CPU)
    g0, d0 = D._params(state.g), D._params(state.d)
    _, m1 = prog.d_step(trainer, state, pool[0], first[0])
    dg = {k: v.clone() for k, v in D._first_grads(state.d,
                                                   state.d_opt).items()}
    _, m2 = prog.g_step(trainer, state, pool[1], first[1])
    gg = D._first_grads(state.g, state.g_opt)
    _, m3 = prog.d_step(trainer, state, pool[2], first[2])
    got = {'loss': [float(m['l_d_total']) if 'l_d_total' in m
                    else float(m['l_g_total']) for m in (m1, m2, m3)],
           'static': D.static_terms(cfg, m1, m2),
           'g_terms': D.g_fixed_terms(cfg, m2),
           'logits': [float(m1['D_real_1']), float(m1['D_fake_1'])],
           'd_grad': dg, 'g_grad': gg, 'g3': D._params(state.g),
           'd3': D._params(state.d)}
    ref = D.reference_steps(cfg, rrdb_x4, g_state, d_state, pool, first)
    nums = D.compare(cfg, got, ref, g0, d0)
    assert nums['g_loss_gap'] < 1e-4 and nums['d_loss_gap'] < 1e-4
    assert nums['d_static_gap'] < 1e-5 and nums['g_static_gap'] < 1e-4
    assert nums['d_logit_gap'] < 1e-5 and nums['g_terms_gap'] < 1e-5
    assert nums['grad_gap'] < 2e-3 and nums['grad_gap_worst'] < 1e-2
    assert nums['change_gap'] < 5e-3


def _run(program):
    return run.execute('rrdb_x4.train_dual', 2 ** 31 + 5, 0.1, False, CPU,
                       program=program, resize=SMALL)


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch',
                                   'half_batch_g'])
def test_planted_fault_is_not_correct(fault):
    out = _run(faults.Train(fault))
    assert out['correct'] is False
    assert any(c['value'] > c['limit'] for c in out['checks'].values())


def test_sound_trainer_is_correct():
    out = _run(None)
    assert out['correct'] is True and out['attempted'] >= 1
    assert set(out['metrics']) == {'train_iter_ms', 'setup_s'}
    assert list(out)[-1] == 'checks'
    assert set(out['readings']) >= set(out['checks'])


def test_iteration_flops_from_shapes():
    _, cfg = run.load_cell('rrdb_x4.train_dual')
    f_g = 36_633_888 * 16 * 52 * 52        # a generator forward
    # the critic at 128: ten convs and the head, per image
    per_img = (2 * 9 * 3 * 64 * 128 ** 2 + 2 * 16 * 64 * 64 * 64 ** 2
               + 2 * 9 * 64 * 128 * 64 ** 2 + 2 * 16 * 128 * 128 * 32 ** 2
               + 2 * 9 * 128 * 256 * 32 ** 2 + 2 * 16 * 256 * 256 * 16 ** 2
               + 2 * 9 * 256 * 512 * 16 ** 2 + 2 * 16 * 512 * 512 * 8 ** 2
               + 2 * 9 * 512 * 512 * 8 ** 2 + 2 * 16 * 512 * 512 * 4 ** 2
               + 2 * 8192 * 100 + 2 * 100)
    assert D.critic_flops(cfg, 16) == 16 * per_img
    f_d = 16 * per_img
    assert D.iteration_flops(cfg, 16) == (22 + 26) * f_g + 25 * f_d
