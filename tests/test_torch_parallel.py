"""The port's data-parallel layer (``exsr_torch.parallel.dist``) on two gloo
ranks on the CPU, against one process on the whole batch: the synced
batch norm's forward, input and parameter gradients and running
statistics (``exsr``'s batch norm under ``jit`` normalises by the global
batch), and the helpers' gradient, metric and gather reductions.

Each test starts its ranks as subprocesses (:func:`run_ranks`) that join
through a ``file://`` store in ``tmp_path`` (no TCP port, so that parallel
test workers never collide), one torch thread each, under a time limit: a
rank left out of step fails the test instead of hanging the suite.  This
module imports no JAX, so that the ranks start fast; the ranks import it
and run one of its ``_rank_*`` functions.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RANK_TIMEOUT = 120
TOL = 1e-5


def run_ranks(module: str, func: str, tmp_path, world: int = 2,
              timeout: float = RANK_TIMEOUT, args: tuple = ()) -> list:
    """Run ``module.func(init_method, rank, world, tmp_path, *args)`` in
    ``world`` subprocesses, one per rank; their outputs.  Fails when a
    rank fails or the ranks outlast ``timeout`` seconds together."""
    init = f'file://{tmp_path}/dist_init'
    # one thread a rank: the ranks share one test worker's CPU share
    env = {**os.environ, 'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join(
               [ROOT, TESTS, os.environ.get('PYTHONPATH', '')])}
    procs = []
    for rank in range(world):
        # a rank that exits with its gloo group alive aborts now and then
        # ("terminate called without an active exception")
        code = (f'import {module} as m; m.{func}({init!r}, {rank}, '
                f'{world}, {str(tmp_path)!r}, *{args!r}); '
                'import torch.distributed as d; '
                'd.is_initialized() and d.destroy_process_group()')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [(p.communicate()[0] or '')[-2000:] for p in procs]
        raise AssertionError(f'ranks ran past {timeout} s (out of step?): '
                             f'{tails}')
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-4000:]}'
    return outs


def join(init: str, rank: int, world: int):
    """A rank's process group and its :class:`DataParallel`."""
    import torch.distributed as dist
    from exsr_torch.parallel.dist import DataParallel
    torch.set_num_threads(1)  # one a rank; ranks share a worker
    dist.init_process_group('gloo', init_method=init, rank=rank,
                            world_size=world)
    return DataParallel(rank, world)


def _bn_inputs(dtype=torch.float64):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.5, 2.0, size=(4, 5, 6, 7)))
    w = torch.from_numpy(rng.normal(size=x.shape))
    return x.to(dtype), w.to(dtype)


def _bn_run(dp, x, w):
    """One train-mode forward of a batch norm (momentum 0.9) on ``x``
    (NCHW), moving its running statistics, and the gradients of ``sum(out
    * w)``."""
    from exsr_torch.models.discriminators import BatchNorm
    from exsr_torch.parallel.dist import sync_batch_norm
    bn = BatchNorm(5).to(x.dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    sync_batch_norm(bn, dp)
    x = x.clone().requires_grad_()
    out = bn(x, update_stats=True)
    (out * w).sum().backward()
    return {'out': out.detach(), 'x_grad': x.grad,
            'w_grad': bn.weight.grad, 'b_grad': bn.bias.grad,
            'running_mean': bn.running_mean, 'running_var': bn.running_var}


def _rank_bn(init, rank, world, tmp):
    dp = join(init, rank, world)
    x, w = _bn_inputs()
    res = _bn_run(dp, dp.shard(x), dp.shard(w))
    # the parameter gradients are per-rank parts: their sum is the total
    res['w_grad'] = dp.all_sum(res['w_grad'])
    res['b_grad'] = dp.all_sum(res['b_grad'])
    torch.save(res, f'{tmp}/bn{rank}.pt')


def test_synced_batch_norm_matches_one_process(tmp_path):
    run_ranks('test_torch_parallel', '_rank_bn', tmp_path)
    x, w = _bn_inputs()
    want = _bn_run(None, x, w)
    got = [torch.load(tmp_path / f'bn{r}.pt') for r in range(2)]
    for key in ('out', 'x_grad'):
        full = torch.cat([g[key] for g in got])
        assert float((full - want[key]).abs().max()) < TOL, key
    for key in ('w_grad', 'b_grad', 'running_mean', 'running_var'):
        for g in got:
            assert float((g[key] - want[key]).abs().max()) < TOL, key
    # the running statistics moved by the global batch's, not a shard's
    assert float((got[0]['running_mean'] - got[1]['running_mean'])
                 .abs().max()) == 0.0


def _rank_helpers(init, rank, world, tmp):
    from exsr_torch.parallel.dist import local_batch_slice
    dp = join(init, rank, world)
    res = {}
    # gradients: one flat all-reduce, their mean over ranks
    grads = [torch.full((2, 3), float(rank + 1)),
             torch.arange(4.0) * (rank + 1)]
    res['grads'] = dp.reduce_grads(grads)
    # metrics: the scalar ones averaged, the rest passed through
    res['metrics'] = dp.reduce_metrics(
        {'a': torch.tensor(float(rank)), 'b': torch.tensor(2.0 * rank + 1),
         'keep': 'text'})
    # gather in rank order, its gradient summed over ranks' uses
    x = torch.arange(3.0, dtype=torch.float64) + 10 * rank
    x.requires_grad_()
    full = dp.gather(x[None], 0)
    weight = torch.tensor([[1.0], [2.0]], dtype=torch.float64) * (rank + 1)
    (full * weight).sum().backward()
    res['gathered'], res['gather_grad'] = full.detach(), x.grad
    # a global mean with its gradient, and the MAP loop's share
    y = torch.tensor([1.0, 2.0], dtype=torch.float64) * (rank + 1)
    y.requires_grad_()
    m = dp.mean(y)
    m.backward()
    res['mean'], res['mean_grad'] = m.detach(), y.grad
    res['count_mean'] = dp.count_mean(y.detach())
    # the slice, and rank 0's module everywhere
    res['slice'] = local_batch_slice(8, rank, world)
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
    res['broadcast'] = dp.broadcast_(lin).weight.detach()
    torch.save(res, f'{tmp}/h{rank}.pt')


def test_helpers_reduce_gather_and_broadcast(tmp_path):
    run_ranks('test_torch_parallel', '_rank_helpers', tmp_path)
    got = [torch.load(tmp_path / f'h{r}.pt', weights_only=False)
           for r in range(2)]
    for r, g in enumerate(got):
        assert torch.equal(g['grads'][0], torch.full((2, 3), 1.5))
        assert torch.equal(g['grads'][1], torch.arange(4.0) * 1.5)
        assert float(g['metrics']['a']) == 0.5
        assert float(g['metrics']['b']) == 2.0
        assert g['metrics']['keep'] == 'text'
        assert torch.equal(g['gathered'], torch.tensor(
            [[0.0, 1, 2], [10, 11, 12]], dtype=torch.float64))
        # d/dx_r of sum over ranks s of (s + 1) * weight_r * x_r
        assert torch.equal(g['gather_grad'], torch.full(
            (3,), 3.0 * (r + 1), dtype=torch.float64))
        # mean of [1, 2, 2, 4]; its gradient sums both ranks' uses
        assert float(g['mean']) == 2.25
        assert torch.equal(g['mean_grad'],
                           torch.full((2,), 0.5, dtype=torch.float64))
        assert float(g['count_mean']) == 0.75 * (r + 1)
        assert g['slice'] == slice(4 * r, 4 * r + 4)
        assert torch.equal(g['broadcast'], torch.zeros(2, 2))


def _rank_stop(init, rank, world, tmp):
    """A stop request (a SIGINT) that reaches rank 1 alone at step 2; the
    run joins the group this rank already initialised."""
    import os
    from exsr_torch.parallel.dist import RankRun
    join(init, rank, world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    run = RankRun('cpu')
    assert (run.dp.rank, run.dp.world) == (rank, world)
    step = 0
    while not run.stop(rank == 1 and step == 2):
        step += 1
    torch.save(step, f'{tmp}/stop{rank}.pt')


def test_ranks_stop_at_the_same_step(tmp_path):
    """Every rank stops at step 3: one step late, so that no step waits
    on the ranks' flags."""
    run_ranks('test_torch_parallel', '_rank_stop', tmp_path)
    assert [torch.load(tmp_path / f'stop{r}.pt') for r in range(2)] == [3, 3]


def test_local_batch_slice_and_one_rank_is_plain():
    import pytest
    from exsr_torch.parallel.dist import (DataParallel, local_batch_slice,
                                          sync_batch_norm)
    from exsr_torch.models.discriminators import BatchNorm
    assert local_batch_slice(16, 1, 2) == slice(8, 16)
    with pytest.raises(ValueError, match='does not divide'):
        local_batch_slice(6, 0, 4)
    bn = sync_batch_norm(BatchNorm(3), DataParallel(0, 1))
    assert bn.dp is None


def test_init_from_env_without_torchrun_is_one_process(monkeypatch):
    from exsr_torch.parallel.dist import init_from_env
    for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(key, raising=False)
    assert init_from_env('cpu') == (None, 'cpu')


# ------------------------------------------- trainer steps on every rank
def build_trainer(job: dict, dp=None, mesh=None):
    """The port's trainer and a fresh state on the CPU from a job's
    weights and options (``kind`` ``'sr'``: the CEM-wrapped RRDBNet and
    the VGG critic; ``'jpeg'``: DnCNN and its critic; ``'chroma'``: the
    frozen Y DnCNN, the chroma DnCNN and its critic).  ``mesh`` (JPEG
    kinds): a rank of a ``data x spatial`` grid in place of ``dp``."""
    if job['kind'] == 'sr':
        from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
        from exsr_torch.models.discriminators import DiscriminatorVGG128
        from exsr_torch.models.rrdb import RRDBNet
        from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
        cem = CEM.create(CEMConf(scale_factor=4))
        wrapped = cem_wrap(lambda m, x, z: m(x, z),
                           cem.device_filters(3, device='cpu'), upscale=4)
        tr = SRRaGANTrainer(
            TrainConfig(**job['cfg']),
            lambda m, x, z: wrapped(m, x, z, 0, pre_pad=False),
            cem.invalidity_margins_hr, dp=dp)
        g, d = RRDBNet(**job['g_kw']), DiscriminatorVGG128(**job['d_kw'])
    else:
        from exsr_torch.models.dncnn import (DnCNN, DnCNNConfig,
                                             DnCNNDiscriminator)
        from exsr_torch.train.decomp import DecompConfig, DecompTrainer
        from exsr_torch.train.decomp_chroma import ChromaDecompTrainer
        if job['kind'] == 'chroma':
            gy = DnCNN(DnCNNConfig(**job['gy_kw']))
            gy.load_state_dict(job['gy_state'])
            tr = ChromaDecompTrainer(DecompConfig(**job['cfg']), gy, dp=dp,
                                     mesh=mesh)
        else:
            tr = DecompTrainer(DecompConfig(**job['cfg']), dp=dp, mesh=mesh)
        g = DnCNN(DnCNNConfig(**job['g_kw']))
        d = DnCNNDiscriminator(**job['d_kw'])
    g.load_state_dict(job['g_state'])
    d.load_state_dict(job['d_state'])
    return tr, tr.init_state(g, d, 0, 'cpu')


def run_job(job: dict, dp=None, mesh=None, plant=None) -> dict:
    """One D or G step's gradients (by name), metrics (floats), and the
    state it moves: the modules' running statistics and the ring.
    ``plant(trainer, state)`` runs before the step (a planted fault)."""
    tr, state = build_trainer(job, dp, mesh)
    if plant is not None:
        plant(tr, state)
    batch, draws, dual = job['batch'], job['draws'], job['dual']
    d_step, ring = job['step'] == 'd', None
    if job['kind'] == 'chroma':
        batch, draws = tr.local(batch, draws)
        inputs = tr.prepare(batch, draws)
        grads, metrics = (tr.d_grads(state, inputs, draws) if d_step else
                          tr.g_grads(state, inputs, job['use_gan']))
    else:
        args = ((state, batch['lr'], batch['hr'], draws, dual)
                if job['kind'] == 'sr' else (state, batch, draws, dual))
        if d_step:
            grads, metrics = tr.d_grads(*args)
        else:
            grads, metrics, ring = tr.g_grads(*args, job['use_gan'])
    module = state.d if d_step else state.g
    names = [n for n, _ in module.named_parameters()]
    out = {'grads': dict(zip(names, (g.clone() for g in grads))),
           'metrics': {k: float(v) for k, v in metrics.items()},
           'running': {f'{tag}.{k}': v.clone()
                       for tag, m in (('g', state.g), ('d', state.d))
                       for k, v in m.state_dict().items() if 'running' in k}}
    if ring is not None:
        out['ring'] = (ring.buffer.clone(), int(ring.count),
                       int(ring.cursor))
    return out


def _rank_trainer(init, rank, world, tmp):
    dp = join(init, rank, world)
    jobs = torch.load(f'{tmp}/jobs.pt', weights_only=False)
    torch.save({name: run_job(job, dp) for name, job in jobs.items()},
               f'{tmp}/out{rank}.pt')


def run_jobs_on_ranks(jobs: dict, tmp_path, world: int = 2) -> list:
    """Every job on ``world`` gloo ranks; each rank's results."""
    torch.save(jobs, tmp_path / 'jobs.pt')
    run_ranks('test_torch_parallel', '_rank_trainer', tmp_path, world)
    return [torch.load(tmp_path / f'out{r}.pt', weights_only=False)
            for r in range(world)]
