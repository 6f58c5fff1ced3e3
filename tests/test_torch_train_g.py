"""The port's SR trainer's G step against exsr's, on the CPU, on exsr's
tiny setup and exsr's draws (``tests/test_torch_train.py`` has the setup,
the D step and the tolerances).

The dual G steps' gradients are held within 1e-4 of the largest element of
exsr's.  In the non-dual steps that is below fp32's own rounding: the last
HR conv moves the output by what is almost a constant, which the CEM all
but removes, so its gradient is a sum that cancels down to rounding level.
exsr's own fp32 gradient lies 0.9e-4 to 2.1e-4 (of the largest element)
from the same step in float64, the port's 1.4e-4 to 2.4e-4, all of it in
that conv.  So the non-dual steps are held two ways: the port in float64
(``sepfilter.float64_reference``: the CPU's plain CEM filters in
float64) within 1e-6 of exsr in float64, the same function to
rounding; and the port's fp32 gradient as close to exsr's float64 one as
exsr's own fp32 gradient is, within a factor of three, or within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exsr_torch.ops.kernels.sepfilter as SF
from exsr.ops.structure_tensor import svd_to_latent_z
from exsr_torch.models.convert import from_exsr_params
from test_torch_train import (B, GRAD_TOL, METRIC_RTOL, STATS_TOL,  # noqa
                              _batch, _close_grads, _close_metrics, _exsr_g,
                              _np, _to_torch, _trainers, setup)


def _exsr_float64_grads(jtr, jstate, setup, u, use_gan):
    """exsr's non-dual G gradients in float64 on the same draws ``u``
    (``sample_z``'s mapping, written out for given draws)."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        state = jstate.replace(g_params=f64(jstate.g_params),
                               d_vars=f64(jstate.d_vars))
        lr_img, hr = (f64(setup['batch'][k]) for k in ('lr', 'hr'))
        u = f64(u.numpy())
        b, hh, wh = hr.shape[:3]
        theta = 2 * jnp.pi * u[..., -1]
        svd = {'theta': theta, 'lambda0_ratio': u[..., 0],
               'lambda1_ratio': u[..., 1]}
        z = jnp.broadcast_to(svd_to_latent_z(u[..., 0], u[..., 1], theta),
                             (b, hh, wh, 3))
        grads, _, _ = jax.jit(jtr._g_grads, static_argnums=(7, 8))(
            state, lr_img, jtr.unpad(hr), z, svd, jax.random.PRNGKey(0),
            state.ratio_stats, False, use_gan)
        return {k: v.double() for k, v in from_exsr_params(
            _np(grads)).items()}


def _port_float64_grads(setup, overrides, u, use_gan):
    """The port's non-dual G gradients in float64 on the same draws."""
    _, _, tr, state = _trainers(setup, overrides)
    state.g.double()
    state.d.double()
    state.ratio_stats.buffer = state.ratio_stats.buffer.double()
    _, batch = _batch(setup)
    with SF.float64_reference():
        grads, _, _ = tr.g_grads(state, batch['lr'].double(),
                                 batch['hr'].double(), {'u': u.double()},
                                 False, use_gan)
    return dict(zip([n for n, _ in state.g.named_parameters()], grads))


G_CASES = {
    'gan': ({}, False, True),
    'no_gan': ({}, False, False),
    'gan_dual': ({}, True, True),
    'relativistic_dual': ({'relativistic': True}, True, True),
    'vanilla_pixel': ({'gan_type': 'vanilla', 'pixel_weight': 1.0}, False,
                      True),
    'decomposed_dual': ({'decomposed_d': True}, True, True),
    'accum2_dual': ({'grad_accum_g': 2}, True, True),
}


@pytest.mark.parametrize('case', list(G_CASES))
def test_g_step_matches_exsr(setup, case):
    overrides, dual, use_gan = G_CASES[case]
    d_kind = 'patch' if overrides.get('decomposed_d') else 'vgg'
    jtr, jstate, tr, state = _trainers(setup, overrides, d_kind)
    jbatch, batch = _batch(setup)
    grads, metrics, stats, draws = _exsr_g(jtr, jstate, jbatch, dual,
                                           use_gan)
    draws = _to_torch(draws)
    d_before = {k: v.clone() for k, v in state.d.state_dict().items()}
    got, got_metrics, got_stats = tr.g_grads(state, batch['lr'],
                                             batch['hr'], draws, dual,
                                             use_gan)
    names = [n for n, _ in state.g.named_parameters()]
    ref = from_exsr_params(_np(grads))
    got_named = dict(zip(names, got))
    if dual:
        assert _close_grads(got_named, ref) < GRAD_TOL
    else:
        exact = _exsr_float64_grads(jtr, jstate, setup, draws['u'], use_gan)
        exsr_err = _close_grads({k: v.double() for k, v in ref.items()},
                                exact)
        port_err = _close_grads({k: v.double() for k, v in
                                 got_named.items()}, exact)
        assert port_err < max(GRAD_TOL, 3 * exsr_err)
        assert _close_grads(_port_float64_grads(
            setup, overrides, draws['u'], use_gan), exact) < 1e-6
    _close_metrics(got_metrics, metrics)
    assert int(got_stats.count) == int(stats.count) == B
    assert int(got_stats.cursor) == int(stats.cursor)
    np.testing.assert_allclose(got_stats.buffer.numpy(),
                               np.asarray(stats.buffer), atol=STATS_TOL,
                               rtol=METRIC_RTOL)
    # the G step leaves D, its running statistics and its gradients alone
    for k, v in state.d.state_dict().items():
        assert torch.equal(v, d_before[k]), k
    assert all(p.grad is None for p in state.d.parameters())
