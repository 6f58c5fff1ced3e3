"""The port's training losses, latent loss, discriminators and controller
against exsr's, on the CPU, on the same numpy-seeded inputs and exsr's
weights carried across (``exsr_torch.models.convert.d_from_exsr_vars``).

Tolerances: the losses within 1e-6 relative; the gradient penalty's
parameter gradients within 1e-5 of their largest element; ``filter_loss``'s
losses within 1e-5 (relative above 1: each is the distance between two
ratios near 1), its bounds and ring within 1e-5 relative, its gradients
within 1e-5 of the largest element; the discriminators'
outputs within 1e-5 of the largest, input gradients within 1e-4 of the
largest, running statistics within 1e-6.  The FC head at input 128 is
held to exsr in float64 (its output and input gradient): exsr's fp32 batch norm takes the variance as
E[x^2] - E[x]^2 (flax's fast variance), which at the deep 4 x 4 layers
cancels to a 3.6e-2 error in exsr's own fp32 input gradient.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.losses import filter_loss as JF
from exsr.losses import losses as JL
from exsr.models.discriminators import DiscriminatorVGG128 as JVGG, \
    PatchGANDiscriminator as JPatch
from exsr.train import controller as JC
from exsr_torch.losses import filter_loss as TF
from exsr_torch.losses import losses as TL
from exsr_torch.models.convert import d_from_exsr_vars
from exsr_torch.models.discriminators import BatchNorm, \
    DiscriminatorVGG128, PatchGANDiscriminator
from exsr_torch.train import controller as TC


def _abs_or_rel(a, b):
    """The largest difference, relative where ``b`` exceeds 1."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan-gp'])
@pytest.mark.parametrize('hinge', [None, 0.5])
@pytest.mark.parametrize('real', [True, False])
def test_gan_loss_matches_exsr(gan_type, hinge, real):
    pred = np.random.default_rng(0).normal(size=(4, 5, 5, 1)) \
        .astype(np.float32)
    want = JL.gan_loss(gan_type, jnp.asarray(pred), real, hinge)
    g_want = jax.grad(lambda p: JL.gan_loss(gan_type, p, real, hinge))(
        jnp.asarray(pred))
    t = torch.from_numpy(pred).requires_grad_()
    got = TL.gan_loss(gan_type, t, real, hinge)
    got.backward()
    assert _rel(got.item(), want) < 1e-6
    assert _rel(t.grad.numpy(), g_want) < 1e-6


def test_gan_loss_unknown_type_raises():
    with pytest.raises(NotImplementedError):
        TL.gan_loss('ragan-x', torch.zeros(2), True)


@pytest.mark.parametrize('chroma', [False, True])
def test_range_loss_and_distances_match_exsr(chroma):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 1.5, size=(2, 8, 8, 3)).astype(np.float32)
    y = rng.uniform(size=x.shape).astype(np.float32)
    mask = (rng.uniform(size=(1, 8, 8, 1)) > 0.5).astype(np.float32)
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, mask))
    assert _rel(TL.range_loss(tx, (0.0, 1.0), chroma).item(),
                JL.range_loss(jnp.asarray(x), (0.0, 1.0), chroma)) < 1e-6
    assert _rel(TL.l1(tx, ty).item(), JL.l1(x, y)) < 1e-6
    assert _rel(TL.l2(tx, ty).item(), JL.l2(x, y)) < 1e-6
    assert _rel(TL.masked_l1(tx, ty, tm).item(),
                JL.masked_l1(x, y, mask)) < 1e-6


def _vgg_pair(nf=8, nb=4, strides=1, size=32):
    jd = JVGG(base_nf=nf, nb=nb, num_2_strides=strides,
              input_patch_size=size)
    v = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3)))
    td = DiscriminatorVGG128(nf, nb, strides, size)
    td.load_state_dict(d_from_exsr_vars(jax.tree.map(np.asarray, v)))
    return jd, v, td


def test_gradient_penalty_matches_exsr():
    """exsr's alpha from its key; the penalty and its gradient in D's
    parameters (second order through D, batch norm included)."""
    jd, v, td = _vgg_pair()
    rng = np.random.default_rng(2)
    real, fake = (rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(5)
    alpha = jax.random.uniform(key, (4, 1, 1, 1))

    def j_gp(params):
        return JL.gradient_penalty(
            lambda x: jd.apply({**v, 'params': params}, x, train=True,
                               mutable=['batch_stats'])[0],
            jnp.asarray(real), jnp.asarray(fake), key)
    want, g_want = jax.jit(jax.value_and_grad(j_gp))(v['params'])
    got = TL.gradient_penalty(lambda x: td(x, False), torch.from_numpy(real),
                              torch.from_numpy(fake),
                              torch.from_numpy(np.array(alpha)))
    got.backward()
    assert _rel(got.item(), want) < 1e-6
    ref = d_from_exsr_vars({'params': jax.tree.map(np.asarray, g_want)})
    scale = max(float(t.abs().max()) for t in ref.values())
    named = dict(td.named_parameters())
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in named.items()}
    assert max(float((grads[k] - ref[k]).abs().max())
               for k in ref) / scale < 1e-5


MODES = ['SVDinNormedOut_structure_tensor', 'structure_tensor',
         'SVD_structure_tensor', 'STD_directional']


@pytest.mark.parametrize('mode', MODES)
def test_filter_loss_matches_exsr_over_a_wrapping_ring(mode):
    """Four updates of a 10-wide ring by batches of 4 (it wraps on the
    third): the loss, the ring and its bounds, and the gradient in the SR
    image, which flows through the bounds as in exsr."""
    nch = TF.num_latent_channels(mode)
    assert nch == JF.num_latent_channels(mode)
    # 'STD_directional' measures two ratios from three Z channels; exsr's
    # ring must be two wide for it (its trainer's three-wide ring fails on
    # the update, as the port's does)
    ring = 2 if mode == 'STD_directional' else nch
    jcfg = JF.FilterLossConfig(latent_channels=mode)
    tcfg = TF.FilterLossConfig(latent_channels=mode)
    jstats, tstats = JF.RatioStats.create(ring, 10), TF.RatioStats.create(
        ring, 10)
    rng = np.random.default_rng(3)

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def j_loss(s, st, hr, z, svd):
        loss, new = JF.filter_loss(jcfg, st, s, hr, z, svd)
        return loss.sum(), (loss, new)
    for step in range(4):
        sr, hr = (rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
                  for _ in range(2))
        u = rng.uniform(size=(4, 1, 1, nch)).astype(np.float32)
        z = np.broadcast_to(2 * u - 1, (4, 16, 16, nch)).copy()
        svd = None
        if mode == 'SVD_structure_tensor':
            svd = {'theta': 2 * np.pi * u[..., -1],
                   'lambda0_ratio': u[..., 0], 'lambda1_ratio': u[..., 1]}

        (_, (want, jstats)), g_want = j_loss(
            jnp.asarray(sr), jstats, jnp.asarray(hr), jnp.asarray(z),
            None if svd is None else {k: jnp.asarray(v)
                                      for k, v in svd.items()})
        t_sr = torch.from_numpy(sr).requires_grad_()
        got, tstats = TF.filter_loss(
            tcfg, tstats, t_sr, torch.from_numpy(hr), torch.from_numpy(z),
            None if svd is None else {k: torch.from_numpy(v)
                                      for k, v in svd.items()})
        got.sum().backward()
        assert got.shape == want.shape
        assert _abs_or_rel(got.detach().numpy(), want) < 1e-5, step
        assert _rel(t_sr.grad.numpy(), g_want) < 1e-5, step
        np.testing.assert_allclose(tstats.buffer.detach().numpy(),
                                   np.asarray(jstats.buffer), rtol=1e-5,
                                   atol=1e-7)
        assert int(tstats.cursor) == int(jstats.cursor)
        assert int(tstats.count) == int(jstats.count) == 4 * (step + 1)
        for a, b in zip(tstats.bounds(), jstats.bounds()):
            assert _rel(a.detach().numpy(), b) < 1e-5
        tstats = tstats.detached()
    assert int(tstats.cursor) == 6      # wrapped: 16 values in 10 slots


def test_filter_loss_integer_mode_raises():
    cfg = TF.FilterLossConfig(latent_channels=3)
    x = torch.rand(2, 8, 8, 3)
    with pytest.raises(NotImplementedError):
        TF.filter_loss(cfg, TF.RatioStats.create(3, 10), x, x, x)


def _check_d(jd, v, td, x, update_stats=True, out_tol=1e-5, grad_tol=1e-4,
             x64=False):
    """Output, input gradient and updated running statistics of exsr's D
    and the port's on ``x`` (a pair for the decomposed PatchGAN)."""
    pair = isinstance(x, tuple)
    has_bn = 'batch_stats' in v

    @jax.jit
    def j_apply(variables, xx):
        if has_bn:
            return jd.apply(variables, xx, train=True,
                            mutable=['batch_stats'])
        return jd.apply(variables, xx, train=True), {}

    jx = tuple(map(jnp.asarray, x)) if pair else jnp.asarray(x)
    out, new = j_apply(v, jx)

    def j_sum(xi):
        xx = (jx[0], xi) if pair else xi
        return j_apply(v, xx)[0].sum()
    g_want = jax.jit(jax.grad(j_sum))(jx[1] if pair else jx)
    if x64:
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                     jnp.float64), v)
            x64_ = jnp.asarray(np.asarray(x, np.float64))
            out = j_apply(v64, x64_)[0]
            g_want = jax.jit(jax.grad(
                lambda xi: j_apply(v64, xi)[0].sum()))(x64_)
    tx = tuple(map(torch.from_numpy, x)) if pair else torch.from_numpy(x)
    leaf = tx[1] if pair else tx
    leaf.requires_grad_()
    got = td(tx, update_stats)
    got.sum().backward()
    assert got.shape == out.shape
    assert _rel(got.detach().numpy(), out) < out_tol
    assert _rel(leaf.grad.numpy(), g_want) < grad_tol
    if has_bn and update_stats:
        want = d_from_exsr_vars({'params': jax.tree.map(np.asarray,
                                                        v['params']),
                                 'batch_stats': jax.tree.map(
                                     np.asarray, new['batch_stats'])})
        sd = td.state_dict()
        for k in want:
            if 'running' in k:
                np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                           atol=1e-6, err_msg=k)


def test_vgg128_patch_head_matches_exsr():
    """exsr's tiny setup's critic: nb 4, nf 8, one stride-2 stage, the
    norm-free 1 x 1 logit conv."""
    jd, v, td = _vgg_pair()
    x = np.random.default_rng(4).uniform(size=(4, 32, 32, 3)) \
        .astype(np.float32)
    _check_d(jd, v, td, x)
    assert td.pseudo_fc1.bn is None and not td.pseudo_fc1.act


def test_vgg128_fc_head_matches_exsr():
    """nb 10, nf 8, five stride-2 stages at input 128: the NHWC flatten
    order of the FC head; output and input gradients against exsr in
    float64 (the running statistics against exsr's fp32 step)."""
    jd, v, td = _vgg_pair(nf=8, nb=10, strides=5, size=128)
    x = np.random.default_rng(5).uniform(size=(4, 128, 128, 3)) \
        .astype(np.float32)
    _check_d(jd, v, td, x, x64=True)
    assert tuple(td(torch.from_numpy(x)).shape) == (4, 1)


def test_d_running_stats_update_only_when_asked():
    jd, v, td = _vgg_pair()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    before = {k: t.clone() for k, t in td.state_dict().items()}
    td(x, update_stats=False)
    for k, t in td.state_dict().items():
        assert torch.equal(t, before[k]), k
    td(x, update_stats=True)
    assert not torch.equal(td.conv1.bn.running_var,
                           before['conv1.bn.running_var'])


def test_batch_norm_keeps_the_biased_variance():
    """flax's momentum 0.9 with the batch's biased variance (torch's
    BatchNorm2d would take the unbiased one: n/(n-1) more)."""
    bn = BatchNorm(3)
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(7))
    y = bn(x, update_stats=True)
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(
        y, (x - x.mean(dim=(0, 2, 3), keepdim=True))
        / torch.sqrt(var[None, :, None, None] + 1e-5))


@pytest.mark.parametrize('decomposed', [False, True])
def test_patchgan_matches_exsr(decomposed):
    jd = JPatch(ndf=8, n_layers=3, decomposed_input=decomposed,
                pre_clipping=True)
    rng = np.random.default_rng(8)
    x = rng.uniform(-0.2, 1.2, size=(2, 32, 32, 3)).astype(np.float32)
    low = rng.uniform(size=x.shape).astype(np.float32)
    inp = (low, x) if decomposed else x
    v = jd.init(jax.random.PRNGKey(2), tuple(map(jnp.asarray, inp))
                if decomposed else jnp.asarray(inp))
    td = PatchGANDiscriminator(8, 3, decomposed_input=decomposed,
                               pre_clipping=True)
    td.load_state_dict(d_from_exsr_vars(jax.tree.map(np.asarray, v)))
    _check_d(jd, v, td, inp)


def test_fresh_d_init_follows_exsr_distributions():
    """Kaiming-normal convs (std sqrt(2 / fan_in)), LeCun-normal truncated
    Dense layers (std sqrt(1 / fan_in), nothing beyond 2 / 0.88 std), zero
    biases, batch-norm scale 1."""
    d = DiscriminatorVGG128(base_nf=16, nb=10, num_2_strides=5,
                            input_patch_size=128, seed=3)
    w = d.conv4.conv.weight
    assert abs(float(w.std()) / np.sqrt(2.0 / w[0].numel()) - 1) < 0.05
    fc = d.fc0.weight
    std = np.sqrt(1.0 / fc.shape[1])
    assert abs(float(fc.std()) / std - 1) < 0.05
    assert float(fc.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(float(m.bias.abs().max()) == 0 for m in (d.conv4.conv, d.fc0))
    assert torch.equal(d.conv4.bn.weight, torch.ones(64))
    again = DiscriminatorVGG128(base_nf=16, nb=10, num_2_strides=5,
                                input_patch_size=128, seed=3)
    assert torch.equal(again.fc0.weight, fc)


def test_vgg128_patch_head_too_small_raises():
    with pytest.raises(ValueError):
        DiscriminatorVGG128(base_nf=8, nb=6, num_2_strides=3,
                            input_patch_size=32)


# ------------------------------------------------------------ controller
def _records(seed, n):
    rng = np.random.default_rng(seed)
    return [{'D_logits_diff': float(rng.normal(0.05, 0.1)),
             'Correctly_distinguished': float(rng.uniform()),
             'l_d_real_0': float(rng.normal(0.3, 0.5)),
             'l_d_fake_0': float(rng.normal(-0.3, 0.5))} for _ in range(n)]


@pytest.mark.parametrize('kwargs', [
    dict(d_update_ratio=2, d_valid_steps_4_g=3),
    dict(d_update_ratio=1, d_valid_steps_4_g=2, d_verification='initial'),
    dict(d_update_ratio=1, d_valid_steps_4_g=2,
         d_verification='initial_gradual'),
    dict(d_update_ratio=1, d_verification='current'),
    dict(d_update_ratio=1, d_verification='convergence',
         steps_4_loss_std=20, min_d_prob_ratio_4_g=1.0),
    dict(d_update_ratio=[[1, 10], [0.0, 1.0]], d_valid_steps_4_g=2),
    dict(d_update_ratio=0.5, d_init_iters=3),
])
def test_controller_decisions_match_exsr_on_recorded_sequences(kwargs):
    """The same sequence of D records, G steps and ticks through exsr's
    controller and the port's: every gating decision, rollback check and
    LR scale equal."""
    jc, tc = JC.GANController(**kwargs), TC.GANController(**kwargs)
    for c in (jc, tc):
        c.steps_4_d_convergence = 10
        c.steps_4_loss_std = 8
        c.std_4_lr_drop = 0.3
    for i, rec in enumerate(_records(0, 60)):
        decisions = []
        for c in (jc, tc):
            do_d, do_g = c.want_d_step(), c.want_g_step()
            if do_d:
                c.record_d(rec)
            if do_g:
                c.record_g()
            if c.gd_controller is not None and i % 7 == 0:
                c.gd_controller.update_ratio(rec['Correctly_distinguished'])
            c.tick()
            decisions.append((do_d, do_g, c.check_lr_drop(),
                              c.check_critic_collapse(window=10),
                              c.lr_scale, c.d_verified, c.d_converged))
        assert decisions[0] == decisions[1], i


def test_controller_gating():
    c = TC.GANController(d_update_ratio=2, d_valid_steps_4_g=3,
                         d_init_iters=0)
    assert c.want_d_step()
    assert not c.want_g_step()
    for _ in range(3):
        c.record_d({'D_logits_diff': 1.0, 'Correctly_distinguished': 1.0,
                    'l_d_real_0': 0.1, 'l_d_fake_0': 0.1})
        c.tick()
    c.step = 4
    assert c.want_g_step()
    c.step = 5
    assert not c.want_g_step()
    c.record_d({'D_logits_diff': -1.0, 'Correctly_distinguished': 0.0,
                'l_d_real_0': 0.1, 'l_d_fake_0': 0.1})
    c.step = 6
    assert not c.want_g_step()


def test_controller_lr_drop_and_stop():
    c = TC.GANController(steps_4_loss_std=4, std_4_lr_drop=0.01,
                         base_lr=1e-5)
    for i in range(8):
        c.record_d({'D_logits_diff': 1.0, 'Correctly_distinguished': 1.0,
                    'l_d_real_0': (i % 2) * 10.0, 'l_d_fake_0': 0.0})
    rollback, too_low = c.check_lr_drop()
    assert rollback and not too_low
    assert c.lr_scale == pytest.approx(0.5)
    # ten halvings take 1e-5 below 1e-8
    assert [c.halve_lr() for _ in range(9)][-1]


def test_controller_critic_collapse_guard():
    rng = np.random.default_rng(0)

    def feed(c, n, diff, mag, mag_end=None):
        mag_end = mag if mag_end is None else mag_end
        for i in range(n):
            d = diff + rng.normal(0, 0.003)
            base = mag + (mag_end - mag) * i / max(n - 1, 1)
            m = base * (1 + rng.normal(0, 0.2))
            c.record_d({'D_logits_diff': d, 'Correctly_distinguished': 0.5,
                        'l_d_real_0': m, 'l_d_fake_0': -m})
    for args, fires in (((0.002, 0.4, 1.3), True), ((0.002, 1.2), True),
                        ((0.01, 0.15), False), ((0.008, 0.65, 0.2), False),
                        ((0.005, 0.5), False), ((0.8, 1.5), False)):
        c = TC.GANController()
        feed(c, 250, *args)
        assert c.check_critic_collapse() == fires, args
    c = TC.GANController()
    feed(c, 50, 0.002, 0.4, 1.3)
    assert not c.check_critic_collapse()


def test_gd_update_controller_linear_map():
    g = TC.GDUpdateController([[1, 10], [0.0, 1.0]])
    g.update_ratio(1.0)
    assert g.dg_steps_ratio == pytest.approx(10)
    g.update_ratio(0.0)
    assert g.dg_steps_ratio == pytest.approx(1)


def test_collapse_guard_default_on_for_wgan():
    from exsr_torch.apps.train_sr import default_collapse_guard
    assert default_collapse_guard('wgan-gp') and default_collapse_guard('wgan')
    for t in ('gan', 'vanilla', None, ''):
        assert not default_collapse_guard(t)
