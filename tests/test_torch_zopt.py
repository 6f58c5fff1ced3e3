"""The port's Z-edit engine modules against exsr's, on the CPU: the
optimizer (Adam, min-loss retention, plateau mode, the round loop), every
objective's value and gradient, the histogram loss and its temperature
searches, patches, structure tensors and the session's numpy helpers.
Inputs come from numpy seeds and go through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.ops import structure_tensor as JST
from exsr.utils import misc as JMisc
from exsr.zopt import histogram as JH
from exsr.zopt import objectives as JO
from exsr.zopt import patches as JP
from exsr.zopt.optimizer import ZOptimizer as JZ
from exsr_torch.ops import structure_tensor as TST
from exsr_torch.utils import misc as TMisc
from exsr_torch.zopt import histogram as TH
from exsr_torch.zopt import objectives as TO
from exsr_torch.zopt import patches as TP
from exsr_torch.zopt import optimizer as TOpt
from exsr_torch.zopt.optimizer import ZOptimizer as TZ


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _linear_forward(w, xp):
    """tests/test_zopt.py's toy generator, in either framework."""
    if xp is jnp:
        return lambda z: jax.nn.sigmoid(w * z)
    return lambda z: torch.sigmoid(w * z)


# (forward weight, objective, lr, max_iters, theta0 seed, with frozen mask)
OPTIMIZE_CASES = {
    'l1_convergence': (3.0, 'l1', 0.1, 100, None, False),
    'frozen_mask': (2.0, 'l1', 0.2, 20, None, True),
    'min_loss_oscillating': (None, 'quad', 0.9, 30, None, False),
    'plateau_mode': (1.0, 'l1', 0.5, -10, None, False),
    'random_start': (1.5, 'l1', 0.3, 15, 5, False),
}


@pytest.mark.parametrize('case', sorted(OPTIMIZE_CASES))
def test_optimize_matches_exsr(case):
    """The same loss sequence to 1e-6, the same number of steps, and the
    same returned Z (min-loss retention, plateau stop, frozen region)."""
    w, kind, lr, iters, seed, frozen = OPTIMIZE_CASES[case]
    shape = (1, 2, 2, 1) if kind == 'quad' else (1, 8, 8, 3)
    desired = np.full(shape, 0.8 if w != 1.0 else 0.5, np.float32)
    theta0 = np.zeros(shape, np.float32) if seed is None else \
        np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    mask = None
    if frozen:
        mask = np.zeros(shape, np.float32)
        mask[:, :4] = 1.0
    results = []
    for xp, Z, conv in ((jnp, JZ, _j), (torch, TZ, _t)):
        if kind == 'quad':
            fwd = (lambda z: z)

            def loss(out, z):
                return ((out - 0.5) ** 2).sum()
        else:
            fwd = _linear_forward(w, xp)
            loss = (JO if xp is jnp else TO).l1_to_desired(conv(desired),
                                                           None)
        zo = Z(fwd, loss, lr=lr)
        z, theta, _, losses = zo.optimize(
            conv(theta0), max_iters=iters,
            z_mask=None if mask is None else conv(mask),
            frozen_theta=conv(theta0))
        results.append((np.asarray(z), np.asarray(losses)))
    (jz, jl), (tz, tl) = results
    assert jl.shape == tl.shape
    assert np.abs(tl - jl).max() <= 1e-6 * np.abs(jl).max()
    np.testing.assert_allclose(tz, jz, atol=2e-6)
    if frozen:
        assert np.abs(tz[:, 4:]).max() == 0.0


ROUND_CASES = {
    # target, lr, n_rounds: a quiet descent, and one whose rate first
    # overshoots (reverts, LR / 5) and then freezes below min_lr (NaNs)
    'descent': ([[0.3, -0.2]], 0.3, 12),
    'reverts_and_freezes': ([[0.3, -0.2]], 0.5, 30),
}


@pytest.mark.parametrize('case', sorted(ROUND_CASES))
def test_optimize_rounds_matches_exsr(case):
    """The round loop: the same loss sequence to 1e-6 with NaN in the same
    places, the same best loss, final learning rate and Z."""
    target, lr, n_rounds = ROUND_CASES[case]
    out = []
    for Z, conv in ((JZ, _j), (TZ, _t)):
        tgt = conv(np.asarray(target, np.float32))
        zo = Z(forward_fn=lambda z: z,
               objective_fn=lambda o, z: ((o - tgt) ** 2).sum(), lr=lr)
        z, _, best, final_lr, losses = zo.optimize_rounds(
            conv(np.zeros((1, 2), np.float32)), n_rounds=n_rounds,
            iters_per_round=5)
        out.append((np.asarray(z), best, final_lr, np.asarray(losses)))
    (jz, jb, jlr, jl), (tz, tb, tlr, tl) = out
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    ok = ~np.isnan(jl)
    np.testing.assert_allclose(tl[ok], jl[ok], rtol=1e-6, atol=1e-7)
    assert tb == pytest.approx(jb, rel=1e-6, abs=1e-7)
    # XLA divides by the constant lr_decay as a product with its
    # reciprocal, which rounds differently after several reverts
    assert tlr == pytest.approx(jlr, rel=1e-6)
    np.testing.assert_allclose(tz, jz, atol=1e-6)
    if case == 'reverts_and_freezes':
        assert jlr < 0.3 and np.isnan(jl).any()


def test_adam_update_matches_optax():
    import optax
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(4)]
    opt = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))
    jstate = opt.init(jnp.zeros((3, 4)))
    tstate = TOpt.adam_init(torch.zeros(3, 4))
    for g in grads:
        ju, jstate = opt.update(jnp.asarray(g), jstate)
        tu, tstate = TOpt.adam_update(torch.from_numpy(g), tstate, 0.05)
        np.testing.assert_allclose(tu.numpy(), 0.05 * np.asarray(ju),
                                   rtol=1e-6)


def test_atanh_and_xavier_init():
    z = np.asarray([[0.3, -0.7, 0.0, 1.0]], np.float32)
    from exsr.zopt.optimizer import atanh_init
    np.testing.assert_allclose(TOpt.atanh_init(_t(z), 1.0).numpy(),
                               np.asarray(atanh_init(_j(z), 1.0)),
                               rtol=1e-6)
    x = TOpt.xavier_uniform_like(torch.zeros(2, 8, 8, 3),
                                 torch.Generator().manual_seed(0))
    bound = 100 * np.sqrt(6.0 / (3 * 64 + 2 * 64))
    assert x.abs().max() <= bound and x.abs().max() > 0.9 * bound
    y = TOpt.xavier_uniform_like(torch.zeros(2, 8, 8, 3),
                                 torch.Generator().manual_seed(0))
    assert torch.equal(x, y)


# ---------------------------------------------------------------- objectives
H = 24


@pytest.fixture(scope='module')
def obj_data():
    rng = np.random.default_rng(11)
    out = rng.uniform(0.1, 0.9, size=(2, H, H, 3)).astype(np.float32)
    desired = rng.uniform(size=(2, H, H, 3)).astype(np.float32)
    mask = np.zeros((H, H), np.float32)
    mask[3:20, 4:21] = 1.0
    return out, desired, mask


def _both(build, out):
    """(exsr value, exsr grad, port value, port grad) of the loss that
    ``build(xp_module, conv)`` returns, at ``out``."""
    jl = build(JO, _j)
    jv, jg = jax.value_and_grad(lambda o: jl(o, None))(_j(out))
    tl = build(TO, _t)
    o = _t(out).requires_grad_(True)
    tv = tl(o, None)
    tv.backward()
    return float(jv), np.asarray(jg), float(tv), o.grad.numpy()


def _helpers(mod, mask, local, overlap=1.0):
    return mod.STDHelpers.create(mask, local=local, overlap=overlap)


OBJECTIVES = {
    'l1': lambda m, c, d, mask: m.l1_to_desired(c(d), c(mask)),
    'l1_nomask': lambda m, c, d, mask: m.l1_to_desired(c(d), None),
    'max_l1': lambda m, c, d, mask: m.negated(m.l1_to_desired(c(d),
                                                              c(mask))),
    'scribble': lambda m, c, d, mask: m.scribble(
        c(d), c(mask), [c(mask[::-1].copy()), c(1 - mask)]),
    'max_STD': lambda m, c, d, mask: m.std_objective(
        _helpers(m, mask, False), 'max_STD'),
    'min_STD_local': lambda m, c, d, mask: m.std_objective(
        _helpers(m, mask, True), 'min_STD'),
    'STD_increase_local': lambda m, c, d, mask: m.std_objective(
        _helpers(m, mask, True, 0.5), 'STD_increase',
        c(np.full((1, 1), 0.3, np.float32))),
    'Mag': lambda m, c, d, mask: m.magnitude_objective(
        c(np.random.default_rng(1).uniform(size=(
            len(JP.patch_indices_from_mask(mask, 7)), 49))
          .astype(np.float32)), c(JP.patch_indices_from_mask(mask, 7))),
    'TV': lambda m, c, d, mask: m.tv_objective(
        _helpers(m, mask, False), c(np.full((1, 1), 0.2, np.float32))),
    'periodicity': lambda m, c, d, mask: m.periodicity_objective(
        [np.array([0, 5]), np.array([3, -2])], c(mask),
        _helpers(m, mask, True), c(np.full((1, 1), 0.2, np.float32))),
    'periodicity_nonInt': lambda m, c, d, mask: m.periodicity_nonint_objective(
        m.periodicity_grids([[0.0, 4.5], [2.5, -1.5]], mask.shape), c(mask),
        _helpers(m, mask, False), c(np.full((1, 1), 0.2, np.float32))),
    'random_l1': lambda m, c, d, mask: m.diversity_objective(
        'random_l1', c(mask)),
    'limited_random_l1_local': lambda m, c, d, mask: m.diversity_objective(
        'local_limited_random_l1', c(mask), _helpers(m, mask, True),
        c(np.full((2, 1), 0.2, np.float32)), c(d), rmse_weight=0.5),
    'random_VGG': lambda m, c, d, mask: m.diversity_objective(
        'random_VGG', None, feature_fn=lambda x: x[..., :2] ** 2),
    'VGG': lambda m, c, d, mask: m.vgg_objective(
        lambda x: x[:, ::2, ::2] * 2 - 1, c(d[:, ::2, ::2])),
    'Adversarial': lambda m, c, d, mask: m.adversarial_objective(
        lambda x: (x ** 3).sum(-1)),
    'desired_SVD': lambda m, c, d, mask: m.desired_svd_objective(
        c(d[:1] * 0.5), c(d[1:]), c(np.array([0.5, -0.2, 0.1], np.float32)),
        c(mask)),
    'non_local': lambda m, c, d, mask: m.with_constraint(
        m.l1_to_desired(c(d), c(mask)),
        m.non_local_constraint(c(d[::-1].copy()), c(1 - mask), 0.1)),
}


@pytest.mark.parametrize('name', sorted(OBJECTIVES))
def test_objective_value_and_gradient_match_exsr(obj_data, name):
    """Value and d/d out against exsr's, 1e-5 relative to the largest."""
    out, desired, mask = obj_data
    jv, jg, tv, tg = _both(
        lambda m, c: OBJECTIVES[name](m, c, desired, mask), out)
    assert tv == pytest.approx(jv, rel=1e-5, abs=1e-7)
    assert np.abs(jg).max() > 0
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()


def test_digit_objectives_match_exsr(obj_data):
    """digit_views_transform (antialiased bilinear resize), the digit
    objective, its traced form and digit_score against exsr's, with one
    toy classifier written in both frameworks."""
    out, _, _ = obj_data

    def clf(xp):
        def apply(x):
            s = x.mean(axis=(1, 2, 3)) if xp is jnp else x.mean((1, 2, 3))
            return (s[:, None] * xp.arange(7.0) + 1.0,
                    xp.sin(s[:, None] * xp.arange(10.0) * 3.0))
        return apply
    bounds = (2, 3, 17, 14)
    jt = JO.digit_views_transform(bounds, (1, 3))
    tt = TO.digit_views_transform(bounds, (1, 3))
    np.testing.assert_allclose(tt(_t(out)).numpy(), np.asarray(jt(_j(out))),
                               atol=1e-5)
    gray = out[..., :1]
    np.testing.assert_allclose(tt(_t(gray)).numpy(),
                               np.asarray(jt(_j(gray))), atol=1e-5)
    jv, jg, tv, tg = _both(
        lambda m, c: m.digit_objective(clf(jnp if m is JO else torch),
                                       bounds, 4), out)
    assert tv == pytest.approx(jv, rel=1e-5)
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()
    traced = TO.digit_objective_traced(clf(torch), tt)
    assert float(traced(_t(out), None, {'digit': torch.tensor(4)})) == \
        pytest.approx(tv, rel=1e-6)
    assert TO.digit_score(clf(torch), tt, _t(out), 7) == pytest.approx(
        JO.digit_score(clf(jnp), jt, _j(out), 7), rel=1e-5)


def test_tv_loss_and_translated(obj_data):
    out, _, _ = obj_data
    np.testing.assert_allclose(TO.tv_loss(_t(out)).numpy(),
                               np.asarray(JO.tv_loss(_j(out))), rtol=1e-6)
    for p in ([0, 3], [-2, 1], [4, -5]):
        assert np.array_equal(TO.translated(_t(out), p).numpy(),
                              np.asarray(JO.translated(_j(out), p)))


# ----------------------------------------------------------------- histogram
HIST_CASES = {
    'hist': dict(temperature=5e-4),
    # the pixel dictionary runs over 256 evenly spaced bins, so its
    # gradient is a small difference of the pulls of the bins on either
    # side (at 1e-3 only 1e-8 of them remain); a wider kernel conditions
    # it, and its gradient is held to 1e-4 (measured 1.7e-5)
    'dict': dict(temperature=0.05, dictionary_not_histogram=True),
    'patch_hist': dict(patch_size=6, temperature=5e-4),
    'patch_dict_noDC': dict(patch_size=6, temperature=1e-3,
                            dictionary_not_histogram=True,
                            no_patch_dc=True),
    'patch_hist_no_localSTD': dict(patch_size=6, temperature=5e-4,
                                   no_patch_dc=True, no_patch_std=True),
}


@pytest.mark.parametrize('case', sorted(HIST_CASES))
def test_soft_histogram_loss_matches_exsr(obj_data, case):
    """SoftHistogramLoss value and d/d out against exsr's, 1e-5."""
    out, _, mask = obj_data
    kw = HIST_CASES[case]
    dm = np.ones((H, H), np.float32)
    # a desired image near the output, so that the kernel's soft counts
    # (temperatures 5e-4, 1e-3) do not vanish
    noise = np.random.default_rng(9).normal(size=out.shape[1:]) * 0.03
    want = np.clip(out[0] + noise, 0, 1).astype(np.float32)
    jl = JH.SoftHistogramLoss.create([want], [dm], mask, **kw)
    tl = TH.SoftHistogramLoss.create([want], [dm], mask, **kw)
    assert tl.hist.bins.shape == jl.hist.bins.shape
    jv, jg = jax.value_and_grad(lambda o: jl(o))(_j(out))
    o = _t(out).requires_grad_(True)
    tv = tl(o)
    tv.backward()
    assert float(tv) == pytest.approx(float(jv), rel=1e-5)
    jg = np.asarray(jg)
    tol = 1e-4 if case == 'dict' else 1e-5
    assert np.abs(o.grad.numpy() - jg).max() <= tol * np.abs(jg).max()


def test_prune_bins_and_kl_div():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 40, size=(4, 300)) / 39.0
    np.testing.assert_array_equal(TH.prune_bins(vals, 0.05),
                                  JH.prune_bins(vals, 0.05))
    p = rng.uniform(size=20).astype(np.float32)
    t = rng.uniform(size=20).astype(np.float32)
    t[3] = 0.0
    assert float(TH.kl_div(_t(np.log(p)), _t(t))) == pytest.approx(
        float(JH.kl_div(_j(np.log(p)), _j(t))), rel=1e-6)


def test_temperature_searches_match_exsr():
    """calibrate_temperature (binary search) returns the same
    temperature; auto_temperature (Adam on log T over the norm of a
    gradient, a gradient of a gradient) the same to 1e-4 relative."""
    rng = np.random.default_rng(4)
    im = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    other = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    mask = np.ones((16, 16), np.float32)
    jl = JH.SoftHistogramLoss.create([im], [mask], mask, temperature=0.05)
    tl = TH.SoftHistogramLoss.create([im], [mask], mask, temperature=0.05)
    assert tl.calibrate_temperature(_t(other)) == pytest.approx(
        jl.calibrate_temperature(_j(other)), rel=1e-6)
    theta0 = (rng.normal(size=(1, 16, 16, 3)) * 0.1).astype(np.float32)
    ja = jl.auto_temperature(lambda th: jnp.tanh(th) * 0.5 + 0.5,
                             _j(theta0), n_iters=12)
    ta = tl.auto_temperature(lambda th: torch.tanh(th) * 0.5 + 0.5,
                             _t(theta0), n_iters=12)
    assert ta == pytest.approx(ja, rel=1e-4)


# ------------------------------------------------ patches, structure, misc
@pytest.mark.parametrize('overlap', [1.0, 0.5, 0.0])
def test_patch_indices_and_stds_match_exsr(overlap):
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(32, 30)) < 0.9
    mask[2:25, 3:28] = True
    ji, jn = JP.patch_indices_from_mask(mask, 7, overlap,
                                        return_non_covered=True)
    ti, tn = TP.patch_indices_from_mask(mask, 7, overlap,
                                        return_non_covered=True)
    np.testing.assert_array_equal(ti, ji)
    assert (tn is None) == (jn is None)
    if jn is not None:
        np.testing.assert_array_equal(tn, jn)
    img = rng.uniform(size=(32, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        TP.gather_patches(_t(img), _t(ti)).numpy(),
        np.asarray(JP.gather_patches(_j(img), _j(ji))))
    np.testing.assert_allclose(
        TP.masked_patch_std(_t(img), _t(ti), None if tn is None else
                            _t(tn)).numpy(),
        np.asarray(JP.masked_patch_std(_j(img), _j(ji), None if jn is None
                                       else _j(jn))), atol=1e-6)


def test_structure_tensor_matches_exsr():
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, 10, 12, 3)).astype(np.float32)
    for t, j in zip(TST.structure_tensor_elements(_t(x)),
                    JST.structure_tensor_elements(_j(x))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    # a well-conditioned tensor (lambda1 away from 0): float64 and fp32
    # S1 - S2 agree to 1e-6
    a = rng.uniform(0.5, 1.0, size=50).astype(np.float32)
    d = rng.uniform(0.5, 1.0, size=50).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, size=50).astype(np.float32)
    for t, j in zip(TST.svd_symmetric_2x2(_t(a), _t(d), _t(b)),
                    JST.svd_symmetric_2x2(_j(a), _j(d), _j(b))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    # the float64 path against numpy's eigenvalues, a near-degenerate one
    # included (lambda1 ~ 1e-4, where fp32 S1 - S2 would lose it)
    a64, d64, b64 = np.array([1.0, 0.01]), np.array([0.5, 1e-4]), \
        np.array([0.2, 5e-4])
    lam0, lam1, _ = TST.svd_symmetric_2x2(_t(a64), _t(d64), _t(b64))
    ev = np.linalg.eigvalsh(np.stack([np.stack([a64, b64], -1),
                                      np.stack([b64, d64], -1)], -2))
    np.testing.assert_allclose(lam1.numpy(), np.abs(ev[:, 0]), rtol=1e-6)
    np.testing.assert_allclose(lam0.numpy(), np.abs(ev[:, 1]), rtol=1e-6)
    assert np.array_equal(TST.valid_struct_tensor(_t(a), _t(d), _t(b))
                          .numpy(),
                          np.asarray(JST.valid_struct_tensor(_j(a), _j(d),
                                                             _j(b))))
    np.testing.assert_allclose(
        TST.svd_to_latent_z(1.0, 0.2, np.pi / 4).numpy(),
        np.asarray(JST.svd_to_latent_z(jnp.asarray(1.0), jnp.asarray(0.2),
                                       jnp.asarray(np.pi / 4))), atol=1e-6)


def test_session_helpers_match_exsr():
    rng = np.random.default_rng(7)
    x = rng.normal(size=40)
    ac = TMisc.overlap_normalized_autocorr(x)
    np.testing.assert_array_equal(ac, JMisc.overlap_normalized_autocorr(x))
    assert TMisc.first_autocorr_peak(ac) == JMisc.first_autocorr_peak(ac)
    img = rng.uniform(size=(20, 30))
    np.testing.assert_array_equal(
        TMisc.bilinear_sample_line(img, 1.5, 2.0, 17.2, 25.9, 33),
        JMisc.bilinear_sample_line(img, 1.5, 2.0, 17.2, 25.9, 33))
    sm = rng.integers(0, 7, size=(16, 16))
    mask = (rng.uniform(size=(16, 16)) > 0.2).astype(np.float32)
    for t, j in zip(TMisc.scribble_mask_components(sm, mask, 0.3),
                    JMisc.scribble_mask_components(sm, mask, 0.3)):
        if isinstance(t, list):
            assert len(t) == len(j)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(t, j)
