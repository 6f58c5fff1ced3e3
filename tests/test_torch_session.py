"""The port's EditSession against exsr's, on the CPU, on the same weights
(a tiny generator: nf 16, nb 1, the default gc) and the same image."""
import jax
import numpy as np
import pytest

from exsr.apps.session import EditSession as JSession
from exsr_torch.apps.session import EditSession as TSession
from exsr_torch.models.convert import from_exsr_params

HR = 96


@pytest.fixture(scope='module')
def sessions():
    js = JSession(scale=4, nb=1, nf=16, time_budget_s=120.0)
    js.init_random_params(0)
    ts = TSession(scale=4, nb=1, nf=16, time_budget_s=120.0, device='cpu')
    ts.load_params(from_exsr_params(jax.tree.map(np.asarray, js.params)))
    img = np.random.default_rng(0).uniform(size=(HR, HR, 3)) \
        .astype(np.float32)
    js.open_image(img)
    ts.open_image(img)
    return js, ts


def _region(lo=24, hi=72):
    mask = np.zeros((HR, HR), np.float32)
    mask[lo:hi, lo:hi] = 1.0
    return mask


def _both(sessions, fn):
    return [fn(s) for s in sessions]


def test_open_image_matches_exsr(sessions):
    """The same LR working image and SR view (fp32 through ~20 convs, 1e-5),
    and the SR view is LR-consistent (clip(0, 1) aside)."""
    js, ts = sessions
    np.testing.assert_allclose(ts.lr_image, js.lr_image, atol=1e-6)
    np.testing.assert_allclose(ts.sr, js.sr, atol=1e-5)
    assert ts.cur_z.shape == (1, HR, HR, 3) and not ts.cur_z.any()
    from exsr_torch.ops.resize import imresize
    down = imresize(ts.sr[0].astype(np.float64), 0.25)
    m = ts.cem.invalidity_margins_lr
    assert np.abs(down - ts.lr_image[0])[m:-m, m:-m].max() < 5e-3


def test_uniform_z_svd_sliders_undo_redo(sessions):
    js, ts = sessions
    sr0 = ts.sr.copy()
    for s in sessions:
        s.set_region(_region(8, 40))
        s.set_uniform_z([0.8, -0.5, 0.3])
    np.testing.assert_allclose(ts.sr, js.sr, atol=1e-5)
    assert np.abs(ts.sr - sr0).max() > 1e-4
    for s in sessions:
        s.set_z_from_svd(1.0, 0.2, np.pi / 4)
    np.testing.assert_allclose(ts.cur_z, js.cur_z, atol=1e-6)
    np.testing.assert_allclose(ts.sr, js.sr, atol=1e-5)
    sr_svd = ts.sr.copy()
    for s in sessions:
        s.undo()
        s.undo()
    np.testing.assert_allclose(ts.sr, sr0, atol=0)
    ts.redo()
    ts.redo()
    np.testing.assert_array_equal(ts.sr, sr_svd)
    for s in sessions:
        s.clear_region()
    ts.undo()
    ts.undo()
    np.testing.assert_allclose(ts.cur_z, 0.0, atol=0)


def test_local_l1_edit_matches_exsr_step_by_step(sessions):
    """A 10-step local l1 edit (the crop, margins and bucket included,
    is the whole 24-pixel LR image, run without pre-pad): the loss history
    agrees per step to 1e-6 of the first loss (measured 1.5e-8), the same
    rounds; Z outside the region stays 0.  (Z itself is not compared: Adam
    divides each element's gradient by its own scale, so elements whose
    gradient is rounding noise take steps of either sign.)"""
    js, ts = sessions
    for s in sessions:
        s.set_region(_region())
    desired = js.sr.copy()
    desired[:, 24:72, 24:72] = 0.7
    rj, rt = _both(sessions, lambda s: s.optimize(
        'l1', data={'desired': desired}, max_iters=10))
    lj, lt = np.asarray(rj['losses']), np.asarray(rt['losses'])
    assert lj.shape == lt.shape == (10,) and rt['rounds'] == rj['rounds']
    assert np.abs(lt - lj).max() <= 1e-6 * lj[0]
    assert rt['final_loss'] == pytest.approx(rj['final_loss'], rel=1e-6)
    assert lt[-1] < lt[0]
    assert np.abs(ts.cur_z[0, :20, :20]).max() == 0
    assert np.abs(ts.cur_z[0, 30:60, 30:60]).max() > 0
    # the l1 edit's optimizer is kept per crop shape
    assert [k[:3] for k in ts._zopt_cache] == [('l1', (1, 24, 24, 3),
                                                False)]
    for s in sessions:
        s.undo()
        s.clear_region()


def test_max_l1_moves_away_as_exsr(sessions):
    """'max_l1' from a target 0.05 below the view, so that no difference
    starts at the kink of |.|: the same loss history, moving away, to 1e-6
    of its largest value."""
    js, ts = sessions
    for s in sessions:
        s.set_region(_region())
    desired = js.sr - 0.05
    rj, rt = _both(sessions, lambda s: s.optimize(
        'max_l1', data={'desired': desired}, max_iters=5))
    lj, lt = np.asarray(rj['losses']), np.asarray(rt['losses'])
    assert lt.shape == lj.shape == (5,) and lt[-1] < lt[0] < 0
    assert np.abs(lt - lj).max() <= 1e-6 * np.abs(lj).max()
    for s in sessions:
        s.undo()
        s.clear_region()


def _hist_data(js):
    """A 16-pixel LR window whose target is the view brightened towards 1
    (half of it plus 0.5): a histogram clearly apart from the view's."""
    mask = _region(40, 56)
    want = np.clip(js.sr[0] * 0.5 + 0.5, 0, 1).astype(np.float32)
    return mask, {'desired': [want], 'desired_masks': [mask]}


def test_hist_fixed_temperature_matches_exsr(sessions):
    """The session's 'hist' dispatch (the target and its mask cropped to
    the edit, the bins, the default temperature 5e-4): the same 5-step loss
    history, falling, to 1e-5 of the first loss (measured 3.0e-7)."""
    js, ts = sessions
    mask, data = _hist_data(js)
    for s in sessions:
        s.set_region(mask)
    rj, rt = _both(sessions, lambda s: s.optimize('hist', data=data,
                                                  max_iters=5))
    lj, lt = np.asarray(rj['losses']), np.asarray(rt['losses'])
    assert lt.shape == lj.shape == (5,) and lt[-1] < lt[0]
    assert np.abs(lt - lj).max() <= 1e-5 * lj[0]
    for s in sessions:
        s.undo()
        s.clear_region()


def test_hist_with_auto_temperature_matches_exsr(sessions, monkeypatch):
    """'hist' with the gradient-based temperature search (50 Adam steps on
    log T over the norm of a gradient: a gradient of a gradient through
    the CEM-wrapped generator), then 5 steps, on a target whose histogram
    differs clearly from the view's, where the search stops at a moderate
    T (measured 2.2e-3 on both sides): the same T to 1e-4 relative
    (measured 1.5e-6) and the same loss history, falling, to 1e-5 of the
    first loss (measured 6.5e-7)."""
    from exsr.zopt import histogram as JH
    from exsr_torch.zopt import histogram as TH
    found = {}
    for key, mod in (('exsr', JH), ('port', TH)):
        def record(self, *a, _orig=mod.SoftHistogramLoss.auto_temperature,
                   _key=key, **k):
            found[_key] = _orig(self, *a, **k)
            return found[_key]
        monkeypatch.setattr(mod.SoftHistogramLoss, 'auto_temperature',
                            record)
    js, ts = sessions
    mask, data = _hist_data(js)
    for s in sessions:
        s.set_region(mask)
    data = dict(data, auto_temperature=True)
    rj, rt = _both(sessions, lambda s: s.optimize('hist', data=data,
                                                  max_iters=5))
    assert 1e-4 < found['exsr'] < 0.05
    assert abs(found['port'] - found['exsr']) <= 1e-4 * found['exsr']
    lj, lt = np.asarray(rj['losses']), np.asarray(rt['losses'])
    assert lt.shape == lj.shape == (5,) and lt[-1] < lt[0]
    assert np.abs(lt - lj).max() <= 1e-5 * lj[0]
    for s in sessions:
        s.undo()
        s.clear_region()


def test_alternatives_bucketing_and_retention(sessions):
    """3 alternatives run at the bucket of 4 and 2 are kept; their draws
    come from the session's generator (not compared with exsr's)."""
    js, ts = sessions
    ts.set_region(_region())
    desired = np.clip(ts.sr + 0.02, 0, 1)
    res = ts.optimize('l1', data={'desired': desired}, max_iters=5,
                      n_alternatives=3)
    assert res['n_alternatives'] == 2
    assert ts._alternatives['zs'].shape == (2, HR, HR, 3)
    keys = [k for k in ts._zopt_cache if k[-1] > 1]
    assert keys and keys[-1][-1] == 4 and keys[-1][1][0] == 4
    alt = ts.alternative_sr(1)
    assert alt.shape == ts.sr.shape and np.isfinite(alt).all()
    before = ts.cur_z.copy()
    ts.copy_alternative(0)
    assert np.abs(ts.cur_z - before).max() > 0
    ts.copy_default_to_alternatives()
    np.testing.assert_allclose(ts.alternative_sr(0), ts.sr, atol=1e-6)
    with pytest.raises(IndexError):
        ts.alternative_sr(2)
    ts.undo()
    ts.undo()
    ts.clear_region()
    # a random_l1 request draws its start from the seeded generator
    ts.set_region(_region())
    r = ts.optimize('random_l1', data={'desired': desired}, max_iters=2,
                    n_alternatives=2)
    assert np.isfinite(r['final_loss']) and r['n_alternatives'] == 1
    ts.undo()
    ts.clear_region()


def test_imprint_matches_exsr(sessions):
    """Imprint at the border (cropped to the canvas) on the same view, 5 l1
    steps: the same region and loss history; the location search finds
    the same spot."""
    js, ts = sessions
    imprint = 0.9 * np.ones((16, 16, 3), np.float64)
    ts.sr = js.sr.copy()  # the same view: imprint builds its target on it
    rj, rt = _both(sessions, lambda s: s.imprint(imprint, (HR - 8, HR - 8),
                                                 optimize_iters=5))
    np.testing.assert_array_equal(ts.region_mask_hr, js.region_mask_hr)
    lj, lt = np.asarray(rj['losses']), np.asarray(rt['losses'])
    # a mean over the whole image of a 64-pixel region: 1e-4 of the first
    # loss (measured 1.6e-5)
    assert np.abs(lt - lj).max() <= 1e-4 * lj[0]
    for s in sessions:
        s.undo()
        s.clear_region()
    search = _region(10, 80)
    pj, pt = _both(sessions, lambda s: s.find_optimal_imprint_location(
        imprint, search, n_trials=20, seed=0))
    assert pt['position'] == pj['position']
    assert pt['consistency_error'] == pytest.approx(
        pj['consistency_error'], rel=1e-4)
    edited = np.clip(js.sr[0] * 1.1, 0, 1)
    np.testing.assert_allclose(ts.enforce_hsv_edit(edited),
                               js.enforce_hsv_edit(edited), atol=1e-6)


def test_save_load_z_and_kernelgan(sessions, tmp_path):
    js, ts = sessions
    ts.set_uniform_z([0.5, 0.5, 0.5])
    p = str(tmp_path / 'z.npz')
    ts.save_z(p)
    saved = ts.cur_z.copy()
    ts.set_uniform_z([0.0, 0.0, 0.0])
    ts.load_z(p)
    np.testing.assert_array_equal(ts.cur_z, saved)
    # exsr reads the port's file and vice versa
    js.load_z(p)
    np.testing.assert_allclose(js.sr, ts.sr, atol=1e-5)
    for _ in range(3):
        ts.undo()
    js.undo()
    with pytest.raises(NotImplementedError, match='KernelGAN'):
        ts.estimate_kernel()


def test_estimate_periodicity_matches_exsr():
    yy = np.arange(96)[:, None] * np.ones((1, 96))
    img = 0.5 + 0.4 * np.sin(2 * np.pi * yy / 12.0)
    sr = np.repeat(img[None, :, :, None], 3, axis=-1).astype(np.float32)
    out = []
    for cls in (JSession, TSession):
        s = cls.__new__(cls)  # only .sr is used
        s.sr = sr
        out.append(s.estimate_periodicity((10.0, 48.0), [(50.0, 48.0),
                                                         (40.0, 70.0)]))
    for t, j in zip(*out[::-1]):
        np.testing.assert_array_equal(t, j)
    assert abs(np.linalg.norm(out[1][0]) - 12.0) < 1.0
