"""The port's JPEGEditSession against exsr's, on the CPU, on the same
weights (nf 16, nb 3, exsr's init carried across) and the same 32-64 px
images: loading, decoding, Z controls, undo and redo, every objective of
``optimize``, the alternatives, the imprint search and the chroma path."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.apps.jpeg_session import JPEGEditSession as JSession
from exsr_torch.apps.jpeg_session import JPEGEditSession as TSession
from exsr_torch.models.convert import dncnn_from_exsr_vars
from exsr_torch.utils import misc as PM
from exsr.utils import misc as EM

HW = 64


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _image(hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(hw, hw, 3))
    return ((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3) \
        .astype(np.float32)


def _pair(qf=10, hw=HW, seed=0):
    js = JSession(nf=16, nb=3, latent_channels=64, qf=qf)
    js.init_random_params(0)
    ts = TSession(nf=16, nb=3, latent_channels=64, qf=qf, device='cpu')
    ts.load_params(dncnn_from_exsr_vars(jax.tree.map(np.asarray,
                                                     js.params)))
    img = _image(hw, seed)
    js.open_image(img)
    ts.open_image(img)
    return js, ts


@pytest.fixture
def pair():
    return _pair()


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)


def test_open_image_and_recompute(pair):
    js, ts = pair
    assert ts.out.shape == (1, HW, HW, 1) and isinstance(ts.out, np.ndarray)
    np.testing.assert_array_equal(ts.y_image, np.asarray(js.y_image))
    # the same quantised coefficients (these images hold no tie)
    np.testing.assert_array_equal(ts.comp.numpy(), np.asarray(js.comp))
    _close(ts.out, js.out)
    _close(ts.recompute(), js.recompute())
    with torch.no_grad():
        c = ts._g_apply(ts.comp, ts._t(ts.cur_z))
    assert (c - ts.comp).abs().max() <= 0.5 + 1e-6


def test_region_uniform_z3_undo_redo(pair):
    js, ts = pair
    mask = np.zeros((HW, HW), np.float32)
    mask[12:30, 20:44] = 1.0
    for s in pair:
        s.set_region(mask)
    np.testing.assert_array_equal(ts.region_mask, js.region_mask)
    np.testing.assert_array_equal(ts._block_mask, js._block_mask)
    _close(ts.set_uniform_z3([0.9, -0.4, 0.2]),
           js.set_uniform_z3([0.9, -0.4, 0.2]))
    np.testing.assert_array_equal(ts.cur_z, js.cur_z)
    _close(ts.undo(), js.undo())
    _close(ts.redo(), js.redo())
    np.testing.assert_array_equal(ts.cur_z, js.cur_z)


def _edit_mask():
    mask = np.zeros((HW, HW), np.float32)
    mask[16:48, 8:40] = 1.0
    return mask


OBJECTIVES = {
    'l1': lambda s: {'desired': np.asarray(s.y_image) / 255.0 * 0.9},
    'max_l1': lambda s: {'desired': np.asarray(s.y_image) / 255.0},
    'max_STD': lambda s: {},
    'local_min_STD': lambda s: {},
    'STD_increase': lambda s: {'STD_increment': 0.02},
    'TV': lambda s: {},
    'scribble': lambda s: {
        'desired': np.full((HW, HW, 3), 0.8, np.float32),
        'scribble_mask': np.pad(np.array([[1, 2], [3, 4]]).repeat(8, 0)
                                .repeat(8, 1), 24),
        'brightness_factor': 0.3},
}


@pytest.mark.parametrize('objective', sorted(OBJECTIVES))
def test_optimize_matches_exsr(objective):
    """Eight Adam steps on the same weights and image: the losses and the
    edited output within 1e-4 (fp32 gradients through three convs, summed
    in another order, step after step)."""
    js, ts = _pair()
    for s in (js, ts):
        s.set_region(_edit_mask())
    data = OBJECTIVES[objective](js)
    rj = js.optimize(objective, data=data, max_iters=8)
    rt = ts.optimize(objective, data=data, max_iters=8)
    assert rt['n_alternatives'] == 0 and len(rt['losses']) == 8
    np.testing.assert_allclose(rt['losses'], np.asarray(rj['losses']),
                               rtol=1e-4, atol=1e-5)
    _close(rt['out'], rj['out'], 1e-4)
    _close(ts.cur_z, js.cur_z, 1e-4)
    # Z moved inside the selected blocks only
    outside = ts._block_mask == 0
    assert np.abs(ts.cur_z[0][outside]).max() == 0
    assert np.abs(ts.cur_z[0][~outside]).max() > 0


def test_random_alternatives_shapes_and_semantics():
    """exsr seeds its alternatives from the clock, so only shapes and
    semantics are compared: three retained alternatives, their decodes
    within the bins, adoption in the region, the default pushed back; the
    port's draw repeats under its seed.  'random_l1' takes the l1 branch,
    as in exsr."""
    js, ts = _pair()
    for s in (js, ts):
        s.set_region(_edit_mask())
    rj = js.optimize('random_VGG', n_alternatives=4, max_iters=3)
    rt = ts.optimize('random_VGG', n_alternatives=4, max_iters=3)
    assert rt['n_alternatives'] == rj['n_alternatives'] == 3
    assert ts._alternatives['zs'].shape == js._alternatives['zs'].shape
    alts = [ts.alternative_out(i) for i in range(3)]
    assert all(a.shape == ts.out.shape for a in alts)
    assert max(np.abs(a - alts[0]).max() for a in alts[1:]) > 1e-4
    with pytest.raises(IndexError):
        ts.alternative_out(3)
    before = ts.cur_z.copy()
    ts.copy_alternative(1)
    m = ts._block_mask[None, :, :, None]
    np.testing.assert_allclose(
        ts.cur_z, ts._alternatives['zs'][1:2] * m + before * (1 - m))
    ts.set_uniform_z3([0.1, 0.2, 0.3])
    ts.copy_default_to_alternatives()
    np.testing.assert_array_equal(
        ts._alternatives['zs'][:, m[0, :, :, 0] > 0],
        np.broadcast_to(ts.cur_z, ts._alternatives['zs'].shape)[
            :, m[0, :, :, 0] > 0])

    def seeded_draw():
        s = TSession(nf=16, nb=3, latent_channels=64, qf=10, device='cpu')
        s.load_params(ts.params)
        s.open_image(_image())
        s.set_region(_edit_mask())
        s.optimize('random_VGG', n_alternatives=3, max_iters=2)
        return s._alternatives['zs']
    np.testing.assert_array_equal(seeded_draw(), seeded_draw())
    with pytest.raises(KeyError):
        ts.optimize('random_l1', n_alternatives=2, max_iters=1)
    with pytest.raises(KeyError):
        js.optimize('random_l1', n_alternatives=2, max_iters=1)


def test_digit_objective_and_empty_region():
    """'digit' runs a classifier callable on the Y output (replicated to
    three channels) and reuses its optimizer across digits."""
    ts = _pair()[1]
    mask = np.zeros((HW, HW), np.float32)
    mask[8:40, 16:40] = 1.0
    ts.set_region(mask)
    seen = []

    def classifier(x):
        seen.append(tuple(x.shape))
        feats = x.mean(dim=(1, 2))
        return (feats @ torch.ones(3, 7), feats @ torch.linspace(-1, 1, 30)
                .reshape(3, 10))
    for digit in (3, 7):
        res = ts.optimize('digit', data={'classifier_apply': classifier,
                                         'digit_2_resemble': digit},
                          max_iters=2)
        assert np.isfinite(res['losses']).all()
    assert len(ts._zo_cache) == 1 and seen[0][-1] == 3
    ts.set_region(np.zeros((HW, HW), np.float32))
    with pytest.raises(ValueError, match='empty region'):
        ts.optimize('TV')
    ts.set_region(mask)
    with pytest.raises(NotImplementedError):
        ts.optimize('no_such_objective')


def test_find_optimal_imprint_mask_matches_exsr(monkeypatch):
    """The same winning rectangle and refined mask.  exsr's search runs
    with its two resizes replaced by the port's (which
    ``test_resize_helpers_match_exsr`` holds to them): JAX compiles its
    resize once per crop shape, hundreds of shapes here."""
    monkeypatch.setattr(EM, 'resize_scribble_image',
                        PM.resize_scribble_image)
    monkeypatch.setattr(EM, 'resize_categorical_image',
                        PM.resize_categorical_image)
    js, ts = _pair(qf=20, hw=48, seed=3)
    des = np.full((40, 40), 60.0, np.float32)
    des[10:30, 12:32] = 220.0
    mask = np.zeros((40, 40), np.float32)
    mask[10:30, 12:32] = 1.0
    args = (des, mask, [10, 8, 24, 24], (16, 16), (16, 16))
    best_j, refined_j = js.find_optimal_imprint_mask(*args)
    best_t, refined_t = ts.find_optimal_imprint_mask(*args)
    np.testing.assert_array_equal(best_t, best_j)
    np.testing.assert_array_equal(refined_t, refined_j)
    assert refined_t.sum() > 0 and not np.array_equal(best_t, args[2])


@pytest.mark.parametrize('hw,out', [((23, 37), (16, 16)),
                                    ((16, 16), (41, 29)),
                                    ((31, 17), (24, 40)),
                                    ((20, 20), (7, 13))])
def test_resize_helpers_match_exsr(hw, out):
    """Odd, up- and down-scaled sizes: the antialiased continuous resize
    within float32 rounding, the categorical one exactly."""
    rng = np.random.default_rng(sum(hw) + sum(out))
    img = rng.uniform(0, 255, hw).astype(np.float32)
    np.testing.assert_allclose(PM.resize_scribble_image(img, out),
                               EM.resize_scribble_image(img, out),
                               rtol=1e-5, atol=1e-4)
    img3 = rng.uniform(size=hw + (3,)).astype(np.float32)
    np.testing.assert_allclose(PM.resize_scribble_image(img3, out),
                               EM.resize_scribble_image(img3, out),
                               atol=1e-6)
    cats = (rng.uniform(size=hw) < 0.5).astype(np.uint8) \
        * rng.integers(1, 4, hw).astype(np.uint8)
    for inclusive in (False, True):
        np.testing.assert_array_equal(
            PM.resize_categorical_image(cats, out, inclusive),
            EM.resize_categorical_image(cats, out, inclusive))
    with pytest.raises(TypeError):
        PM.resize_categorical_image(img, out)


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def test_open_jpeg_and_compose_rgb(tmp_path):
    """A colour file: the recovered (fractional) QF, the file's table, the
    decode, the chroma planes and the full-range composition."""
    js, ts = _pair()
    arr = (_image(48, 7) * 255).astype(np.uint8)
    path = tmp_path / 'c.jpg'
    path.write_bytes(_jpeg(arr, quality=12))
    _close(ts.open_jpeg_file(str(path)), js.open_jpeg_file(str(path)))
    assert ts.qf == pytest.approx(js.qf, rel=1e-12) and ts.qf != int(ts.qf)
    np.testing.assert_array_equal(ts.file_q_table, js.file_q_table)
    _close(ts.file_chroma, js.file_chroma, 1e-3)
    _close(ts.compose_rgb(), js.compose_rgb(), 1e-5)
    grey = _jpeg(arr[..., 0], quality=50)
    _close(ts.open_jpeg_bytes(grey, native=False), js.open_jpeg_bytes(grey))
    assert ts.file_chroma is None
    _close(ts.compose_rgb(), js.compose_rgb())
    from exsr.jpeg.codec import LUMA_Q_TABLE
    coeffs = np.round(np.random.default_rng(1).normal(0, 2, (5, 6, 64))) \
        .astype(np.float32)
    _close(ts.open_coefficients(coeffs, LUMA_Q_TABLE * 1.0),
           js.open_coefficients(coeffs, LUMA_Q_TABLE * 1.0))
    assert ts.out.shape == (1, 40, 48, 1) and 49 < ts.qf < 51


def test_chroma_generator_path():
    """attach_chroma: CbCr from the chroma generator conditioned on the
    edited Y (recompressed-RGB session, studio swing), on the same
    weights."""
    from exsr.models.dncnn import DnCNN, DnCNNConfig
    js, ts = _pair(hw=32)
    js.attach_chroma(None, nf=16, nb=2)
    gc = DnCNN(DnCNNConfig(n_channels=16, depth=2, in_nc=384, out_nc=128,
                           chroma_generator=True, block_size=8,
                           num_latent_channels=0))
    js.chroma_params = gc.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 2, 2, 384)),
                               jnp.zeros((1, 2, 2, 0)))
    ts.attach_chroma(dncnn_from_exsr_vars(jax.tree.map(
        np.asarray, js.chroma_params)), nf=16, nb=2)
    _close(ts.decode_chroma(), js.decode_chroma(), 1e-3)
    _close(ts.compose_rgb(), js.compose_rgb(), 1e-5)
    for s in (js, ts):
        s.set_uniform_z3([0.9, -0.9, 0.5])
    _close(ts.decode_chroma(), js.decode_chroma(), 1e-3)
    ts.attach_chroma(None, nf=16, nb=2)
    with pytest.raises(RuntimeError):
        ts.decode_chroma()


def test_cuda_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        TSession(nf=16, nb=3)
