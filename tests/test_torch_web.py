"""The port's exploration server against exsr's, on the CPU.

One exsr ``SessionApi`` over exsr's ``EditSession(nb=1)`` and one port
``SessionApi`` over the port's, on the same weights (exsr's seeded
initialisation carried across by ``from_exsr_params``; the JPEG API at
exsr's fixture sizes, nf 16, nb 3, by ``dncnn_from_exsr_vars``), take the
same requests, in-process through ``dispatch`` and over HTTP.  Responses
are compared field by field: integers, booleans, strings and shapes
equal; decoded PNGs within 1 grey level; losses within 1e-4 of the
largest loss of the response (Adam's normalised steps carry the two
frameworks' fp32 rounding into Z); other floats within 1e-4 relative.
The 'digit' tool runs both packages on one seeded classifier written in
the reference ``.pth`` layout.  After each request that moves Z the port's
session takes exsr's Z (:func:`_sync`), so that every request starts both
from one state: where a gradient element's sign is float32 noise, Adam's
normalised steps move Z by the learning rate either way, and a chain of
edits compounds it (three 'digit' steps leave Z 0.35 apart and the view 2
grey levels apart at 672 pixels, with the losses 1e-5 apart).  The
endpoints that draw random Z
(``random_*``, ``alternative``) draw from exsr's clock-seeded key and the
port's seeded generator, so their shapes and statistics are compared, not
their values.  The tests exsr's ``tests/test_web.py`` marks slow are slow
here too."""
import base64
import io
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.apps import web as X
from exsr.apps.jpeg_session import JPEGEditSession as XJPEG
from exsr.apps.session import EditSession as XSession
from exsr_torch.apps import web as T
from exsr_torch.apps.jpeg_session import JPEGEditSession as TJPEG
from exsr_torch.apps.session import EditSession as TSession
from exsr_torch.models.convert import dncnn_from_exsr_vars, from_exsr_params

HR = 96
LOSS_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def sr_apis():
    xs = XSession(scale=4, nb=1, time_budget_s=600.0)
    xs.init_random_params(0)
    ts = TSession(scale=4, nb=1, time_budget_s=600.0, device='cpu')
    ts.load_params(from_exsr_params(_np_tree(xs.params)))
    return X.SessionApi(xs), T.SessionApi(ts)


@pytest.fixture(scope='module')
def jpeg_apis():
    xs = XJPEG(nf=16, nb=3, latent_channels=64, qf=10)
    xs.init_random_params(0)
    ts = TJPEG(nf=16, nb=3, latent_channels=64, qf=10, device='cpu')
    ts.load_params(dncnn_from_exsr_vars(_np_tree(xs.params)))
    return X.JpegSessionApi(xs), T.JpegSessionApi(ts)


def _serve(api):
    srv = T.make_server(api, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f'http://127.0.0.1:{srv.server_address[1]}'


@pytest.fixture(scope='module')
def sr_servers(sr_apis):
    servers = [_serve(api) for api in sr_apis]
    yield [base for _, base in servers], sr_apis
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope='module')
def jpeg_servers(jpeg_apis):
    servers = [_serve(api) for api in jpeg_apis]
    yield [base for _, base in servers], jpeg_apis
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope='module')
def svhn_weights(tmp_path_factory):
    from test_torch_convert import _svhn_pth
    return _svhn_pth(str(tmp_path_factory.mktemp('svhn') / 'svhn.pth'), 12)


def _post(base, name, body):
    req = urllib.request.Request(
        f'{base}/api/{name}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _png_b64(img01, fmt='PNG', **kw):
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64)))) \
        .astype(np.int64)


def _match(x, t, path=''):
    """exsr's response ``x`` against the port's ``t``."""
    if isinstance(x, dict):
        assert set(x) == set(t), (path, set(x) ^ set(t))
        for k in x:
            if k == 'error':
                assert t[k], path
            elif k == 'png':
                a, b = _decode(x[k]), _decode(t[k])
                assert a.shape == b.shape, path
                assert np.abs(a - b).max() <= 1, (path, np.abs(a - b).max())
            elif k == 'losses':
                a, b = np.asarray(x[k], float), np.asarray(t[k], float)
                assert a.shape == b.shape, path
                assert np.abs(a - b).max() <= LOSS_TOL * np.abs(a).max(), \
                    (path, a, b)
            else:
                _match(x[k], t[k], f'{path}.{k}')
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(t), path
        for i, (a, b) in enumerate(zip(x, t)):
            _match(a, b, f'{path}[{i}]')
    elif isinstance(x, float) and not isinstance(t, bool):
        assert t == pytest.approx(x, rel=LOSS_TOL, abs=1e-7), (path, x, t)
    else:
        assert x == t, (path, x, t)


# the requests that move Z
EDITS = ('optimize', 'digit', 'imprint', 'hsv', 'alternative')


def _sync(apis):
    """The port's session takes exsr's current Z."""
    xs, ts = (api.session for api in apis)
    if xs.cur_z is not None:
        ts.cur_z = np.array(xs.cur_z)
        ts.recompute()


def _both(apis, name, req):
    """One request to both APIs in-process; their responses matched."""
    x, t = (api.dispatch(name, dict(req)) for api in apis)
    _match(x, t, name)
    if name in EDITS:
        _sync(apis)
    return t


def _both_http(servers, name, req):
    bases, apis = servers
    x, t = (_post(b, name, req) for b in bases)
    _match(x, t, name)
    if name in EDITS:
        _sync(apis)
    return t


def _image(seed, hw=HR):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(hw, hw, 3))
    return ((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3) \
        .astype(np.float32)


def test_page_served(sr_servers):
    with urllib.request.urlopen(sr_servers[0][1] + '/', timeout=30) as r:
        page = r.read().decode()
    assert 'explorable' in page and 'api/' in page
    assert page == X.PAGE == T.PAGE


def test_request_sequence_matches_exsr(sr_apis, svhn_weights):
    """The SR tool chain in-process: open, the views, a region, the
    Z sliders, two edits, undo and redo, the kernel switch, a polygon,
    periodicity, digit and state."""
    img = _image(0)
    out = _both(sr_apis, 'open', {'image': _png_b64(img), 'is_hr': True})
    assert out == {'sr_shape': [1, HR, HR, 3], 'lr_shape': [1, 24, 24, 3]}
    for which in ('sr', 'lr', 'gt', 'z'):
        _both(sr_apis, 'view', {'which': which})
    assert _both(sr_apis, 'region', {'rect': [16, 16, 80, 80]}) == \
        {'selected_px': 64 * 64}
    _both(sr_apis, 'uniform_z', {'values': [0.7, -0.4, 0.2]})
    _both(sr_apis, 'view', {'which': 'sr'})
    _both(sr_apis, 'svd', {'lambda0': 1.0, 'lambda1': 0.2, 'theta': 0.7})
    _both(sr_apis, 'view', {'which': 'z'})
    out = _both(sr_apis, 'optimize', {'objective': 'max_STD',
                                      'max_iters': 5})
    assert out['rounds'] == 1 and len(out['losses']) == 5
    desired = _image(1)
    out = _both(sr_apis, 'optimize', {'objective': 'l1', 'max_iters': 5,
                                      'data': {'desired':
                                               _png_b64(desired)}})
    assert out['losses'][-1] < out['losses'][0]
    _both(sr_apis, 'view', {'which': 'sr'})
    assert _both(sr_apis, 'state', {})['can_undo']
    _both(sr_apis, 'undo', {})
    assert _both(sr_apis, 'state', {})['can_redo']
    _both(sr_apis, 'redo', {})
    _both(sr_apis, 'view', {'which': 'sr'})
    out = _both(sr_apis, 'kernel', {'kind': 'blurry_cubic_1.0'})
    assert out['margins_lr'] > 0
    _both(sr_apis, 'view', {'which': 'sr'})
    _both(sr_apis, 'kernel', {'kind': 'bicubic'})
    _both(sr_apis, 'kernel', {'kind': 'gaussian'})     # an error
    out = _both(sr_apis, 'region', {'polygon': [[10, 10], [10, 60],
                                                [60, 35]]})
    assert 0 < out['selected_px'] < HR * HR
    _both(sr_apis, 'region', {})                       # an error
    _both(sr_apis, 'periodicity', {'origin': [40, 40],
                                   'points': [[40, 60], [60, 40]]})
    _both(sr_apis, 'region', {'rect': [30, 30, 70, 62]})
    out = _both(sr_apis, 'digit', {'digit': 3, 'max_iters': 3,
                                   'weights': svhn_weights})
    assert np.isfinite(out['final_loss'])
    _both(sr_apis, 'view', {'which': 'sr'})
    _both(sr_apis, 'state', {})
    _both(sr_apis, 'nope', {})


@pytest.mark.slow
def test_full_edit_flow(sr_servers, tmp_path):
    """exsr's HTTP flow on both servers: open -> region -> uniform Z ->
    optimize -> undo -> save/load Z -> kernel switch -> polygon."""
    img = _image(2)
    _both_http(sr_servers, 'open', {'image': _png_b64(img), 'is_hr': True})
    sr0 = _both_http(sr_servers, 'view', {'which': 'sr'})['png']
    _both_http(sr_servers, 'region', {'rect': [16, 16, 80, 80]})
    _both_http(sr_servers, 'uniform_z', {'values': [0.7, -0.4, 0.2]})
    _both_http(sr_servers, 'optimize', {'objective': 'max_STD',
                                        'max_iters': 5})
    _both_http(sr_servers, 'undo', {})
    _both_http(sr_servers, 'undo', {})
    back = _both_http(sr_servers, 'view', {'which': 'sr'})['png']
    np.testing.assert_array_equal(_decode(back), _decode(sr0))
    for i, base in enumerate(sr_servers[0]):
        path = str(tmp_path / f'z{i}.npz')
        assert _post(base, 'save_z', {'path': path})['ok']
        assert _post(base, 'load_z', {'path': path})['ok']
    _both_http(sr_servers, 'kernel', {'kind': 'blurry_cubic_1.0'})
    _both_http(sr_servers, 'view', {'which': 'sr'})
    _both_http(sr_servers, 'kernel', {'kind': 'bicubic'})
    _both_http(sr_servers, 'region', {'polygon': [[10, 10], [10, 60],
                                                  [60, 35]]})
    _both_http(sr_servers, 'nope', {})


def test_jpeg_web_flow(jpeg_servers, tmp_path, svhn_weights):
    """JPEG mode over HTTP: open at QF -> views -> region -> uniform Z ->
    optimize -> a digit -> undo -> Z save/load -> the SR-only errors ->
    save_outputs."""
    img = _image(3, 64)
    out = _both_http(jpeg_servers, 'open', {'image': _png_b64(img),
                                            'qf': 10})
    assert out['out_shape'] == [1, 64, 64, 1] and out['qf'] == 10.0
    assert _both_http(jpeg_servers, 'state', {})['mode'] == 'jpeg'
    for which in ('out', 'input', 'rgb', 'z'):
        _both_http(jpeg_servers, 'view', {'which': which})
    assert _both_http(jpeg_servers, 'region',
                      {'rect': [16, 16, 48, 48]})['selected_px'] == 32 * 32
    _both_http(jpeg_servers, 'uniform_z', {'values': [0.9, -0.4, 0.2]})
    out = _both_http(jpeg_servers, 'optimize', {'objective': 'max_STD',
                                                'max_iters': 4})
    assert len(out['losses']) == 4
    _both_http(jpeg_servers, 'view', {'which': 'out'})
    out = _both_http(jpeg_servers, 'digit', {'digit': 5, 'max_iters': 3,
                                             'weights': svhn_weights})
    assert np.isfinite(out['final_loss'])
    _both_http(jpeg_servers, 'view', {'which': 'out'})
    _both_http(jpeg_servers, 'undo', {})
    for i, base in enumerate(jpeg_servers[0]):
        path = str(tmp_path / f'z{i}.npz')
        assert _post(base, 'save_z', {'path': path})['ok']
        assert _post(base, 'load_z', {'path': path})['ok']
    for name in ('svd', 'kernel', 'periodicity', 'region_from_z',
                 'find_imprint_location'):
        _both_http(jpeg_servers, name, {'image': _png_b64(img[:8, :8])})
    paths = [_post(b, 'save_outputs', {'path': str(tmp_path / f'j{i}')})
             for i, b in enumerate(jpeg_servers[0])]
    assert all(p['out'].endswith('_out.png') and 'z' not in p
               for p in paths)
    a, b = (np.asarray(Image.open(p['out'])).astype(int) for p in paths)
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a - b).max() <= 1


def test_jpeg_web_opens_real_jpeg_coefficients(jpeg_servers):
    """A real JPEG upload edits its own quantised coefficients (exact DQT),
    and its plain decode is the 'input' view; ``recompress`` opens the
    pixels instead."""
    rng = np.random.default_rng(1)
    b64 = _png_b64(rng.uniform(size=(64, 64, 3)), fmt='JPEG', quality=20)
    out = _both_http(jpeg_servers, 'open', {'image': b64})
    assert out['source'] == 'jpeg-coefficients' and 10 <= out['qf'] <= 35
    for which in ('input', 'out', 'rgb'):
        _both_http(jpeg_servers, 'view', {'which': which})
    out = _both_http(jpeg_servers, 'open', {'image': b64, 'recompress': True})
    assert out['source'] == 'recompressed'
    _both_http(jpeg_servers, 'view', {'which': 'input'})


@pytest.mark.slow
def test_editing_tools_flow(sr_apis, svhn_weights):
    """Imprint (auto-located, resized, transparent), HSV, digit and
    scribble through both APIs."""
    img = _image(4)
    _both(sr_apis, 'open', {'image': _png_b64(img), 'is_hr': True})
    imprint = 0.9 * np.ones((16, 16, 3), np.float32)
    loc = _both(sr_apis, 'find_imprint_location',
                {'image': _png_b64(imprint), 'search_rect': [8, 8, 88, 88],
                 'n_trials': 20})
    y, x = loc['position']
    _both(sr_apis, 'imprint', {'image': _png_b64(imprint), 'size': [24, 24],
                               'position': [y, x], 'optimize_iters': 4})
    timp = np.ones((16, 16, 3), np.float32)
    timp[4:12, 4:12] = [0.1, 0.6, 0.1]
    _both(sr_apis, 'imprint', {'image': _png_b64(timp), 'position': [y, x],
                               'transparent': True, 'optimize_iters': 3})
    _both(sr_apis, 'imprint', {'image': _png_b64(imprint), 'auto': True,
                               'search_rect': [8, 8, 88, 88],
                               'n_trials': 10, 'optimize_iters': 2})
    _both(sr_apis, 'region', {'rect': [16, 16, 80, 80]})
    _both(sr_apis, 'hsv', {'hue_shift': 40.0, 'sat': 1.3, 'val': 0.9,
                           'optimize_iters': 4})
    _both(sr_apis, 'digit', {'digit': 3, 'max_iters': 2,
                             'weights': svhn_weights})
    sr = _decode(_both(sr_apis, 'view', {'which': 'sr'})['png']) / 255.0
    desired = sr.copy()
    desired[30:40, 30:50] = [1.0, 0.1, 0.1]
    smask = np.zeros((HR, HR), np.uint8)
    smask[30:40, 30:50] = 1
    smask[50:60, 30:50] = 2
    smask[70:78, 30:50] = 5
    mask_rgb = np.repeat(smask[..., None], 3, -1) * 16 / 255.0
    _both(sr_apis, 'optimize', {
        'objective': 'scribble', 'max_iters': 4,
        'data': {'desired': _png_b64(desired),
                 'scribble_mask': _png_b64(mask_rgb),
                 'brightness_factor': 0.3}})
    _both(sr_apis, 'view', {'which': 'sr'})
    assert _both(sr_apis, 'state', {})['can_undo']


@pytest.mark.slow
def test_jpeg_imprint_and_tool_errors(jpeg_apis, svhn_weights):
    """JPEG mode: the Y imprint, HSV with and without its note, digit with
    the auto flow over 0-9 on the same classifier, and a scribble."""
    img = _image(5, 64)
    _both(jpeg_apis, 'open', {'image': _png_b64(img), 'qf': 10,
                              'recompress': True})
    imprint = 0.8 * np.ones((16, 16, 3), np.float32)
    _both(jpeg_apis, 'imprint', {'image': _png_b64(imprint),
                                 'position': [8, 8], 'size': [16, 16],
                                 'optimize_iters': 3})
    assert 'note' not in _both(jpeg_apis, 'hsv', {'val': 0.8,
                                                  'optimize_iters': 2})
    assert 'note' in _both(jpeg_apis, 'hsv', {'hue_shift': 30.0,
                                              'optimize_iters': 1})
    _both(jpeg_apis, 'region', {'rect': [8, 8, 40, 40]})
    _both(jpeg_apis, 'digit', {'digit': 3, 'max_iters': 2,
                               'weights': svhn_weights})
    out = _both(jpeg_apis, 'digit', {'auto': True, 'max_iters': 1,
                                     'weights': svhn_weights})
    assert 'most_likely' in out
    _both(jpeg_apis, 'view', {'which': 'out'})
    view = _decode(_both(jpeg_apis, 'view', {'which': 'out'})['png']) / 255.
    desired = view[..., :3].copy()
    desired[10:18, 10:30] = [1.0, 1.0, 1.0]
    smask = np.zeros(view.shape[:2], np.uint8)
    smask[10:18, 10:30] = 1
    smask[20:26, 10:30] = 3
    smask[28:36, 10:30] = 5
    mask_rgb = np.repeat(smask[..., None], 3, -1) * 16 / 255.0
    _both(jpeg_apis, 'optimize', {
        'objective': 'scribble', 'max_iters': 3,
        'data': {'desired': _png_b64(desired),
                 'scribble_mask': _png_b64(mask_rgb),
                 'brightness_factor': 0.3}})


def _alternative_moves(base, region):
    """How far each retained alternative of an HTTP server moves the
    image inside the region (mean grey levels), its shape checked."""
    y0, x0, y1, x1 = region
    cur = _decode(_post(base, 'view', {'which': 'sr'})['png'])
    moves = []
    for i in range(2):
        alt = _decode(_post(base, 'alternative', {'index': i})['png'])
        assert alt.shape == cur.shape
        moves.append(np.abs(alt - cur)[y0:y1, x0:x1].mean())
    return moves


def test_alternatives_and_invert_region(sr_servers):
    """Random alternatives: the same count, shapes and push/adopt/range
    behaviour; the alternatives move the image inside the region (each
    package by its own random draws) by a mean within 25 % of exsr's."""
    img = _image(7)
    _both_http(sr_servers, 'open', {'image': _png_b64(img), 'is_hr': True})
    _both_http(sr_servers, 'region', {'rect': [16, 16, 80, 80]})
    assert _both_http(sr_servers, 'invert_region', {})['selected_px'] == \
        HR * HR - 64 * 64
    _both_http(sr_servers, 'invert_region', {})
    outs = [_post(b, 'optimize', {'objective': 'random_l1',
                                  'n_alternatives': 3, 'max_iters': 4})
            for b in sr_servers[0]]
    for o in outs:
        assert o['n_alternatives'] == 2 and o['rounds'] == 1
        # max_iters rounds up to whole rounds of 5 steps, as in exsr
        assert len(o['losses']) == 5 and np.isfinite(o['final_loss'])
        assert o['final_loss'] < 0      # the diversity grew
    means = [np.mean(_alternative_moves(base, (16, 16, 80, 80)))
             for base in sr_servers[0]]
    # each package moves the region by its own random draws, about alike
    # (measured ~5.4 grey levels in both)
    assert min(means) > 0.5
    assert abs(means[1] - means[0]) <= 0.25 * means[0]
    _both_http(sr_servers, 'alternative', {'index': 1, 'copy': True})
    _both_http(sr_servers, 'alternative', {'push': True})
    _both_http(sr_servers, 'alternative', {'index': 9})        # an error
    _both_http(sr_servers, 'clear_region', {})
    assert _both_http(sr_servers, 'invert_region', {})['selected_px'] == 0
    _both_http(sr_servers, 'optimize', {'objective': 'max_STD',
                                        'max_iters': 2})       # an error
    _both_http(sr_servers, 'invert_region', {})
    _both_http(sr_servers, 'open', {'image': _png_b64(img), 'is_hr': True})
    _both_http(sr_servers, 'alternative', {'index': 0})        # an error


def test_save_outputs_and_region_from_z(sr_servers, tmp_path):
    img = _image(11)
    _both_http(sr_servers, 'open', {'image': _png_b64(img), 'is_hr': True})
    _both_http(sr_servers, 'region', {'rect': [32, 32, 64, 64]})
    _both_http(sr_servers, 'uniform_z', {'values': [0.9, 0.9, 0.9]})
    outs = [_post(b, 'save_outputs', {'path': str(tmp_path / f's{i}')})
            for i, b in enumerate(sr_servers[0])]
    for key in ('out', 'z'):
        a, b = (np.asarray(Image.open(o[key])).astype(int) for o in outs)
        assert a.shape == b.shape == (HR, HR, 3)
        assert np.abs(a - b).max() <= (1 if key == 'out' else 0)
    _both_http(sr_servers, 'clear_region', {})
    r = _both_http(sr_servers, 'region_from_z', {'path': outs[1]['z']})
    assert 32 * 32 <= r['selected_px'] <= 34 * 34
    bad = np.full((8, 8, 3), 0.2, np.float32)
    _both_http(sr_servers, 'region_from_z', {'image': _png_b64(bad)})


def test_page_script_consistency():
    """Every getElementById target exists in the markup, brackets balance
    in the script, and every api('name') call has an endpoint on the
    port's SR API."""
    import re
    body, script = T.PAGE.split('<script>')
    script = script.split('</script>')[0]
    ids_used = set(re.findall(r"getElementById\('([^']+)'\)", script))
    ids_defined = set(re.findall(r'id="([^"]+)"', body))
    assert not ids_used - ids_defined
    for o, c in ('()', '{}', '[]'):
        assert script.count(o) == script.count(c), f'unbalanced {o}{c}'
    endpoints = set(re.findall(r"api\('([^']+)'", script))
    assert endpoints
    for ep in endpoints:
        assert callable(getattr(T.SessionApi, ep, None)), ep
        assert callable(getattr(T.JpegSessionApi, ep, None)), ep


def test_scribble_mask_decode_formats():
    """The 16-wide bucket wire format with the antialiased fringe gated by
    alpha, and the legacy raw-id format: the same ids as exsr's."""
    def b64_rgba(arr):
        buf = io.BytesIO()
        Image.fromarray(arr, 'RGBA').save(buf, format='PNG')
        return 'data:image/png;base64,' + base64.b64encode(
            buf.getvalue()).decode()

    a = np.zeros((4, 6, 4), np.uint8)
    a[0, 0] = [2 * 16, 2 * 16, 2 * 16, 255]
    a[1, 1] = [15 * 16, 15 * 16, 15 * 16, 255]
    a[2, 2] = [2 * 16 + 3, 2 * 16 + 3, 2 * 16 + 3, 255]
    a[3, 3] = [2 * 16, 2 * 16, 2 * 16, 40]
    ids = T._decode_scribble_mask(b64_rgba(a))
    assert ids[0, 0] == 2 and ids[1, 1] == 15 and ids[2, 2] == 2
    assert ids[3, 3] == 0 and ids[0, 5] == 0
    np.testing.assert_array_equal(ids, X._decode_scribble_mask(b64_rgba(a)))
    legacy = np.zeros((3, 3, 4), np.uint8)
    legacy[0, 0] = [1, 1, 1, 255]
    legacy[1, 1] = [5, 5, 5, 255]
    ids = T._decode_scribble_mask(b64_rgba(legacy))
    assert ids[0, 0] == 1 and ids[1, 1] == 5
    np.testing.assert_array_equal(ids,
                                  X._decode_scribble_mask(b64_rgba(legacy)))
    poly = [[3.5, 2.0], [20.0, 9.0], [11.0, 25.5], [2.0, 18.0]]
    np.testing.assert_array_equal(T._polygon_mask(poly, (24, 28)),
                                  X._polygon_mask(poly, (24, 28)))


def test_esrgan_comparison_view():
    """The plain-ESRGAN view: an error until attached, then the Z-less,
    CEM-less generator on the LR image, equal to exsr's on the same
    weights, cached per working image."""
    from exsr.models.rrdb import RRDBNet as XNet
    import jax.numpy as jnp
    apis = []
    p0 = XNet(nb=1, upscale=4, latent_channels=0).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)), None)
    for sess, api_cls, params in (
            (XSession(scale=4, nb=1), X.SessionApi, p0),
            (TSession(scale=4, nb=1, device='cpu'), T.SessionApi,
             from_exsr_params(_np_tree(p0)))):
        sess.init_random_params(0)
        apis.append(api_cls(sess))
        api_cls(sess).open({'image': _png_b64(_image(8, 64)),
                            'is_hr': True})
        assert 'esrgan' in api_cls(sess).view({'which': 'esrgan'})['error'] \
            .lower()
        sess.attach_esrgan(params)
    _both(apis, 'view', {'which': 'esrgan'})
    ts = apis[1].session
    e1 = ts.esrgan_sr()
    assert e1.shape == ts.sr.shape and np.abs(e1 - ts.sr).max() > 1e-4
    assert ts.esrgan_sr() is e1
    _both(apis, 'open', {'image': _png_b64(_image(8, 48)), 'is_hr': True})
    e2 = ts.esrgan_sr()
    assert e2 is not e1 and e2.shape == ts.sr.shape
    _both(apis, 'view', {'which': 'esrgan'})


def test_main_accepts_gui_opt_configs(tmp_path):
    """``web --opt`` with a GUI_SR / GUI_JPEG style config decides the mode
    and the generator as exsr's does; explicit flags win; ``--checkpoint``
    and ``--esrgan_checkpoint`` load the port's checkpoints."""
    gui_sr = {
        'name': 'g', 'model': 'srragan', 'scale': 4,
        'path': {'root': str(tmp_path)},
        'network_G': {'which_model_G': 'RRDB_net', 'CEM_arch': 1,
                      'latent_input': 'all_layers', 'latent_channels': 3,
                      'nf': 64, 'nb': 1, 'in_nc': 3, 'out_nc': 3, 'gc': 32}}
    p1 = tmp_path / 'gui_sr.json'
    p1.write_text(json.dumps(gui_sr))
    srv = T.main(['--opt', str(p1), '--port', '0', '--device', 'cpu'],
                 serve=False)
    try:
        assert isinstance(srv.api, T.SessionApi)
        assert srv.api.session.nb == 1
        assert srv.api.session.latent_channels == 3
        assert str(srv.api.session._device) == 'cpu'
    finally:
        srv.server_close()
    gui_jpeg = {
        'name': 'gj', 'model': 'dncnn', 'scale': 4,
        'path': {'root': str(tmp_path)},
        'network_G': {'which_model_G': 'DnCNN', 'DCT_G': 1,
                      'latent_input': 'all_layers', 'latent_channels': 64,
                      'nf': 8, 'nb': 2, 'in_nc': 64, 'out_nc': 64},
        'network_G_Y': {'nf': 16, 'nb': 3}}
    p2 = tmp_path / 'gui_jpeg.json'
    p2.write_text(json.dumps(gui_jpeg))
    srv2 = T.main(['--opt', str(p2), '--port', '0', '--device', 'cpu'],
                  serve=False)
    try:
        api2 = srv2.api
        assert isinstance(api2, T.JpegSessionApi)
        assert api2.session.nf == 16 and api2.session.nb == 3
        assert api2.session.latent_channels == 64
    finally:
        srv2.server_close()
    srv3 = T.main(['--opt', str(p1), '--nb', '2', '--port', '0',
                   '--device', 'cpu'], serve=False)
    try:
        assert srv3.api.session.nb == 2
    finally:
        srv3.server_close()
    # the port's checkpoint layout, for the generator and the ESRGAN view
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.train.checkpoints import CheckpointManager
    for name, nz, seed in (('g', 3, 4), ('e', 0, 5)):
        CheckpointManager(str(tmp_path / name)).save(0, {
            'g_params': RRDBNet(nb=1, latent_channels=nz,
                                seed=seed).state_dict()})
    srv4 = T.main(['--nb', '1', '--checkpoint', str(tmp_path / 'g'),
                   '--esrgan_checkpoint', str(tmp_path / 'e'), '--port',
                   '0', '--device', 'cpu'], serve=False)
    try:
        s = srv4.api.session
        ref = RRDBNet(nb=1, latent_channels=3, seed=4).state_dict()
        assert torch.equal(s.params['fea_conv.weight'],
                           ref['fea_conv.weight'])
        assert torch.equal(s._esrgan.hr_conv1.weight, RRDBNet(
            nb=1, seed=5).hr_conv1.weight)
    finally:
        srv4.server_close()
