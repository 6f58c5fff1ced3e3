"""The port's JFIF reader against exsr's, on the CPU: PIL-encoded colour,
grey, 4:4:4 and restart-marker files give identical coefficients, tables
and geometry through both of the port's scan loops (C++ and Python), and
the port rejects what exsr rejects."""
import io

import numpy as np
import pytest
from PIL import Image

from exsr.jpeg import jfif as E
from exsr_torch import native
from exsr_torch.jpeg import jfif as P
from exsr_torch.native import jfif_native
from exsr_torch.ops.kernels import build


def _encode(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def _image(h=72, w=88, seed=11):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3))
    return ((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3) \
        .astype(np.uint8)


FILES = {
    'color_420_qf10': lambda: _encode(_image(), quality=10, subsampling=2),
    'color_420_qf90': lambda: _encode(_image(), quality=90, subsampling=2),
    'color_422_qf50': lambda: _encode(_image(), quality=50, subsampling=1),
    'color_444_qf60': lambda: _encode(_image(), quality=60, subsampling=0),
    'grey_qf75': lambda: _encode(_image()[..., 0], quality=75),
    'restart_rows': lambda: _encode(_image(), quality=80,
                                    restart_marker_rows=1),
    'restart_blocks_grey': lambda: _encode(_image(40, 40)[..., 0],
                                           quality=70,
                                           restart_marker_blocks=3),
    'odd_size': lambda: _encode(_image(37, 53), quality=40),
}


@pytest.fixture(scope='module')
def exsr_python_reader():
    """exsr's reader with its C++ scan switched off (its environment
    switch), for the duration of this module."""
    mp = pytest.MonkeyPatch()
    mp.setenv('EXSR_PURE_JFIF', '1')
    yield
    mp.undo()


def _same(a, b):
    assert (a['width'], a['height']) == (b['width'], b['height'])
    assert len(a['components']) == len(b['components'])
    for x, y in zip(a['components'], b['components']):
        assert x.coeffs.dtype == y.coeffs.dtype == np.int32
        np.testing.assert_array_equal(x.coeffs, y.coeffs)
        np.testing.assert_array_equal(x.q_table, y.q_table)
        assert x.q_table.dtype == y.q_table.dtype
        assert x.sampling == y.sampling


@pytest.mark.parametrize('native_scan', [True, False])
@pytest.mark.parametrize('name', sorted(FILES))
def test_decode_matches_exsr(exsr_python_reader, name, native_scan):
    data = FILES[name]()
    _same(P.decode_jfif(data, native=native_scan), E.decode_jfif(data))


def test_default_picks_the_native_scan_and_loads_files(tmp_path):
    data = FILES['color_420_qf10']()
    assert jfif_native.available()
    _same(P.decode_jfif(data), P.decode_jfif(data, native=False))
    path = tmp_path / 'x.jpg'
    path.write_bytes(data)
    _same(P.load_jpeg_coefficients(str(path), native=True),
          P.decode_jfif(data, native=False))


def _progressive():
    return _encode(np.zeros((16, 16), np.uint8), progressive=True)


def _non_interleaved():
    data = bytearray(_encode(np.full((16, 16, 3), 128, np.uint8),
                             quality=75))
    i = data.find(b'\xff\xda')
    seg_len = int.from_bytes(data[i + 2:i + 4], 'big')
    seg = data[i + 4:i + 2 + seg_len]
    new_seg = bytes([1]) + bytes(seg[1:3]) + bytes(seg[-3:])
    return (bytes(data[:i + 2]) + (len(new_seg) + 2).to_bytes(2, 'big')
            + new_seg + bytes(data[i + 2 + seg_len:]))


def _oversized_dht():
    raw = _encode(np.zeros((16, 16), np.uint8), quality=50)
    payload = bytes([0x00]) + bytes([255] * 16) + bytes(256)
    seg = b'\xff\xc4' + (len(payload) + 2).to_bytes(2, 'big') + payload
    return raw[:2] + seg + raw[2:]


def _bad_code():
    """The entropy-coded data replaced by stuffed 0xFF bytes: a run of
    one-bits, which no standard Huffman table assigns."""
    data = bytearray(_encode(_image(32, 32)[..., 0], quality=75))
    i = data.find(b'\xff\xda')
    start = i + 2 + int.from_bytes(data[i + 2:i + 4], 'big')
    end = data.rfind(b'\xff\xd9')
    n = (end - start) // 2
    return bytes(data[:start]) + b'\xff\x00' * n + bytes(data[end:])


def _sixteen_bit_dqt():
    raw = _encode(np.zeros((16, 16), np.uint8), quality=50)
    payload = bytes([0x10]) + bytes(128)
    seg = b'\xff\xdb' + (len(payload) + 2).to_bytes(2, 'big') + payload
    return raw[:2] + seg + raw[2:]


REJECTED = {
    'progressive': (_progressive, 'non-baseline'),
    'non_interleaved': (_non_interleaved, 'non-interleaved'),
    'oversized_dht': (_oversized_dht, '> 256'),
    'bad_huffman_code': (_bad_code, 'bad Huffman code'),
    'sixteen_bit_dqt': (_sixteen_bit_dqt, '16-bit'),
    'not_a_jpeg': (lambda: b'\x89PNG....', 'missing SOI'),
}


@pytest.mark.parametrize('native_scan', [True, False])
@pytest.mark.parametrize('case', sorted(REJECTED))
def test_rejections_match_exsr(exsr_python_reader, case, native_scan):
    make, message = REJECTED[case]
    data = make()
    with pytest.raises(E.UnsupportedJPEGError, match=message):
        E.decode_jfif(data)
    with pytest.raises(P.UnsupportedJPEGError, match=message):
        P.decode_jfif(data, native=native_scan)


def test_fill_bytes_before_markers():
    data = _encode(np.full((16, 16), 128, np.uint8), quality=75)
    padded = data[:2] + b'\xff\xff\xff' + data[2:]
    _same(P.decode_jfif(padded, native=True), P.decode_jfif(data))


def test_native_true_raises_without_a_compiler(monkeypatch, tmp_path):
    """``native=True`` raises when the C++ scan cannot be built; the
    default falls back to the Python reader; nothing is built next to the
    source."""
    def no_compiler(*a, **k):
        raise FileNotFoundError('g++')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(build.subprocess, 'Popen', no_compiler)
    monkeypatch.setattr(jfif_native, '_lib', None)
    monkeypatch.setattr(jfif_native, '_error', None)
    data = FILES['grey_qf75']()
    with pytest.raises(native.NativeBuildError, match='no g\\+\\+'):
        P.decode_jfif(data, native=True)
    assert not jfif_native.available()
    _same(P.decode_jfif(data), E.decode_jfif(data))
    assert not list((tmp_path / 'build').glob('*.so'))
    assert not list(native.SRC_DIR.glob('*.so'))
