"""The port's DCT and JPEG codec against exsr's, on the CPU: the DCT round
trip, the QF tables bit for bit, compress/extract in luma and chroma mode
(every packed layout) with the quantisation tie rule, zigzag and the
bin-consistency clamp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.jpeg import codec as E
from exsr.ops import dct as ED
from exsr_torch.jpeg import codec as P
from exsr_torch.ops import dct as PD


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: under the suite's parallel workers, torch's
    default of one thread per core spins them against each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _images(n, h, w, seed):
    """Y images in [0, 255]: smooth content plus strong noise, so that every
    frequency, and quantisation ties, occur."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    out = []
    for _ in range(n):
        base = sum(np.sin(2 * np.pi * (f * yy + g * xx + p))
                   for f, g, p in rng.uniform(0.5, 6, size=(3, 3)))
        out.append(np.clip(128 + 30 * base + 25 * rng.standard_normal(
            (h, w)), 0, 255))
    return np.stack(out)[..., None].astype(np.float32)


def _assert_quantised(port, ref, unquantised):
    """Equal, except where exsr's unquantised value lies within 1e-3 of a
    half-integer: there the two may differ by exactly 1."""
    diff = np.abs(np.asarray(port, np.float64) - np.asarray(ref))
    u = np.asarray(unquantised, np.float64)
    tie = np.abs(np.abs(u - np.floor(u)) - 0.5) < 1e-3
    assert diff.max() <= 1
    assert not (diff[~tie] > 0).any(), int((diff[~tie] > 0).sum())


@pytest.mark.parametrize('bs', [8, 16])
def test_dct_round_trip_and_parity(bs):
    img = _images(2, 4 * bs, 3 * bs, seed=bs)
    coeffs = PD.image_to_dct(torch.from_numpy(img), bs=bs)
    ref = np.asarray(ED.image_to_dct(jnp.asarray(img), bs=bs))
    assert coeffs.shape == (2, 4, 3, bs * bs)
    # fp32 sums of up to bs * 255 in another order: 2e-6 of the largest
    np.testing.assert_allclose(coeffs.numpy(), ref,
                               atol=2e-6 * np.abs(ref).max())
    back = PD.dct_to_image(coeffs, bs=bs).numpy()
    np.testing.assert_allclose(back, img, atol=1e-3)
    np.testing.assert_allclose(
        back, np.asarray(ED.dct_to_image(jnp.asarray(ref), bs=bs)),
        atol=1e-3)
    np.testing.assert_array_equal(PD.dct_matrix(bs), ED.dct_matrix(bs))
    blocks = PD.blockize(torch.from_numpy(img), bs)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(ED.blockize(jnp.asarray(img), bs)))
    np.testing.assert_array_equal(PD.unblockize(blocks).numpy(), img)


FRACTIONAL_QFS = [0.5, 7.25, 12.345, 33.3, 49.99, 50.01, 66.6666, 99.9,
                  17.4732, 43.51]


@pytest.mark.parametrize('table', ['luma', 'luma16', 'chroma16'])
def test_q_tables_bit_equal_for_every_qf(table):
    """Every integer QF 1-100 and fractional ones (a file's recovered QF):
    the float32 recipe, bit for bit; a float64 one would differ."""
    base = {'luma': E.LUMA_Q_TABLE,
            'luma16': E.pad_q_table(E.LUMA_Q_TABLE, 16),
            'chroma16': E.pad_q_table(E.CHROMA_Q_TABLE, 16)}[table]
    rng = np.random.default_rng(1)
    qfs = np.concatenate([np.arange(1, 101), FRACTIONAL_QFS,
                          rng.uniform(1, 100, 500)]).astype(np.float32)
    ref = np.asarray(E.scaled_q_table(jnp.asarray(qfs), base))
    port = P.scaled_q_table(torch.from_numpy(qfs), base).numpy()
    assert port.shape == ref.shape == (len(qfs), 1, 1, base.size)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(P.qf_to_factor(qfs).numpy(),
                                  np.asarray(E.qf_to_factor(qfs)))
    # the codec's own tables
    codec = P.JPEGCodec(chroma_mode=table != 'luma', block_size=16
                        if table != 'luma' else 8)
    tables = codec.q_tables(qfs)
    got = tables if table == 'luma' else tables[table == 'chroma16']
    np.testing.assert_array_equal(got.numpy(), ref)


def test_luma_compress_extract_with_tie_rule():
    """A batch of per-row QFs; the quantised coefficients equal exsr's but
    at ties; ``q=`` overrides the table."""
    img = _images(4, 48, 64, seed=3)
    qf = np.array([5.0, 10.0, 50.0, 95.0], np.float32)
    e, p = E.JPEGCodec(), P.JPEGCodec()
    unq = np.asarray(e.compress(jnp.asarray(img), jnp.asarray(qf),
                                quantize=False))
    port_unq = p.compress(torch.from_numpy(img), qf, quantize=False).numpy()
    np.testing.assert_allclose(port_unq, unq, atol=2e-6 * np.abs(unq).max())
    ref = np.asarray(e.compress(jnp.asarray(img), jnp.asarray(qf)))
    port = p.compress(torch.from_numpy(img), qf)
    _assert_quantised(port.numpy(), ref, unq)
    ext = p.extract(torch.tensor(ref), qf).numpy()
    np.testing.assert_allclose(
        ext, np.asarray(e.extract(jnp.asarray(ref), jnp.asarray(qf))),
        atol=1e-3)
    # an explicit table (a file's DQT)
    q = np.random.default_rng(2).integers(1, 40, (1, 1, 1, 64)) \
        .astype(np.float32)
    ref_q = np.asarray(e.compress(jnp.asarray(img), None, q=jnp.asarray(q)))
    unq_q = np.asarray(e.compress(jnp.asarray(img), None, quantize=False,
                                  q=jnp.asarray(q)))
    _assert_quantised(p.compress(torch.from_numpy(img), None,
                                 q=q).numpy(), ref_q, unq_q)
    np.testing.assert_allclose(
        p.extract(torch.tensor(ref_q), None, q=q).numpy(),
        np.asarray(e.extract(jnp.asarray(ref_q), None, q=jnp.asarray(q))),
        atol=1e-3)
    with pytest.raises(ValueError):
        P.JPEGCodec(chroma_mode=True, block_size=16).compress(
            torch.from_numpy(img), qf)


def _ycbcr(n, hw, seed):
    y = _images(n, hw, hw, seed)
    cb = _images(n, hw, hw, seed + 1)
    cr = _images(n, hw, hw, seed + 2)
    return np.concatenate([y, cb, cr], -1)


@pytest.mark.parametrize('mode', [True, 'downsample_only', False])
def test_chroma_compress_every_mode(mode):
    img = _ycbcr(2, 32, seed=4)
    qf = np.array([10.0, 75.0], np.float32)
    e = E.JPEGCodec(chroma_mode=True, block_size=16)
    p = P.JPEGCodec(chroma_mode=True, block_size=16)
    ref = np.asarray(e.compress_ycbcr(jnp.asarray(img), jnp.asarray(qf),
                                      mode))
    port = p.compress_ycbcr(torch.from_numpy(img), qf, mode).numpy()
    assert port.shape == ref.shape
    assert ref.shape[-1] == (3 * 256 if mode is False else 256 + 128)
    if mode is True:
        unq = np.asarray(e.compress_ycbcr(jnp.asarray(img), jnp.asarray(qf),
                                          'downsample_only'))
        _assert_quantised(port[..., 256:], ref[..., 256:], unq[..., 256:])
        port, ref = port[..., :256], ref[..., :256]
    np.testing.assert_allclose(port, ref, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize('layout', ['y+low', 'low', 'full'])
def test_chroma_extract_every_layout(layout):
    img = _ycbcr(2, 32, seed=5)
    qf = np.array([20.0, 60.0], np.float32)
    e = E.JPEGCodec(chroma_mode=True, block_size=16)
    p = P.JPEGCodec(chroma_mode=True, block_size=16)
    packed = np.asarray(e.compress_ycbcr(jnp.asarray(img), jnp.asarray(qf)))
    full = np.asarray(e.compress_ycbcr(jnp.asarray(img), jnp.asarray(qf),
                                       False))
    x = {'y+low': packed, 'low': packed[..., 256:],
         'full': full[..., 256:]}[layout]
    ref = np.asarray(e.extract_ycbcr(jnp.asarray(x), jnp.asarray(qf)))
    port = p.extract_ycbcr(torch.tensor(x), qf).numpy()
    assert port.shape == ref.shape == (2, 32, 32, 3 if layout == 'y+low'
                                       else 2)
    np.testing.assert_allclose(port, ref, atol=1e-3)
    with pytest.raises(ValueError, match='channel count'):
        p.extract_ycbcr(torch.zeros(1, 2, 2, 100), qf[:1])


def test_zigzag_pad_and_clamp():
    flat = np.arange(64)
    np.testing.assert_array_equal(P.zigzag_decode_q_table(flat),
                                  E.zigzag_decode_q_table(flat))
    np.testing.assert_array_equal(P.ZIGZAG_ORDER, E.ZIGZAG_ORDER)
    np.testing.assert_array_equal(P.pad_q_table(P.CHROMA_Q_TABLE, 16),
                                  E.pad_q_table(E.CHROMA_Q_TABLE, 16))
    rng = np.random.default_rng(6)
    c = rng.normal(0, 3, (2, 3, 3, 64)).astype(np.float32)
    q = np.round(rng.normal(0, 3, c.shape)).astype(np.float32)
    port = P.consistency_clamp(torch.from_numpy(c), torch.from_numpy(q))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(E.consistency_clamp(jnp.asarray(c),
                                                     jnp.asarray(q))))
    assert (port - torch.from_numpy(q)).abs().max() <= 0.5
