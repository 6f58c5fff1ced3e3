"""The port's hand-written kernels on the GPU, each against its plain
PyTorch version, and the port's forward on CUDA against the same forward on
the CPU.  Every test needs CUDA and skips without it.

This file imports no JAX, so that it runs on a GPU machine without it::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import contextlib

import numpy as np
import pytest
import torch

from exsr_torch.apps.eval_sr import build_model
from exsr_torch.cem.cem import CEM, CEMConf
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.ops.kernels import rrdb_block as K
from exsr_torch.ops import filters as F
from exsr_torch.ops.kernels.sepfilter import (sepfilter_down,
                                              sepfilter_down_plain,
                                              sepfilter_edge,
                                              sepfilter_edge_plain,
                                              sepfilter_up,
                                              sepfilter_up_plain)
from exsr_torch.ops.kernels.stage4 import stage4, stage4_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs CUDA: the kernels have no CPU or interpret mode')
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda')
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _rand(gen, *shape, dtype=torch.float32, device='cuda'):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize('shape,kh,kw', [((2, 70, 130, 3), 27, 17),
                                         ((1, 16, 64, 1), 1, 3),
                                         ((3, 9, 5, 4), 17, 27),
                                         ((2, 70, 130, 3), 4, 17),
                                         ((3, 9, 5, 4), 8, 6)])
def test_sepfilter_kernel_matches_plain(cuda, shape, kh, kw):
    """Odd and even tap counts; an even one grows its axis by one."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(*shape, generator=gen, device=cuda)
    kcol, krow = _rand(gen, kh), _rand(gen, kw)
    before = sepfilter_edge.launches
    out = sepfilter_edge(x, kcol, krow)
    torch.cuda.synchronize()
    assert sepfilter_edge.launches == before + 1
    ref = sepfilter_edge_plain(x, kcol, krow)
    b, h, w, c = shape
    assert out.shape == ref.shape == (b, h + 1 - kh % 2, w + 1 - kw % 2, c)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def _cem_taps(sf, which, device):
    """(kcol, krow, pre) of the bicubic CEM's ``which`` filter at ``sf``."""
    filt = CEM.create(CEMConf(scale_factor=sf)).device_filters(
        3, device=device)
    return (*getattr(filt, which), filt.pre)


# LR sizes: tiles of the up kernel (32 x 64 HR) and of the down kernel
# (8 LR rows) are not whole; one image smaller than every tile
LR_SHAPES = [(2, 13, 21), (1, 3, 2), (2, 37, 70)]


@pytest.mark.parametrize('c', [1, 3, 4])
@pytest.mark.parametrize('sf', [2, 3, 4, 8])
@pytest.mark.parametrize('b,h,w', LR_SHAPES)
def test_sepfilter_down_kernel_matches_plain_and_composition(cuda, sf, c, b,
                                                             h, w):
    """Against its plain version to 1e-5; against aliased_subsample of the
    same-size kernel bit for bit (the same operations in the same order);
    three runs bit-equal.  One HR size that is not a multiple of sf."""
    kcol, krow, pre = _cem_taps(sf, 'w_down_1d', cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    for hh, ww in ((sf * h, sf * w), (sf * h + 1, sf * w + sf - 1)):
        x = torch.rand(b, hh, ww, c, generator=gen, device=cuda)
        before = sepfilter_down.launches
        out = sepfilter_down(x, kcol, krow, sf, pre)
        torch.cuda.synchronize()
        assert sepfilter_down.launches == before + 1
        ref = sepfilter_down_plain(x, kcol, krow, sf, pre)
        assert out.shape == ref.shape
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        composed = F.aliased_subsample(sepfilter_edge(x, kcol, krow), sf, pre)
        assert torch.equal(out, composed)
        for _ in range(2):
            assert torch.equal(sepfilter_down(x, kcol, krow, sf, pre), out)


@pytest.mark.parametrize('combine', [False, True])
@pytest.mark.parametrize('c', [1, 3, 4])
@pytest.mark.parametrize('sf', [2, 3, 4, 8])
@pytest.mark.parametrize('b,h,w', LR_SHAPES)
def test_sepfilter_up_kernel_matches_plain_and_composition(cuda, sf, c, b, h,
                                                           w, combine):
    """Against its plain version to 1e-5; against the same-size kernel on
    the zero-stuffed image (and the elementwise combine) bit for bit: a
    skipped product is fmaf(k, 0, acc) == acc; three runs bit-equal.  At
    sf 2 (pre 0) the clamped top and left edges repeat data."""
    kcol, krow, pre = _cem_taps(sf, 'w_up_1d', cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = torch.rand(b, h, w, c, generator=gen, device=cuda) * 2 - 1
    kw = {}
    if combine:
        kw = dict(b=torch.rand(b, h, w, c, generator=gen, device=cuda),
                  g=torch.rand(b, sf * h, sf * w, c, generator=gen,
                               device=cuda))
    before = sepfilter_up.launches
    out = sepfilter_up(a, kcol, krow, sf, pre, **kw)
    torch.cuda.synchronize()
    assert sepfilter_up.launches == before + 1
    ref = sepfilter_up_plain(a, kcol, krow, sf, pre, **kw)
    assert out.shape == ref.shape == (b, sf * h, sf * w, c)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)

    def up(t):
        return sepfilter_edge(F.zero_stuff(t, sf, pre).contiguous(), kcol,
                              krow)
    composed = up(a) if not combine else up(a) + (kw['g'] - up(kw['b']))
    assert torch.equal(out, composed)
    for _ in range(2):
        assert torch.equal(sepfilter_up(a, kcol, krow, sf, pre, **kw), out)


@pytest.mark.parametrize('k', [4, 6, 8])
@pytest.mark.parametrize('sf,pre', [(2, (0, 0)), (3, (1, 1)), (4, (1, 2))])
@pytest.mark.parametrize('b,h,w', LR_SHAPES)
def test_polyphase_kernels_take_even_taps(cuda, k, sf, pre, b, h, w):
    """Even tap counts, as exsr's filters take them: the outputs' shapes
    and values equal the plain versions' (1e-5) and their composition
    through the same-size kernel (bit for bit), in both modes of the up
    kernel; the combine refuses a g of the ungrown size."""
    gen = torch.Generator(device=cuda).manual_seed(k * 10 + sf)
    kcol, krow = _rand(gen, k), _rand(gen, k + 2)
    x = torch.rand(b, sf * h, sf * w, 3, generator=gen, device=cuda)
    out = sepfilter_down(x, kcol, krow, sf, pre)
    ref = sepfilter_down_plain(x, kcol, krow, sf, pre)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert torch.equal(out, F.aliased_subsample(
        sepfilter_edge(x, kcol, krow), sf, pre))
    a, lo = (torch.rand(b, h, w, 3, generator=gen, device=cuda)
             for _ in range(2))
    hr = (b, sf * h + 1, sf * w + 1, 3)
    g = torch.rand(hr, generator=gen, device=cuda)

    def up(t):
        return sepfilter_edge(F.zero_stuff(t, sf, pre).contiguous(), kcol,
                              krow)
    for kw, composed in (({}, up(a)),
                         ({'b': lo, 'g': g}, up(a) + (g - up(lo)))):
        out = sepfilter_up(a, kcol, krow, sf, pre, **kw)
        ref = sepfilter_up_plain(a, kcol, krow, sf, pre, **kw)
        assert out.shape == ref.shape == hr
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        assert torch.equal(out, composed)
    with pytest.raises(ValueError, match=f'x{sf} size'):
        sepfilter_up(a, kcol, krow, sf, pre, b=lo,
                     g=g[:, 1:, 1:].contiguous())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('gc', [8, 16, 32])
@pytest.mark.parametrize('nf', [16, 48, 64])
@pytest.mark.parametrize('b,h,w', [(2, 40, 36), (2, 7, 19), (3, 1, 1),
                                   (3, 3, 130), (3, 129, 17), (1, 40, 40),
                                   (1, 56, 56), (1, 64, 64)])
def test_stage4_kernel_matches_plain(cuda, dtype, gc, nf, b, h, w):
    """fp32 to 1e-5; bf16 to one bf16 ulp (2^-7 relative), where fp32
    summation order moves the scaled sum across a rounding boundary.
    Shapes that do not divide the 8 x 8 (bf16) or 8 x 16 (fp32) tile, one
    pixel, three images, the edit crops at batch 1.
    The bf16 kernel runs three times on the same inputs and must repeat
    itself bit for bit: a missing barrier or wait shows on some runs only.
    """
    gen = torch.Generator(device=cuda).manual_seed(1)
    c3 = _rand(gen, b, h, w, gc, dtype=dtype)
    ps = [_rand(gen, b, h, w, nf + k * gc, dtype=dtype) for k in (4, 3, 2, 1)]
    x = _rand(gen, b, h, w, nf, dtype=dtype)
    w4 = (_rand(gen, 3, 3, gc, nf) * 0.1).to(dtype)
    b4 = _rand(gen, nf)
    before = stage4.launches
    out = stage4(c3, *ps, x, w4, b4)
    torch.cuda.synchronize()
    assert stage4.launches == before + 1
    ref = stage4_plain(c3, *ps, x, w4, b4)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)
    if dtype == torch.bfloat16:
        for _ in range(2):
            assert torch.equal(stage4(c3, *ps, x, w4, b4), out)


def test_stage4_kernel_takes_gc_not_a_multiple_of_8(cuda):
    """gc 6: c3 arrives in 4-byte copies and K is zero-padded to 16 in
    shared memory; P widths are any multiples of 8."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    c3 = _rand(gen, 2, 9, 11, 6, dtype=torch.bfloat16)
    ps = [_rand(gen, 2, 9, 11, 32 + 8 * k, dtype=torch.bfloat16)
          for k in (4, 3, 2, 1)]
    x = _rand(gen, 2, 9, 11, 32, dtype=torch.bfloat16)
    w4 = (_rand(gen, 3, 3, 6, 32) * 0.1).bfloat16()
    b4 = _rand(gen, 32)
    out = stage4(c3, *ps, x, w4, b4).float()
    ref = stage4_plain(c3, *ps, x, w4, b4).float()
    torch.testing.assert_close(out, ref, atol=2 ** -7, rtol=2 ** -7)


def _rdb_weights(gen, nf, gc, nz, dtype, device):
    """Random fp32 RDB parameters (kaiming fan-in x 0.5, nonzero biases),
    packed for ``dtype``."""
    ws, bs = [], []
    for i in range(5):
        cin, cout = nz + nf + i * gc, (gc if i < 4 else nf)
        ws.append(_rand(gen, cout, cin, 3, 3, device=device)
                  * 0.5 * (2 / (9 * cin)) ** 0.5)
        bs.append(_rand(gen, cout, device=device) * 0.1)
    return K.pack_rdb(ws, bs, dtype)


def assert_rdb_close(out, ref):
    """fp32: 1e-5.  bf16: |out - ref| <= 2^-7 |ref| + 2^-9.  The kernel and
    the plain version sum in fp32 in different orders, so a value may round
    to the other bf16 neighbour: in the output (one ulp, 2^-7 relative at
    most) or in an intermediate c_i, whose flip reaches the output diluted
    but can exceed one ulp of an output that is close to zero."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        diff = (out.float() - ref.float()).abs()
        excess = diff - (2 ** -7 * ref.float().abs() + 2 ** -9)
        assert excess.max().item() <= 0, diff.max().item()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('nf,gc', [(16, 8), (32, 16), (64, 32)])
@pytest.mark.parametrize('b,h,w', [(2, 7, 19), (2, 40, 36), (3, 9, 70),
                                   (2, 3, 5), (1, 17, 33), (1, 40, 40),
                                   (1, 56, 56), (1, 64, 64)])
def test_rdb_kernel_matches_plain(cuda, dtype, nf, gc, b, h, w):
    """Shapes that do not divide the 8 x 16 tile (bf16) or the 16 x 16 of
    a 2 x 2 cluster of 8 x 8 tiles (fp32), one wider than a tile with a
    ragged edge and three images, one smaller than a tile, one a pixel past
    whole clusters, the edit crops at batch 1.  The
    bf16 kernel runs three times on the same inputs and must repeat itself
    bit for bit: a missing fence or barrier shows on some runs only."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    wts = _rdb_weights(gen, nf, gc, 3, dtype, cuda)
    x = _rand(gen, b, h, w, nf, dtype=dtype)
    z = (torch.rand(b, h, w, 3, generator=gen, device=cuda) * 2 - 1) \
        .to(dtype)
    x0 = _rand(gen, b, h, w, nf, dtype=dtype)
    before = K.rdb.launches
    out = K.rdb(x, z, wts)
    out_x0 = K.rdb(x, z, wts, x0=x0)
    torch.cuda.synchronize()
    assert K.rdb.launches == before + 2
    ref = K.rdb_plain(x, z, wts)
    assert_rdb_close(out, ref)
    # the fused outer residual is the plain elementwise op on the kernel's
    # own RDB output, bit for bit
    assert torch.equal(out_x0, K.mul_in_dtype(out, 0.2) + x0)
    if dtype == torch.bfloat16:
        for _ in range(2):
            again = K.rdb(x, z, wts)
            assert_rdb_close(again, ref)
            assert torch.equal(again, out)


def test_rdb_kernel_raises_for_a_width_it_is_not_built_for(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    wts = _rdb_weights(gen, 16, 40, 3, torch.bfloat16, cuda)
    x = _rand(gen, 1, 8, 8, 16, dtype=torch.bfloat16)
    z = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16, device=cuda)
    before = K.rdb.launches
    with pytest.raises(NotImplementedError, match='gc'):
        K.rdb(x, z, wts)
    assert K.rdb.launches == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rrdb_block_on_cuda_matches_cpu(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    w3 = [_rdb_weights(gen, 64, 32, 3, torch.float32, cuda)
          for _ in range(3)]
    x = _rand(gen, 2, 21, 13, 64)
    z = torch.rand(2, 21, 13, 3, generator=gen, device=cuda) * 2 - 1
    outs = {}
    for dev in ('cpu', cuda):
        w3d = [K.pack_rdb([k.permute(3, 2, 0, 1).to(dev) for k in w.kernels],
                          [b.to(dev) for b in w.biases], dtype) for w in w3]
        xd, zd = x.to(dev, dtype), z.to(dev, dtype)
        outs[str(dev)] = (K.rrdb_block(xd, zd, w3d).cpu(),
                          K.rrdb_block_chained(xd, zd, w3d).cpu())
    assert torch.equal(*outs[str(cuda)])
    out, ref = outs[str(cuda)][0].float(), outs['cpu'][0].float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        # three RDBs chained: a bf16 rounding flipped by the fp32 summation
        # order in one feeds the next, so two ulps (2^-6 relative) plus an
        # absolute term for outputs close to zero
        assert ((out - ref).abs() - 2 ** -6 * (ref.abs() + 1)).max() <= 0


def test_fused_rrdbnet_on_cuda_matches_cpu(cuda):
    """RRDBNet(fused_trunk=True) at nb 2, fp32: 3 rdb launches per block."""
    rng = np.random.default_rng(7)
    lr = torch.from_numpy(rng.uniform(size=(2, 20, 20, 3)).astype('f'))
    z = torch.from_numpy(rng.uniform(-1, 1, size=(2, 80, 80, 3)).astype('f'))
    net = RRDBNet(nf=16, nb=2, gc=8, latent_channels=3, seed=8,
                  fused_trunk=True)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('bias'):  # nonzero biases
                p.add_(0.01)
        ref = net(lr, z)
        net.to(cuda)
        K.rdb.launches = 0
        out = net(lr.to(cuda), z.to(cuda))
        torch.cuda.synchronize()
    assert K.rdb.launches == 3 * 2
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)


def test_kernels_refuse_gradients(cuda):
    """The fused RDB kernel still has no backward (the fused trunk is for
    inference, as exsr's pallas_trunk); the CEM filter's entry points and
    the stage-4 epilogue take gradients since their backwards exist."""
    x = torch.rand(1, 8, 8, 3, device=cuda, requires_grad=True)
    k = torch.ones(3, device=cuda)
    for y in (sepfilter_edge(x, k, k), sepfilter_down(x, k, k, 2, (0, 0)),
              sepfilter_up(x, k, k, 2, (0, 0))):
        assert y.requires_grad
    gen = torch.Generator(device=cuda).manual_seed(9)
    wts = _rdb_weights(gen, 16, 8, 3, torch.float32, cuda)
    xr = torch.rand(1, 8, 8, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match='backward'):
        K.rdb(xr, torch.rand(1, 8, 8, 3, device=cuda), wts)
    net = RRDBNet(nf=16, nb=1, gc=8, latent_channels=3,
                  fused_trunk=True).to(cuda)
    with pytest.raises(NotImplementedError, match='backward'):
        net(torch.rand(1, 8, 8, 3, device=cuda),
            torch.rand(1, 32, 32, 3, device=cuda))


# (kind, sf, pre, taps, (h, w) of the forward's input, batch): every sf of
# the bicubic CEM at both extreme sub-positions, the CEM's tap counts,
# ragged sizes, tiles cut short, and axes shorter than the taps
TAPS_GRID = (
    [('E', 1, 0, k, hw, 2) for k in (4, 9, 11, 17, 27, 33)
     for hw in ((13, 21), (3, 2), (70, 130))]
    + [(kind, sf, pre, k, hw, 2) for sf in (2, 3, 4, 8)
       for pre in (0, sf - 1)
       for kind, k, hw in (('D', 9, (5 * sf + 1, 3 * sf)),
                           ('D', 17, (sf, sf + 1)),
                           ('D', 33, (37 * sf + 3, 19 * sf)),
                           ('U', 11, (5, 3)), ('U', 17, (2, 1)),
                           ('U', 33, (37, 70)))]
    # even taps grow the forward's output by one along each axis
    + [(kind, sf, pre, k, hw, 2) for sf in (2, 3, 4) for pre in (0, sf - 1)
       for k in (4, 6, 8)
       for kind, hw in (('D', (5 * sf + 1, 3 * sf)), ('U', (5, 3)))]
    # the x4 CEM's own shapes (27-tap E, 17-tap U and D, pre 1): the edit
    # crops at batch 1 and the training shape at batch 16
    + [(kind, sf, 1 if sf > 1 else 0, k, (n * m, n * m), batch)
       for n, batch in ((40, 1), (56, 1), (64, 1), (52, 16))
       for kind, sf, k, m in (('E', 1, 27, 1), ('U', 4, 17, 1),
                              ('D', 4, 17, 4))]
    # sizes where the tile chosen per launch (adjoint_tile) switches: every
    # tile of each kind
    + [('E', 1, 0, 27, (n, n), b) for n, b in ((130, 1), (180, 1),
                                                (260, 1), (128, 16))]
    + [('U', 4, 1, 17, (n, n), b) for n, b in ((90, 1), (130, 1),
                                                (180, 1), (260, 1),
                                                (128, 16))]
    + [('D', 4, 1, 17, (n, n), b) for n, b in ((260, 1), (360, 1),
                                                (520, 1), (520, 2),
                                                (512, 16))]
)


@pytest.mark.parametrize('kind,sf,pre,k,hw,batch', TAPS_GRID)
def test_sepfilter_taps_matches_plain(cuda, kind, sf, pre, k, hw, batch):
    """The adjoint kernel against its plain version on the same tables,
    tiled for the batch, fp32, 1e-5 of the largest output (the sums run in
    another order)."""
    from exsr_torch.ops.kernels import sepfilter as S
    gen = torch.Generator(device=cuda).manual_seed(k + 100 * sf + pre)
    kcol, krow = _rand(gen, k), _rand(gen, k)
    h, w = hw
    g = 1 - k % 2
    n_out = {'E': (h + g, w + g), 'D': (len(range(pre, h + g, sf)),
                                        len(range(pre, w + g, sf))),
             'U': (h * sf + g, w * sf + g)}[kind]
    for c in (1, 3):
        y = torch.rand(batch, *n_out, c, generator=gen, device=cuda)
        tabs = S.AdjointTables.of(kcol, krow).get(kind, h, w, sf,
                                                  (pre, pre), cuda,
                                                  batch=batch)
        assert (tabs[0].tile, tabs[1].tile) == S.adjoint_tile(kind, h, w,
                                                              batch)
        before = S.sepfilter_taps.launches
        out = S.sepfilter_taps(y, *tabs)
        torch.cuda.synchronize()
        assert S.sepfilter_taps.launches == before + 1
        ref = S.sepfilter_taps_plain(y, *tabs)
        assert out.shape == (batch, h, w, c)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(cot)
    return [t.grad for t in leaves]


@pytest.mark.parametrize('sf', [2, 4, 8])
def test_sepfilter_gradients_on_cuda_match_cpu(cuda, sf):
    """Each CEM filter entry point's gradient through the kernels on the
    card against the plain route on the CPU, 1e-5 of the largest; the
    backward launches one sepfilter_taps per adjoint."""
    from exsr_torch.ops.kernels import sepfilter as S
    filt = {d: CEM.create(CEMConf(scale_factor=sf)).device_filters(
        3, device=d) for d in ('cpu', cuda)}
    rng = np.random.default_rng(sf)
    lr = torch.from_numpy(rng.uniform(size=(2, 13, 21, 3)).astype('f'))
    hr = torch.from_numpy(rng.uniform(size=(2, 13 * sf, 21 * sf, 3))
                          .astype('f'))
    cases = [('conv_inv_hth', (lr,), lr, 1), ('downscale', (hr,), lr, 1),
             ('upscale', (lr,), hr, 1), ('enforce', (lr, hr), hr, 1)]
    for name, inputs, cot_like, taps in cases:
        cot = torch.from_numpy(rng.normal(size=cot_like.shape).astype('f'))
        ref = _grads(getattr(filt['cpu'], name), inputs, cot)
        before = S.sepfilter_taps.launches
        got = _grads(getattr(filt[cuda], name),
                     [t.to(cuda) for t in inputs], cot.to(cuda))
        torch.cuda.synchronize()
        # enforce: one U^T for both of its LR inputs, then E^T and D^T
        n = {'enforce': 4}.get(name, taps)
        assert S.sepfilter_taps.launches - before == n, name
        for g, r in zip(got, ref):
            assert (g.cpu() - r).abs().max() <= 1e-5 * r.abs().max(), name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_stage4_backward_on_cuda_matches_cpu(cuda, dtype):
    """The stage-4 Function's gradients on the card (kernel forward, cuDNN
    transposed conv) against the CPU's: x and the P buffers exactly (0.2 g
    in the dtype), c3 to 1e-5 of the largest in fp32 and to one bf16 ulp
    of the largest in bf16 (fp32 sums in another order, then rounded)."""
    gen = torch.Generator().manual_seed(3)
    nf, gc = 32, 16
    c3 = torch.randn(2, 9, 11, gc, generator=gen).to(dtype)
    ps = [torch.randn(2, 9, 11, nf + k * gc, generator=gen).to(dtype)
          for k in (4, 3, 2, 1)]
    x = torch.randn(2, 9, 11, nf, generator=gen).to(dtype)
    w4 = (torch.randn(3, 3, gc, nf, generator=gen) * 0.1).to(dtype)
    b4 = torch.randn(nf, generator=gen)
    cot = torch.randn(2, 9, 11, nf, generator=gen).to(dtype)
    inputs = (c3, *ps, x)

    def fn(*a):
        return stage4(*a, w4.to(a[0].device), b4.to(a[0].device))
    ref = _grads(fn, inputs, cot)
    before = stage4.launches
    got = _grads(fn, [t.to(cuda) for t in inputs], cot.to(cuda))
    torch.cuda.synchronize()
    assert stage4.launches == before + 1
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g.cpu(), r)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    err = (got[0].cpu().float() - ref[0].float()).abs().max()
    assert err <= tol * ref[0].float().abs().max()


def test_edit_session_step_on_cuda(cuda):
    """One EditSession l1 round (5 steps) at nb 2 on CUDA: every step runs
    the kernels forward and backward (2 / 1 / 1 CEM filters, 3 * nb
    stage-4, 3 sepfilter_taps), the loss falls, and its history matches
    the same session on the CPU to 1e-5 of the first loss."""
    from exsr_torch.apps.session import EditSession
    from exsr_torch.ops.kernels.sepfilter import sepfilter_taps
    img = np.random.default_rng(4).uniform(size=(96, 96, 3)) \
        .astype(np.float32)
    mask = np.zeros((96, 96), np.float32)
    mask[40:56, 40:56] = 1.0
    results = {}
    for dev in ('cpu', cuda):
        s = EditSession(scale=4, nb=2, nf=16, device=dev,
                        time_budget_s=120.0)
        s.init_random_params(0)
        s.open_image(img)
        s.set_region(mask)
        desired = s.sr.copy()
        desired[:, 40:56, 40:56] = 0.7
        counted = (sepfilter_edge, sepfilter_down, sepfilter_up, stage4,
                   sepfilter_taps)
        for f in counted:
            f.launches = 0
        res = s.optimize('l1', data={'desired': desired}, max_iters=5)
        torch.cuda.synchronize()
        results[str(dev)] = (res, tuple(f.launches for f in counted))
    (rc, lc), (rg, lg) = results['cpu'], results[str(cuda)]
    assert lc == (0, 0, 0, 0, 0)
    # 5 steps and the view's forward; 3 adjoints per backward
    assert lg == (2 * 6, 6, 6, 6 * 6, 3 * 5)
    lt, lr_ = np.asarray(rg['losses']), np.asarray(rc['losses'])
    assert lt.shape == (5,) and lt[-1] < lt[0]
    assert np.abs(lt - lr_).max() <= 1e-5 * lr_[0]


def test_cem_chain_on_cuda_matches_cpu_and_is_consistent(cuda):
    cem = CEM.create(CEMConf(scale_factor=4))
    rng = np.random.default_rng(2)
    lr = torch.from_numpy(rng.uniform(size=(2, 40, 40, 3)).astype('f'))
    g = torch.from_numpy(rng.uniform(size=(2, 160, 160, 3)).astype('f'))
    outs = {}
    for dev in ('cpu', cuda):
        filt = cem.device_filters(3, device=dev)
        outs[str(dev)] = filt.enforce(lr.to(dev), g.to(dev))
    torch.testing.assert_close(outs[str(cuda)].cpu(), outs['cpu'],
                               atol=1e-5, rtol=0)
    filt = cem.device_filters(3, device=cuda)
    m = cem.invalidity_margins_lr
    err = (filt.downscale(outs[str(cuda)]).cpu() - lr)[:, m:-m, m:-m]
    assert err.abs().max().item() < 5e-6


def test_build_model_on_cuda_matches_cpu(cuda):
    """The serving forward at nb 2, nf 16, fp32: CUDA kernels vs plain CPU
    versions, and exactly 2 same-size, 1 down, 1 up and 3 * nb stage-4
    launches per forward."""
    rng = np.random.default_rng(3)
    lr = rng.uniform(size=(2, 20, 20, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(2, 80, 80, 3)).astype(np.float32)
    net = RRDBNet(nf=16, nb=2, gc=8, latent_channels=3, seed=4)
    _, fwd_cpu = build_model(4, nb=2, nf=16, device='cpu',
                             dtype=torch.float32, params=net)
    _, fwd_gpu = build_model(4, nb=2, nf=16, device=cuda,
                             dtype=torch.float32, params=net)
    sepfilter_edge.launches = stage4.launches = 0
    sepfilter_down.launches = sepfilter_up.launches = 0
    out = fwd_gpu(lr, z)
    torch.cuda.synchronize()
    assert (sepfilter_edge.launches, sepfilter_down.launches,
            sepfilter_up.launches, stage4.launches) == (2, 1, 1, 6)
    torch.testing.assert_close(out.cpu(), fwd_cpu(lr, z), atol=1e-5,
                               rtol=0)


def test_eval_cli_on_cuda(cuda, tmp_path):
    """The evaluation CLI on the card at nb 1, nf 16: every summary key
    finite, the CEM's consistency kept, the SR images written, and the
    CEM filter and stage-4 kernels launched for each forward."""
    import json
    from PIL import Image
    from exsr_torch.apps import eval_sr
    rng = np.random.default_rng(0)
    d = tmp_path / 'hr'
    d.mkdir()
    for i in range(2):
        Image.fromarray((rng.uniform(size=(96, 96, 3)) * 255)
                        .astype(np.uint8)).save(d / f'im{i}.png')
    sepfilter_edge.launches = stage4.launches = 0
    summary = eval_sr.main(['--hr_dir', str(d), '--nb', '1', '--nf', '16',
                            '--num_z', '3', '--latent', 'uniform_sweep',
                            '--save_images', '--out_dir',
                            str(tmp_path / 'out')])
    assert summary['num_images'] == 2
    for key in ('avg_psnr', 'avg_ssim', 'avg_consistency_mae',
                'avg_per_pixel_std', 'avg_hr_std', 'avg_sr_high_freq_std'):
        assert np.isfinite(summary[key])
    assert summary['avg_consistency_mae'] < 1e-5
    assert (sepfilter_edge.launches, stage4.launches) == (4, 6)
    saved = json.loads((tmp_path / 'out' / 'summary.json').read_text())
    assert len(saved['per_image']) == 2
    assert (tmp_path / 'out' / 'im1_SR.png').exists()


def _tiny_trainer(device, overrides=None):
    """A trainer at nb 1, nf 16, gc 8, patch 112 (LR 28), D nb 4 / nf 8 /
    one stride-2 stage, two inner MAP iterations, on ``device``, with
    seeded weights and a seeded batch of 4."""
    from exsr_torch.cem.cem import cem_wrap
    from exsr_torch.models.discriminators import DiscriminatorVGG128
    from exsr_torch.train.srragan import SRRaGANTrainer, TrainConfig
    cem = CEM.create(CEMConf(scale_factor=4))
    filt = cem.device_filters(3, device=device)
    wrapped = cem_wrap(lambda m, x, z: m(x, z), filt, upscale=4)
    m = cem.invalidity_margins_hr
    cfg = TrainConfig(**{'optimal_z_iters': 2, **(overrides or {})})
    tr = SRRaGANTrainer(cfg, lambda g, x, z: wrapped(g, x, z, 0,
                                                     pre_pad=False), m)
    state = tr.init_state(
        RRDBNet(nf=16, nb=1, gc=8, latent_channels=3, seed=4),
        DiscriminatorVGG128(8, 4, 1, 112 - 2 * m, seed=5), seed=6,
        device=device)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.uniform(size=(4, s, s, 3)).astype(
        np.float32)).to(device) for k, s in (('lr', 28), ('hr', 112))}
    return tr, state, batch


def _map(x, fn):
    """``fn`` on every tensor of a draw (a tensor or nested lists)."""
    return [_map(v, fn) for v in x] if isinstance(x, list) else fn(x)


def _step_grads(kind, dual, dev, draws, float64=False):
    """One step's gradients, metrics and D's state on ``dev`` from
    ``draws`` (``float64``: the CPU's plain path in float64)."""
    from exsr_torch.ops.kernels.sepfilter import float64_reference
    tr, state, batch = _tiny_trainer(dev)
    cast = (lambda t: t.to(dev, torch.float64)) if float64 else \
        (lambda t: t.to(dev))
    draws = {k: _map(v, cast) for k, v in draws.items()}
    ctx = float64_reference() if float64 else contextlib.nullcontext()
    if float64:
        state.g.double()
        state.d.double()
        state.ratio_stats.buffer = state.ratio_stats.buffer.double()
        batch = {k: v.double() for k, v in batch.items()}
    with ctx:
        if kind == 'd':
            grads, metrics = tr.d_grads(state, batch['lr'], batch['hr'],
                                        draws, dual)
        else:
            grads, metrics, _ = tr.g_grads(state, batch['lr'], batch['hr'],
                                           draws, dual, True)
    return ([g.detach().cpu().double() for g in grads],
            {k: float(v) for k, v in metrics.items()},
            {k: v.cpu() for k, v in state.d.state_dict().items()})


def _gap(a, b):
    scale = max(float(y.abs().max()) for y in b)
    return max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale


@pytest.mark.parametrize('kind,dual', [('d', False), ('g', False),
                                       ('d', True), ('g', True)])
def test_train_step_on_cuda_matches_cpu(cuda, kind, dual):
    """Each of the trainer's four step kinds on the card against the CPU,
    on the same draws: gradients within 1e-4 of the largest element,
    metrics within 1e-4 relative, D's running statistics within 1e-5, the
    CEM kernels launched as the step predicts.  The non-dual G step's last
    HR conv gradient cancels through the CEM down to fp32 rounding (1.4e-4
    to 2.4e-4 from float64 on the CPU at this size): beyond 1e-4 the step
    in float64 on the CPU decides, the card no farther from it than three
    times the CPU."""
    from exsr_torch.ops.kernels.sepfilter import sepfilter_taps
    tr, state, batch = _tiny_trainer(cuda)
    draw = tr.draw_d if kind == 'd' else tr.draw_g
    draws = draw(state, batch['hr'].shape, dual)
    sepfilter_edge.launches = sepfilter_taps.launches = 0
    g_gpu, m_gpu, d_gpu = _step_grads(kind, dual, cuda, draws)
    inner = 2 if dual else 0
    fwd = (2 if dual else 1) + inner
    bwd = inner + ((2 if dual else 1) if kind == 'g' else 0)
    assert (sepfilter_edge.launches, sepfilter_taps.launches) == \
        (2 * fwd, 3 * bwd)
    g_cpu, m_cpu, d_cpu = _step_grads(kind, dual, torch.device('cpu'), draws)
    err = _gap(g_gpu, g_cpu)
    if err >= 1e-4 and (kind, dual) == ('g', False):
        exact = _step_grads(kind, dual, torch.device('cpu'), draws,
                            float64=True)[0]
        assert _gap(g_gpu, exact) <= max(1e-4, 3 * _gap(g_cpu, exact))
    else:
        assert err < 1e-4
    for k, v in m_cpu.items():
        assert m_gpu[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    for k, v in d_cpu.items():
        torch.testing.assert_close(d_gpu[k], v, atol=1e-5, rtol=0)


def test_d_running_stats_left_alone_by_penalty_and_g_step(cuda):
    """On the card: a D step moves D's running statistics by the real pass
    and each fake pass only (the penalty's passes leave them), and a G
    step leaves them and D's Adam state untouched."""
    tr, state, batch = _tiny_trainer(cuda)
    bn = state.d.conv1.bn
    calls = []
    state.d.register_forward_pre_hook(
        lambda m, args: calls.append(len(args) > 1 and args[1]))
    before = bn.running_var.clone()
    tr.d_step(state, batch, dual=True)
    # the real pass and two fakes update; the two penalties do not
    assert calls.count(True) == 3 and calls.count(False) == 2
    assert not torch.equal(bn.running_var, before)
    stats = [t.clone() for t in state.d.buffers()]
    opt = {k: {n: t.clone() for n, t in v.items()
               if isinstance(t, torch.Tensor)}
           for k, v in state.d_opt.state.items()}
    calls.clear()
    tr.g_step(state, batch, dual=True)
    assert calls and not any(calls)
    for a, b in zip(state.d.buffers(), stats):
        assert torch.equal(a, b)
    for k, v in state.d_opt.state.items():
        for n, t in opt[k].items():
            assert torch.equal(v[n], t)


@pytest.mark.parametrize('case', ['sepfilter_edge[lr]', 'sepfilter_down',
                                  'sepfilter_up[up]',
                                  'sepfilter_up[combine]'])
def test_cem_entry_points_at_training_shapes(cuda, case):
    """The CEM filter's entry points at the flagship training shapes (LR
    52, HR 208, batch 16) against their plain versions (1e-5) and their
    compositions through the same-size kernel (bit for bit)."""
    from exsr_torch.ops.kernels.measure import sepfilter_kernels
    filt = CEM.create(CEMConf(scale_factor=4)).device_filters(3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    rec = sepfilter_kernels(filt, gen, cuda, 16, 52, cases=(case,),
                            references=False)[case]
    assert rec['max_abs_err'] <= 1e-5 and rec['bit_equal_composition']


def test_cem_adjoints_at_training_shapes(cuda):
    """``sepfilter_taps``'s three adjoints at LR 52, HR 208, batch 16
    against the plain version (1e-5 of the largest output)."""
    from exsr_torch.ops.kernels.measure import sepfilter_taps_kernels
    filt = CEM.create(CEMConf(scale_factor=4)).device_filters(3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(10)
    recs = sepfilter_taps_kernels(filt, gen, cuda, 16, 52)
    assert set(recs) == {'U', 'E', 'D'}
    assert all(r['max_rel_err'] <= 1e-5 for r in recs.values())


def test_train_cli_on_cuda(cuda, tmp_path):
    """The training CLI on the card at a tiny size: D steps, validation,
    checkpoints, then --resume (a step's metrics are logged with the next
    step's, so a run's last step logs the D loss of the one before)."""
    from PIL import Image
    from exsr_torch.apps import train_sr
    from exsr_torch.utils.logging import MetricLog
    rng = np.random.default_rng(1)
    d = tmp_path / 'hr'
    d.mkdir()
    for i in range(3):
        Image.fromarray((rng.uniform(size=(128, 128, 3)) * 255)
                        .astype(np.uint8)).save(d / f'im{i}.png')
    exp = str(tmp_path / 'exp')
    args = ['--hr_dir', str(d), '--val_hr_dir', str(d), '--scale', '4',
            '--patch', '112', '--batch', '2', '--nb', '1', '--nf', '8',
            '--gc', '4', '--d_nb', '4', '--d_nf', '8', '--d_strides', '1',
            '--exp_dir', exp, '--print_freq', '1', '--val_freq', '2']
    sepfilter_edge.launches = 0
    train_sr.main(args + ['--niter', '3'])
    assert sepfilter_edge.launches > 0
    train_sr.main(args + ['--niter', '5', '--resume'])
    log = MetricLog().load(f'{exp}/logs.npz')
    assert log.last('psnr_val') is not None
    assert max(s for s, _ in log.series['l_d_total']) == 5


# ------------------------------------------------------- explorable JPEG

@pytest.fixture
def default_tf32(cuda):
    """PyTorch's default TF32 flags (cuDNN on, matmul off), the fixture's
    restored after: an entry point must turn TF32 off itself."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_build_model_fp32_under_default_tf32_flags(default_tf32):
    """The fp32 serving forward at full width with PyTorch's default flags:
    within 1e-4 of the CPU, as phase 4 checks it with TF32 off."""
    gen = torch.Generator().manual_seed(2)
    lr = torch.rand(2, 16, 16, 3, generator=gen)
    z = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    outs = {}
    for dev in ('cpu', default_tf32):
        _, fwd = build_model(4, device=dev)
        outs[str(dev)] = fwd(lr, z).cpu()
    assert torch.backends.cudnn.allow_tf32
    assert (outs['cpu'] - outs[str(default_tf32)]).abs().max().item() < 1e-4


def _y_images(n, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw] / hw
    out = [np.clip(128 + 30 * sum(np.sin(2 * np.pi * (f * yy + g * xx + p))
                                  for f, g, p in rng.uniform(0.5, 8, (3, 3)))
                   + 20 * rng.standard_normal((hw, hw)), 0, 255)
           for _ in range(n)]
    return np.stack(out)[..., None].astype(np.float32)


def _quantised_agree(card, cpu, unq64):
    diff = np.abs(card.astype(np.float64) - cpu)
    tie = np.abs(np.abs(unq64 - np.floor(unq64)) - 0.5) < 1e-3
    assert diff.max() <= 1 and not (diff[~tie] > 0).any()


def test_jpeg_codec_card_vs_cpu(cuda):
    """Luma and chroma compress/extract on the card against the CPU: the
    quantised coefficients equal but at ties (float64 decides where), the
    QF tables bit-equal."""
    from exsr_torch.jpeg import codec as C
    ys = _y_images(4, 128, 0)
    qf = torch.tensor([5.0, 20.0, 50.0, 97.0])
    luma = C.JPEGCodec()
    unq = luma.compress(torch.from_numpy(ys).double(), qf,
                        quantize=False).numpy()
    card = luma.compress(torch.from_numpy(ys).to(cuda), qf.to(cuda)).cpu()
    cpu = luma.compress(torch.from_numpy(ys), qf)
    _quantised_agree(card.numpy(), cpu.double().numpy(), unq)
    torch.testing.assert_close(
        luma.extract(cpu.to(cuda), qf.to(cuda)).cpu(),
        luma.extract(cpu, qf), atol=1e-3, rtol=0)
    tables = C.scaled_q_table(np.arange(1, 101, dtype=np.float32),
                              C.LUMA_Q_TABLE, cuda).cpu()
    assert torch.equal(tables, C.scaled_q_table(
        np.arange(1, 101, dtype=np.float32), C.LUMA_Q_TABLE))
    chroma = C.JPEGCodec(chroma_mode=True, block_size=16)
    img = torch.from_numpy(np.concatenate(
        [ys[:2], ys[2:] - 128, ys[:2][:, ::-1] - 100], -1).copy())
    q2 = qf[:2]
    for mode in (True, False):
        a = chroma.compress_ycbcr(img.to(cuda), q2.to(cuda), mode).cpu()
        b = chroma.compress_ycbcr(img, q2, mode)
        # extract's input: Y with the chroma's low frequencies, or the two
        # full chroma channels
        packed = b if mode is True else b[..., 256:]
        if mode is True:
            u = chroma.compress_ycbcr(img.double(), q2, 'downsample_only')
            _quantised_agree(a[..., 256:].numpy(),
                             b[..., 256:].double().numpy(),
                             u[..., 256:].numpy())
            a, b = a[..., :256], b[..., :256]
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5
        torch.testing.assert_close(
            chroma.extract_ycbcr(packed.to(cuda), q2.to(cuda)).cpu(),
            chroma.extract_ycbcr(packed, q2), atol=1e-3, rtol=0)


@pytest.mark.parametrize('case', ['luma', 'chroma', 'discriminator'])
def test_dncnn_card_vs_cpu(cuda, case):
    """The generators (latent at every layer, batch norm) and the
    discriminator (spectral norm, batch norm, FC head, resized Z), fp32,
    on the card against the CPU: the generators within 1e-4 of their
    largest correction (the output less the quantised input it carries,
    bounded by 0.5), the discriminator within 1e-4 of its largest
    output."""
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, \
        DnCNNDiscriminator
    gen = torch.Generator().manual_seed(7)
    if case == 'discriminator':
        net = DnCNNDiscriminator(n_channels=64, depth=6,
                                 expected_input_size=16, norm='batch',
                                 spectral_norm=True,
                                 latent_input='all_layers',
                                 num_latent_channels=3, seed=2)
        x = torch.randn(3, 16, 16, 64, generator=gen)
        z = torch.rand(3, 16, 16, 3, generator=gen) * 2 - 1
    else:
        chroma = case == 'chroma'
        net = DnCNN(DnCNNConfig(
            n_channels=64, depth=6, in_nc=384 if chroma else 64,
            out_nc=128 if chroma else 64, chroma_generator=chroma,
            num_latent_channels=0 if chroma else 8), seed=1)
        x = torch.round(torch.randn(3, 12, 12, 384 if chroma else 64,
                                    generator=gen) * 4)
        z = None if chroma else torch.rand(3, 12, 12, 8, generator=gen)
    outs = {}
    for dev in ('cpu', cuda):
        net.to(dev)
        with torch.no_grad():
            outs[str(dev)] = net(x.to(dev), None if z is None
                                 else z.to(dev)).cpu()
    ref = outs['cpu']
    if case == 'discriminator':
        scale = ref.abs().max()
    elif case == 'luma':
        scale = (ref - x).abs().max()
    else:
        # the chroma generator carries the input's 8 x 8 low frequencies
        # in the first 8 x 8 quadrant of each block
        q = net.cfg.block_size // 8
        base = torch.zeros(3, 12, 12, 2, q, 8, q, 8)
        base[..., 0, :, 0, :] = x[..., 256:].reshape(3, 12, 12, 2, 8, 8)
        scale = (ref - base.reshape(ref.shape)).abs().max()
    assert ((outs[str(cuda)] - ref).abs().max() / scale) <= 1e-4


def test_jpeg_session_card_vs_cpu(default_tf32):
    """JPEGEditSession on the card against the CPU on the same weights,
    with PyTorch's default TF32 flags: the decode, an l1 edit and the
    chroma path."""
    from exsr_torch.apps.jpeg_session import JPEGEditSession
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    chroma = DnCNN(DnCNNConfig(n_channels=32, depth=4, in_nc=384,
                               out_nc=128, chroma_generator=True,
                               num_latent_channels=0), seed=5)
    res = {}
    for dev in ('cpu', default_tf32):
        s = JPEGEditSession(nf=64, nb=6, latent_channels=64, qf=15,
                            device=dev)
        s.init_random_params(4)
        s.open_image(img)
        out0 = s.out.copy()
        r = s.optimize('l1', data={'desired': s.y_image / 255.0 * 0.9},
                       max_iters=5)
        s.attach_chroma(chroma, nf=32, nb=4)
        res[str(dev)] = (out0, r['losses'], s.out, s.compose_rgb())
    for a, b in zip(res['cpu'], res[str(default_tf32)]):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    assert torch.backends.cudnn.allow_tf32


def test_native_jfif_scan_matches_python_reader(cuda):
    """The C++ scan, built with this machine's g++, against the Python
    reader on colour 4:2:0 / 4:4:4, grey and restart-marker files."""
    import io
    from PIL import Image
    from exsr_torch.jpeg.jfif import decode_jfif
    from exsr_torch.native import jfif_native
    assert jfif_native.available()
    rgb = np.concatenate(list(_y_images(3, 96, 5)), -1).astype(np.uint8)
    files = []
    for arr, kw in ((rgb, dict(quality=10, subsampling=2)),
                    (rgb, dict(quality=60, subsampling=0)),
                    (rgb[..., 0], dict(quality=75)),
                    (rgb, dict(quality=80, restart_marker_rows=1))):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format='JPEG', **kw)
        files.append(buf.getvalue())
    for data in files:
        a, b = decode_jfif(data, native=True), decode_jfif(data,
                                                           native=False)
        for x, y in zip(a['components'], b['components']):
            np.testing.assert_array_equal(x.coeffs, y.coeffs)
            np.testing.assert_array_equal(x.q_table, y.q_table)


def _decomp_grads(dev, kind, dual, draws, float64=False):
    """One explorable-JPEG step's gradients and metrics on ``dev`` (nf 32,
    depth 4, patch 64, batch 2), from ``draws`` (``float64``: on the CPU
    in float64), and the generator's running statistics after it; without
    ``draws``, the draws."""
    from exsr_torch.models.dncnn import (DnCNN, DnCNNConfig,
                                         DnCNNDiscriminator)
    from exsr_torch.train.decomp import DecompConfig, DecompTrainer
    tr = DecompTrainer(DecompConfig(optimal_z_iters=2))
    state = tr.init_state(
        DnCNN(DnCNNConfig(n_channels=32, depth=4, num_latent_channels=64),
              seed=3),
        DnCNNDiscriminator(n_channels=32, depth=4, expected_input_size=8,
                           seed=4), 0, dev)
    rng = np.random.default_rng(5)
    batch = {'uncomp': torch.from_numpy((255 * rng.uniform(
                 size=(2, 64, 64, 1))).astype(np.float32)).to(dev),
             'qf': torch.tensor([7, 33], device=dev)}
    if draws is None:
        draw = tr.draw_d if kind == 'd' else tr.draw_g
        return draw(state, (2, 8, 8, 64), dual)
    cast = (lambda t: t.to(dev, torch.float64)) if float64 else \
        (lambda t: t.to(dev))
    draws = {k: _map(v, cast) for k, v in draws.items()}
    if float64:
        state.g.double()
        state.d.double()
        batch['uncomp'] = batch['uncomp'].double()
    if kind == 'd':
        grads, metrics = tr.d_grads(state, batch, draws, dual)
    else:
        grads, metrics, _ = tr.g_grads(state, batch, draws, dual, True)
    return ([g.detach().cpu().double() for g in grads],
            {k: float(v) for k, v in metrics.items()},
            {k: v.cpu().double() for k, v in state.g.state_dict().items()
             if 'running' in k})


@pytest.mark.parametrize('kind,dual', [('d', False), ('g', False),
                                       ('d', True), ('g', True)])
def test_decomp_step_on_cuda_matches_cpu(cuda, kind, dual):
    """The explorable-JPEG trainer's D and G gradients on the card against
    the CPU on the same draws: within 1e-4 of the largest element, else
    (the MAP loop's Adam steps and the critic's input make the gradients
    sensitive to rounding) no farther from the CPU's float64 run than three
    times the CPU's fp32 run; the generator's running statistics within
    1e-5."""
    cpu = torch.device('cpu')
    draws = _decomp_grads(cuda, kind, dual, None)
    g_gpu, m_gpu, bn_gpu = _decomp_grads(cuda, kind, dual, draws)
    g_cpu, m_cpu, bn_cpu = _decomp_grads(cpu, kind, dual, draws)
    if _gap(g_gpu, g_cpu) >= 1e-4:
        exact = _decomp_grads(cpu, kind, dual, draws, float64=True)[0]
        assert _gap(g_gpu, exact) <= max(1e-4, 3 * _gap(g_cpu, exact))
    else:
        for k, v in m_cpu.items():
            assert m_gpu[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    for k, v in bn_cpu.items():
        torch.testing.assert_close(bn_gpu[k], v, atol=1e-5, rtol=1e-5)


def _kernelgan_runs(iters, devices):
    """KernelGAN at its default width from seed 0's weights and crops on
    each ``(device, dtype)``: ``{(device, dtype): (losses, raw kernel)}``."""
    from exsr_torch.kernelgan.kernelgan import KernelGAN, KernelGANConfig
    img = np.random.default_rng(8).uniform(size=(96, 96, 3)).astype(
        np.float32)
    runs = {}
    for dev, dt in devices:
        kg = KernelGAN(KernelGANConfig(max_iters=iters), device=dev)
        kg.g.to(dt)
        kg.d.to(dt)
        kg.estimate(img)
        runs[(str(dev), dt)] = (np.stack(kg.losses), kg.raw_kernel)
    return runs


def _kg_gaps(a, b):
    """(losses' largest relative gap, kernel's gap over its largest
    entry)."""
    return (float(np.max(np.abs(a[0] - b[0]) / np.abs(b[0]))),
            float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max()))


def test_kernelgan_first_iterations_on_cuda_match_cpu(cuda):
    """KernelGAN at its default width on the card against the CPU, from
    the same initial weights and crops.  One iteration: the losses within
    1e-4 relative, the kernel within 1e-4 of its largest entry.  Twenty:
    Adam's normalised steps make the run sensitive to rounding (fp32
    against float64 on the CPU parts by ~2 % of the kernel), so the card's
    losses and kernel must be no farther from the CPU's float64 run than
    three times the CPU's fp32 run is."""
    f32, f64 = torch.float32, torch.float64
    one = _kernelgan_runs(1, [('cpu', f32), (cuda, f32)])
    assert max(_kg_gaps(one[(str(cuda), f32)], one[('cpu', f32)])) < 1e-4
    runs = _kernelgan_runs(20, [('cpu', f32), ('cpu', f64), (cuda, f32)])
    exact = runs[('cpu', f64)]
    card = _kg_gaps(runs[(str(cuda), f32)], exact)
    cpu = _kg_gaps(runs[('cpu', f32)], exact)
    assert all(c <= max(1e-4, 3 * p) for c, p in zip(card, cpu)), \
        (card, cpu)


def test_web_sr_optimize_request_on_cuda(cuda):
    """One SR 'optimize' request through the server's SessionApi at nb 2
    on CUDA: it launches stage4, the CEM filters and sepfilter_taps (an
    initial forward, 5 steps forward and backward, the view's forward),
    its losses match the same request on the CPU to 1e-5 of the first
    loss, and the served view keeps the CEM's consistency."""
    import base64
    import io
    from PIL import Image
    from exsr_torch.apps.session import EditSession
    from exsr_torch.apps.web import SessionApi
    from exsr_torch.ops.kernels.sepfilter import sepfilter_taps
    img = (np.random.default_rng(5).uniform(size=(96, 96, 3)) * 255) \
        .astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='PNG')
    png = base64.b64encode(buf.getvalue()).decode()
    counted = (sepfilter_edge, sepfilter_down, sepfilter_up, stage4,
               sepfilter_taps)
    results = {}
    for dev in ('cpu', cuda):
        s = EditSession(scale=4, nb=2, nf=16, device=dev,
                        time_budget_s=120.0)
        s.init_random_params(0)
        api = SessionApi(s)
        api.dispatch('open', {'image': png, 'is_hr': True})
        api.dispatch('region', {'rect': [32, 32, 64, 64]})
        for f in counted:
            f.launches = 0
        out = api.dispatch('optimize', {'objective': 'max_STD',
                                        'max_iters': 5})
        torch.cuda.synchronize()
        results[str(dev)] = (out, tuple(f.launches for f in counted), s)
    (oc, lc, _), (og, lg, sg) = results['cpu'], results[str(cuda)]
    assert lc == (0, 0, 0, 0, 0)
    assert lg == (2 * 7, 7, 7, 6 * 7, 3 * 5)
    lt, lr_ = np.asarray(og['losses']), np.asarray(oc['losses'])
    assert lt.shape == (5,) and lt[-1] < lt[0]
    assert np.abs(lt - lr_).max() <= 1e-5 * abs(lr_[0])
    m = sg.cem.invalidity_margins_lr
    with torch.no_grad():
        lr = torch.as_tensor(sg.lr_image, device=cuda)
        out = sg._wrapped(sg.eff_params, lr, torch.as_tensor(
            sg.cur_z, device=cuda), m, pre_pad=True)
        cons = (sg.filters.downscale(out) - lr)[:, m:-m, m:-m].abs().max()
    assert cons.item() < 5e-6


@pytest.mark.parametrize('kind', ['sft', 'segnet', 'eresnet', 'minc',
                                  'resnet101', 'vgg96', 'vgg128sn',
                                  'acd96'])
def test_aux_models_on_cuda_match_cpu(cuda, kind):
    """The models no entry point reaches, narrow, on the card against the
    CPU in fp32 (1e-4 of the largest output); the critics in train mode,
    their running statistics (or ``u``) moved once on both.  ResNet101's
    train-mode batch statistics (8 values a channel in the last stage)
    carry fp32 rounding through 101 layers to ~1e-3 on either device:
    beyond 1e-4 its float64 run on the CPU decides, the card no farther
    from it than three times the CPU."""
    import copy
    from exsr_torch.device import full_fp32
    from exsr_torch.models import discriminators as D
    from exsr_torch.models.encoders import EResNet, SegNet
    from exsr_torch.models.perceptual import MINCNet, ResNet101Features
    from exsr_torch.models.sft import SFTNet
    rng = np.random.default_rng(5)

    def x(*shape):
        return torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
    module, inputs, kw = {
        'sft': lambda: (SFTNet(n_blocks=2), (x(2, 16, 16, 3),
                                             x(2, 64, 64, 8)), {}),
        'segnet': lambda: (SegNet(num_layers=5), (x(2, 32, 32, 3),),
                           {'train': True}),
        'eresnet': lambda: (EResNet(output_nc=8, ndf=8, vae_like=True,
                                    input_size=128),
                            (x(2, 128, 128, 3),), {}),
        'minc': lambda: (MINCNet(), (x(2, 32, 32, 3),), {}),
        'resnet101': lambda: (ResNet101Features(), (x(2, 64, 64, 3),),
                              {'train': True}),
        'vgg96': lambda: (D.DiscriminatorVGG(base_nf=8), (x(4, 96, 96, 3),),
                          {'update_stats': True}),
        'vgg128sn': lambda: (D.DiscriminatorVGG128SN(nf=8),
                             (x(4, 128, 128, 3),), {'update_stats': True}),
        'acd96': lambda: (D.ACDVGGBN96(base_nf=8), (x(4, 96, 96, 3),),
                          {'update_stats': True}),
    }[kind]()
    card = copy.deepcopy(module).to(cuda)
    exact = copy.deepcopy(module).double() if kind == 'resnet101' else None
    with torch.no_grad(), full_fp32():
        want = module(*inputs, **kw)
        got = card(*(t.to(cuda) for t in inputs), **kw)
        ref = None if exact is None else \
            exact(*(t.double() for t in inputs), **kw)
    pairs = list(zip(got, want)) if isinstance(want, tuple) \
        else [(got, want)]
    for g, w in pairs:
        assert g.device.type == 'cuda'
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        if err >= 1e-4 and ref is not None:
            def gap(t):
                return float((t.cpu().double() - ref).abs().max()
                             / ref.abs().max())
            assert gap(g) <= max(1e-4, 3 * gap(w))
        else:
            assert err < 1e-4
    sd = card.state_dict()
    for k, v in module.state_dict().items():
        torch.testing.assert_close(sd[k].cpu(), v, atol=1e-5, rtol=1e-4,
                                   msg=k)


def test_one_rank_nccl_trains_a_step(cuda, monkeypatch):
    """``init_from_env`` under a one-rank torchrun environment joins an
    NCCL group on ``cuda:LOCAL_RANK``; a trainer on that rank is the
    one-process trainer (no collective in the step)."""
    import socket
    import torch.distributed as dist
    from exsr_torch.parallel.dist import init_from_env
    from exsr_torch.train.decomp import DecompTrainer, DecompConfig
    from exsr_torch.models.dncnn import (DnCNN, DnCNNConfig,
                                         DnCNNDiscriminator)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    for k, v in (('RANK', '0'), ('WORLD_SIZE', '1'), ('LOCAL_RANK', '0'),
                 ('MASTER_ADDR', 'localhost'), ('MASTER_PORT', str(port))):
        monkeypatch.setenv(k, v)
    dp, device = init_from_env()
    try:
        assert dist.get_backend() == 'nccl'
        assert device == torch.device('cuda', 0) and dp.world == 1
        tr = DecompTrainer(DecompConfig(optimal_z_iters=1), dp=dp)
        assert tr.dp is None
        state = tr.init_state(DnCNN(DnCNNConfig(n_channels=16, depth=3)),
                              DnCNNDiscriminator(n_channels=16, depth=3,
                                                 expected_input_size=8),
                              device=device)
        batch = {'uncomp': torch.rand(2, 64, 64, 1, device=device) * 255,
                 'qf': torch.tensor([10, 40], device=device)}
        _, metrics = tr.d_step(state, batch, dual=False)
        assert np.isfinite(float(metrics['l_d_total']))
        dist.barrier()
    finally:
        dist.destroy_process_group()
