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
                                   (3, 3, 130), (3, 129, 17)])
def test_stage4_kernel_matches_plain(cuda, dtype, gc, nf, b, h, w):
    """fp32 to 1e-5; bf16 to one bf16 ulp (2^-7 relative), where fp32
    summation order moves the scaled sum across a rounding boundary.
    Shapes that do not divide the 8 x 8 tile, one pixel, three images.
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
                                   (2, 3, 5)])
def test_rdb_kernel_matches_plain(cuda, dtype, nf, gc, b, h, w):
    """Shapes that do not divide the 8 x 16 tile, one wider than a tile
    with a ragged edge and three images, one smaller than a tile.  The
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


# (kind, sf, pre, taps, (h, w) of the forward's input): every sf of the
# bicubic CEM at both extreme sub-positions, the CEM's tap counts, ragged
# sizes, tiles cut short, and axes shorter than the taps
TAPS_GRID = (
    [('E', 1, 0, k, hw) for k in (4, 9, 11, 17, 27, 33)
     for hw in ((13, 21), (3, 2), (70, 130))]
    + [(kind, sf, pre, k, hw) for sf in (2, 3, 4, 8) for pre in (0, sf - 1)
       for kind, k, hw in (('D', 9, (5 * sf + 1, 3 * sf)),
                           ('D', 17, (sf, sf + 1)),
                           ('D', 33, (37 * sf + 3, 19 * sf)),
                           ('U', 11, (5, 3)), ('U', 17, (2, 1)),
                           ('U', 33, (37, 70)))]
    # even taps grow the forward's output by one along each axis
    + [(kind, sf, pre, k, hw) for sf in (2, 3, 4) for pre in (0, sf - 1)
       for k in (4, 6, 8)
       for kind, hw in (('D', (5 * sf + 1, 3 * sf)), ('U', (5, 3)))]
)


@pytest.mark.parametrize('kind,sf,pre,k,hw', TAPS_GRID)
def test_sepfilter_taps_matches_plain(cuda, kind, sf, pre, k, hw):
    """The adjoint kernel against its plain version on the same tables,
    fp32, 1e-5 of the largest output (the sums run in another order)."""
    from exsr_torch.ops.kernels import sepfilter as S
    gen = torch.Generator(device=cuda).manual_seed(k + 100 * sf + pre)
    kcol, krow = _rand(gen, k), _rand(gen, k)
    h, w = hw
    g = 1 - k % 2
    n_out = {'E': (h + g, w + g), 'D': (len(range(pre, h + g, sf)),
                                        len(range(pre, w + g, sf))),
             'U': (h * sf + g, w * sf + g)}[kind]
    for c in (1, 3):
        y = torch.rand(2, *n_out, c, generator=gen, device=cuda)
        tabs = S.AdjointTables.of(kcol, krow).get(kind, h, w, sf,
                                                  (pre, pre), cuda)
        before = S.sepfilter_taps.launches
        out = S.sepfilter_taps(y, *tabs)
        torch.cuda.synchronize()
        assert S.sepfilter_taps.launches == before + 1
        ref = S.sepfilter_taps_plain(y, *tabs)
        assert out.shape == (2, h, w, c)
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
