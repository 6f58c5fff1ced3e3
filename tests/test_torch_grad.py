"""Gradients of the port's kernels and of the CEM-wrapped grouped forward,
on the CPU, against exsr's XLA paths (``jax.vjp`` / ``jax.grad``; none of
exsr's Pallas kernels has a VJP) and against autograd's own checks.

The CEM filter's backward is its adjoint, applied by ``sepfilter_taps``
from host-built tables (``adjoint_taps``); on the CPU its plain version
runs, so these tests hold the tables themselves.  The CUDA kernels are held
to the plain route by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.cem import cem as JCem
from exsr.models import rrdb_fast as JFast
from exsr.models.rrdb import RRDBNet as JNet
from exsr_torch.cem import cem as TCem
from exsr_torch.models import rrdb_fast as TFast
from exsr_torch.models.convert import from_exsr_params
from exsr_torch.ops import filters as TF
from exsr_torch.ops.kernels import sepfilter as K
from exsr_torch.ops.kernels.stage4 import _Stage4, stage4


def _forward_plain(kind, x, kcol, krow, sf, pre):
    if kind == 'E':
        return K.sepfilter_edge_plain(x, kcol, krow)
    if kind == 'D':
        return K.sepfilter_down_plain(x, kcol, krow, sf, pre)
    return K.sepfilter_up_plain(x, kcol, krow, sf, pre)


def _adjoint_plain(kind, y, kcol, krow, sf, pre, h, w):
    tabs = K.AdjointTables.of(kcol, krow).get(kind, h, w, sf, pre, y.device,
                                              y.dtype)
    return K.sepfilter_taps_plain(y, *tabs)


# (kind, sf, pre, taps, (h, w)): every sf of the bicubic CEM with both
# extreme sub-positions, the CEM's tap counts, ragged sizes and axes
# shorter than the taps (every tap of a row lands on one edge)
ADJOINT_GRID = (
    [('E', 1, 0, k, hw) for k in (9, 11, 17, 27, 33)
     for hw in ((13, 21), (3, 2))]
    + [(kind, sf, pre, k, hw) for sf in (2, 3, 4, 8) for pre in (0, sf - 1)
       for kind, k, hw in (('D', 9, (5 * sf + 1, 3 * sf)),
                           ('D', 17, (sf, sf + 1)),
                           ('D', 33, (3 * sf, 2 * sf - 1)),
                           ('U', 11, (5, 3)), ('U', 17, (2, 1)))]
)


@pytest.mark.parametrize('kind,sf,pre,k,hw', ADJOINT_GRID)
def test_adjoint_identity(kind, sf, pre, k, hw):
    """<A x, y> == <x, A^T y> in float64 to 1e-12 relative: the tables
    transpose each axis's forward matrix, folds at the clamped edges
    included.  (For D, ``hw`` is the HR input; for U, the LR input.)"""
    rng = np.random.default_rng(hash((kind, sf, pre, k)) % 2 ** 32)
    kcol = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    krow = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    h, w = hw
    x = torch.from_numpy(rng.normal(size=(2, h, w, 3)))
    ax = _forward_plain(kind, x, kcol, krow, sf, (pre, pre))
    y = torch.from_numpy(rng.normal(size=tuple(ax.shape)))
    aty = _adjoint_plain(kind, y, kcol, krow, sf, (pre, pre), h, w)
    assert aty.shape == x.shape
    lhs, rhs = float((ax * y).sum()), float((x * aty).sum())
    scale = float(ax.abs().sum() * y.abs().max())
    assert abs(lhs - rhs) <= 1e-12 * scale, (lhs, rhs)


def test_adjoint_taps_fold_onto_the_edge():
    """At x4 (17 taps, pre 1) the clamped taps of the first outputs fold
    onto the first sample: D^T's first HR sample takes taps 0-7 of LR
    output 0 (HR 1 - 8 + r <= 0) summed, and taps 0-3 of output 1; E^T's
    first sample takes the k//2 + 1 folded taps of output 0 and fewer of
    each later one.  Weights of one sample sum to what the forward gives
    it."""
    taps = np.arange(1, 18, dtype=np.float64)
    idx, w = K.adjoint_taps('D', 64, 4, 1, taps)
    assert list(idx[:, 0]) == [0, 1, -1, -1, -1]
    assert list(w[:2, 0]) == [taps[:8].sum(), taps[:4].sum()]
    assert (idx[:, 32] >= 0).sum() == 4  # 17 taps over sf 4, interior
    assert w.sum() == taps.sum() * 16    # every LR output spends its taps
    idx, w = K.adjoint_taps('E', 64, 1, 0, taps)
    assert list(idx[:9, 0]) == list(range(9)) and idx[9, 0] == -1
    assert list(w[:9, 0]) == [taps[:9 - e].sum() for e in range(9)]
    idx, w = K.adjoint_taps('U', 16, 4, 1, taps)
    assert idx.shape == (17, 16) and (idx[:, 0] >= 0).sum() == 10


def _gradcheck(fn, *inputs):
    """First and second derivatives by finite differences, in the fast
    mode (random projections of the Jacobians)."""
    return torch.autograd.gradcheck(fn, inputs, fast_mode=True) and \
        torch.autograd.gradgradcheck(fn, inputs, fast_mode=True)


@pytest.mark.parametrize('which', ['edge', 'down', 'up', 'up_combine'])
def test_sepfilter_functions_gradcheck(which):
    """Each CEM filter Function, and its backward (for gradients of
    gradients), by finite differences in float64 on a ragged image."""
    gen = torch.Generator().manual_seed(0)
    kcol, krow = torch.randn(5, generator=gen), torch.randn(7, generator=gen)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          requires_grad=True)
    if which == 'edge':
        assert _gradcheck(lambda x: K._linear('E', x, kcol, krow),
                          rnd(2, 7, 9, 2))
    elif which == 'down':
        assert _gradcheck(
            lambda x: K._linear('D', x, kcol, krow, 3, (1, 1)),
            rnd(1, 10, 8, 3))
    elif which == 'up':
        assert _gradcheck(
            lambda a: K._linear('U', a, kcol, krow, 2, (0, 0)),
            rnd(1, 4, 5, 3))
    else:
        assert _gradcheck(
            lambda a, b, g: K._up_combine(a, b, g, kcol, krow, 3, (1, 1)),
            rnd(1, 3, 4, 1), rnd(1, 3, 4, 1), rnd(1, 9, 12, 1))


def test_stage4_function_gradcheck():
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    gc, nf = 4, 8
    args = (rnd(1, 4, 5, gc), *(rnd(1, 4, 5, nf + k * gc)
                                for k in (4, 3, 2, 1)),
            rnd(1, 4, 5, nf), rnd(3, 3, gc, nf), rnd(nf))
    assert _gradcheck(lambda *a: _Stage4.apply(*a), *args)


def _rel_err(t, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(t) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('sf', [2, 3, 4, 8])
def test_cem_filter_gradients_match_exsr(sf):
    """d/d input of each entry point (through CEMFilters) against jax.vjp
    of exsr's XLA CEMFilters, fp32, 1e-5 relative to max |grad|."""
    jf = JCem.CEM.create(JCem.CEMConf(scale_factor=sf)).device_filters(3)
    tf = TCem.CEM.create(TCem.CEMConf(scale_factor=sf)).device_filters(
        3, device='cpu')
    rng = np.random.default_rng(sf)
    h, w = 7, 11
    lr = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    hr = rng.uniform(size=(2, h * sf, w * sf, 3)).astype(np.float32)
    cot_lr = rng.normal(size=lr.shape).astype(np.float32)
    cot_hr = rng.normal(size=hr.shape).astype(np.float32)
    cases = [('conv_inv_hth', lr, cot_lr), ('downscale', hr, cot_lr),
             ('upscale', lr, cot_hr)]
    for name, x, cot in cases:
        _, vjp = jax.vjp(getattr(jf, name), jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(cot))
        xt = torch.from_numpy(x).requires_grad_(True)
        getattr(tf, name)(xt).backward(torch.from_numpy(cot))
        assert _rel_err(xt.grad, ref) < 1e-5, name
    # the combine: gradients of lr and of the generated image
    _, vjp = jax.vjp(jf.enforce, jnp.asarray(lr), jnp.asarray(hr))
    ref_lr, ref_g = vjp(jnp.asarray(cot_hr))
    tl = torch.from_numpy(lr).requires_grad_(True)
    tg = torch.from_numpy(hr).requires_grad_(True)
    tf.enforce(tl, tg).backward(torch.from_numpy(cot_hr))
    assert _rel_err(tl.grad, ref_lr) < 1e-5
    assert _rel_err(tg.grad, ref_g) < 1e-5


def test_cem_filters_keep_their_adjoint_tables(monkeypatch):
    """CEMFilters' backward takes its tables from the AdjointTables it owns
    (built from the numpy taps): a second backward at the same shape builds
    none, none is built from the tap tensors, and the tables equal those
    built from the tap tensors."""
    filt = TCem.CEM.create(TCem.CEMConf(scale_factor=4)).device_filters(
        3, device='cpu')
    monkeypatch.setattr(K.AdjointTables, 'of', classmethod(
        lambda cls, *a: pytest.fail('tables built from the tap tensors')))
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.uniform(size=(1, 9, 10, 3)).astype('f'))
    hr = torch.from_numpy(rng.uniform(size=(1, 36, 40, 3)).astype('f'))
    built = []
    for _ in range(2):
        g = hr.clone().requires_grad_(True)
        filt.enforce(lr, g).sum().backward()
        built.append(sum(len(t._cache) for t in (
            filt.adj_down, filt.adj_up, filt.adj_inv_hth)))
    # one U^T, one E^T (lr takes no gradient), one D^T: 3 tables
    assert built == [3, 3]
    monkeypatch.undo()
    for tabs, taps, kind, n in ((filt.adj_up, filt.w_up_1d, 'U', (9, 10)),
                                (filt.adj_inv_hth, filt.w_inv_hth_1d, 'E',
                                 (9, 10)),
                                (filt.adj_down, filt.w_down_1d, 'D',
                                 (36, 40))):
        args = (kind, *n, filt.sf, filt.pre, 'cpu')
        for a, b in zip(tabs.get(*args), K.AdjointTables.of(*taps)
                        .get(*args)):
            assert torch.equal(a.idx, b.idx) and torch.equal(a.w, b.w)


def test_stage4_gradient_matches_exsr_xla_epilogue():
    """The stage-4 Function's gradients against jax.vjp of the XLA
    epilogue in exsr's _rdb_grouped (rrdb_fast.py:141-150), fp32, 1e-5
    relative to max |grad| of each input."""
    nf, gc = 16, 8
    rng = np.random.default_rng(3)
    c3 = rng.normal(size=(2, 6, 7, gc)).astype(np.float32)
    ps = [rng.normal(size=(2, 6, 7, nf + k * gc)).astype(np.float32)
          for k in (4, 3, 2, 1)]
    x = rng.normal(size=(2, 6, 7, nf)).astype(np.float32)
    w4 = (rng.normal(size=(3, 3, gc, nf)) * 0.1).astype(np.float32)
    b4 = rng.normal(size=nf).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def epilogue(c3, p0, p1, p2, p3, x):
        p4 = JFast._conv(c3, jnp.asarray(w4))
        out = (p0[..., :nf] + p1[..., :nf] + p2[..., :nf] + p3[..., :nf]
               + p4 + jnp.asarray(b4))
        return out * 0.2 + x

    _, vjp = jax.vjp(epilogue, *map(jnp.asarray, (c3, *ps, x)))
    refs = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (c3, *ps, x)]
    stage4(*ts, torch.from_numpy(w4), torch.from_numpy(b4)).backward(
        torch.from_numpy(cot))
    for t, ref in zip(ts, refs):
        assert _rel_err(t.grad, ref) < 1e-5


NF, GC, NB = 16, 8, 2


@pytest.fixture(scope='module')
def edit_case():
    """exsr's generator params (nf 16, gc 8, nb 2), the port's state dict
    of the same weights, and an edit crop: LR 24 (no pre-pad, the crop
    carries its margins), a Z, a desired image saturated at 0 and 1 over
    a third of its pixels, and a loss mask."""
    g = JNet(nf=NF, gc=GC, nb=NB, latent_channels=3)
    params = g.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)),
                    jnp.zeros((1, 32, 32, 3)))
    state = from_exsr_params(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(8)
    lr = rng.uniform(size=(1, 24, 24, 3)).astype(np.float32)
    z = rng.uniform(-0.9, 0.9, size=(1, 96, 96, 3)).astype(np.float32)
    desired = rng.uniform(size=(1, 96, 96, 3)).astype(np.float32)
    desired[:, :32] = 1.0
    desired[:, 32:48] = 0.0
    mask = np.zeros((1, 96, 96, 1), np.float32)
    mask[:, 20:76, 20:76] = 1.0
    return params, state, lr, z, desired, mask


def _exsr_grad(params, lr, z, desired, mask, dtype):
    jc = JCem.CEM.create(JCem.CEMConf(scale_factor=4))
    fwd = JCem.cem_wrap(
        lambda p, x, zz: JFast.rrdbnet_apply_fast(p, x, zz, nf=NF, gc=GC,
                                                  nb=NB, dtype=dtype),
        jc.device_filters(3), 4)

    def loss(zz):
        out = jnp.clip(fwd(params, jnp.asarray(lr), zz,
                           jc.invalidity_margins_lr, pre_pad=False), 0, 1)
        return jnp.abs(out * mask - desired * mask).mean()
    val, grad = jax.value_and_grad(loss)(jnp.asarray(z))
    return float(val), np.asarray(grad, np.float32)


def _port_grad(state, lr, z, desired, mask, dtype):
    tc = TCem.CEM.create(TCem.CEMConf(scale_factor=4))
    packed = TFast.pack_grouped_params(state, dtype=dtype)
    fwd = TCem.cem_wrap(
        lambda p, x, zz: TFast.rrdbnet_apply_fast(None, x, zz, packed=p,
                                                  dtype=dtype),
        tc.device_filters(3, device='cpu'), 4)
    zt = torch.from_numpy(z).requires_grad_(True)
    m, d = torch.from_numpy(mask), torch.from_numpy(desired)
    out = TF.clip_unit(fwd(packed, torch.from_numpy(lr), zt,
                           tc.invalidity_margins_lr, pre_pad=False))
    loss = (out * m - d * m).abs().mean()
    loss.backward()
    assert all(not t.requires_grad for blk in packed[0]
               for e in blk.values() for t in e.values())
    return loss.item(), zt.grad.numpy()


def test_edit_gradient_matches_exsr_fp32(edit_case):
    """d(masked l1)/dZ of the clipped CEM-wrapped grouped forward on an
    edit crop (pre_pad off), fp32, against jax.grad of exsr's
    cem_wrap(rrdbnet_apply_fast).  Tolerance 1e-5 relative to max |grad|
    (measured 2.3e-7): ~70 convs and their transposes summed in another
    order on each side."""
    params, state, lr, z, desired, mask = edit_case
    jl, jg = _exsr_grad(params, lr, z, desired, mask, None)
    tl, tg = _port_grad(state, lr, z, desired, mask, None)
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert np.abs(jg).max() > 0
    assert _rel_err(tg, jg) < 1e-5


def test_edit_gradient_matches_exsr_bf16_within_its_gap(edit_case):
    """The same gradient through a bf16 trunk.  exsr's is XLA's bf16
    autodiff, and bf16 rounds at other places in the two frameworks, so
    the port is held to exsr by exsr's own bf16-vs-fp32 gap: its distance
    from exsr's bf16 gradient at most twice that gap (measured 0.018x);
    and it must be a bf16 gradient, farther from the fp32 one than a
    tenth of the gap (measured 1.0x)."""
    params, state, lr, z, desired, mask = edit_case
    _, j32 = _exsr_grad(params, lr, z, desired, mask, None)
    _, j16 = _exsr_grad(params, lr, z, desired, mask, jnp.bfloat16)
    _, t16 = _port_grad(state, lr, z, desired, mask, torch.bfloat16)
    gap = np.abs(j16 - j32).max()
    assert gap > 0
    assert np.abs(t16 - j16).max() <= 2 * gap
    assert np.abs(t16 - j32).max() > 0.1 * gap


def test_clip_ties_split_the_gradient_as_exsr():
    """jnp.clip passes half the gradient at an exact tie with 0 or 1
    (maximum and minimum split ties); torch.clamp passes all of it.  The
    port clips with ``clip_unit``, which splits ties as exsr does."""
    vals = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray(vals)))
    t = torch.from_numpy(vals).requires_grad_(True)
    TF.clip_unit(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    np.testing.assert_array_equal(ref, [0.0, 0.5, 1.0, 0.5, 0.0])
    c = torch.from_numpy(vals).requires_grad_(True)
    c.clamp(0.0, 1.0).sum().backward()
    assert c.grad[1] == 1.0 and c.grad[3] == 1.0


def test_grouped_trunk_saves_no_p_buffer(edit_case):
    """Under autograd the grouped trunk keeps, per RDB, the conv inputs
    ([z, x] and c0..c3) and the leaky_relu inputs alive, never a P buffer:
    the slice sums read P through views, and the stage-4 backward needs
    only w4.  Checked on every activation that autograd saves."""
    _, state, lr, z, _, _ = edit_case
    packed = TFast.pack_grouped_params(state, dtype=None)
    p_widths = {NF + k * GC for k in (1, 2, 3, 4)}
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    zt = torch.from_numpy(z).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TFast.rrdb_trunk_fast(packed, torch.from_numpy(lr), zt, dtype=None)
    h, w = lr.shape[1:3]
    acts = [s for s in saved if len(s) == 4 and (s[1:3] == (h, w)
                                                 or s[2:] == (h, w))]
    assert acts
    for s in acts:
        channels = s[3] if s[1:3] == (h, w) else s[1]
        assert channels not in p_widths, s
