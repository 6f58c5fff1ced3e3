"""The port's two hand-written kernels: their plain PyTorch versions against
the Pallas kernels they replace (interpret mode, as tests/test_pallas.py
runs them), and the wrappers' input checks and launch counters.  The
kernels themselves are tested on the GPU by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.ops import filters as JF
from exsr.ops.pallas.sepfilter import sepfilter_edge_pallas
from exsr.ops.pallas.stage4 import stage4_pallas, stage4_pallas_chunked
from exsr_torch.ops.kernels.sepfilter import sepfilter_edge
from exsr_torch.ops.kernels.stage4 import stage4


def _sep_inputs(seed, shape, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    return x, rng.normal(size=kh), rng.normal(size=kw)


def _sep_torch(x, kcol, krow, device='cpu'):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return sepfilter_edge(f(x), f(kcol), f(krow))


@pytest.mark.parametrize('shape,kh,kw', [((2, 24, 24, 3), 5, 3),
                                         ((1, 20, 36, 2), 9, 17)])
def test_sepfilter_plain_matches_pallas(shape, kh, kw):
    x, kcol, krow = _sep_inputs(0, shape, kh, kw)
    ref = sepfilter_edge_pallas(jnp.asarray(x), tuple(kcol.tolist()),
                                tuple(krow.tolist()), interpret=True)
    out = _sep_torch(x, kcol, krow)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_sepfilter_plain_inv_hth_taps():
    """Real x4 inv_hTh taps, against the 2-D filter and the Pallas
    kernel (2e-5, as tests/test_pallas.py)."""
    from exsr.cem.cem import CEM, CEMConf
    cem = CEM.create(CEMConf(scale_factor=4))
    col, row = JF.separable_factors(cem.inv_hth)
    assert len(col) == 27
    x = np.random.default_rng(1).uniform(size=(1, 32, 32, 3)) \
        .astype(np.float32)
    ref2d = JF.filter_replicate_same(jnp.asarray(x),
                                     JF.depthwise_weights(cem.inv_hth, 3))
    ref = sepfilter_edge_pallas(jnp.asarray(x), tuple(col.tolist()),
                                tuple(row.tolist()), interpret=True)
    out = _sep_torch(x, col, row).numpy()
    np.testing.assert_allclose(out, np.asarray(ref2d), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


def _s4_inputs(seed, b, h, w, gc, nf, dtype=np.float32):
    rng = np.random.default_rng(seed)
    c3 = rng.normal(size=(b, h, w, gc)).astype(dtype)
    ps = [rng.normal(size=(b, h, w, nf + k * gc)).astype(dtype)
          for k in (4, 3, 2, 1)]
    x = rng.normal(size=(b, h, w, nf)).astype(dtype)
    w4 = (rng.normal(size=(3, 3, gc, nf)) * 0.1).astype(dtype)
    b4 = rng.normal(size=(nf,)).astype(np.float32)
    return c3, ps, x, w4, b4


def _s4_torch(c3, ps, x, w4, b4, device='cpu', dtype=torch.float32):
    f = lambda a: torch.as_tensor(a, device=device).to(dtype)
    return stage4(f(c3), *[f(p) for p in ps], f(x), f(w4),
                  torch.as_tensor(b4, device=device))


def test_stage4_plain_matches_pallas():
    c3, ps, x, w4, b4 = _s4_inputs(0, 2, 12, 12, 8, 16)
    ref = stage4_pallas(*map(jnp.asarray, (c3, *ps, x, w4, b4)),
                        interpret=True)
    out = _s4_torch(c3, ps, x, w4, b4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('h,rc', [(24, 8), (20, 32)])
def test_stage4_plain_matches_pallas_chunked(h, rc):
    c3, ps, x, w4, b4 = _s4_inputs(1, 2, h, 12, 8, 16)
    ref = stage4_pallas_chunked(*map(jnp.asarray, (c3, *ps, x, w4, b4)),
                                row_chunk=rc, interpret=True)
    out = stage4(*map(torch.from_numpy, (c3, *ps, x, w4, b4)),
                 row_chunk=rc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_stage4_plain_bf16_rounding_order():
    """bf16: the scaled sum is rounded to bf16 before x is added, as the
    Pallas kernel does; the two agree to one bf16 ulp of the output."""
    c3, ps, x, w4, b4 = _s4_inputs(2, 1, 8, 8, 8, 16)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = stage4_pallas(*map(bf, (c3, *ps, x, w4)), jnp.asarray(b4),
                        interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = _s4_torch(c3, ps, x, w4, b4, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)


def test_cpu_calls_leave_launch_counters_at_zero():
    sepfilter_edge.launches = stage4.launches = 0
    x, kcol, krow = _sep_inputs(3, (1, 8, 8, 3), 3, 3)
    _sep_torch(x, kcol, krow)
    _s4_torch(*_s4_inputs(3, 1, 8, 8, 8, 16))
    assert sepfilter_edge.launches == 0
    assert stage4.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 8, 3)
    k = torch.ones(3)
    with pytest.raises(ValueError, match='fp32'):
        sepfilter_edge(x.double(), k, k)
    with pytest.raises(ValueError, match='contiguous'):
        sepfilter_edge(x.permute(0, 2, 1, 3), k, k)
    with pytest.raises(ValueError, match='1-D'):
        sepfilter_edge(x, k[None], k)
    c3, ps, xs, w4, b4 = _s4_inputs(4, 1, 8, 8, 8, 16)
    t = torch.from_numpy
    args = [t(c3), *map(t, ps), t(xs), t(w4), t(b4)]
    with pytest.raises(ValueError, match='P0'):
        stage4(args[0], args[1][..., :8], *args[2:])
    with pytest.raises(ValueError, match='w4'):
        stage4(*args[:6], args[6][:, :, :4], args[7])
    with pytest.raises(ValueError, match='contiguous'):
        stage4(*args[:5], args[5].transpose(1, 2), *args[6:])
    with pytest.raises(ValueError, match='dtype'):
        stage4(*args[:5], args[5].double(), *args[6:])
