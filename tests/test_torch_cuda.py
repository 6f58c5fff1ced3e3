"""The port's hand-written kernels on the GPU, each against its plain
PyTorch version, and the port's forward on CUDA against the same forward on
the CPU.  Every test needs CUDA and skips without it.

This file imports no JAX, so that it runs on a GPU machine without it::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from exsr_torch.apps.eval_sr import build_model
from exsr_torch.cem.cem import CEM, CEMConf
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.ops.kernels.sepfilter import (sepfilter_edge,
                                              sepfilter_edge_plain)
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
                                         ((3, 9, 5, 4), 17, 27)])
def test_sepfilter_kernel_matches_plain(cuda, shape, kh, kw):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(*shape, generator=gen, device=cuda)
    kcol, krow = _rand(gen, kh), _rand(gen, kw)
    before = sepfilter_edge.launches
    out = sepfilter_edge(x, kcol, krow)
    torch.cuda.synchronize()
    assert sepfilter_edge.launches == before + 1
    ref = sepfilter_edge_plain(x, kcol, krow)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match='odd'):
        sepfilter_edge(x, torch.cat([kcol, kcol]), krow)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h,w,gc,nf', [(40, 36, 32, 64), (7, 19, 8, 16)])
def test_stage4_kernel_matches_plain(cuda, dtype, h, w, gc, nf):
    """fp32 to 1e-5; bf16 to one bf16 ulp (2^-7 relative), where fp32
    summation order moves the scaled sum across a rounding boundary."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    c3 = _rand(gen, 2, h, w, gc, dtype=dtype)
    ps = [_rand(gen, 2, h, w, nf + k * gc, dtype=dtype) for k in (4, 3, 2, 1)]
    x = _rand(gen, 2, h, w, nf, dtype=dtype)
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


def test_kernels_refuse_gradients(cuda):
    x = torch.rand(1, 8, 8, 3, device=cuda, requires_grad=True)
    k = torch.ones(3, device=cuda)
    with pytest.raises(NotImplementedError, match='backward'):
        sepfilter_edge(x, k, k)


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
    versions, and exactly 5 + 3 * nb kernel launches per forward."""
    rng = np.random.default_rng(3)
    lr = rng.uniform(size=(2, 20, 20, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(2, 80, 80, 3)).astype(np.float32)
    net = RRDBNet(nf=16, nb=2, gc=8, latent_channels=3, seed=4)
    _, fwd_cpu = build_model(4, nb=2, nf=16, device='cpu',
                             dtype=torch.float32, params=net)
    _, fwd_gpu = build_model(4, nb=2, nf=16, device=cuda,
                             dtype=torch.float32, params=net)
    sepfilter_edge.launches = stage4.launches = 0
    out = fwd_gpu(lr, z)
    torch.cuda.synchronize()
    assert (sepfilter_edge.launches, stage4.launches) == (5, 6)
    torch.testing.assert_close(out.cpu(), fwd_cpu(lr, z), atol=1e-5,
                               rtol=0)
