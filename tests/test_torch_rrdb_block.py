"""The fused residual dense block against exsr's Pallas kernels (interpret
mode, as tests/test_pallas.py runs them), the kernel's weight layout, the
wrapper's refusals, and the fused-trunk RRDBNet against exsr's
``RRDBNet(pallas_trunk=True)``.  CPU; the CUDA kernel itself is tested by
tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from exsr.apps import eval_sr as JApp
from exsr.models.rrdb import RRDBNet as JNet
from exsr.ops.pallas.rrdb_block import (rdb_pallas, rrdb_block_chained,
                                        rrdb_block_pallas)
from exsr_torch.apps import eval_sr as TApp
from exsr_torch.models.convert import from_exsr_params
from exsr_torch.models.rrdb import RRDBNet as TNet
from exsr_torch.ops.kernels import rrdb_block as K

NF, GC, NZ = 16, 8, 3
DTYPES = {'fp32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16)}


def _rdb_tree(rng, nf=NF, gc=GC, nz=NZ):
    """One RDB's params in exsr's layout (HWIO kernels), nonzero biases."""
    tree = {}
    for c in range(5):
        cin, cout = nz + nf + c * gc, (gc if c < 4 else nf)
        k = rng.normal(size=(3, 3, cin, cout)) * 0.5 * np.sqrt(2 / (9 * cin))
        tree[f'conv{c}'] = {'Conv_0': {
            'kernel': k.astype(np.float32),
            'bias': (rng.normal(size=cout) * 0.1).astype(np.float32)}}
    return tree


def _pack(tree, dtype):
    convs = [tree[f'conv{c}']['Conv_0'] for c in range(5)]
    return K.pack_rdb(
        [torch.from_numpy(c['kernel'].transpose(3, 2, 0, 1)) for c in convs],
        [torch.from_numpy(c['bias']) for c in convs], dtype)


def _inputs(seed, b, h, w, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, NF)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(b, h, w, NZ)).astype(np.float32)
    tx, jx = DTYPES[dtype]
    return (torch.from_numpy(x).to(tx), torch.from_numpy(z).to(tx),
            jnp.asarray(x).astype(jx), jnp.asarray(z).astype(jx))


def _assert_close(out, ref, dtype):
    """fp32: 1e-5 (tests/test_pallas.py:53).  bf16: one bf16 ulp of the
    reference at every element; fp32 summation order may move a value
    across a bf16 rounding boundary, in the output or in an intermediate
    c_i whose flip then reaches the output much diluted."""
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if dtype == 'fp32':
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                      - 7)
        assert np.all(np.abs(out - ref) <= ulp), np.abs(out - ref).max()


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('h,w', [(8, 8), (7, 10)])
def test_rdb_plain_matches_pallas(dtype, h, w):
    tree = _rdb_tree(np.random.default_rng(0))
    x, z, jx, jz = _inputs(1, 2, h, w, dtype)
    ref = rdb_pallas(jx, jz, tree, nf=NF, gc=GC, interpret=True)
    out = K.rdb(x, z, _pack(tree, DTYPES[dtype][0]))
    assert out.dtype == x.dtype and out.shape == x.shape
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_rrdb_block_plain_matches_pallas_and_chained(dtype):
    rng = np.random.default_rng(2)
    trees = [_rdb_tree(rng) for _ in range(3)]
    params = {f'rdb{r + 1}': t for r, t in enumerate(trees)}
    x, z, jx, jz = _inputs(3, 2, 8, 8, dtype)
    ref = rrdb_block_pallas(jx, jz, params, nf=NF, gc=GC, interpret=True)
    ref_chained = rrdb_block_chained(jx, jz, params, nf=NF, gc=GC,
                                     interpret=True)
    w3 = [_pack(t, DTYPES[dtype][0]) for t in trees]
    out = K.rrdb_block(x, z, w3)
    out_chained = K.rrdb_block_chained(x, z, w3)
    _assert_close(out, ref, dtype)
    _assert_close(out_chained, ref_chained, dtype)
    # the fused outer residual is the chained elementwise op, bit for bit
    assert torch.equal(out, out_chained)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_pack_matches_exsr_flattening(dtype):
    """rrdb_block.py:111-116: kernels in the activation dtype, biases fp32
    (also under a bf16 trunk), in conv order."""
    tree = _rdb_tree(np.random.default_rng(4))
    tx, jx = DTYPES[dtype]
    w = _pack(tree, tx)
    assert w.dtype == tx and (w.nf, w.gc, w.nz) == (NF, GC, NZ)
    for c in range(5):
        leaf = tree[f'conv{c}']['Conv_0']
        ref_k = np.asarray(jnp.asarray(leaf['kernel'], jx).astype(jnp.float32))
        ref_b = np.asarray(jnp.asarray(leaf['bias'], jnp.float32))
        assert w.kernels[c].dtype == tx
        np.testing.assert_array_equal(w.kernels[c].float().numpy(), ref_k)
        assert w.biases[c].dtype == torch.float32
        np.testing.assert_array_equal(w.biases[c].numpy(), ref_b)
    with pytest.raises(ValueError, match='fp32 parameters'):
        convs = [tree[f'conv{c}']['Conv_0'] for c in range(5)]
        K.pack_rdb([torch.from_numpy(c['kernel'].transpose(3, 2, 0, 1))
                    for c in convs],
                   [torch.from_numpy(c['bias']).bfloat16() for c in convs],
                   torch.bfloat16)


# the wgmma B descriptor the kernel builds (rdb.cu, weight_desc): K-major,
# no swizzle, leading byte offset 128, stride byte offset 256
DESC_LBO, DESC_SBO = 128, 256


def _read_through_descriptor(flat, k, n):
    """Read w[tap, k, n] back as the tensor cores address it: steps of 16
    channels, contiguous, N * 32 bytes each; inside a step, 8 x 8 core
    matrices of 128 bytes whose rows (one output's 8 channels) are 16 bytes
    apart, LBO between the two core matrices along K, SBO between groups of
    8 outputs."""
    step_bytes = n * 32
    kk, nn_ = torch.meshgrid(torch.arange(k), torch.arange(n), indexing='ij')
    byte = ((kk // 16) * step_bytes + (nn_ // 8) * DESC_SBO
            + ((kk % 16) // 8) * DESC_LBO + (nn_ % 8) * 16 + (kk % 8) * 2)
    taps = torch.arange(9)[:, None, None] * (k // 16) * step_bytes
    idx = (taps + byte[None]) // 2
    assert idx.unique().numel() == 9 * k * n  # a bijection onto the buffer
    return flat.float()[idx]


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('nf,gc', [(16, 8), (32, 16), (64, 32)])
def test_kernel_layout_holds_every_weight_in_its_slot(dtype, nf, gc):
    rng = np.random.default_rng(5)
    tree = _rdb_tree(rng, nf=nf, gc=gc)
    tx = DTYPES[dtype][0]
    w = _pack(tree, tx)
    gcp = w.gcp
    off = boff = 0
    for c in range(5):
        kk, nn_ = 16 + nf + c * gcp, (gcp if c < 4 else nf)
        flat = w.packed[off:off + 9 * kk * nn_]
        dense = (_read_through_descriptor(flat, kk, nn_) if tx == torch.bfloat16
                 else flat.reshape(9, kk, nn_))
        ref = torch.zeros(9, kk, nn_)
        src = w.kernels[c].float().reshape(9, -1, w.kernels[c].shape[3])
        cin, cout = src.shape[1:]
        slots = ([*range(NZ)] + [16 + j for j in range(nf)]
                 + [16 + nf + (j // gc) * gcp + j % gc
                    for j in range(cin - NZ - nf)])
        ref[:, slots, :cout] = src
        torch.testing.assert_close(dense, ref, atol=0, rtol=0)
        bias = w.packed_bias[boff:boff + nn_]
        assert torch.equal(bias[:cout], w.biases[c])
        assert not bias[cout:].any()
        off, boff = off + 9 * kk * nn_, boff + nn_
    assert off == w.packed.numel() and boff == w.packed_bias.numel()


@pytest.mark.parametrize('nf,gc,dtype,ok', [
    (64, 32, 'bf16', True), (16, 8, 'bf16', True), (32, 16, 'bf16', True),
    (16, 40, 'bf16', False),   # convs 0..3 would write 48 padded outputs
    (48, 8, 'bf16', False),    # conv 4 would write 48 outputs
    (16, 40, 'fp32', True),    # the fp32 kernel takes any padded gc
    (24, 8, 'fp32', False)])   # nf must fill 16-channel slots
def test_wrapper_raises_for_widths_the_kernel_is_not_built_for(nf, gc, dtype,
                                                               ok):
    w = _pack(_rdb_tree(np.random.default_rng(12), nf=nf, gc=gc),
              DTYPES[dtype][0])
    if ok:
        K.require_kernel_widths(w)
    else:
        with pytest.raises(NotImplementedError, match='nf'):
            K.require_kernel_widths(w)
    # the plain version, which CPU tensors take, has no such limit
    x = torch.zeros(1, 4, 4, nf, dtype=w.dtype)
    assert K.rdb(x, torch.zeros(1, 4, 4, NZ, dtype=w.dtype), w).shape \
        == x.shape


def test_mul_in_dtype_rounds_the_scale_as_jax():
    x = np.random.default_rng(6).normal(size=100_000).astype(np.float32)
    ref = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * 0.2)
                     .astype(jnp.float32))
    out = K.mul_in_dtype(torch.from_numpy(x).bfloat16(), 0.2)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_wrapper_refusals_and_cpu_counter():
    w = _pack(_rdb_tree(np.random.default_rng(7)), torch.float32)
    x, z, _, _ = _inputs(8, 1, 6, 6, 'fp32')
    K.rdb.launches = 0
    K.rdb(x, z, w)
    K.rrdb_block(x, z, [w, w, w])
    K.rrdb_block_chained(x, z, [w, w, w])
    assert K.rdb.launches == 0
    with pytest.raises(ValueError, match='packed for'):
        K.rdb(x.bfloat16(), z.bfloat16(), w)
    with pytest.raises(ValueError, match='contiguous'):
        K.rdb(x.transpose(1, 2), z.transpose(1, 2), w)
    with pytest.raises(ValueError, match='nf=16'):
        K.rdb(x[..., :8].contiguous(), z, w)
    with pytest.raises(ValueError, match='differ'):
        K.rdb(x, z[:, :5].contiguous(), w)
    with pytest.raises(ValueError, match='NHWC'):
        K.rdb(x[0], z[0], w)
    with pytest.raises(ValueError, match='x0'):
        K.rdb(x, z, w, x0=x[:, :5].contiguous())
    with pytest.raises(ValueError, match='fp32 or bf16'):
        K.pack_rdb([torch.zeros(1)] * 5, [torch.zeros(1)] * 5, torch.float16)


def _exsr_net(nb, nf, gc, h, seed):
    g = JNet(nf=nf, gc=gc, nb=nb, latent_channels=NZ)
    params = g.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, h, 3)),
                    jnp.zeros((1, 4 * h, 4 * h, NZ)))
    return params, from_exsr_params(jax.tree.map(np.asarray, params))


def test_fused_rrdbnet_matches_exsr_pallas_trunk():
    """fp32 to 1e-5; bf16 within 4x of exsr's own bf16-vs-fp32 gap."""
    params, state = _exsr_net(2, NF, GC, 10, seed=0)
    rng = np.random.default_rng(9)
    lr = rng.uniform(size=(1, 10, 10, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 40, 40, NZ)).astype(np.float32)
    outs = {}
    for name, (tx, jx) in DTYPES.items():
        g = JNet(nb=2, nf=NF, gc=GC, latent_channels=NZ, pallas_trunk=True,
                 dtype=None if name == 'fp32' else jx)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(g.apply(params, jnp.asarray(lr), jnp.asarray(z)))
        net = TNet(nf=NF, nb=2, gc=GC, latent_channels=NZ, fused_trunk=True,
                   dtype=tx)
        net.load_state_dict(state)
        K.rdb.launches = 0
        with torch.no_grad():
            out = net(torch.from_numpy(lr), torch.from_numpy(z))
        assert K.rdb.launches == 0  # plain versions on the CPU
        assert out.dtype == torch.float32 and out.shape == (1, 40, 40, 3)
        outs[name] = (out.numpy(), ref)
    out32, ref32 = outs['fp32']
    np.testing.assert_allclose(out32, ref32, atol=1e-5, rtol=0)
    out16, ref16 = outs['bf16']
    gap = np.abs(ref16 - ref32).max()
    assert gap > 0
    assert np.abs(out16 - ref16).max() <= 4 * gap


def test_fused_trunk_equals_module_trunk_and_reuses_its_packing():
    net = TNet(nf=NF, nb=2, gc=GC, latent_channels=NZ, seed=3,
               fused_trunk=True)
    plain = TNet(nf=NF, nb=2, gc=GC, latent_channels=NZ, seed=3)
    rng = np.random.default_rng(10)
    lr = torch.from_numpy(rng.uniform(size=(2, 9, 7, 3)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(-1, 1, size=(2, 36, 28, NZ))
                         .astype(np.float32))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('bias'):  # nonzero biases
                p.add_(0.01)
        plain.load_state_dict(net.state_dict())
        out = net(lr, z)
        packed = net._packed
        torch.testing.assert_close(out, plain(lr, z), atol=1e-5, rtol=0)
        net(lr, z)
        assert net._packed is packed  # packed once per set of weights
        net.trunk[0].rdb1.conv0.bias.add_(1.0)
        changed = net(lr, z)
        assert net._packed is not packed
        assert not torch.allclose(changed, out)


def test_fused_trunk_needs_z_and_fp32_parameters():
    with pytest.raises(ValueError, match='latent_channels'):
        TNet(nf=NF, nb=1, gc=GC, latent_channels=0, fused_trunk=True)
    net = TNet(nf=NF, nb=1, gc=GC, latent_channels=NZ,
               fused_trunk=True).bfloat16()
    with pytest.raises(ValueError, match='fp32 parameters'):
        net(torch.zeros(1, 4, 4, 3).bfloat16(),
            torch.zeros(1, 16, 16, NZ).bfloat16())


def test_build_model_default_dtype_matches_exsr():
    """Both build_models with their defaults compute in fp32."""
    _, state = _exsr_net(1, 16, 32, 16, seed=0)  # exsr's PRNGKey(0) init
    _, j_fwd = JApp.build_model(4, nb=1, latent_channels=3, nf=16)
    _, t_fwd = TApp.build_model(4, nb=1, latent_channels=3, nf=16,
                                device='cpu', params=state)
    rng = np.random.default_rng(11)
    lr = rng.uniform(size=(1, 24, 24, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 96, 96, 3)).astype(np.float32)
    np.testing.assert_allclose(t_fwd(lr, z).numpy(), j_fwd(lr, z), atol=1e-5,
                               rtol=0)


def test_executed_flops_counts_halo_padding_and_ragged_units():
    """nf 64, gc 32 on one 8 x 16 tile: conv i runs 6, 5, 4, 3, 2 units of
    64 pixels over K = 80 + 32 i slots and 32 (conv 4: 64) outputs."""
    per_tile = 2 * 9 * 64 * (6 * 80 * 32 + 5 * 112 * 32 + 4 * 144 * 32
                             + 3 * 176 * 32 + 2 * 208 * 64)
    assert K.executed_flops_bf16(1, 8, 16, 64, 32) == per_tile
    # ragged images round up to whole tiles; gc pads to 16 slots
    assert K.executed_flops_bf16(2, 9, 17, 64, 32) == 2 * 4 * per_tile
    assert K.executed_flops_bf16(1, 8, 16, 64, 24) == per_tile
    useful = 2 * 9 * 128 * sum((3 + 64 + 32 * i) * (32 if i < 4 else 64)
                               for i in range(5))
    assert 1.7 < per_tile / useful < 1.8
