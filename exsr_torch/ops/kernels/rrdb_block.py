"""The fused residual dense block (RDB) as one kernel, and the RRDB built
from it.

Replaces the three entry points of ``exsr/ops/pallas/rrdb_block.py``, which
share the kernel body ``_rrdb_kernel`` (``:38``):

* :func:`rdb` is ``rdb_pallas`` (``:145``), one RDB::

      feats = [z, x]
      c_i = dtype(leaky_relu(conv3x3(feats, w_i) + b_i, 0.2))   (i = 0..3)
      out = dtype(0.2 * (conv3x3([feats, c0..c3], w_4) + b_4) + float(x))

  with fp32 accumulation and fp32 biases, as ``rrdb_block.py:56,86-91``;
* :func:`rrdb_block` is ``rrdb_block_pallas`` (``:100``), a whole RRDB:
  three RDBs and the outer residual ``cur * dtype(0.2) + x`` in dtype
  arithmetic (``:93``).  It is three launches of the RDB kernel, the third
  with the outer residual fused into its epilogue (``x0``), so the RRDB
  costs no extra pass over memory.  A single kernel over a whole RRDB would
  need a 15-pixel halo, which an H100 block cannot hold at a useful tile;
* :func:`rrdb_block_chained` is ``rrdb_block_chained`` (``:178``): three
  RDB launches and the outer residual as a separate elementwise op.  It
  computes the same function as :func:`rrdb_block`.

Tensors are NHWC: ``x`` ``[B, h, w, nf]``, ``z`` ``[B, h, w, nz]`` in x's
dtype (bf16 or fp32).  Weights come packed (:func:`pack_rdb`): the five
HWIO kernels cast to the activation dtype, the biases kept fp32, as
``rrdb_block.py:111-116`` flattens them, plus the same weights in the CUDA
kernel's layout.  Pack once per set of weights; :class:`RRDBNet` keeps its
packed trunk on the module (``exsr_torch.models.rrdb``).

On the H100 the RDB is bound by operations (489,600 flops per pixel at
nf 64, gc 32 against 262 bytes in bf16).  The CUDA kernel
(``exsr_torch/csrc/rdb.cu``) keeps every intermediate in shared memory: one
block per output tile stages ``[z, x]`` with a 5-pixel halo and computes
each conv on the tile grown by the halo the later convs need.  In bf16 the
products run on the tensor cores with ``wgmma``: two consumer warpgroups
read the pixels with ``ldmatrix`` and the weights through a shared-memory
descriptor from a ring that a producer thread fills with bulk copies, slot
by slot under ``mbarrier``s.  In fp32 (reference checks only) they run on
fp32 FMA.  The bf16 kernel is instantiated for ``gc <= 32`` and ``nf`` 16,
32 or 64; :func:`rdb` raises ``NotImplementedError`` for other widths on
CUDA.  The wrapper runs :func:`rdb_plain` for CPU tensors and launches the
kernel for CUDA tensors; there is no backward.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from exsr_torch.ops.filters import to_nchw, to_nhwc
from exsr_torch.ops.kernels import build

Z_SLOTS = 16  # the kernel's channel slots for z (nz <= 16), zero-padded
# padded output widths the bf16 kernel instantiates wgmma for: convs 0..3
# (gc rounded up to 16) and conv 4 (nf)
BF16_GC_WIDTHS, BF16_NF_WIDTHS = (16, 32), (16, 32, 64)
SMEM_LIMIT = 227 * 1024


@dataclass(frozen=True)
class RdbWeights:
    """One RDB's weights, packed for :func:`rdb`.

    ``kernels`` are the five HWIO ``[3, 3, cin_i, cout_i]`` kernels in the
    activation dtype and ``biases`` the five fp32 biases, in ``exsr``'s
    flattening order.  ``packed`` and ``packed_bias`` hold the same weights
    in the CUDA kernel's layout (:func:`kernel_layout`).
    """
    kernels: tuple
    biases: tuple
    packed: torch.Tensor
    packed_bias: torch.Tensor
    nf: int
    gc: int
    nz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.packed.dtype

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def gcp(self) -> int:
        """gc rounded up to the kernel's 16-channel slot width."""
        return -(-self.gc // 16) * 16


def _slots(nz: int, nf: int, gc: int, gcp: int, cin: int) -> list:
    """Kernel channel slot of each input channel of ``[z, x, c0, ...]``."""
    out = []
    for ch in range(cin):
        if ch < nz:
            out.append(ch)
        elif ch < nz + nf:
            out.append(Z_SLOTS + ch - nz)
        else:
            j = ch - nz - nf
            out.append(Z_SLOTS + nf + (j // gc) * gcp + j % gc)
    return out


def kernel_layout(kernels, biases, nf: int, gc: int, nz: int, dtype):
    """The CUDA kernel's weight layout: ``(weights, biases)``, both flat.

    Conv i reads ``K_i = 16 + nf + i * gcp`` input slots (z zero-padded to
    16, x, then each earlier ``c_j`` padded to ``gcp``) and writes
    ``N_i = gcp`` (``nf`` for conv 4) outputs; padding is zero.  Per conv,
    fp32 weights are ``[tap][K_i][N_i]``.  bf16 weights are in the order
    the ``wgmma`` B descriptor reads, ``[tap][K_i/16][N_i/8][k half][n % 8]
    [k % 8]``: a (tap, 16-channel) step is ``N_i`` x 16 values in 8 x 8
    core matrices of 128 contiguous bytes with K innermost (no swizzle);
    the two core matrices along K lie 128 bytes apart (the descriptor's
    leading byte offset) and the next 8 outputs 256 bytes on (its stride
    byte offset).  Within a step, ``w[k, n]`` is element
    ``(n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8``; a step is
    contiguous, so the kernel's producer streams whole steps with 1-D bulk
    copies.  Biases are fp32 ``[N_i]`` per conv.
    """
    gcp = -(-gc // 16) * 16
    ws, bs = [], []
    for i, (k, b) in enumerate(zip(kernels, biases)):
        cin, cout = k.shape[2], k.shape[3]
        kk, nn_ = Z_SLOTS + nf + i * gcp, (gcp if i < 4 else nf)
        w = torch.zeros(9, kk, nn_, dtype=dtype, device=k.device)
        idx = torch.tensor(_slots(nz, nf, gc, gcp, cin), device=k.device)
        w[:, idx, :cout] = k.reshape(9, cin, cout).to(dtype)
        if dtype == torch.bfloat16:
            # (tap, kc, k half, k % 8, n // 8, n % 8) -> descriptor order
            w = w.reshape(9, kk // 16, 2, 8, nn_ // 8, 8) \
                .permute(0, 1, 4, 2, 5, 3)
        ws.append(w.reshape(-1))
        bp = torch.zeros(nn_, dtype=torch.float32, device=k.device)
        bp[:cout] = b
        bs.append(bp)
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous()


def pack_rdb(weights, biases, dtype) -> RdbWeights:
    """Pack one RDB from its fp32 parameters.

    ``weights`` are the five conv weights in the port's OIHW layout
    (``ResidualDenseBlock.conv{i}.weight``), ``biases`` the five biases.
    The kernels are cast to ``dtype`` and the biases kept fp32, so the
    parameters must be fp32: a module already cast to bf16 has
    bf16-rounded biases, which is not what ``exsr`` feeds its kernel.
    """
    weights, biases = list(weights), list(biases)
    if len(weights) != 5 or len(biases) != 5:
        raise ValueError('an RDB has five convs')
    if any(t.dtype != torch.float32 for t in weights + biases):
        raise ValueError('pack_rdb takes the fp32 parameters; the activation '
                         'dtype is the dtype argument')
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dtype must be fp32 or bf16, got {dtype}')
    with torch.no_grad():
        kernels = tuple(w.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
                        for w in weights)
        bias = tuple(b.detach().float().contiguous() for b in biases)
        gc, nf = kernels[0].shape[3], kernels[4].shape[3]
        nz = kernels[0].shape[2] - nf
        for i, k in enumerate(kernels):
            want = (3, 3, nz + nf + i * gc, gc if i < 4 else nf)
            if tuple(k.shape) != want:
                raise ValueError(f'conv{i} kernel is {tuple(k.shape)} HWIO, '
                                 f'expected {want}')
        packed, packed_bias = kernel_layout(kernels, bias, nf, gc, nz, dtype)
    return RdbWeights(kernels, bias, packed, packed_bias, nf, gc, nz)


def pack_rrdb(block, dtype) -> tuple:
    """Pack the three RDBs of one of the port's ``RRDB`` modules."""
    return tuple(
        pack_rdb([getattr(rdb_mod, f'conv{i}').weight for i in range(5)],
                 [getattr(rdb_mod, f'conv{i}').bias for i in range(5)], dtype)
        for rdb_mod in (block.rdb1, block.rdb2, block.rdb3))


def mul_in_dtype(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` rounded to x's dtype first, as JAX multiplies by
    a Python scalar (0.2 is 0.2001953125 in bf16); ``x * s`` in PyTorch
    would scale a bf16 tensor by the fp32 value."""
    return x * torch.tensor(s, dtype=x.dtype).item()


def rdb_plain(x, z, w: RdbWeights, x0=None):
    """Plain PyTorch version of :func:`rdb`, in the kernel's rounding order:
    fp32 convs on the dtype's values, each ``c_i`` rounded to the dtype,
    the inner residual rounded once, the outer one (``x0``) in the dtype."""
    feats = [z, x]
    for i in range(5):
        k = w.kernels[i].float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        inp = torch.cat(feats, -1).float()
        acc = to_nhwc(F.conv2d(to_nchw(inp), k, padding=1)) + w.biases[i]
        if i < 4:
            feats.append(F.leaky_relu(acc, 0.2).to(x.dtype))
    out = (acc * 0.2 + x.float()).to(x.dtype)
    if x0 is not None:
        out = mul_in_dtype(out, 0.2) + x0
    return out


def _check(x, z, w: RdbWeights, x0) -> None:
    if x.dim() != 4 or z.dim() != 4:
        raise ValueError('x and z must be NHWC [B, h, w, C]')
    if x.shape[:3] != z.shape[:3]:
        raise ValueError(f'x {tuple(x.shape)} and z {tuple(z.shape)} differ '
                         'in [B, h, w]')
    if x.shape[-1] != w.nf or z.shape[-1] != w.nz:
        raise ValueError(f'the weights take nf={w.nf}, nz={w.nz}; got x '
                         f'{tuple(x.shape)}, z {tuple(z.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dtype must be fp32 or bf16, got {x.dtype}')
    named = [('x', x), ('z', z)] + ([('x0', x0)] if x0 is not None else [])
    for name, t in named:
        if t.dtype != w.dtype:
            raise ValueError(f'{name} is {t.dtype}, the weights are packed '
                             f'for {w.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous NHWC')
        if t.device != w.device:
            raise ValueError(f'{name} is on {t.device}, the weights on '
                             f'{w.device}')
    if x0 is not None and x0.shape != x.shape:
        raise ValueError(f'x0 {tuple(x0.shape)} must match x '
                         f'{tuple(x.shape)}')


def require_kernel_widths(w: RdbWeights) -> None:
    """Raise ``NotImplementedError`` unless the CUDA kernel is built for
    these weights' widths: nf a multiple of 16 and 1 <= nz <= 16; in bf16
    also gc <= 32 (convs 0..3 write 16 or 32 padded outputs) and nf 16, 32
    or 64 (conv 4), the widths ``wgmma`` is instantiated for."""
    if w.nf % 16 or not 1 <= w.nz <= Z_SLOTS:
        raise NotImplementedError(
            f'the CUDA kernel takes nf a multiple of 16 and 1 <= nz <= '
            f'{Z_SLOTS}, got nf={w.nf} nz={w.nz}')
    if w.dtype == torch.bfloat16 and (w.gcp not in BF16_GC_WIDTHS
                                      or w.nf not in BF16_NF_WIDTHS):
        raise NotImplementedError(
            f'the bf16 CUDA kernel is built for gc <= {BF16_GC_WIDTHS[-1]} '
            f'and nf in {BF16_NF_WIDTHS}, got nf={w.nf} gc={w.gc}')


BF16_TILE = (8, 16)  # the bf16 kernel's output tile (rdb.cu, Tile)


def executed_flops_bf16(b: int, h: int, wd: int, nf: int, gc: int) -> int:
    """Flops the bf16 CUDA kernel executes on the tensor cores for one
    call, everything it recomputes or pads included: per output tile, conv
    i runs ceil(region pixels / 64) units of 64 pixels on the tile grown by
    4 - i pixels a side, over K_i = 16 + nf + i * gcp input slots (z padded
    to 16, gc to gcp) and N_i padded outputs, nine taps each."""
    th, tw = BF16_TILE
    gcp = -(-gc // 16) * 16
    tiles = b * -(-h // th) * -(-wd // tw)
    per_tile = 0
    for i in range(5):
        units = -(-(th + 8 - 2 * i) * (tw + 8 - 2 * i) // 64)
        per_tile += 2 * 9 * units * 64 * (Z_SLOTS + nf + i * gcp) \
            * (gcp if i < 4 else nf)
    return tiles * per_tile


def rdb(x, z, w: RdbWeights, x0=None):
    """One residual dense block; with ``x0``, also the outer RRDB residual
    ``out * dtype(0.2) + x0``.  A CPU tensor goes to :func:`rdb_plain`; a
    CUDA tensor launches the kernel (no gradient)."""
    _check(x, z, w, x0)
    if x.device.type == 'cpu':
        return rdb_plain(x, z, w, x0)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, z, x0)):
        raise NotImplementedError('rdb has no backward on CUDA')
    b, h, wd, nf = x.shape
    require_kernel_widths(w)
    is_bf16 = int(x.dtype == torch.bfloat16)
    # pixel stride in shared memory: bank-conflict padding (see rdb.cu)
    cs = Z_SLOTS + nf + 4 * w.gcp + (8 if is_bf16 else 1)
    lib = build.load('rdb', _SIGNATURES)
    smem = lib.exsr_rdb_smem(nf, w.gcp, cs, is_bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f'nf={nf} gc={w.gc} needs {smem} bytes of shared '
                         'memory, more than a block has')
    out = torch.empty_like(x)
    # cp.async and the bulk copies move 16-byte pieces
    if any(t.data_ptr() % 16 for t in (x, out, w.packed)):
        raise ValueError('x and the packed weights must be 16-byte aligned')
    err = lib.exsr_rdb(
        x.data_ptr(), z.data_ptr(), x0.data_ptr() if x0 is not None else None,
        out.data_ptr(), w.packed.data_ptr(), w.packed_bias.data_ptr(),
        b, h, wd, nf, w.nz, w.gcp, cs, is_bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, 'rdb')
    rdb.launches += 1
    return out


rdb.launches = 0


def rrdb_block(x, z, w3):
    """One RRDB: three :func:`rdb` launches, the outer residual fused into
    the third one's epilogue.  ``w3`` holds the three packed RDBs."""
    cur = rdb(x, z, w3[0])
    cur = rdb(cur, z, w3[1])
    return rdb(cur, z, w3[2], x0=x)


def rrdb_block_chained(x, z, w3):
    """One RRDB as three :func:`rdb` launches plus the outer residual as a
    separate elementwise op, as ``rrdb_block.py:178-184``."""
    cur = x
    for w in w3:
        cur = rdb(cur, z, w)
    return mul_in_dtype(cur, 0.2) + x


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_rdb': ([_P] * 6 + [_I] * 8 + [_P], _I),
    'exsr_rdb_smem': ([_I] * 4, ctypes.c_size_t),
}
