"""The CEM and the generator on height shards: ``exsr``'s ``spatial`` axis.

Under ``exsr``'s ``P('data', 'spatial', None, None)`` XLA splits the image
height over the ``spatial`` devices and inserts each conv's and CEM
filter's halo.  Here every operation on a shard is written out: exchange
the halo its taps need (:func:`exsr_torch.parallel.halo.halo_exchange`),
run the unsharded entry point on the extended rows, crop.  The entry
points clamp (CEM filters) or zero-pad (convs) at the edge of the tensor
they are given.  With a halo at least the operation's reach, the rows that
an inner edge makes wrong land in the part that is cropped; at a global
edge the tensor's edge is the global one and the entry point's own
padding is the unsharded operation's.  So each rank launches the same
kernels as one process does (``sepfilter_edge`` twice, ``sepfilter_down``
and ``sepfilter_up`` once per CEM, ``stage4`` or ``rdb`` 69 times per
full-width trunk) on its shard plus halo, and every kernel's autograd
Function composes with the exchange's adjoint.

:class:`Rows` is the layout of one sharded tensor's height: the shard
heights of the rank's spatial group.  Shards are equal, except under
``pre_pad``, where the top rank replicate-pads its top and the bottom
rank its bottom by the margins (interior sides get halos) and the output
is cropped the same way.  W is never sharded.

* :func:`downscale`, :func:`upscale`, :func:`conv_inv_hth`,
  :func:`enforce`: ``CEMFilters``' methods on shards.  HR halos are whole
  multiples of ``sf``, so every shard's first row keeps the polyphase
  phase of global row 0.  An even tap count along H (which grows the
  output by a row) raises.
* :func:`rrdbnet_apply_fast`: the grouped generator (``stage4``); one
  exchange of 5 rows before each residual-dense block covers its five
  convs (one per conv was 2.6-3.1x slower on the card, PERF.md).
  The Z resize needs no halo: at an integer factor each LR row's bilinear
  taps lie in its own ``sf`` rows of HR.
* :func:`rrdbnet_fused`: ``RRDBNet(fused_trunk=True)``'s forward, the
  ``rdb`` kernel on each block's rows plus 5, inference only.
* :func:`rrdbnet_module`: the canonical ``RRDBNet.forward`` that training
  differentiates, through the module's own parameters and cuDNN
  autograd, with one 5-row exchange per residual-dense block; the Z-less
  ``MSRResNet`` and ``SRResNet`` through :func:`msrresnet_module` and
  :func:`srresnet_module` (one 2-row exchange per residual block, one row
  for each other conv and for ``MSRResNet``'s bilinear skip).
* :func:`dncnn_module`: the JPEG trainers' DnCNN on block-row shards, one
  exchange of ``depth`` block rows a forward, its norms' statistics from
  the rank's own rows combined over the grid.
* :func:`cem_wrap`: ``exsr_torch.cem.cem.cem_wrap`` on shards; its
  result ``cem_apply(params, lr, z_hr, margins_lr, pre_pad, mesh,
  decompose=False)`` is the entry point.  A caller drives it as
  ``exsr``'s do: ``make_mesh``, ``ShardingRules.shard_batch``, the
  sharded forward, ``gather``; the SR trainer on a grid
  (:class:`exsr_torch.parallel.mesh.TrainGrid`) takes it with the mesh
  bound.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from exsr_torch.device import full_fp32
from exsr_torch.models.discriminators import combine_moments
from exsr_torch.models.dncnn import NORM_EPS
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.models.rrdb_fast import (_conv, _rdb_grouped, _subpixel,
                                         pack_grouped_params)
from exsr_torch.ops.filters import (bilinear_resize, nearest_upsample,
                                    to_nchw, to_nhwc)
from exsr_torch.ops.kernels.rrdb_block import mul_in_dtype, rdb
from exsr_torch.ops.kernels.sepfilter import sepfilter_up
from exsr_torch.parallel.halo import halo_exchange, received

RDB_HALO = 5  # a residual-dense block's convs, stage 4's included


@dataclasses.dataclass(frozen=True)
class Rows:
    """The heights of a sharded tensor's shards over the rank's spatial
    group, in rank order."""
    mesh: object
    heights: tuple

    @classmethod
    def equal(cls, mesh, h: int) -> 'Rows':
        return cls(mesh, (int(h),) * mesh.spatial)

    def scaled(self, f: int) -> 'Rows':
        return Rows(self.mesh, tuple(f * h for h in self.heights))

    def exchange(self, x, top: int, bottom: int | None = None) -> tuple:
        """``(x extended by its halos, rows above, rows below)``."""
        bottom = top if bottom is None else bottom
        ext = halo_exchange(x, top, bottom, self.mesh, self.heights)
        return (ext,) + received(self.heights, self.mesh.spatial_index,
                                 top, bottom)


def crop(x, top: int, bottom: int):
    """``x`` without its first ``top`` and last ``bottom`` rows."""
    return x[:, top:x.shape[1] - bottom]


def local(fn, x, rows: Rows, halo: int, scale: int = 1):
    """``fn`` (output rows ``scale`` times its input's) on the rank's
    shard: exchange ``halo`` rows, apply, crop."""
    ext, a, b = rows.exchange(x, halo)
    return crop(fn(ext), scale * a, scale * b)


# ---------------------------------------------------------------- the CEM
def _reach(w2d, what: str) -> int:
    """Rows a filter reads on each side; an even tap count raises."""
    k = int(w2d.shape[2])
    if k % 2 == 0:
        raise ValueError(f'{what}: {k} taps along H grow the output by a '
                         'row, which the height-sharded CEM does not '
                         'support (exsr\'s enforce fails on the shapes)')
    return k // 2


def _up_halo(filt) -> int:
    """LR rows whose ``sf`` stuffed HR rows cover the up filter's reach."""
    return -(-_reach(filt.w_up, 'upscale') // filt.sf)


def downscale(filt, x, rows: Rows):
    """``filt.downscale`` of HR shards; ``rows`` are the LR output's."""
    sf = filt.sf
    t = -(-_reach(filt.w_down, 'downscale') // sf)
    ext, a, b = rows.scaled(sf).exchange(x, sf * t)
    return crop(filt.downscale(ext), a // sf, b // sf)


def upscale(filt, x, rows: Rows):
    """``filt.upscale`` of LR shards with ``rows``."""
    return local(filt.upscale, x, rows, _up_halo(filt), filt.sf)


def conv_inv_hth(filt, x, rows: Rows):
    """``filt.conv_inv_hth`` of LR shards with ``rows``."""
    return local(filt.conv_inv_hth, x, rows, _reach(filt.w_inv_hth,
                                                    'inv_hTh'))


def enforce(filt, lr, generated, rows: Rows, decompose: bool = False):
    """``filt.enforce(lr, generated, decompose)`` on shards (``rows``: LR).

    As ``CEMFilters.enforce``: with a separable up filter and without
    ``decompose`` or ``sigmoid_range_limit``, one ``sepfilter_up``
    computes ``U(a) + (g - U(b))`` for ``a = inv_hTh * lr`` and ``b =
    inv_hTh * D g``; ``lr`` and ``D g`` go through one exchange, wide
    enough for both the inv_hTh filter and the up filter, and ``g``, which
    the combine only adds, takes zero rows in place of a halo.  Otherwise
    ``ortho + ns`` (with ``decompose`` the pair) from the sharded
    filters."""
    r_inv = _reach(filt.w_inv_hth, 'inv_hTh')
    t_up = _up_halo(filt)
    d = downscale(filt, generated, rows)
    if decompose or filt.w_up_1d is None or filt.sigmoid_range_limit:
        ortho = upscale(filt, conv_inv_hth(filt, lr, rows), rows)
        ns = generated - upscale(filt, conv_inv_hth(filt, d, rows), rows)
        if filt.sigmoid_range_limit:
            lo, hi = filt.input_range
            ns = torch.tanh(ns) * (hi - lo)
        return (ortho, ns) if decompose else ortho + ns
    c = lr.shape[-1]
    ext, a, b = rows.exchange(torch.cat([lr, d], -1), r_inv + t_up)
    ka, kb = min(t_up, a), min(t_up, b)
    inv_a = crop(filt.conv_inv_hth(ext[..., :c]), a - ka, b - kb)
    inv_b = crop(filt.conv_inv_hth(ext[..., c:]), a - ka, b - kb)
    sf = filt.sf
    g = F.pad(generated, (0, 0, 0, 0, sf * ka, sf * kb))
    out = sepfilter_up(inv_a.contiguous(), *filt.w_up_1d, sf, filt.pre,
                       b=inv_b.contiguous(), g=g.contiguous(),
                       adjoint=filt.adj_up)
    return crop(out, sf * ka, sf * kb)


# ------------------------------------------------------------ generators
def _z_lr(z_hr, h: int, w: int):
    """The trunk's Z: bilinear (half-pixel) at an integer factor reads only
    the HR rows of each LR row's own cell, so a shard needs no halo."""
    return None if z_hr is None else bilinear_resize(z_hr, h, w)


def _cat(z, x):
    return x if z is None else torch.cat([z, x], -1)


def rrdb_trunk_fast(packed, lr, z_hr, rows: Rows, *, dtype=torch.bfloat16):
    """``exsr_torch.models.rrdb_fast.rrdb_trunk_fast`` on LR shards: one
    5-row exchange before each residual-dense block."""
    trunk, rest = packed
    n, h, w, _ = lr.shape
    if dtype is not None:
        lr = lr.to(dtype)
        z_hr = z_hr.to(dtype) if z_hr is not None else None
    z_lr = _z_lr(z_hr, h, w)
    fc = rest['fea_conv']
    fea = local(lambda t: _conv(t, fc['weight'], fc['bias']),
                _cat(z_lr, lr), rows, 1)
    z_ext = None if z_lr is None else rows.exchange(z_lr, RDB_HALO)[0]

    def rdb_(cur, e):
        ext, a, b = rows.exchange(cur, RDB_HALO)
        return crop(_rdb_grouped(ext, z_ext, e), a, b)
    t = fea
    for bp in trunk:
        o = rdb_(t, bp['rdb1'])
        o = rdb_(o, bp['rdb2'])
        o = rdb_(o, bp['rdb3'])
        t = mul_in_dtype(o, 0.2) + t
    tc = rest['trunk_conv']
    return fea + local(lambda e: _conv(e, tc['weight'], tc['bias']),
                       _cat(z_lr, t), rows, 1)


def rrdb_tail_fast(packed, feats, z_hr, rows: Rows, *, upscale: int = 4,
                   out_dtype=torch.float32):
    """``exsr_torch.models.rrdb_fast.rrdb_tail_fast`` on shards (``rows``:
    LR): each upconv and HR conv with a one-row exchange."""
    _, rest = packed
    x = feats
    if z_hr is not None:
        z_hr = z_hr.to(x.dtype)
    n_up = 1 if upscale == 3 else int(np.log2(upscale))
    for i in range(n_up):
        uc = rest[f'upconv{i}']
        if upscale == 3:
            x = local(lambda t: _conv(nearest_upsample(t, 3), uc['weight'],
                                      uc['bias']), x, rows, 1, 3)
            rows = rows.scaled(3)
        else:
            x = local(lambda t: _subpixel(t, uc['wt'], uc['bias']), x, rows,
                      1, 2)
            rows = rows.scaled(2)
        x = F.leaky_relu(x, 0.2)
    for j in (0, 1):
        hc = rest[f'hr_conv{j}']
        x = local(lambda t: _conv(t, hc['weight'], hc['bias']),
                  _cat(z_hr, x), rows, 1)
        if j == 0:
            x = F.leaky_relu(x, 0.2)
    return x.to(out_dtype)


def rrdbnet_apply_fast(params, lr, z_hr, rows: Rows, *, upscale: int = 4,
                       dtype=torch.bfloat16, packed=None):
    """``exsr_torch.models.rrdb_fast.rrdbnet_apply_fast`` on shards
    (``rows``: LR)."""
    if packed is None:
        packed = pack_grouped_params(params, dtype=dtype)
    feats = rrdb_trunk_fast(packed, lr, z_hr, rows, dtype=dtype)
    return rrdb_tail_fast(packed, feats, z_hr, rows, upscale=upscale,
                          out_dtype=lr.dtype)


def _module(m, nz: int = 0):
    """An NCHW conv module (a ``ZConv`` when ``nz``: its Z leads the
    channels) as a function of NHWC ``[z | x]``."""
    if nz:
        return lambda t: to_nhwc(m(to_nchw(t[..., nz:]),
                                   to_nchw(t[..., :nz])))
    return lambda t: to_nhwc(m(to_nchw(t)))


def _rrdbnet(net, lr, z_hr, rows: Rows, trunk):
    """``RRDBNet``'s forward on shards (``rows``: LR) around ``trunk(fea,
    z_lr)``, which runs the blocks on the rank's rows: the first conv, the
    trunk conv, each upsampling stage and the HR convs with a one-row
    exchange each."""
    nz = net.latent_channels
    in_dtype = lr.dtype
    dtype = net.fea_conv.weight.dtype if net.dtype is None else net.dtype
    n, h, w, _ = lr.shape
    lr = lr.to(dtype)
    z_hr = None if z_hr is None else z_hr.to(dtype)
    z_lr = _z_lr(z_hr, h, w)
    fea = local(_module(net.fea_conv), _cat(z_lr, lr), rows, 1)
    x = fea + local(_module(net.trunk_conv, nz), _cat(z_lr, trunk(fea, z_lr)),
                    rows, 1)
    f = 3 if net.upscale == 3 else 2
    for i in range(net.n_up):
        up = _module(getattr(net, f'upconv{i}'))
        x = F.leaky_relu(local(lambda t: up(nearest_upsample(t, f)), x,
                               rows, 1, f), 0.2)
        rows = rows.scaled(f)
    x = F.leaky_relu(local(_module(net.hr_conv0, nz), _cat(z_hr, x), rows,
                           1), 0.2)
    x = local(_module(net.hr_conv1, nz), _cat(z_hr, x), rows, 1)
    return x.to(in_dtype)


def rrdbnet_fused(net, lr, z_hr, rows: Rows):
    """``RRDBNet(fused_trunk=True)``'s forward on shards (``rows``: LR):
    each block's three ``rdb`` launches with one 5-row exchange each, the
    block's input, extended once, as the third launch's residual.
    Inference only, as the kernel is."""
    if not net.fused_trunk:
        raise ValueError('rrdbnet_fused runs the fused trunk; the grouped '
                         'trunk is rrdbnet_apply_fast')
    dtype = net.fea_conv.weight.dtype if net.dtype is None else net.dtype

    def trunk(fea, z_lr):
        z_ext = rows.exchange(z_lr.contiguous(), RDB_HALO)[0].contiguous()

        def rdb_(cur, w, x0=None):
            ext, a, b = rows.exchange(cur, RDB_HALO)
            return ext, crop(rdb(ext.contiguous(), z_ext, w, x0=x0), a, b)
        t = fea
        for w3 in net._packed_trunk(dtype):
            x0, cur = rdb_(t, w3[0])
            cur = rdb_(cur, w3[1])[1]
            t = rdb_(cur, w3[2], x0.contiguous())[1]
        return t
    return _rrdbnet(net, lr, z_hr, rows, trunk)


def _res_blocks(net, x, rows: Rows):
    """The residual blocks of ``MSRResNet`` / ``SRResNet`` (``conv2(relu(
    conv1(x))) + x``) on shards: one 2-row exchange covers a block's two
    convs."""
    for i in range(net.nb):
        c1 = _module(getattr(net, f'rb{i}_conv1'))
        c2 = _module(getattr(net, f'rb{i}_conv2'))
        ext, a, b = rows.exchange(x, 2)
        x = crop(ext + c2(F.relu(c1(ext))), a, b)
    return x


def msrresnet_module(net, lr, rows: Rows):
    """``MSRResNet.forward`` on LR shards (``rows``): the first conv and
    each upconv (its pixel shuffle local) with a one-row exchange, the
    residual blocks with one 2-row exchange each, the HR convs with a
    one-row exchange each.  The half-pixel bilinear skip reads at most
    one LR row beyond each HR row's own (at x3 and x4), so it takes a
    one-row exchange of the input and clamps where the extended rows end:
    at the global edges, as one process does, and elsewhere in rows that
    are cropped."""
    from exsr_torch.models.classifiers import pixel_shuffle_nhwc
    f, sf, lr_rows = net.f, net.upscale, rows
    x = F.leaky_relu(local(_module(net.conv_first), lr, rows, 1), 0.1)
    x = _res_blocks(net, x, rows)
    for i in range(net.n_up):
        up = _module(getattr(net, f'upconv{i + 1}'))
        x = F.leaky_relu(local(lambda t: pixel_shuffle_nhwc(up(t), f), x,
                               rows, 1, f), 0.1)
        rows = rows.scaled(f)
    x = F.leaky_relu(local(_module(net.HRconv), x, rows, 1), 0.1)
    x = local(_module(net.conv_last), x, rows, 1)
    return x + local(lambda t: bilinear_resize(t, sf * t.shape[1],
                                               sf * t.shape[2]),
                     lr, lr_rows, 1, sf)


def srresnet_module(net, lr, rows: Rows):
    """``SRResNet.forward`` on LR shards (``rows``): each conv with a
    one-row exchange, the residual blocks with one 2-row exchange each,
    each nearest upsample local before its conv."""
    f = net.f
    fea = local(_module(net.fea_conv), lr, rows, 1)
    x = fea + local(_module(net.lr_conv), _res_blocks(net, fea, rows), rows,
                    1)
    for i in range(net.n_up):
        up = _module(getattr(net, f'upconv{i}'))
        x = F.relu(local(lambda t: up(nearest_upsample(t, f)), x, rows, 1, f))
        rows = rows.scaled(f)
    x = F.relu(local(_module(net.hr_conv0), x, rows, 1))
    return local(_module(net.hr_conv1), x, rows, 1)


def rrdbnet_module(net, lr, z_hr, rows: Rows):
    """The canonical ``RRDBNet.forward`` on shards (``rows``: LR), through
    the module's own parameters and cuDNN autograd: each residual-dense
    block on its input extended by one 5-row exchange (Z's extended
    once), the block's output cropped.  The generator training
    differentiates.  The Z-less ``MSRResNet`` and ``SRResNet`` (``z_hr``
    None) run :func:`msrresnet_module` and :func:`srresnet_module`; any
    other class raises."""
    from exsr_torch.models.classifiers import MSRResNet, SRResNet
    plain = {MSRResNet: msrresnet_module, SRResNet: srresnet_module}
    if type(net) in plain:
        if z_hr is not None:
            raise ValueError(f'{type(net).__name__} takes no Z')
        return plain[type(net)](net, lr, rows)
    if not isinstance(net, RRDBNet):
        raise ValueError(f'{type(net).__name__} has no height-sharded '
                         'forward: RRDBNet, MSRResNet and SRResNet train '
                         'on a spatial grid')
    if net.fused_trunk:
        raise ValueError('rrdbnet_module runs the module trunk; the fused '
                         'trunk is rrdbnet_fused (inference only)')

    def trunk(fea, z_lr):
        z_ext = None if z_lr is None else \
            to_nchw(rows.exchange(z_lr, RDB_HALO)[0])

        def rdb_(cur, block):
            ext, a, b = rows.exchange(cur, RDB_HALO)
            return crop(to_nhwc(block(to_nchw(ext), z_ext)), a, b)
        t = fea
        for blk in net.trunk:
            o = rdb_(rdb_(rdb_(t, blk.rdb1), blk.rdb2), blk.rdb3)
            t = mul_in_dtype(o, 0.2) + t
        return t
    return _rrdbnet(net, lr, z_hr, rows, trunk)


# ------------------------------------------------------------------ DnCNN
def _instance_norm(x, own: slice, mesh):
    """``dncnn._standardize(x, (2, 3))`` of NCHW row shards: each image's
    per-channel mean and variance from the rank's ``own`` rows, combined
    exactly over the spatial group (one gather)."""
    o = x[:, :, own]
    c, n = o.shape[1], o.shape[2] * o.shape[3]    # n equal on every rank
    var, mean = torch.var_mean(o, dim=(2, 3), correction=0)
    if mesh.spatial > 1:
        parts = mesh.spatial_dp.gather(torch.cat([mean, n * var], 1)[None],
                                       0)
        mean, var = combine_moments(parts[..., :c], parts[..., c:], n)
    return ((x - mean[..., None, None])
            / torch.sqrt(var[..., None, None] + NORM_EPS))


def dncnn_module(net, coeffs, z, rows: Rows, train: bool = False,
                 update_stats: bool | None = None):
    """``DnCNN.forward(coeffs, z, train, update_stats)`` on block-row
    shards (``rows``: the coefficients' heights, whole 8 x 8 blocks or
    16 x 16 cells of the image).

    One exchange of ``depth`` block rows (``depth * (k // 2)``) covers the
    conv stack: each conv zero-pads where the extended rows end, which is
    the global edge or a row that the next convs only spoil within the
    halo.  Z (per pixel, as in the MAP loop, or constant) rides in the
    same exchange.  The norms take their statistics from the rank's own
    rows and normalise the halo alike: batch norm over the module's
    ``dp`` (``TrainGrid.join(..., world=True)``: every rank of the grid),
    instance norm per image over the spatial group.  The output head,
    the chroma generator's low-frequency add included, is local to each
    block.  Shards must be equal (the trainers' alignment gives that)."""
    if update_stats is None:
        update_stats = train
    cfg, nz = net.cfg, net.nz
    ext, a, b = rows.exchange(coeffs if not nz else
                              torch.cat([z, coeffs], -1),
                              cfg.depth * (cfg.kernel_size // 2))
    own = slice(a, ext.shape[1] - b)
    if cfg.norm == 'instance':
        def norm(i, x):
            return _instance_norm(x, own, rows.mesh)
    else:
        def norm(i, x):
            return net.norm(i, x, train, update_stats, rows=own)
    x = net.convs(to_nchw(ext[..., nz:]), to_nchw(ext[..., :nz]) if nz
                  else None, norm)
    return net.head(x[:, :, own], coeffs)


# ------------------------------------------------------------ entry point
def _edge_pad(x, m: int, index: int, spatial: int):
    """Replicate padding of an H-shard: W by ``m`` on both sides, H by
    ``m`` at the global top (first shard) and bottom (last shard)."""
    top = m if index == 0 else 0
    bottom = m if index == spatial - 1 else 0
    return to_nhwc(F.pad(to_nchw(x), (m, m, top, bottom), mode='replicate'))


def cem_wrap(g_apply, cem_filters, upscale: int):
    """``exsr_torch.cem.cem.cem_wrap`` on height shards.

    ``g_apply(params, lr, z_hr, rows)`` is a sharded generator
    (:func:`rrdbnet_apply_fast`, :func:`rrdbnet_fused`,
    :func:`rrdbnet_module`).  Returns ``cem_apply(params, lr, z_hr,
    margins_lr, pre_pad, mesh, decompose=False)`` on the rank's shards of
    ``lr`` (``[n, h, W, 3]``) and ``z_hr`` (``[n, sf h, sf W, Cz]``, or
    None), which returns the rank's ``[n, sf h, sf W, 3]`` shard of the
    output (with ``decompose``, of the CEM's ``(low, high)`` pair).  The
    forward runs in full fp32 (TF32 off); a backward that the caller runs
    later sees the caller's flags, as the trainers' steps run theirs
    inside ``full_fp32()``."""

    @full_fp32()
    def cem_apply(params, lr, z_hr, margins_lr: int, pre_pad: bool, mesh,
                  decompose: bool = False):
        sf = upscale
        n, h, w, _ = lr.shape
        if z_hr is not None and tuple(z_hr.shape[:3]) != (n, sf * h,
                                                           sf * w):
            raise ValueError(f'z_hr shard {tuple(z_hr.shape)} is not the '
                             f'x{sf} of the lr shard {tuple(lr.shape)}')
        rows = Rows.equal(mesh, h)
        i, s = mesh.spatial_index, mesh.spatial
        m = margins_lr if pre_pad else 0
        if m > 0:
            lr = _edge_pad(lr, m, i, s)
            z_hr = _edge_pad(z_hr, sf * m, i, s) if z_hr is not None \
                else None
            rows = Rows(mesh, tuple(
                h + m * ((j == 0) + (j == s - 1)) for j in range(s)))
        generated = g_apply(params, lr, z_hr, rows)
        out = enforce(cem_filters, lr[..., -3:], generated, rows, decompose)
        if m > 0:
            mh = sf * m

            def unpad(o):
                return o[:, mh if i == 0 else 0:
                         o.shape[1] - (mh if i == s - 1 else 0), mh:-mh]
            out = tuple(map(unpad, out)) if decompose else unpad(out)
        return out

    return cem_apply
