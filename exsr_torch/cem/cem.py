"""CEM, the Consistency Enforcing Module, in PyTorch.

Counterpart of ``exsr/cem/cem.py``.  The CEM splits an SR network's output
into the component orthogonal to the downsampling kernel's null space,
computed from the LR input alone (``ortho = U (inv_hTh * y)``), and the
null-space component taken from the network (``ns = g - U (inv_hTh * D g)``),
so that ``D(ortho + ns) == y`` up to the filter-inversion error.  U is
consistent upscaling, D consistent downscaling.

Setup (kernel synthesis, inv_hTh inversion, margin probing) runs once on
the host in float64 (:mod:`exsr_torch.ops.resize`,
:mod:`exsr_torch.ops.inv_hth`).  The device chain is fp32 NHWC.  Every
separable filter runs through the hand-written kernels of
:mod:`exsr_torch.ops.kernels.sepfilter`: the inv_hTh filter as
``sepfilter_edge``, the downscale as ``sepfilter_down``, the upscale as
``sepfilter_up``, and the combine ``ortho + ns`` as one ``sepfilter_up`` in
its combine mode.  A non-separable estimated kernel runs as a plain 2-D
depthwise ``F.conv2d``.  The chain is differentiable, as the Z-edit engine
needs: each filter's backward is its adjoint, applied by the
``sepfilter_taps`` kernel on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from scipy.signal import convolve2d

from exsr_torch.device import resolve_device
from exsr_torch.ops import filters as F
from exsr_torch.ops import resize as R
from exsr_torch.ops.inv_hth import (compute_inv_hth,
                                    invalid_margin_size_downscale)
from exsr_torch.ops.kernels.sepfilter import (AdjointTables, sepfilter_down,
                                              sepfilter_edge, sepfilter_up)


@dataclasses.dataclass(frozen=True)
class CEMConf:
    """CEM configuration (``exsr/cem/cem.py:35``)."""
    scale_factor: int
    filter_perturbation_limit: float = 0.999
    desired_inv_hth_energy_portion: float = 1 - 1e-6
    lower_magnitude_bound: float = 0.01
    sigmoid_range_limit: bool = False
    input_range: tuple[float, float] = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class CEM:
    """Analytic CEM state: filters and margins for one (scale, kernel)."""
    conf: CEMConf
    ds_kernel: np.ndarray               # h (float64, sums to 1)
    inv_hth: np.ndarray                 # inverse of aliased (h*h^T)
    ds_kernel_invalidity_half_size_lr: int
    inv_hth_invalidity_half_size: int
    invalidity_margins_lr: int
    invalidity_margins_hr: int

    @classmethod
    def create(cls, conf: CEMConf, upscale_kernel: np.ndarray | str | None
               = None, registry: R.KernelRegistry | None = None) -> 'CEM':
        """Build the CEM for a scale factor and an optional estimated
        kernel.  An estimated downscaling kernel (ndarray, e.g. from
        KernelGAN) raises the magnitude bound to 0.1 for stability;
        ``'blurry_cubic_<sigma>'`` blurs the bicubic kernel."""
        sf = int(conf.scale_factor)
        registry = registry or R.KernelRegistry()
        lower_bound = conf.lower_magnitude_bound
        if isinstance(upscale_kernel, np.ndarray):
            registry.set_estimated(sf, upscale_kernel)
            lower_bound = max(lower_bound, 0.1)
        elif isinstance(upscale_kernel, str) and \
                upscale_kernel.startswith('blurry_cubic_'):
            registry.set_blurry_cubic(
                sf, float(upscale_kernel[len('blurry_cubic_'):]))
        ds_kernel = R.downscale_kernel(sf, registry)
        ds_margin = invalid_margin_size_downscale(
            sf, conf.filter_perturbation_limit, registry)
        inv_hth, inv_margin = compute_inv_hth(
            ds_kernel, sf,
            lower_magnitude_bound=lower_bound,
            desired_energy_portion=conf.desired_inv_hth_energy_portion,
            filter_perturbation_limit=conf.filter_perturbation_limit)
        margins_lr = 2 * ds_margin + inv_margin
        return cls(conf=conf, ds_kernel=ds_kernel, inv_hth=inv_hth,
                   ds_kernel_invalidity_half_size_lr=ds_margin,
                   inv_hth_invalidity_half_size=inv_margin,
                   invalidity_margins_lr=margins_lr,
                   invalidity_margins_hr=sf * margins_lr)

    # ---------------------------------------------------------------- device
    def device_filters(self, channels: int = 3, device=None
                       ) -> 'CEMFilters':
        """The fp32 filter set on ``device`` (CUDA unless ``'cpu'``).

        Each 2-D filter that factors as a rank-1 outer product (all of them
        for bicubic) runs as column then row taps through the separable
        kernel, with the :class:`AdjointTables` of its backward built
        from the numpy taps; others keep the 2-D path.
        """
        device = resolve_device(device)
        sf = int(self.conf.scale_factor)
        pre, _post = R.calc_strides((0, 0), sf)

        def build(kernel2d):
            w2d = F.depthwise_weights(kernel2d, channels, device=device)
            fac = F.separable_factors(kernel2d)
            if fac is None:
                return w2d, None, None
            taps = tuple(torch.as_tensor(t, dtype=torch.float32,
                                         device=device) for t in fac)
            # the adjoint's tables from the fp32 taps the forward uses
            fp32 = (t.astype(np.float32) for t in fac)
            return w2d, taps, AdjointTables(*fp32)

        w_down, w_down_1d, adj_down = build(np.rot90(self.ds_kernel, 2)
                                            .copy())
        w_up, w_up_1d, adj_up = build(self.ds_kernel * sf ** 2)
        w_inv, w_inv_1d, adj_inv = build(self.inv_hth)
        return CEMFilters(
            sf=sf, pre=(int(pre[0]), int(pre[1])),
            w_down=w_down, w_up=w_up, w_inv_hth=w_inv,
            w_down_1d=w_down_1d, w_up_1d=w_up_1d, w_inv_hth_1d=w_inv_1d,
            adj_down=adj_down, adj_up=adj_up, adj_inv_hth=adj_inv,
            sigmoid_range_limit=self.conf.sigmoid_range_limit,
            input_range=self.conf.input_range)

    # ------------------------------------------------------------- host-side
    def loss_mask(self, patch_size: int) -> np.ndarray:
        """[1, patch, patch, 1] mask zeroing the CEM-invalid boundary."""
        m = np.zeros((1, patch_size, patch_size, 1), dtype=np.float32)
        t = self.invalidity_margins_hr
        m[:, t:-t, t:-t, :] = 1.0
        if m.mean() <= 0:
            raise ValueError('the loss mask nullifies the whole patch')
        return m

    def project_2_ortho_2_ns(self, hr: np.ndarray) -> np.ndarray:
        """Project an HR image onto the subspace orthogonal to the null
        space: downscale, then DT-satisfying upscale."""
        sf = int(self.conf.scale_factor)
        lr = R.imresize(hr, 1.0 / sf)
        if lr.ndim < hr.ndim:
            lr = lr.reshape(list(np.array(hr.shape[:2]) // sf) +
                            ([hr.shape[2]] if hr.ndim > 2 else []))
        return self.dt_satisfying_upscale(lr)

    def dt_satisfying_upscale(self, lr: np.ndarray) -> np.ndarray:
        """Upscale an LR image so that downsampling reproduces it."""
        sf = int(self.conf.scale_factor)
        margin = (2 * self.inv_hth_invalidity_half_size +
                  self.ds_kernel_invalidity_half_size_lr)
        pad = ((margin, margin), (margin, margin)) + \
            (((0, 0),) if lr.ndim > 2 else ())
        lr_p = np.pad(lr, pad, mode='edge')
        if lr_p.ndim == 2:
            lr_p = lr_p[..., None]
        filtered = np.stack([convolve2d(lr_p[:, :, c], self.inv_hth,
                                        mode='same')
                             for c in range(lr_p.shape[-1])], -1)
        hr = R.imresize(filtered, float(sf))
        m = sf * margin
        return hr[m:-m, m:-m, :]

    def enforce_dt_on_image_pair(self, lr_source: np.ndarray,
                                 hr_input: np.ndarray) -> np.ndarray:
        """Make an arbitrary HR edit consistent with an LR source, which
        may be LR- or HR-sized."""
        sf = int(self.conf.scale_factor)
        same = [lr_source.shape[i] == hr_input.shape[i]
                for i in range(lr_source.ndim)]
        lr_scale = [sf * lr_source.shape[i] == hr_input.shape[i]
                    for i in range(lr_source.ndim)]
        if not np.all(np.logical_or(same, lr_scale)):
            raise ValueError('lr_source must be LR- or HR-sized')
        if len(same) == 2:
            lr_source = lr_source[..., None]
            hr_input = hr_input[..., None]
        if np.any(lr_scale):
            low_freq = self.dt_satisfying_upscale(lr_source)
        else:
            low_freq = self.project_2_ortho_2_ns(lr_source)
        return hr_input - self.project_2_ortho_2_ns(hr_input) + low_freq


@dataclasses.dataclass(frozen=True)
class CEMFilters:
    """Device-resident constant filters: 2-D depthwise weights
    ``[C, 1, kh, kw]`` and, for separable filters, fp32 ``(col, row)`` 1-D
    taps and the tables of their adjoints."""
    sf: int
    pre: tuple[int, int]
    w_down: torch.Tensor
    w_up: torch.Tensor
    w_inv_hth: torch.Tensor
    w_down_1d: tuple[torch.Tensor, torch.Tensor] | None = None
    w_up_1d: tuple[torch.Tensor, torch.Tensor] | None = None
    w_inv_hth_1d: tuple[torch.Tensor, torch.Tensor] | None = None
    adj_down: AdjointTables | None = None
    adj_up: AdjointTables | None = None
    adj_inv_hth: AdjointTables | None = None
    sigmoid_range_limit: bool = False
    input_range: tuple[float, float] = (0.0, 1.0)

    def downscale(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_down_1d is not None:
            return sepfilter_down(x.contiguous(), *self.w_down_1d, self.sf,
                                  self.pre, adjoint=self.adj_down)
        return F.aliased_subsample(F.filter_replicate_same(x, self.w_down),
                                   self.sf, self.pre)

    def upscale(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_up_1d is not None:
            return sepfilter_up(x.contiguous(), *self.w_up_1d, self.sf,
                                self.pre, adjoint=self.adj_up)
        return F.filter_replicate_same(F.zero_stuff(x, self.sf, self.pre),
                                       self.w_up)

    def conv_inv_hth(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_inv_hth_1d is not None:
            return sepfilter_edge(x.contiguous(), *self.w_inv_hth_1d,
                                  adjoint=self.adj_inv_hth)
        return F.filter_replicate_same(x, self.w_inv_hth)

    def ortho_component(self, lr: torch.Tensor) -> torch.Tensor:
        """U (inv_hTh * y): the LR-determined low-frequency component."""
        return self.upscale(self.conv_inv_hth(lr))

    def project_ortho(self, hr: torch.Tensor) -> torch.Tensor:
        """Projection of an HR image onto the orthogonal(-to-null) space."""
        return self.ortho_component(self.downscale(hr))

    def ns_component(self, generated: torch.Tensor) -> torch.Tensor:
        """Null-space component of a generated HR image."""
        ns = generated - self.project_ortho(generated)
        if self.sigmoid_range_limit:
            lo, hi = self.input_range
            ns = torch.tanh(ns) * (hi - lo)
        return ns

    def enforce(self, lr: torch.Tensor, generated: torch.Tensor,
                decompose: bool = False):
        """The CEM combine ``ortho(lr) + ns(generated)``; with
        ``decompose`` the pair ``(ortho, ns)``.  Without either option and
        with a separable upscale filter, both upscales and the combine run
        as one :func:`sepfilter_up`: ``U(a) + (g - U(b))``, the same
        operations in the same order."""
        if not (decompose or self.sigmoid_range_limit) and \
                self.w_up_1d is not None:
            a = self.conv_inv_hth(lr).contiguous()
            b = self.conv_inv_hth(self.downscale(generated)).contiguous()
            return sepfilter_up(a, *self.w_up_1d, self.sf, self.pre, b=b,
                                g=generated.contiguous(),
                                adjoint=self.adj_up)
        ortho = self.ortho_component(lr)
        ns = self.ns_component(generated)
        if decompose:
            return ortho, ns
        return ortho + ns


def cem_wrap(g_apply: Callable, cem_filters: CEMFilters, upscale: int):
    """Wrap a generator in the CEM.

    ``g_apply(params, lr, z_hr)`` takes the NHWC LR input and the latent
    map in HR pixels (``[N, H, W, Cz]``) or None and returns the HR image.
    Returns ``apply(params, lr, z_hr, margins_lr, pre_pad, decompose)``;
    ``pre_pad`` replicate-pads the inputs by the invalidity margins and
    crops the output back (``exsr/cem/cem.py:251``).
    """

    def apply(params, lr: torch.Tensor, z_hr: torch.Tensor | None,
              margins_lr: int, pre_pad: bool, decompose: bool = False):
        sf = upscale
        if pre_pad and margins_lr > 0:
            m = margins_lr
            lr_in = F.replicate_pad(lr, m)
            z_in = F.replicate_pad(z_hr, sf * m) if z_hr is not None else None
        else:
            lr_in, z_in = lr, z_hr
        generated = g_apply(params, lr_in, z_in)
        out = cem_filters.enforce(lr_in[..., -3:], generated,
                                  decompose=decompose)
        if pre_pad and margins_lr > 0:
            mh = sf * margins_lr
            if decompose:
                out = tuple(o[:, mh:-mh, mh:-mh, :] for o in out)
            else:
                out = out[:, mh:-mh, mh:-mh, :]
        return out

    return apply


def consistent_downsample(x: torch.Tensor, cem_filters: CEMFilters,
                          margin_lr: int) -> torch.Tensor:
    """Downsample HR images with replicate pre-padding against border
    artifacts.  ``margin_lr`` should be
    ``cem.ds_kernel_invalidity_half_size_lr``."""
    sf = cem_filters.sf
    padded = F.replicate_pad(x, sf * margin_lr)
    down = cem_filters.downscale(padded)
    if margin_lr > 0:
        down = down[:, margin_lr:-margin_lr, margin_lr:-margin_lr, :]
    return down
