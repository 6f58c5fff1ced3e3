"""KernelGAN: blind estimation of an image's downscaling kernel.

Counterpart of ``exsr/kernelgan/kernelgan.py`` (Bell-Kligler et al.):

* a deep-linear generator (bias-free convs of sizes ``G_STRUCTURE``, the
  last one stride 2) whose composition is the estimated kernel;
* a spectral-norm patch critic with a sigmoid map, judged by pixelwise L1
  to 0 and 1;
* the regularizers: similarity to bicubic downscaling, sum to one, the
  boundary penalty, centralization and L0.2 sparsity, weighted by the
  Learner's schedule (the bicubic weight divided by 100 every 200
  iterations once G is similar to bicubic, then centralization and
  sparsity switched on) and the learning rate divided by 10 every 750
  iterations;
* crops sampled by gradient magnitude, drawn with ``exsr``'s numpy stream
  (``default_rng(seed)``), so that both packages see the same crops;
* post-processing: negligible entries zeroed, the centre of mass shifted
  to the stride-2 convention, the sum renormalised.

``exsr`` runs all iterations as one compiled scan.  Here they are a host
loop of small launches in full fp32 (TF32 off); the schedule's latch and
weights live on the device and move by ``torch.where``, and the losses
are read once after the loop, so the loop never waits on the device.
The learning-rate factor depends on the iteration index only and stays
on the host.  Fresh weights follow ``exsr``'s initialisers (truncated
Xavier-normal for G; the critic's spectral-norm convs as
:class:`~exsr_torch.models.dncnn.SpectralNormConv`), drawn from a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.models.discriminators import BatchNorm, lecun_normal_
from exsr_torch.models.dncnn import SpectralNormConv
from exsr_torch.ops.filters import to_nchw, to_nhwc

G_STRUCTURE = (7, 5, 3, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class KernelGANConfig:
    input_crop_size: int = 64
    scale_factor: float = 0.5      # the downscaling factor G imitates
    g_chan: int = 64
    d_chan: int = 64
    g_kernel_size: int = 13
    d_n_layers: int = 7
    d_kernel_size: int = 7
    max_iters: int = 3000
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    beta1: float = 0.5
    n_filtering: int = 40
    # constraint weights and the Learner's schedule
    lambda_sum2one: float = 0.5
    lambda_bicubic: float = 5.0
    lambda_boundaries: float = 0.5
    lambda_centralized_end: float = 1.0
    lambda_sparse_end: float = 5.0

    @property
    def inv_scale(self) -> int:
        return int(1 / self.scale_factor)


def _xavier_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``xavier_normal``: a unit normal truncated to [-2, 2], std
    ``sqrt(2 / (fan_in + fan_out))``."""
    fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
    lecun_normal_(w, gen)
    w.mul_(np.sqrt(2.0 * fan_in / (fan_in + fan_out)))


class KGGenerator(nn.Module):
    """The deep-linear downscaling generator: NHWC ``[N, H, W, 1]`` (one
    colour channel per batch row) -> ``[N, H', W', 1]``."""

    def __init__(self, cfg: KernelGANConfig = KernelGANConfig(),
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        last = len(G_STRUCTURE) - 1
        in_ch = 1
        for i, k in enumerate(G_STRUCTURE):
            out_ch = 1 if i == last else cfg.g_chan
            conv = nn.Conv2d(in_ch, out_ch, k, bias=False,
                             stride=cfg.inv_scale if i == last else 1)
            with torch.no_grad():
                _xavier_normal_(conv.weight, gen)
            setattr(self, f'conv{i}', conv)
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.forward_nchw(to_nchw(x)))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(G_STRUCTURE)):
            x = getattr(self, f'conv{i}')(x)
        return x


class KGDiscriminator(nn.Module):
    """The spectral-norm fully-convolutional critic: NHWC ``[N, s, s, 1]``
    -> a sigmoid map ``[N, s - d_kernel_size + 1, ..., 1]``.  Batch norm
    (momentum 0.9, eps 1e-5) always normalises by the batch; the running
    statistics and spectral norm's ``u`` move only with
    ``update_stats``."""

    def __init__(self, cfg: KernelGANConfig = KernelGANConfig(),
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        c = cfg.d_chan
        self.first = SpectralNormConv(1, c, cfg.d_kernel_size, gen=gen)
        self.mids = list(range(1, cfg.d_n_layers - 1))
        for i in self.mids:
            setattr(self, f'mid{i}', SpectralNormConv(c, c, 1, gen=gen))
            setattr(self, f'bn{i}', BatchNorm(c, momentum=0.9, eps=1e-5))
        self.final = SpectralNormConv(c, 1, 1, gen=gen)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        return to_nhwc(self.forward_nchw(to_nchw(x), update_stats))

    def forward_nchw(self, x: torch.Tensor, update_stats: bool = False
                     ) -> torch.Tensor:
        x = self.first(x, update_stats)
        for i in self.mids:
            x = getattr(self, f'mid{i}')(x, update_stats)
            x = F.relu(getattr(self, f'bn{i}')(x, update_stats))
        return torch.sigmoid(self.final(x, update_stats))


def generator_kernel(g: KGGenerator) -> torch.Tensor:
    """The ``[k, k]`` kernel the deep-linear G composes to: a delta through
    the layers by correlation (the first padded by ``g_kernel_size - 1``,
    the rest VALID, all stride 1), flipped."""
    pad = g.cfg.g_kernel_size - 1
    k = g.conv0.weight.new_ones(1, 1, 1, 1)
    for i in range(len(G_STRUCTURE)):
        k = F.conv2d(k, getattr(g, f'conv{i}').weight,
                     padding=pad if i == 0 else 0)
    return torch.flip(k[0, 0], dims=(0, 1))


def _bicubic_k8() -> np.ndarray:
    """The fixed 8 x 8 stride-2 bicubic kernel: the outer product of the
    half-pel bicubic taps."""
    t = np.array([-0.0117187500, -0.0351562500, 0.1132812500, 0.4335937500])
    t1 = np.concatenate([t, t[::-1]])
    return np.outer(t1, t1)


BICUBIC_K8 = _bicubic_k8()


def gradient_prob_map(img: np.ndarray, crop_size: int) -> np.ndarray:
    """A probability over crop centres (flattened ``[H * W]``) weighted by
    the gradient magnitude of the grey image, zero where a crop would not
    fit (uniform there instead if the image is flat)."""
    from scipy.ndimage import convolve
    gray = img.mean(-1)
    gx = np.abs(convolve(gray, np.array([[1, -1]]), mode='nearest'))
    gy = np.abs(convolve(gray, np.array([[1], [-1]]), mode='nearest'))
    gmag = gx + gy
    h, w = gmag.shape
    pad = crop_size // 2
    mask = np.zeros_like(gmag)
    mask[pad:h - pad, pad:w - pad] = 1.0
    pm = gmag * mask
    s = pm.sum()
    if s <= 0:
        pm = mask
        s = pm.sum()
    return (pm / s).reshape(-1)


def penalty_mask(ks: int) -> np.ndarray:
    """The boundary penalty mask of a ``ks x ks`` kernel: 30 times one
    minus a normalised Gaussian, zero in the middle."""
    center = ks // 2 + ks % 2
    z = np.arange(-ks // 2 + 1, ks // 2 + 1)
    g1 = np.exp(-z ** 2 / (2 * ks ** 2)) / np.sqrt(2 * np.pi * ks ** 2)
    mask = np.outer(g1, g1)
    mask = 1 - mask / mask.max()
    margin = (ks - center) // 2 - 1
    if margin > 0:
        mask[margin:-margin, margin:-margin] = 0
    return 30.0 * mask


def learner_init(cfg: KernelGANConfig, device,
                 dtype=torch.float32) -> dict:
    """The schedule's state on ``device``: the similar-to-bicubic latch,
    its counter of consecutive hits, and the three weights it moves."""
    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return {'similar': torch.zeros((), dtype=torch.bool, device=device),
            'bic_cnt': torch.zeros((), dtype=torch.int32, device=device),
            'lam_bic': scalar(cfg.lambda_bicubic), 'lam_cent': scalar(0.0),
            'lam_sparse': scalar(0.0)}


def learner_update(cfg: KernelGANConfig, it: int, state: dict,
                   bic_loss: torch.Tensor) -> dict:
    """The Learner's update after iteration ``it``, on the device: G is
    similar to bicubic once the bicubic loss was below 0.4 twice in a
    row; from then on the bicubic weight is divided by 100 every 200
    iterations (down to 5e-6), and once it is below 5e-3 the
    centralization and sparsity weights take their final values."""
    similar, bic_cnt, lam_bic = (state['similar'], state['bic_cnt'],
                                 state['lam_bic'])
    hit = bic_loss < 0.4
    bic_cnt = torch.where(similar, bic_cnt, torch.where(hit, bic_cnt + 1, 0))
    similar = similar | (hit & (bic_cnt >= 2))
    if it % 200 == 0:
        lam_bic = torch.where(similar & (lam_bic > 5e-6),
                              torch.clamp(lam_bic / 100.0, min=5e-6),
                              lam_bic)
    insert = similar & (lam_bic < 5e-3)
    return {'similar': similar, 'bic_cnt': bic_cnt, 'lam_bic': lam_bic,
            'lam_cent': torch.where(insert, cfg.lambda_centralized_end,
                                    state['lam_cent']),
            'lam_sparse': torch.where(insert, cfg.lambda_sparse_end,
                                      state['lam_sparse'])}


class KernelGAN:
    """Per-image kernel estimation on ``device`` (CUDA unless ``'cpu'``).
    ``g`` and ``d`` hold the initial weights; every :meth:`estimate`
    starts from them, in their dtype (``float64`` gives a reference run).  After a call, ``losses`` holds the per-iteration
    ``(G loss, D loss, bicubic loss)`` and ``raw_kernel`` the composed
    kernel before post-processing."""

    def __init__(self, cfg: KernelGANConfig = KernelGANConfig(),
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._np_rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        self.g = KGGenerator(cfg, gen)
        self.d = KGDiscriminator(cfg, gen)
        self.losses = None
        self.raw_kernel = None

    # ----------------------------------------------------------------- data
    def sample_crops(self, image: np.ndarray):
        """``(G crops [N, s, s, 3], D crops [N, d, d, 3] with N(0, 1/255)
        noise, d)`` for ``N = max_iters``, float32."""
        cfg = self.cfg
        g_size = cfg.input_crop_size
        shave = sum(k - 1 for k in G_STRUCTURE)
        d_size = (g_size - shave + cfg.inv_scale - 1) // cfg.inv_scale
        pm_g = gradient_prob_map(image, g_size)
        pm_d = gradient_prob_map(image, d_size)
        h, w = image.shape[:2]

        def crops(pm, size, n):
            centers = self._np_rng.choice(len(pm), size=n, p=pm)
            rows = np.minimum(np.maximum(centers // w - size // 2, 0),
                              h - size)
            cols = np.minimum(np.maximum(centers % w - size // 2, 0),
                              w - size)
            rows -= rows % 2
            cols -= cols % 2
            return np.stack([image[r:r + size, c:c + size]
                             for r, c in zip(rows, cols)])

        n = cfg.max_iters
        g_crops = crops(pm_g, g_size, n)
        d_crops = crops(pm_d, d_size, n)
        d_crops = d_crops + self._np_rng.normal(0, 1 / 255.0, d_crops.shape)
        return (g_crops.astype(np.float32), d_crops.astype(np.float32),
                d_size)

    # ----------------------------------------------------------------- train
    @full_fp32()
    def estimate(self, image: np.ndarray) -> np.ndarray:
        """Run the estimation on one ``[H, W, 3]`` image in [0, 1]; returns
        the post-processed kernel, float64, summing to one."""
        cfg, dev = self.cfg, self.device
        dt = self.g.conv0.weight.dtype
        g_crops, d_crops, _ = self.sample_crops(image)
        # colour channels folded into the batch: [N, 3, 1, s, s]
        g_in_all = torch.from_numpy(g_crops).permute(0, 3, 1, 2)[:, :, None]
        d_in_all = torch.from_numpy(d_crops).permute(0, 3, 1, 2)[:, :, None]
        g_in_all, d_in_all = g_in_all.to(dev, dt), d_in_all.to(dev, dt)
        g = copy.deepcopy(self.g).to(dev)
        d = copy.deepcopy(self.d).to(dev)
        g_params, d_params = list(g.parameters()), list(d.parameters())
        g_opt = torch.optim.Adam(g_params, lr=cfg.g_lr,
                                 betas=(cfg.beta1, 0.999), eps=1e-8)
        d_opt = torch.optim.Adam(d_params, lr=cfg.d_lr,
                                 betas=(cfg.beta1, 0.999), eps=1e-8)
        ks, s = cfg.g_kernel_size, cfg.inv_scale
        mask = torch.tensor(penalty_mask(ks), dtype=dt, device=dev)
        idx = torch.arange(ks, dtype=dt, device=dev)
        wanted = ks // 2 + 0.5 * (s - ks % 2)
        bic_w = torch.tensor(BICUBIC_K8, dtype=dt, device=dev)[None, None]
        sched = learner_init(cfg, dev, dt)
        losses = torch.empty(cfg.max_iters, 3, dtype=dt, device=dev)
        for it in range(cfg.max_iters):
            lr_fac = float(np.float32(0.1) ** np.float32(it // 750))
            g_in, d_in = g_in_all[it], d_in_all[it]

            # ---- G step
            g_out = g.forward_nchw(g_in)
            gan = (d.forward_nchw(g_out) - 1.0).abs().mean()
            k = generator_kernel(g)
            down = F.conv2d(g_in, bic_w, stride=s)
            dh = (down.shape[2] - g_out.shape[2]) // 2
            dw = (down.shape[3] - g_out.shape[3]) // 2
            down = down[:, :, dh:dh + g_out.shape[2], dw:dw + g_out.shape[3]]
            bic = ((g_out - down) ** 2).mean()
            ksum = k.sum()
            com_r = (k.sum(1) @ idx) / ksum
            com_c = (k.sum(0) @ idx) / ksum
            cent = ((com_r - wanted) ** 2 + (com_c - wanted) ** 2) / 2
            # the epsilon bounds the sparsity gradient at entries that
            # reach zero exactly
            sparse = ((k.abs() + 1e-12) ** 0.2).mean()
            g_loss = gan + (sched['lam_bic'] * bic
                            + cfg.lambda_sum2one * (1.0 - ksum).abs()
                            + cfg.lambda_boundaries * (k * mask).abs().mean()
                            + sched['lam_cent'] * cent
                            + sched['lam_sparse'] * sparse)
            g_loss.backward(inputs=g_params)
            g_opt.param_groups[0]['lr'] = cfg.g_lr * lr_fac
            g_opt.step()
            g_opt.zero_grad(set_to_none=True)

            # ---- D step, on the updated G's output
            with torch.no_grad():
                fake = g.forward_nchw(g_in)
            pred_real = d.forward_nchw(d_in, update_stats=True)
            pred_fake = d.forward_nchw(fake, update_stats=True)
            d_loss = (pred_fake.abs().mean()
                      + (pred_real - 1.0).abs().mean()) * 0.5
            d_loss.backward(inputs=d_params)
            d_opt.param_groups[0]['lr'] = cfg.d_lr * lr_fac
            d_opt.step()
            d_opt.zero_grad(set_to_none=True)

            sched = learner_update(cfg, it, sched, bic.detach())
            losses[it] = torch.stack([g_loss.detach(), d_loss.detach(),
                                      bic.detach()])
        with torch.no_grad():
            k = generator_kernel(g).cpu().numpy()
        self.losses = tuple(losses.cpu().numpy().T)
        self.raw_kernel = k
        # in float64: the CEM rebuild checks the sum against float32's
        # epsilon, which a kernel normalised in float32 can miss
        return post_process_kernel(k.astype(np.float64), sf=s,
                                   n=cfg.n_filtering)


def zeroize_negligible(k: np.ndarray, n: int) -> np.ndarray:
    """Entries below 0.75 of the ``n + 1``-th largest zeroed (by a shift
    and a clip), the rest renormalised."""
    k_sorted = np.sort(k.flatten())
    k_n_min = 0.75 * k_sorted[-n - 1]
    filtered = np.clip(k - k_n_min, 0, 100)
    return filtered / filtered.sum()


def kernel_shift(kernel: np.ndarray, sf: int) -> np.ndarray:
    """The kernel padded and spline-shifted so that its centre of mass sits
    at ``shape // 2 + 0.5 (sf - shape % 2)``."""
    from scipy.ndimage import center_of_mass, shift
    com = np.array(center_of_mass(kernel))
    wanted = np.array(kernel.shape) // 2 + 0.5 * (
        np.array(sf) - (np.array(kernel.shape) % 2))
    vec = wanted - com
    pad = int(np.ceil(np.max(np.abs(vec)))) + 1
    return shift(np.pad(kernel, pad), vec)


def post_process_kernel(k: np.ndarray, sf: int, n: int = 40) -> np.ndarray:
    """:func:`zeroize_negligible`, :func:`kernel_shift`, then a
    renormalisation: the spline shift moves the sum slightly, and the CEM
    rebuild needs it at one."""
    k = kernel_shift(zeroize_negligible(k, n), sf=sf)
    return k / k.sum()


def aniso_gaussian_kernel(size: int, sig1: float, sig2: float,
                          theta: float, sf: int = 2) -> np.ndarray:
    """An anisotropic Gaussian downscaling kernel (sigmas ``sig1``,
    ``sig2``, rotated by ``theta``), centred at the stride-``sf``
    convention that :func:`kernel_shift` enforces."""
    c = size // 2 + 0.5 * (sf - size % 2)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    dd = np.stack([yy - c, xx - c], -1)
    r = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    cov = r @ np.diag([sig1 ** 2, sig2 ** 2]) @ r.T
    icov = np.linalg.inv(cov)
    k = np.exp(-0.5 * np.einsum('hwi,ij,hwj->hw', dd, icov, dd))
    return k / k.sum()


def kernel_moments(k: np.ndarray):
    """``(centre of mass, centred 2 x 2 covariance)`` of a kernel."""
    k = np.asarray(k, np.float64)
    k = k / k.sum()
    yy, xx = np.mgrid[:k.shape[0], :k.shape[1]].astype(np.float64)
    com = np.array([(k * yy).sum(), (k * xx).sum()])
    dy, dx = yy - com[0], xx - com[1]
    cov = np.array([[(k * dy * dy).sum(), (k * dy * dx).sum()],
                    [(k * dy * dx).sum(), (k * dx * dx).sum()]])
    return com, cov


def analytic_x4_kernel(k: np.ndarray) -> np.ndarray:
    """The x4 kernel composed from an estimated x2 kernel (the x2 kernel
    applied twice, the second at stride 2), cropped and normalised."""
    ks = k.shape[0]
    big = np.zeros((3 * ks - 2, 3 * ks - 2))
    for r in range(ks):
        for c in range(ks):
            big[2 * r:2 * r + ks, 2 * c:2 * c + ks] += k[r, c] * k
    crop = ks // 2
    big = big[crop:-crop, crop:-crop]
    return big / big.sum()


def estimate_sr_kernel(lr_image: np.ndarray, scale: int,
                       max_iters: int = 3000, device=None) -> np.ndarray:
    """The downscaling kernel of an ``[h, w, 3]`` LR image for an SR scale:
    KernelGAN's x2 estimate at the default configuration (``max_iters``
    iterations, seed 0), composed to x4 at scale 4."""
    k2 = KernelGAN(KernelGANConfig(max_iters=max_iters),
                   device=device).estimate(lr_image)
    return analytic_x4_kernel(k2) if scale == 4 else k2
