"""Objective library for Z-space editing.

Counterpart of ``exsr/zopt/objectives.py``.  Each function here returns
``loss_fn(out, z) -> scalar`` where ``out`` is the model output batch
``[B, H, W, C]`` in [0, 1], closed over device constants (masks, desired
images, patch indices) prepared once per edit.  The objectives
that need another network (``vgg_objective``, ``adversarial_objective``,
the ``digit_*`` functions) take it as a torch callable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from exsr_torch.ops.filters import to_nchw, to_nhwc
from exsr_torch.zopt.patches import masked_patch_std, \
    patch_indices_from_mask

PATCH_SIZE_4_STD = 7
STD_CHANGE_FACTOR = 1.05


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative at 0: +1 (``jnp.abs`` passes the
    gradient where x >= 0); ``torch.abs`` passes 0 there.  An L1 term whose
    difference is exactly 0, such as an output equal to its desired value
    at the start of an edit, then moves as it does in ``exsr``."""
    return torch.where(x >= 0, x, -x)


def tv_loss(image: torch.Tensor) -> torch.Tensor:
    """Per-image anisotropic TV ``[B]``."""
    dx = abs_(image[:, :, :-1, :] - image[:, :, 1:, :]).mean((1, 2, 3))
    dy = abs_(image[:, :-1, :, :] - image[:, 1:, :, :]).mean((1, 2, 3))
    return dx + dy


def translated(image: torch.Tensor, point) -> torch.Tensor:
    """Crop so the result is the image translated by (dy, dx); NHWC."""
    dy, dx = int(point[0]), int(point[1])
    ys = slice(dy if dy > 0 else None, dy if dy < 0 else None)
    xs = slice(dx if dx > 0 else None, dx if dx < 0 else None)
    return image[:, ys, xs, :]


@dataclasses.dataclass
class STDHelpers:
    """Masked-STD machinery shared by several objectives."""
    image_mask: torch.Tensor | None        # [H, W]
    local: bool
    indices: torch.Tensor | None = None    # [P, k*k]
    non_covered: torch.Tensor | None = None

    @classmethod
    def create(cls, image_mask: np.ndarray | None, local: bool,
               overlap: float = 1.0, device=None) -> 'STDHelpers':
        def dev(a):
            return None if a is None else torch.as_tensor(a, device=device)
        if not local or image_mask is None:
            return cls(dev(image_mask), local=False)
        idx, non_cov = patch_indices_from_mask(
            image_mask, PATCH_SIZE_4_STD, patches_overlap=overlap,
            return_non_covered=True)
        return cls(dev(image_mask), True, dev(idx), dev(non_cov))

    def __call__(self, out: torch.Tensor) -> torch.Tensor:
        """``[B, num_stats]``: per-image masked STDs."""
        if self.local:
            return masked_patch_std(out.mean(-1), self.indices,
                                    self.non_covered)
        masked = out * self.image_mask[None, :, :, None] \
            if self.image_mask is not None else out
        return torch.std(masked.reshape(out.shape[0], -1), dim=1,
                         correction=1)[:, None]


def negated(loss):
    """Sign-flipped objective: the 'max_' distance modes maximize the
    wrapped distance."""
    def f(out, z):
        return -loss(out, z)
    return f


def l1_to_desired(desired: torch.Tensor, loss_mask: torch.Tensor | None):
    """'l1': masked L1 to a desired image."""
    def loss_fn(out, z):
        if loss_mask is None:
            return abs_(out - desired).mean()
        m = loss_mask[None, :, :, None]
        return abs_(out * m - desired * m).mean()
    return loss_fn


def scribble(desired: torch.Tensor, l1_mask: torch.Tensor,
             tv_masks: list[torch.Tensor]):
    """'scribble': L1 on drawn strokes plus 8-neighbour local TV per region
    id."""
    points = [np.array(p) for p in [(-1, -1), (-1, 0), (0, -1), (1, -1)]]

    def loss_fn(out, z):
        m = l1_mask[None, :, :, None]
        loss = abs_(out * m - desired * m).mean()
        for tvm in tv_masks:
            tvm4 = tvm[None, :, :, None]
            for p in points:
                cur_mask = translated(tvm4, p) * translated(tvm4, -p)
                diff = translated(out, p) - translated(out, -p)
                loss = loss + (cur_mask * abs_(diff)).mean()
        return loss
    return loss_fn


def std_objective(helpers: STDHelpers, mode: str,
                  desired_std: torch.Tensor | None = None):
    """'max_STD' / 'min_STD' / 'STD_increase' / 'STD_decrease'."""
    def loss_fn(out, z):
        stds = helpers(out)
        if mode in ('STD_increase', 'STD_decrease'):
            loss = ((stds - desired_std) ** 2).mean()
        else:
            loss = stds.mean()
        return -loss if mode == 'max_STD' else loss
    return loss_fn


def magnitude_objective(desired_patches: torch.Tensor,
                        indices: torch.Tensor):
    """'Mag': match patches to STD-modified versions of the initial
    patches."""
    def loss_fn(out, z):
        gray = out.mean(-1).reshape(out.shape[0], -1)
        patches = gray[:, indices.long()]                 # [B, P, k*k]
        return ((patches - desired_patches) ** 2).mean((1, 2)).mean()
    return loss_fn


def tv_objective(helpers: STDHelpers, initial_std: torch.Tensor,
                 std_weight: float = 100.0):
    """'TV': minimize masked TV while keeping the initial STD."""
    mask = helpers.image_mask

    def loss_fn(out, z):
        std_term = std_weight * ((helpers(out) - initial_std) ** 2).mean()
        return std_term + tv_loss(out * mask[None, :, :, None]).mean()
    return loss_fn


def periodicity_objective(points: list, image_mask: torch.Tensor,
                          helpers: STDHelpers,
                          initial_std: torch.Tensor | None,
                          desired_std: torch.Tensor | None = None,
                          std_weight: float = 20.0):
    """'periodicity' (integer translations): the image should repeat at
    the given period vectors inside the mask; 'Plus' targets an increased
    STD instead of the initial one."""
    mask4 = image_mask[None, :, :, None]
    target_std = desired_std if desired_std is not None else initial_std

    def loss_fn(out, z):
        loss = std_weight * ((helpers(out) - target_std) ** 2).mean()
        for p in points:
            cur_mask = translated(mask4, p) * translated(mask4, -p)
            diff = translated(out, p) - translated(out, -p)
            loss = loss + (cur_mask * abs_(diff)).mean()
        return loss
    return loss_fn


def periodicity_grids(points, image_size, device=None):
    """Sampling grids for non-integer periods: per period vector, two
    pixel-coordinate grids (the +p/2 and -p/2 shifted crops), fp32."""
    grids = []
    h, w = image_size
    for point in points:
        pair = []
        for sign in (1, -1):
            cur = sign * np.asarray(point, dtype=np.float64)
            rngs = []
            for axis, size in ((0, h), (1, w)):
                t = cur[axis]
                lo = t if t > 0 else 0
                hi = size + t if t < 0 else size
                num = size - int(np.ceil(max(abs(0 - lo), abs(size - hi))))
                rngs.append(np.linspace(lo, hi, num))
            yy, xx = np.meshgrid(rngs[0], rngs[1], indexing='ij')
            pair.append(tuple(torch.as_tensor(g, dtype=torch.float32,
                                              device=device)
                              for g in (yy, xx)))
        grids.append(pair)
    return grids


def map_coordinates_linear(img: torch.Tensor, yy: torch.Tensor,
                           xx: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(img, [yy, xx], order=1,
    mode='nearest')`` on the two leading axes of ``img`` ``[H, W, ...]``:
    bilinear weights, neighbour indices clamped to the image."""
    h, w = img.shape[:2]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.long(), x0.long()
    ys = (y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1))
    xs = (x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1))
    extra = (None,) * (img.dim() - 2)
    out = None
    for yi, wy in zip(ys, (wy0, wy1)):
        for xi, wx in zip(xs, (wx0, wx1)):
            term = (wy * wx)[(...,) + extra] * img[yi, xi]
            out = term if out is None else out + term
    return out


def periodicity_nonint_objective(grids, image_mask: torch.Tensor,
                                 helpers: STDHelpers,
                                 initial_std: torch.Tensor | None,
                                 desired_std: torch.Tensor | None = None,
                                 std_weight: float = 20.0):
    """Non-integer periodicity by bilinear resampling."""
    target_std = desired_std if desired_std is not None else initial_std

    def loss_fn(out, z):
        loss = std_weight * ((helpers(out) - target_std) ** 2).mean()
        chw = out.permute(1, 2, 0, 3)  # [H, W, B, C]
        for (yy0, xx0), (yy1, xx1) in grids:
            m0 = map_coordinates_linear(image_mask, yy0, xx0)
            m1 = map_coordinates_linear(image_mask, yy1, xx1)
            hh = min(m0.shape[0], m1.shape[0])
            ww = min(m0.shape[1], m1.shape[1])
            cur_mask = m0[:hh, :ww] * m1[:hh, :ww]
            a = map_coordinates_linear(chw, yy0, xx0)[:hh, :ww]
            b = map_coordinates_linear(chw, yy1, xx1)[:hh, :ww]
            diffs = abs_(a - b).permute(2, 0, 1, 3)      # [B, hh, ww, C]
            loss = loss + (cur_mask[None, :, :, None] * diffs).mean()
        return loss
    return loss_fn


def vgg_objective(vgg_apply: Callable, desired_features: torch.Tensor):
    """'VGG': L1 feature match to a desired image."""
    def loss_fn(out, z):
        return abs_(vgg_apply(out) - desired_features).mean()
    return loss_fn


def adversarial_objective(d_apply: Callable):
    """'Adversarial': fool the critic (-mean(D))."""
    def loss_fn(out, z):
        return -d_apply(out).mean()
    return loss_fn


def diversity_objective(mode: str, image_mask: torch.Tensor | None,
                        helpers: STDHelpers | None = None,
                        initial_std: torch.Tensor | None = None,
                        initial_image: torch.Tensor | None = None,
                        rmse_weight: float = 0.0,
                        feature_fn: Callable | None = None,
                        std_weight: float = 1e3):
    """'random_l1' / 'random_VGG' (+'limited'): maximize the smallest
    pairwise distance across the batch of alternatives; 'limited'
    subtracts an RMSE leash to the current image."""
    use_vgg = feature_fn is not None

    def loss_fn(out, z):
        data = feature_fn(out) if use_vgg else out
        diffs = abs_(data[None] - data[:, None])            # [B, B, ...]
        eye = torch.eye(data.shape[0], dtype=data.dtype, device=data.device)
        eye = eye.reshape(eye.shape + (1,) * (diffs.dim() - 2))
        z_loss = torch.min(diffs + eye, dim=0).values         # [B, ...]
        if 'limited' in mode and initial_image is not None:
            z_loss = z_loss - rmse_weight * abs_(data - initial_image)
        if image_mask is not None and not use_vgg:
            z_loss = z_loss * image_mask[None, :, :, None]
        loss = -z_loss.mean()
        if 'local' in mode and helpers is not None:
            loss = loss + std_weight * (
                (helpers(out) - initial_std) ** 2).mean()
        return loss
    return loss_fn


def brightness_objective(desired: torch.Tensor, loss_mask: torch.Tensor):
    """Brightness edit: the l1 objective on a desired image whose HSV value
    was scaled beforehand."""
    return l1_to_desired(desired, loss_mask)


def desired_svd_objective(reference_min: torch.Tensor,
                          reference_max: torch.Tensor,
                          target_z3: torch.Tensor,
                          image_mask: torch.Tensor,
                          noise_std: float = 1.0 / 255.0):
    """'desired_SVD': drive the masked structure-tensor statistics toward
    the Z that the SVD sliders encode.  ``reference_min`` and
    ``reference_max`` are the model's outputs at Z = -1 and Z = +1 over
    the same region."""
    from exsr_torch.ops.structure_tensor import image_gradients
    mask = image_mask[:-1, :-1]  # gradient maps lose one row and column
    msum = mask.sum()

    def masked_moments(img4):
        ix, iy = image_gradients(img4)
        mom = torch.stack([ix * ix, iy * iy, ix * iy], 0).mean(-1)
        return (mom * mask[None, None]).sum((2, 3)) / msum   # [3, B]

    ref_min = masked_moments(reference_min)[:, 0]
    ref_max = masked_moments(reference_max)[:, 0]
    normalizer = torch.sqrt(torch.prod(
        (ref_min[:2] + ref_max[:2]) / 2.0)) + noise_std
    ref_min = ref_min / normalizer
    ref_max = ref_max / normalizer
    tz = target_z3.reshape(-1)

    def loss_fn(out, z):
        measured = masked_moments(out) / normalizer
        target = tz / 2.0 * (ref_max - ref_min) + (ref_max + ref_min) / 2.0
        return abs_(measured - target[:, None]).mean()
    return loss_fn


def digit_views_transform(mask_bounds: tuple,
                          multiview: tuple[int, int] = (1, 3),
                          classifier_size: int = 54) -> Callable:
    """Multi-view crop, zoom and translate transform feeding the SVHN
    classifier: crop to the mask bounds, build zoom and translation views
    resized (bilinear, antialiased) to the classifier input with edge
    padding, normalized to [-1, 1]; a one-channel input is repeated to
    three."""
    y0, x0, y1, x1 = mask_bounds
    ch, cw = y1 - y0 + 1, x1 - x0 + 1
    n_zoom, n_trans = multiview
    if n_trans % 2 == 0:
        n_trans += 1
    views = []
    seen = set()
    for extra_zoom in range(n_zoom + 1):
        rf = (classifier_size - extra_zoom) / ch
        rw = int(np.round(rf * cw))
        req = classifier_size - rw
        for left in np.linspace(0, req, n_trans + 2)[1:-1]:
            pad_l = int(np.round(left))
            pad_t = int(np.round(np.ceil(extra_zoom / 2)))
            key = (pad_l, pad_t, rf)
            if key in seen:
                continue
            seen.add(key)
            views.append((rf, pad_l, req - pad_l, pad_t,
                          extra_zoom - pad_t))

    def transform(out):
        crop = out[:, y0:y1 + 1, x0:x1 + 1, :]
        if crop.shape[-1] == 1:
            crop = crop.expand(-1, -1, -1, 3)
        stacked = []
        for rf, pl_, pr_, pt_, pb_ in views:
            rh = int(np.round(rf * ch))
            rw = int(np.round(rf * cw))
            v = F.interpolate(to_nchw(crop), size=(rh, rw), mode='bilinear',
                              align_corners=False, antialias=True)
            v = F.pad(v, (pl_, pr_, pt_, pb_), mode='replicate')
            stacked.append(to_nhwc(v))
        return (torch.cat(stacked, 0) - 0.5) / 0.5
    return transform


def digit_score(classifier_apply: Callable, transform: Callable,
                out, digit: int) -> tuple[int, float]:
    """``(num_digits, prob)``: the argmax of the mean length-head logits
    and the mean softmax probability of ``digit`` over the views."""
    with torch.no_grad():
        heads = classifier_apply(transform(torch.as_tensor(out)))
    length_logits, d1 = heads[0], heads[1]
    num = int(torch.argmax(length_logits.mean(0)))
    prob = float(torch.softmax(d1, -1)[:, digit].mean())
    return num, prob


def _digit_loss(heads, digit) -> torch.Tensor:
    length_logits, d1 = heads[0], heads[1]
    n = d1.shape[0]
    labels = torch.as_tensor(digit, device=d1.device).long().expand(n)
    ones = torch.ones(n, dtype=torch.long, device=d1.device)
    return F.cross_entropy(d1, labels) + F.cross_entropy(length_logits, ones)


def digit_objective_traced(classifier_apply: Callable, transform: Callable):
    """:func:`digit_objective` with the target label passed in
    ``args['digit']``, so one objective serves all ten digits."""
    def loss_fn(out, z, args):
        return _digit_loss(classifier_apply(transform(out)), args['digit'])
    return loss_fn


def digit_objective(classifier_apply: Callable, mask_bounds: tuple,
                    digit: int, multiview: tuple[int, int] = (1, 3),
                    classifier_size: int = 54):
    """'digit': make the masked region classify as an SVHN digit, by the
    cross-entropy of (digit, length 1) over the views of
    :func:`digit_views_transform`.  ``classifier_apply(x) ->
    (length_logits, d1, ...)`` with x in [-1, 1]."""
    transform = digit_views_transform(mask_bounds, multiview,
                                      classifier_size)

    def loss_fn(out, z):
        return _digit_loss(classifier_apply(transform(out)), digit)
    return loss_fn


def non_local_constraint(initial_output: torch.Tensor,
                         constraining_mask: torch.Tensor, weight: float):
    """Penalty holding the image fixed outside the edit mask."""
    m = constraining_mask[None, :, :, None]

    def penalty(out):
        return weight * abs_(out * m - initial_output * m).mean()
    return penalty


def with_constraint(loss_fn: Callable, penalty: Callable):
    def wrapped(out, z):
        return loss_fn(out, z) + penalty(out)
    return wrapped
