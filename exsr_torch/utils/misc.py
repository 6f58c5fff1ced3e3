"""Host helpers of the edit session and the CLIs: the periodicity tool's
autocorrelation and line sampling, the scribble tool's masks, the JPEG
imprint tool's resizes, Z maps made from images or stored as PNG,
scheduled loss weights, the training loop's one-transfer metric fetch, and
its cooperative SIGINT stop.

The port's own copies of ``varying_weight``, ``im_to_z_input``,
``z_map_to_png``, ``png_to_z_map`` (``exsr/utils/misc.py:31-82``),
``overlap_normalized_autocorr``, ``first_autocorr_peak``,
``bilinear_sample_line``, ``resize_scribble_image``,
``resize_categorical_image``, ``scribble_mask_components``
(``exsr/utils/misc.py:98-187``), and of ``fetch_scalars``,
``stage_scalars``, ``read_scalars`` and ``install_sigint_stop``
(``exsr/utils/misc.py:189-283``) over torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import uniform_filter, zoom
from scipy.signal import convolve2d


def varying_weight(step, steps, values, legitimate_range=None):
    """A piecewise-linear scheduled loss weight: ``values`` at ``steps``,
    interpolated, optionally clipped to ``legitimate_range``."""
    w = float(np.interp(step, np.asarray(steps, np.float64),
                        np.asarray(values, np.float64)))
    if legitimate_range is not None:
        w = float(np.clip(w, *legitimate_range))
    return w


def im_to_z_input(image: np.ndarray, size_hw: tuple[int, int],
                  z_range: float = 1.0,
                  single_channel: bool = False) -> np.ndarray:
    """An image as a Z input map ``[H, W, C]`` float32: resized to
    ``size_hw`` (bilinear), min-max normalized into ``[-z_range,
    z_range]``, then smoothed by a 5 x 5 edge-padded box filter."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1 and not single_channel:
        img = np.repeat(img, 3, axis=-1)
    factors = (size_hw[0] / img.shape[0], size_hw[1] / img.shape[1], 1)
    img = zoom(img, factors, order=1)[:size_hw[0], :size_hw[1]]
    if single_channel:
        img = img.mean(2, keepdims=True)
    # a tolerance, not > 0: the bilinear zoom leaves ~1e-18 of noise on a
    # constant image, which min-max normalization would blow up
    if img.max() - img.min() > 1e-9:
        img = ((img - img.min()) / (img.max() - img.min())
               * 2 * z_range - z_range)
        img = uniform_filter(img, size=(5, 5, 1), mode='nearest')
    else:
        img = img * 2 * z_range - z_range
    return img.astype(np.float32)


def z_map_to_png(z: np.ndarray) -> np.ndarray:
    """A [-1, 1] 3-channel Z map as a uint8 image."""
    if z.ndim != 3 or z.shape[-1] != 3:
        raise ValueError(f'expected an [H, W, 3] Z map, got {z.shape}')
    return np.round((np.clip(z, -1, 1) + 1.0) * 127.5).astype(np.uint8)


def png_to_z_map(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`z_map_to_png`, to within 1/127.5."""
    return img.astype(np.float32) / 127.5 - 1.0


def overlap_normalized_autocorr(x: np.ndarray) -> np.ndarray:
    """Mean-subtracted full autocorrelation divided by the per-lag overlap
    count, positive lags only."""
    x = np.asarray(x, np.float64) - np.mean(x)
    result = np.correlate(x, x, mode='full')
    normalizer = np.arange(1, x.size + 1)
    normalizer = np.concatenate([normalizer, normalizer[-2::-1]])
    return (result / normalizer)[x.size:]


def first_autocorr_peak(ac: np.ndarray, min_value: float = 1e-3):
    """Index of the first local autocorrelation maximum above
    ``min_value``, or None."""
    for i in range(1, len(ac) - 1):
        if ac[i] > ac[i - 1] and ac[i] > ac[i + 1] and ac[i] > min_value:
            return i
    return None


def bilinear_sample_line(img: np.ndarray, y0: float, x0: float,
                         y1: float, x1: float, n: int) -> np.ndarray:
    """Sample a grayscale image bilinearly at n points along a segment."""
    ys = np.linspace(y0, y1, n)
    xs = np.linspace(x0, x1, n)
    h, w = img.shape
    yc = np.clip(ys, 0, h - 1)
    xc = np.clip(xs, 0, w - 1)
    iy = np.clip(np.floor(yc).astype(int), 0, h - 2)
    ix = np.clip(np.floor(xc).astype(int), 0, w - 2)
    fy, fx = yc - iy, xc - ix
    return ((1 - fy) * (1 - fx) * img[iy, ix]
            + (1 - fy) * fx * img[iy, ix + 1]
            + fy * (1 - fx) * img[iy + 1, ix]
            + fy * fx * img[iy + 1, ix + 1])


def scribble_mask_components(scribble_mask: np.ndarray, mask: np.ndarray,
                             brightness: float):
    """The scribble target's pieces: the 3x3-smeared brightness multiplier
    (classes 2 and 3), the L1 mask over drawn-stroke classes 1-3, and one
    mask per TV-region id (> 3)."""
    mult = np.ones_like(scribble_mask, np.float32)
    mult += brightness * (scribble_mask == 2).astype(np.float32)
    mult -= brightness * (scribble_mask == 3).astype(np.float32)
    k = np.ones((3, 3)) / 9.0
    mult = convolve2d(np.pad(mult, 1, mode='edge'), k, 'valid')
    l1_mask = (mask * ((scribble_mask > 0) & (scribble_mask < 4))) \
        .astype(np.float32)
    tv_ids = [i for i in np.unique(scribble_mask * mask) if i > 3]
    tv_masks = [(mask * (scribble_mask == i)).astype(np.float32)
                for i in tv_ids]
    return mult, l1_mask, tv_masks


def _linear_resize_weights(in_size: int, out_size: int,
                           antialias: bool) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of a triangle-kernel resize,
    in ``jax.image.resize``'s arithmetic: sample ``o`` sits at
    ``(o + 0.5) / scale - 0.5``; with ``antialias`` a downscale widens the
    kernel by ``1 / scale``; each column is normalised to sum 1, and a
    sample outside the input gets no weight."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0)) if antialias else f32(1.0)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _linear_resize(image: np.ndarray, dsize, antialias: bool) -> np.ndarray:
    """``jax.image.resize(image, dsize + image.shape[2:], 'linear',
    antialias=antialias)`` in numpy float32: a resized axis is contracted
    with its weights, an axis of unchanged size is left alone."""
    out = np.asarray(image, np.float32)
    for axis, n in enumerate(tuple(dsize)):
        m = out.shape[axis]
        if m == n:
            continue
        w = _linear_resize_weights(m, n, antialias)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def resize_scribble_image(image: np.ndarray, dsize) -> np.ndarray:
    """Continuous-valued resize to ``dsize = (h, w)``: antialiased linear
    resampling, as ``exsr``'s ``jax.image.resize(..., 'linear',
    antialias=True)`` (a triangle kernel widened by the scale when
    downsizing), not ``F.interpolate``'s bilinear antialias."""
    if tuple(image.shape[:2]) == tuple(dsize):
        return image
    return _linear_resize(image, dsize, antialias=True)


def resize_categorical_image(image: np.ndarray, dsize,
                             inclusive: bool = False) -> np.ndarray:
    """Categorical (mask or label) resize: each category's indicator is
    resized linearly without antialiasing and thresholded (> 0.5, or
    > 0 with ``inclusive``, which marks every partly touched pixel and
    skips category 0); lower categories overrule higher ones where they
    overlap."""
    if not np.issubdtype(image.dtype, np.integer):
        raise TypeError(f'categorical resize of a {image.dtype} image')
    if tuple(image.shape[:2]) == tuple(dsize):
        return image
    out = np.zeros(tuple(dsize), image.dtype)
    cats = sorted(set(image.reshape(-1).tolist()))[::-1]
    if inclusive:
        cats = [c for c in cats if c != 0]
    for c in cats:
        r = _linear_resize((image == c).astype(np.float32), dsize,
                           antialias=False)
        m = r > (0.0 if inclusive else 0.5)
        out = np.where(m, np.asarray(c, image.dtype), out)
    return out


def _scalar_keys(metrics) -> list:
    return [k for k, v in metrics.items() if np.ndim(v) == 0
            and not isinstance(v, (str, bytes))]


def _stack(metrics, keys) -> torch.Tensor:
    device = next((metrics[k].device for k in keys
                   if isinstance(metrics[k], torch.Tensor)), 'cpu')
    return torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=device).reshape(())
                        for k in keys])


def fetch_scalars(metrics) -> dict:
    """A dict's scalar entries (0-d tensors or numbers) as host floats,
    read from the device in one transfer; other entries pass through."""
    keys = _scalar_keys(metrics)
    if not keys:
        return dict(metrics)
    out = dict(metrics)
    out.update(zip(keys, _stack(metrics, keys).cpu().tolist()))
    return out


def stage_scalars(metrics):
    """Start the one-transfer fetch of a dict's scalar entries: they are
    stacked on the device and copied, without waiting, into pinned host
    memory behind a CUDA event, so that a later :func:`read_scalars`
    overlaps the copy with whatever the caller enqueues in between (the
    training loop reads step t after enqueueing step t + 1)."""
    keys = _scalar_keys(metrics)
    staged = None
    if keys:
        stacked = _stack(metrics, keys)
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype,
                               pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            staged = (host, event)
        else:
            staged = (stacked, None)
    rest = {k: v for k, v in metrics.items() if k not in set(keys)}
    return keys, staged, rest


def read_scalars(staged) -> dict:
    """A :func:`stage_scalars` handle as host floats (waits for its
    copy)."""
    keys, held, rest = staged
    out = dict(rest)
    if keys:
        values, event = held
        if event is not None:
            event.synchronize()
        out.update(zip(keys, values.tolist()))
    return out


def install_sigint_stop():
    """Turn the first SIGINT into a cooperative stop request.

    A training CLI stopped at a deadline with ``timeout --signal=INT``
    would otherwise unwind past its final forced checkpoint.  The handler
    records the request and puts the previous handler back, so a second
    SIGINT still interrupts at once.  Returns a callable that the loop
    polls; its ``restore()`` puts the previous handler back, for callers
    in the same process (tests, pipelines).
    """
    import signal

    flag = {'stop': False}
    prev = signal.getsignal(signal.SIGINT)
    if prev is None:  # installed outside Python: put Python's default back
        prev = signal.default_int_handler

    def _handler(signum, frame):
        flag['stop'] = True
        signal.signal(signal.SIGINT, prev)
        print('SIGINT: stopping at the next step boundary '
              '(send again to hard-interrupt)', flush=True)

    class _Stop:
        def __call__(self):
            return flag['stop']

        @staticmethod
        def restore():
            signal.signal(signal.SIGINT, prev)

    signal.signal(signal.SIGINT, _handler)
    return _Stop()
