"""Image-folder datasets and the batch loader of the training and
evaluation CLIs.

The port's own copy of ``exsr/data/datasets.py`` without its LMDB half:
:func:`list_images`, :func:`read_img` (PIL, as ``exsr`` reads images),
:class:`LRHRDataset` (LR read from ``lr_root`` or synthesized from HR by
the port's ``imresize``; random LR-aligned crops and flip/rotate
augmentation when ``train`` and ``patch_size`` are set), :class:`LRDataset`,
:class:`JPEGDataset` (uncompressed Y or YCbCr crops in [0, 255] with a
quality factor each), and :class:`DataLoader`, the threaded, seeded batch
iterator.  Items are float32 HWC numpy arrays; batches stack them to NHWC.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from exsr_torch.ops.resize import KernelRegistry, imresize
from exsr_torch.utils.color import modcrop, rgb2ycbcr

IMG_EXTENSIONS = ('.png', '.jpg', '.jpeg', '.bmp', '.ppm', '.tif', '.tiff')


def list_images(root: str) -> list[str]:
    """The image files under ``root``, walked in sorted order."""
    if not os.path.isdir(root):
        raise NotADirectoryError(f'{root} is not a directory')
    paths = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(dirpath, f))
    if not paths:
        raise FileNotFoundError(f'{root} contains no images')
    return paths


def read_img(path: str) -> np.ndarray:
    """float32 HWC RGB in [0, 1]."""
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im.convert('RGB'), dtype=np.float32)
    return img / 255.0


def augment(imgs: Sequence[np.ndarray], hflip: bool, vflip: bool,
            rot90: bool) -> list[np.ndarray]:
    """The same flips and transpose applied to every image."""
    out = []
    for img in imgs:
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        out.append(np.ascontiguousarray(img))
    return out


@dataclasses.dataclass
class LRHRDataset:
    """Paired LR/HR images: HR cropped to a multiple of ``scale``, LR from
    ``lr_root`` (the same count of files) or, when None, ``imresize`` of
    the HR image by ``1 / scale`` (``registry``'s kernel, bicubic by
    default).  Decoded pairs are kept up to ``cache_bytes``."""
    hr_root: str
    scale: int
    lr_root: str | None = None
    patch_size: int | None = None       # HR patch (train) or None (eval)
    use_flip: bool = True
    use_rot: bool = True
    train: bool = True
    registry: KernelRegistry | None = None
    cache_bytes: int = 1 << 30

    def __post_init__(self):
        self.hr_paths = list_images(self.hr_root)
        self.lr_paths = list_images(self.lr_root) if self.lr_root else None
        if self.lr_paths and len(self.lr_paths) != len(self.hr_paths):
            raise ValueError(f'{len(self.lr_paths)} LR images for '
                             f'{len(self.hr_paths)} HR images')
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._cache_used = 0

    def __len__(self):
        return len(self.hr_paths)

    def _full_pair(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        hr = modcrop(read_img(self.hr_paths[idx]), self.scale)
        if self.lr_paths:
            lr = read_img(self.lr_paths[idx])
        else:
            lr = imresize(hr, 1.0 / self.scale, registry=self.registry)
        sz = hr.nbytes + lr.nbytes
        if self._cache_used + sz <= self.cache_bytes:
            self._cache[idx] = (hr, lr)
            self._cache_used += sz
        return hr, lr

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        hr, lr = self._full_pair(idx)
        if self.train and self.patch_size:
            ps = self.patch_size
            lps = ps // self.scale
            h, w = lr.shape[:2]
            if h < lps or w < lps:
                raise ValueError(f'image {self.hr_paths[idx]} is smaller '
                                 f'than the patch')
            y = int(rng.integers(0, h - lps + 1))
            x = int(rng.integers(0, w - lps + 1))
            lr = lr[y:y + lps, x:x + lps]
            hr = hr[y * self.scale:(y + lps) * self.scale,
                    x * self.scale:(x + lps) * self.scale]
            if self.use_flip or self.use_rot:
                hf = self.use_flip and rng.random() < 0.5
                vf = self.use_flip and rng.random() < 0.5
                rot = self.use_rot and rng.random() < 0.5
                lr, hr = augment([lr, hr], hf, vf, rot)
        return {'lr': lr.astype(np.float32), 'hr': hr.astype(np.float32),
                'path': self.hr_paths[idx]}


@dataclasses.dataclass
class LRDataset:
    """LR images without ground truth."""
    lr_root: str

    def __post_init__(self):
        self.lr_paths = list_images(self.lr_root)

    def __len__(self):
        return len(self.lr_paths)

    def __getitem__(self, idx: int, rng=None):
        return {'lr': read_img(self.lr_paths[idx]).astype(np.float32),
                'path': self.lr_paths[idx]}


@dataclasses.dataclass
class JPEGDataset:
    """Uncompressed crops and a JPEG quality factor per item.

    ``qf_spec`` is a list of ``(qf_or_range, probability)``, a range an
    inclusive ``(lo, hi)`` pair.  In training each item draws a spec by its
    probability, then a QF from it, and takes a random crop; in evaluation
    the QFs cycle through the specs' means by index and the crop is
    central.  A crop smaller than ``patch_size`` is edge-padded.
    ``uncomp`` is Y ``[ps, ps, 1]`` or, with ``chroma``, YCbCr
    ``[ps, ps, 3]``, in [0, 255].  ``min_image_size`` drops images whose
    shorter side is below it.  The same ``np.random.Generator`` state gives
    the crop and QF ``exsr``'s gives.
    """
    root: str
    patch_size: int = 256
    chroma: bool = False
    qf_spec: Sequence = ((10, 1.0),)
    train: bool = True
    min_image_size: int | None = None

    def __post_init__(self):
        self.paths = list_images(self.root)
        if self.min_image_size:
            from PIL import Image
            kept = []
            for p in self.paths:
                with Image.open(p) as im:
                    if min(im.size) >= self.min_image_size:
                        kept.append(p)
            self.paths = kept
        probs = np.array([p for _, p in self.qf_spec], dtype=np.float64)
        self._probs = probs / probs.sum()

    def __len__(self):
        return len(self.paths)

    def _sample_qf(self, idx: int, rng: np.random.Generator) -> int:
        if self.train:
            spec = self.qf_spec[rng.choice(len(self.qf_spec),
                                           p=self._probs)][0]
            if isinstance(spec, (tuple, list)):
                return int(rng.integers(spec[0], spec[1] + 1))
            return int(spec)
        vals = [int(np.mean(s)) if isinstance(s, (tuple, list)) else int(s)
                for s, _ in self.qf_spec]
        return vals[idx % len(vals)]

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        ycbcr = rgb2ycbcr(read_img(self.paths[idx]), only_y=not self.chroma)
        if ycbcr.ndim == 2:
            ycbcr = ycbcr[..., None]
        ps = self.patch_size
        h, w = ycbcr.shape[:2]
        if self.train:
            y = int(rng.integers(0, max(h - ps, 0) + 1))
            x = int(rng.integers(0, max(w - ps, 0) + 1))
        else:
            y, x = max(0, (h - ps) // 2), max(0, (w - ps) // 2)
        crop = ycbcr[y:y + ps, x:x + ps]
        if crop.shape[0] < ps or crop.shape[1] < ps:
            crop = np.pad(crop, ((0, ps - crop.shape[0]),
                                 (0, ps - crop.shape[1]), (0, 0)),
                          mode='edge')
        return {'uncomp': (255.0 * crop).astype(np.float32),
                'qf': np.int32(self._sample_qf(idx, rng)),
                'path': self.paths[idx]}


class DataLoader:
    """Threaded, seeded, prefetching batch iterator of NHWC numpy batches.

    Each batch is collated by one of ``num_threads`` threads with its own
    ``np.random.default_rng((seed, epoch, batch))``, so the batches do not
    depend on the threads' timing.  With ``shuffle`` the order is permuted
    per epoch (seed ``seed + epoch``); ``drop_last`` drops the last partial
    batch and refuses a dataset smaller than one batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 4, prefetch: int = 4,
                 drop_last: bool = True):
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f'dataset has {len(dataset)} items < batch_size '
                f'{batch_size}: with drop_last every epoch would be empty '
                '(the train loop would spin forever)')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """The batches of one epoch, in order."""
        indices = self._epoch_indices(epoch)
        n_batches = len(self)
        work: queue.Queue = queue.Queue()
        done: dict[int, dict] = {}
        cv = threading.Condition()
        for b in range(n_batches):
            work.put(b)

        def collate(batch_idx):
            rng = np.random.default_rng((self.seed, epoch, batch_idx))
            items = [self.dataset.__getitem__(int(i), rng=rng)
                     for i in indices[batch_idx * self.batch_size:
                                      (batch_idx + 1) * self.batch_size]]
            return {k: ([it[k] for it in items] if k == 'path'
                        else np.stack([it[k] for it in items]))
                    for k in items[0]}

        def worker():
            while True:
                try:
                    b = work.get_nowait()
                except queue.Empty:
                    return
                batch = collate(b)
                with cv:
                    done[b] = batch
                    cv.notify_all()

        for _ in range(self.num_threads):
            threading.Thread(target=worker, daemon=True).start()
        for b in range(n_batches):
            with cv:
                while b not in done:
                    cv.wait()
                batch = done.pop(b)
            yield batch

    def stream(self, start_epoch: int = 0) -> Iterator[dict]:
        """The batches of epoch after epoch, from ``start_epoch``: a
        background producer keeps up to ``prefetch`` of them ready across
        epoch boundaries (an epoch of a small dataset may be a single
        batch), with the same seeds and order as :meth:`epoch` calls."""
        out: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))

        def produce():
            e = start_epoch
            while True:
                for batch in self.epoch(e):
                    out.put(batch)
                e += 1

        threading.Thread(target=produce, daemon=True).start()
        while True:
            yield out.get()
