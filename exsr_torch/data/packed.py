"""Packed random-access image datasets: one flat blob of raw uint8 HWC
images and a JSON index beside it, read through a shared memory map.

The port's copy of the numpy half of ``exsr/data/packed.py``; the LMDB
reader is left out (``lmdb`` is not a dependency of the port).

  python -m exsr_torch.apps.scripts pack --input_dir D --out data.pack
  PackedImageDataset('data.pack') / PackedLRHRDataset('data.pack', 4)
"""
from __future__ import annotations

import json
import os

import numpy as np

from exsr_torch.data.datasets import augment, list_images
from exsr_torch.ops.resize import imresize
from exsr_torch.utils.color import modcrop


def pack_images(input_dir: str, out_path: str) -> int:
    """Write every image under ``input_dir`` (RGB, sorted as
    :func:`~exsr_torch.data.datasets.list_images` walks) into the blob
    ``out_path`` and its index ``out_path + '.json'``; returns the
    count."""
    from PIL import Image
    index = []
    offset = 0
    with open(out_path, 'wb') as blob:
        for path in list_images(input_dir):
            with Image.open(path) as im:
                arr = np.asarray(im.convert('RGB'), dtype=np.uint8)
            blob.write(np.ascontiguousarray(arr).tobytes())
            index.append({'name': os.path.basename(path),
                          'offset': offset, 'shape': list(arr.shape)})
            offset += arr.nbytes
    with open(out_path + '.json', 'w') as f:
        json.dump(index, f)
    return len(index)


class PackedImageDataset:
    """Random-access reader of a packed blob: ``read(i)`` gives image
    ``i`` as float32 HWC in [0, 1], ``name(i)`` its file name."""

    def __init__(self, pack_path: str):
        with open(pack_path + '.json') as f:
            self.index = json.load(f)
        self._mm = np.memmap(pack_path, dtype=np.uint8, mode='r')

    def __len__(self):
        return len(self.index)

    def read(self, i: int) -> np.ndarray:
        ent = self.index[i]
        h, w, c = ent['shape']
        start = ent['offset']
        arr = self._mm[start:start + h * w * c].reshape(h, w, c)
        return np.asarray(arr, dtype=np.float32) / 255.0

    def name(self, i: int) -> str:
        return self.index[i]['name']


class PackedLRHRDataset:
    """LR/HR pairs from a packed HR blob, the LR synthesized by
    ``imresize`` (``registry``'s kernel, bicubic by default): the packed
    counterpart of :class:`~exsr_torch.data.datasets.LRHRDataset`.  With
    ``train`` and ``patch_size``, an LR-aligned random crop and random
    flips and transpose, drawn from ``rng`` in ``exsr``'s order."""

    def __init__(self, pack_path: str, scale: int,
                 patch_size: int | None = None, train: bool = True,
                 use_flip: bool = True, use_rot: bool = True,
                 registry=None):
        self.packed = PackedImageDataset(pack_path)
        self.scale = scale
        self.patch_size = patch_size
        self.train = train
        self.use_flip = use_flip
        self.use_rot = use_rot
        self.registry = registry

    def __len__(self):
        return len(self.packed)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        hr = modcrop(self.packed.read(idx), self.scale)
        lr = imresize(hr, 1.0 / self.scale, registry=self.registry)
        if self.train and self.patch_size:
            s = self.scale
            lps = self.patch_size // s
            h, w = lr.shape[:2]
            y = int(rng.integers(0, h - lps + 1))
            x = int(rng.integers(0, w - lps + 1))
            lr = lr[y:y + lps, x:x + lps]
            hr = hr[y * s:(y + lps) * s, x * s:(x + lps) * s]
            hf = self.use_flip and rng.random() < 0.5
            vf = self.use_flip and rng.random() < 0.5
            rot = self.use_rot and rng.random() < 0.5
            lr, hr = augment([lr, hr], hf, vf, rot)
        return {'lr': lr.astype(np.float32), 'hr': hr.astype(np.float32),
                'path': self.packed.name(idx)}
