"""The DCT-domain JPEG codec of explorable JPEG decoding.

Counterpart of ``exsr/jpeg/codec.py``, channels-last: coefficient maps are
``[N, H/bs, W/bs, bs*bs]``.

* The standard luma and chroma quantisation tables, scaled by the libjpeg
  quality-factor convention per batch row.  The scaling runs in float32,
  as ``exsr``'s: ``round(f32(factor) * f32(Q / 100))`` then a clip to
  [1, 255], with ``round`` half to even.  A float64 scaling rounds some
  ties the other way.
* Blocks, the -128 level shift, the orthonormal 2-D DCT
  (:mod:`exsr_torch.ops.dct`), division by the table and rounding.
* Chroma mode on 16 x 16 blocks with edge-padded tables; chroma
  downsampling is modelled by wiping the coefficients outside the
  low-frequency 8 x 8 quadrant.
* :func:`consistency_clamp`, the quantisation-bin clamp (the JPEG
  analogue of the CEM).

QF and table arguments may be numbers, arrays or tensors; they are taken
to the device of the image or coefficients they scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exsr_torch.ops.dct import dct_to_image, image_to_dct

# standard JPEG quantisation tables (ITU T.81 Annex K)
LUMA_Q_TABLE = np.array((
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 36, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99)), dtype=np.float64)

CHROMA_Q_TABLE = np.array((
    (17, 18, 24, 47, 99, 99, 99, 99),
    (18, 21, 26, 66, 99, 99, 99, 99),
    (24, 26, 56, 99, 99, 99, 99, 99),
    (47, 66, 99, 99, 99, 99, 99, 99),
    (99, 99, 99, 99, 99, 99, 99, 99),
    (99, 99, 99, 99, 99, 99, 99, 99),
    (99, 99, 99, 99, 99, 99, 99, 99),
    (99, 99, 99, 99, 99, 99, 99, 99)), dtype=np.float64)

ZIGZAG_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def zigzag_decode_q_table(flat: np.ndarray) -> np.ndarray:
    """64 zigzag-ordered values (as a JPEG file stores them) -> the 8 x 8
    table in natural order."""
    table = np.zeros(64, flat.dtype)
    table[ZIGZAG_ORDER] = flat
    return table.reshape(8, 8)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def qf_to_factor(qf, device=None) -> torch.Tensor:
    """libjpeg's quality-factor scaling, in float32: ``5000 / qf`` below 50,
    else ``200 - 2 qf``."""
    qf = _f32(qf, device)
    # a tensor numerator: ``5000.0 / qf`` is ``qf.reciprocal() * 5000`` in
    # PyTorch, which rounds twice and moves some table entries by one
    return torch.where(qf < 50, torch.full_like(qf, 5000.0) / qf,
                       200.0 - 2.0 * qf)


def scaled_q_table(qf, base_table: np.ndarray, device=None) -> torch.Tensor:
    """``[B]`` QFs -> ``[B, 1, 1, bs*bs]`` absolute quantisation steps,
    ``clip(round(factor * Q / 100), 1, 255)`` in float32."""
    factor = qf_to_factor(qf, device).reshape(-1, 1)
    base = _f32((base_table.reshape(-1) / 100.0).astype(np.float32),
                factor.device)
    q = torch.clamp(torch.round(factor * base[None, :]), 1.0, 255.0)
    return q[:, None, None, :]


def pad_q_table(base: np.ndarray, bs: int) -> np.ndarray:
    """Edge-pad an 8 x 8 table to ``bs x bs``."""
    return np.pad(base, ((0, bs - 8), (0, bs - 8)), mode='edge')


@dataclasses.dataclass(frozen=True)
class JPEGCodec:
    """Luma (``bs=8``) or chroma-mode (``bs=16``, three-channel) codec."""
    chroma_mode: bool = False
    block_size: int = 8

    def q_tables(self, qf, device=None):
        """The luma table, or in chroma mode the (luma, chroma) pair of
        padded tables, for each QF of ``qf``."""
        if not self.chroma_mode:
            return scaled_q_table(qf, LUMA_Q_TABLE, device)
        bs = self.block_size
        return (scaled_q_table(qf, pad_q_table(LUMA_Q_TABLE, bs), device),
                scaled_q_table(qf, pad_q_table(CHROMA_Q_TABLE, bs), device))

    def _luma_q(self, qf, q, device):
        if self.chroma_mode:
            raise ValueError('a chroma-mode codec takes compress_ycbcr / '
                             'extract_ycbcr')
        return self.q_tables(qf, device) if q is None else _f32(q, device)

    # ------------------------------------------------------------------ luma
    def compress(self, image: torch.Tensor, qf, quantize: bool = True,
                 q=None) -> torch.Tensor:
        """``[N, H, W, 1]`` Y image in [0, 255] -> ``[N, H/8, W/8, 64]``
        coefficients divided by the table (and rounded when
        ``quantize``).  ``q`` replaces the QF-scaled table with an explicit
        one, e.g. a real file's DQT, broadcastable to ``[N, 1, 1, 64]``."""
        q = self._luma_q(qf, q, image.device)
        coeffs = image_to_dct(image - 128.0, bs=8) / q
        return torch.round(coeffs) if quantize else coeffs

    def extract(self, coeffs: torch.Tensor, qf, q=None) -> torch.Tensor:
        """Inverse of :meth:`compress`."""
        q = self._luma_q(qf, q, coeffs.device)
        return dct_to_image(coeffs * q, bs=8) + 128.0

    # ---------------------------------------------------------------- chroma
    def compress_ycbcr(self, image: torch.Tensor, qf,
                       downsample_or_quantize=True) -> torch.Tensor:
        """``[N, H, W, 3]`` YCbCr in [0, 255] -> packed coefficients on
        ``bs x bs`` blocks: Y by the padded luma table, Cb and Cr by the
        padded chroma table.  With ``downsample_or_quantize`` the chroma
        keeps its low-frequency 8 x 8 quadrant (rounded unless the value is
        ``'downsample_only'``): ``[N, H/bs, W/bs, bs^2 + 64 + 64]``;
        without it ``[N, H/bs, W/bs, 3 bs^2]``, nothing rounded."""
        if not self.chroma_mode:
            raise ValueError('compress_ycbcr needs a chroma-mode codec')
        bs = self.block_size
        qy, qc = self.q_tables(qf, image.device)
        chans = []
        for c, shift in enumerate((128.0, 0.0, 0.0)):
            coeffs = image_to_dct(image[..., c:c + 1] - shift, bs=bs)
            chans.append(coeffs / (qy if c == 0 else qc))
        if not downsample_or_quantize:
            return torch.cat(chans, dim=-1)
        low = []
        for c in (1, 2):
            cc = chans[c].reshape(chans[c].shape[:3] + (bs, bs))[..., :8, :8]
            if downsample_or_quantize != 'downsample_only':
                cc = torch.round(cc)
            low.append(cc.reshape(cc.shape[:3] + (64,)))
        return torch.cat([chans[0]] + low, dim=-1)

    def extract_ycbcr(self, coeffs: torch.Tensor, qf) -> torch.Tensor:
        """Packed coefficients -> ``[N, H, W, channels]`` in [0, 255].

        Takes ``2 bs^2`` channels (two full chroma channels), ``2 * 64``
        (the chroma's low frequencies alone) or ``bs^2 + 2 * 64`` (Y and
        the chroma's low frequencies, the chroma generator's input)."""
        if not self.chroma_mode:
            raise ValueError('extract_ycbcr needs a chroma-mode codec')
        bs = self.block_size
        qy, qc = self.q_tables(qf, coeffs.device)
        nc = coeffs.shape[-1]

        def lift_low(c64):  # the 8 x 8 low frequencies into a bs x bs block
            blocks = c64.reshape(c64.shape[:3] + (8, 8))
            blocks = torch.nn.functional.pad(blocks, (0, bs - 8, 0, bs - 8))
            return blocks.reshape(c64.shape[:3] + (bs * bs,))

        full = bs ** 2
        if nc == 2 * full:
            chans = [coeffs[..., :full], coeffs[..., full:]]
            qs, shifts = [qc, qc], [0.0, 0.0]
        elif nc == 2 * 64:
            chans = [lift_low(coeffs[..., :64]), lift_low(coeffs[..., 64:])]
            qs, shifts = [qc, qc], [0.0, 0.0]
        elif nc == full + 2 * 64:
            chans = [coeffs[..., :full],
                     lift_low(coeffs[..., full:full + 64]),
                     lift_low(coeffs[..., full + 64:])]
            qs, shifts = [qy, qc, qc], [128.0, 0.0, 0.0]
        else:
            raise ValueError(f'unexpected channel count {nc}')
        return torch.cat([dct_to_image(c * q, bs=bs) + s
                          for c, q, s in zip(chans, qs, shifts)], dim=-1)


def consistency_clamp(coeffs: torch.Tensor, quantized: torch.Tensor
                      ) -> torch.Tensor:
    """Clamp coefficients to within half a bin of the quantised input."""
    return torch.clamp(coeffs, quantized - 0.5, quantized + 0.5)
