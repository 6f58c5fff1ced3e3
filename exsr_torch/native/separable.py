"""ctypes binding of the C++ separable resize (``separable_conv.cpp``),
the fast path of :func:`exsr_torch.ops.resize.imresize`.

:func:`load` builds it with ``g++`` at first use
(:func:`exsr_torch.native.build_and_load`) and raises
:class:`~exsr_torch.native.NativeBuildError` when it cannot; the outcome
of the first attempt is kept for the process.  Every function takes and
returns float64 HWC arrays and 1-D float64 taps.
"""
from __future__ import annotations

import ctypes

import numpy as np

from exsr_torch.native import NativeBuildError, build_and_load

_lib: ctypes.CDLL | None = None
_error: NativeBuildError | None = None


def load() -> ctypes.CDLL:
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = build_and_load('separable_conv')
        except NativeBuildError as e:
            _error = e
        else:
            dptr = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            lib.exsr_torch_sepconv_edge.argtypes = [
                dptr, i64, i64, i64, dptr, i64, dptr, i64, dptr]
            for fn in (lib.exsr_torch_downscale, lib.exsr_torch_upscale):
                fn.argtypes = [dptr, i64, i64, i64, dptr, i64, dptr, i64,
                               i64, i64, i64, dptr]
            _lib = lib
    if _error is not None:
        raise _error
    return _lib


def _c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _prepare(img, kcol, krow):
    return (np.ascontiguousarray(img, np.float64),
            np.ascontiguousarray(kcol, np.float64),
            np.ascontiguousarray(krow, np.float64))


def sepconv_edge(img: np.ndarray, kcol: np.ndarray, krow: np.ndarray
                 ) -> np.ndarray:
    """Edge-padded separable correlation, the same size."""
    lib = load()
    img, kcol, krow = _prepare(img, kcol, krow)
    h, w, c = img.shape
    out = np.empty_like(img)
    lib.exsr_torch_sepconv_edge(_c(img), h, w, c, _c(kcol), len(kcol),
                                _c(krow), len(krow), _c(out))
    return out


def downscale(img: np.ndarray, kcol: np.ndarray, krow: np.ndarray, f: int,
              pre: tuple[int, int]) -> np.ndarray:
    """The filtered image at rows ``pre[0] + f i`` and columns ``pre[1] +
    f j``: ``[H // f, W // f, C]``."""
    lib = load()
    img, kcol, krow = _prepare(img, kcol, krow)
    h, w, c = img.shape
    out = np.empty((h // f, w // f, c), np.float64)
    lib.exsr_torch_downscale(_c(img), h, w, c, _c(kcol), len(kcol),
                             _c(krow), len(krow), f, pre[0], pre[1], _c(out))
    return out


def upscale(img: np.ndarray, kcol: np.ndarray, krow: np.ndarray, f: int,
            pre: tuple[int, int]) -> np.ndarray:
    """The image zero-stuffed by ``f`` (samples at ``pre + f i``), then
    filtered: ``[H f, W f, C]``."""
    lib = load()
    img, kcol, krow = _prepare(img, kcol, krow)
    h, w, c = img.shape
    out = np.empty((h * f, w * f, c), np.float64)
    lib.exsr_torch_upscale(_c(img), h, w, c, _c(kcol), len(kcol),
                           _c(krow), len(krow), f, pre[0], pre[1], _c(out))
    return out
