"""ctypes binding of the C++ baseline-JPEG scan decoder (``jfif_scan.cpp``),
the bit-serial loop of :mod:`exsr_torch.jpeg.jfif`.

:func:`load` builds it with ``g++`` at first use
(:func:`exsr_torch.native.build_and_load`) and raises
:class:`~exsr_torch.native.NativeBuildError` when it cannot;
:func:`available` says whether it can.  The outcome of the first attempt
is kept for the process.
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
            lib = build_and_load('jfif_scan')
        except NativeBuildError as e:
            _error = e
        else:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.exsr_jfif_decode_scan.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                i32p, i32p, u8p, u8p, u8p, u8p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(i32p)]
            lib.exsr_jfif_decode_scan.restype = ctypes.c_int
            _lib = lib
    if _error is not None:
        raise _error
    return _lib


def available() -> bool:
    try:
        load()
    except NativeBuildError:
        return False
    return True


def decode_scan(data: bytes, pos: int, comp_h, comp_v,
                dc_tables, ac_tables, mcus_x: int, mcus_y: int,
                restart_interval: int, planes: list[np.ndarray]) -> int:
    """Run the native scan loop.

    ``dc_tables``/``ac_tables``: per scan component, ``(counts[16],
    symbols[<=256])``.  ``planes``: per component a zeroed C-contiguous
    int32 ``[bh, bw, 64]`` array, filled in natural coefficient order.
    Returns the C error code (0 ok, 1 bad Huffman code, 2 AC overrun,
    3 missing restart marker)."""
    lib = load()
    n = len(comp_h)
    if not 1 <= n <= 8 or len(planes) != n:
        raise ValueError(f'{n} scan components, {len(planes)} planes')
    for p in planes:
        if p.dtype != np.int32 or not p.flags.c_contiguous:
            raise ValueError('planes must be C-contiguous int32 arrays')
    buf = np.frombuffer(data, np.uint8)
    ch = np.ascontiguousarray(comp_h, np.int32)
    cv = np.ascontiguousarray(comp_v, np.int32)

    def pack(tables):
        counts = np.zeros((n, 16), np.uint8)
        syms = np.zeros((n, 256), np.uint8)
        for i, (c, s) in enumerate(tables):
            counts[i, :len(c)] = c
            syms[i, :len(s)] = s
        return counts, syms
    dcc, dcs = pack(dc_tables)
    acc, acs = pack(ac_tables)
    i32p = ctypes.POINTER(ctypes.c_int32)
    plane_ptrs = (i32p * n)(*[p.ctypes.data_as(i32p) for p in planes])

    def u8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.exsr_jfif_decode_scan(
        u8(buf), len(data), pos, n,
        ch.ctypes.data_as(i32p), cv.ctypes.data_as(i32p),
        u8(dcc), u8(dcs), u8(acc), u8(acs),
        mcus_x, mcus_y, restart_interval, plane_ptrs)
