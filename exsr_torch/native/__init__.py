"""Host-side C++ of the port, built with ``g++`` and loaded with ``ctypes``.

Each source here is compiled at first use into
``build/exsr_torch_native/<name>-<hash>.so`` at the repository root (the
hash covers the source and the flags, so an edited source is rebuilt and a
stale library is never loaded), never next to the source, by the kernels'
build module (:func:`exsr_torch.ops.kernels.build.compile_sources`).  Nothing
is built when a module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from exsr_torch.ops.kernels.build import BuildError as NativeBuildError
from exsr_torch.ops.kernels.build import compile_sources, source_library

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'exsr_torch_native'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

__all__ = ['NativeBuildError', 'build_and_load']


def build_and_load(name: str) -> ctypes.CDLL:
    """Compile ``<name>.cpp`` unless its library exists, then load it."""
    src = SRC_DIR / f'{name}.cpp'
    compile_sources({name: src}, BUILD_DIR, CXX, CXX_FLAGS)
    target = source_library(src, BUILD_DIR, CXX_FLAGS)
    try:
        return ctypes.CDLL(str(target))
    except OSError as e:
        raise NativeBuildError(f'cannot load {target}: {e}') from e
