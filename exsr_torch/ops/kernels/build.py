"""Build and load the port's hand-written CUDA kernels.

Each ``exsr_torch/csrc/<name>.cu`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``build/exsr_torch_kernels/<name>-<hash>.so`` at the repository root and
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
built or imported when this module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = (Path(__file__).resolve().parents[3] / 'build'
             / 'exsr_torch_kernels')
SOURCES = ('sepfilter', 'stage4', 'rdb')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH``, or the toolkit's default
    install directory."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin',
                                       'nvcc'))
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build(names=SOURCES) -> dict:
    """Compile every missing library of ``names``, one ``nvcc`` each, all
    started together.  Returns ``{name: {'seconds', 'ptxas'}}`` for the
    libraries built by this call (ptxas's register and spill report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, target)  # atomic: concurrent builds race safely
        report[name] = {'seconds': time.perf_counter() - t0, 'ptxas': log}
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream are ``c_void_p`` so that ctypes does not cut
    them to 32 bits."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        signatures = dict(signatures, exsr_cuda_error_string=(
            [ctypes.c_int], ctypes.c_char_p))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


@contextlib.contextmanager
def substitute(name: str, lib: ctypes.CDLL):
    """Within the block, :func:`load` returns ``lib`` for ``name``: a probe
    runs another build of a source (a variant, an older version) through
    the same wrappers."""
    saved = _loaded.get(name)
    _loaded[name] = lib
    try:
        yield lib
    finally:
        if saved is None:
            _loaded.pop(name, None)
        else:
            _loaded[name] = saved


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.exsr_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg}) at launch')
