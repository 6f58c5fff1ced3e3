"""Build and load the port's hand-written CUDA kernels (and, through
:func:`compile_sources`, its host C++ in :mod:`exsr_torch.native`).

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


class BuildError(RuntimeError):
    """A source could not be compiled, or its library loaded."""


def source_library(src: Path, build_dir: Path, flags) -> Path:
    """Where ``src`` built with ``flags`` lives in ``build_dir``: the name
    carries a hash of the source, the headers beside it (``*.cuh``, which
    a kernel source may include) and the flags."""
    text = src.read_bytes() + b''.join(
        h.read_bytes() for h in sorted(src.parent.glob('*.cuh')))
    digest = hashlib.sha256(text + ' '.join(flags).encode()).hexdigest()
    return build_dir / f'{src.stem}-{digest[:16]}.so'


def compile_sources(sources: dict, build_dir: Path, compiler: str,
                    flags) -> dict:
    """Compile the missing library of each ``{name: source path}`` with
    ``compiler`` and ``flags``, one process each, all started together.
    Returns ``{name: {'seconds', 'log'}}`` for the libraries built by this
    call (the compiler's output).  Each library is written beside its place
    and renamed into it, so processes that build at the same time never
    load half a file."""
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        target = source_library(src, build_dir, flags)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.Popen(
                [compiler, *flags, '-o', tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            os.unlink(tmp)
            for other, other_tmp, _, _ in jobs.values():
                other.kill()
                other.wait()
                os.unlink(other_tmp)
            raise BuildError(f'no {compiler} to build {src.name}') from e
        jobs[name] = (proc, tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'{sources[name].name} ({compiler} exit '
                          f'{proc.returncode}):\n{log}')
            continue
        os.replace(tmp, target)
        report[name] = {'seconds': time.perf_counter() - t0, 'log': log}
    if failed:
        raise BuildError('build failed: ' + '\n'.join(failed))
    return report


def library_path(name: str) -> Path:
    return source_library(CSRC / f'{name}.cu', BUILD_DIR, NVCC_FLAGS)


def build(names=SOURCES) -> dict:
    """Compile every missing library of ``names``, one ``nvcc`` each, all
    started together.  Returns ``{name: {'seconds', 'ptxas'}}`` for the
    libraries built by this call (ptxas's register and spill report)."""
    report = compile_sources({n: CSRC / f'{n}.cu' for n in names},
                             BUILD_DIR, nvcc_path(), NVCC_FLAGS)
    return {n: {'seconds': r['seconds'], 'ptxas': r['log']}
            for n, r in report.items()}


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


def build_copy(source: str, subs, directory, name: str,
               header_subs=(), header_dir=None) -> tuple:
    """Compile a copy of a kernel source into ``directory``, for a probe:
    ``source`` (the text of a ``.cu`` file) with the exact text
    substitutions ``subs`` applied, beside copies of the headers
    (``*.cuh``) of ``header_dir`` if it has any, else of ``csrc``, with
    ``header_subs`` applied (a quoted include finds them first).  Each
    substitution must match exactly once in its file, or this raises.
    Returns the loaded library (signatures unset) and the compiler's
    output."""
    def apply(text, pairs, where):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: pattern matches '
                                   f'{text.count(old)} times in {where}: '
                                   f'{old!r}')
            text = text.replace(old, new)
        return text
    directory = Path(directory)
    found = sorted(Path(header_dir).glob('*.cuh')) if header_dir else []
    headers = {h.name: h.read_text()
               for h in found or sorted(CSRC.glob('*.cuh'))}
    left = list(header_subs)
    for hname, text in headers.items():
        mine = [(o, n) for o, n in left if o in text]
        left = [x for x in left if x not in mine]
        (directory / hname).write_text(apply(text, mine, hname))
    if left:
        raise RuntimeError(f'{name}: header patterns match nowhere: {left!r}')
    cu, so = directory / f'{name}.cu', directory / f'{name}.so'
    cu.write_text(apply(source, subs, f'{name}.cu'))
    done = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise BuildError(f'{name}: nvcc failed\n{done.stdout}{done.stderr}')
    return ctypes.CDLL(str(so)), done.stdout + done.stderr


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.exsr_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg}) at launch')
