"""Build ``csrc/*.cu`` into one shared library with a plain C interface,
and ``csrc/fastpre.cpp`` into a host library of its own.

The CUDA library is compiled with ``nvcc`` for Hopper (``sm_90a``) at first
use (one ``nvcc`` per source, all started together, then one link), cached
in ``yolo_tpu_torch/_build/`` under a hash of the sources and flags, and
loaded with ``ctypes``. Kernels launch on PyTorch's current stream; the
wrappers in ``ops/`` pass device pointers and the stream as integers.
A failed build or load raises: there is no fallback.

The host library (the batch letterbox of ``native/``, C++ with OpenMP) is
compiled with ``g++`` under the JAX package's flags (``HOST_FLAGS``), into
the same directory under a hash of its source and flags; it needs no CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'

# --fmad=false: no multiply-add contraction, so the kernels' float results
# (the NMS IoU, the int8 conv epilogue) match the plain PyTorch versions bit
# for bit. -Xptxas=-v: each kernel's registers, spills and shared memory go
# to the build log (``build_log()``).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xptxas=-v', '-Xcompiler', '-fPIC')


# the JAX package's flags for native/fastpre.cpp, and no -march=native:
# with FMA, g++ contracts the four-term bilinear sum, and values on a .5
# would round apart from the JAX package's library
HOST_FLAGS = ('-O3', '-fopenmp', '-shared', '-fPIC')
HOST_SOURCE = CSRC_DIR / 'fastpre.cpp'


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob('*.cu'))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, 'bin', 'nvcc'))
    candidates.append(shutil.which('nvcc') or '')
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the yolo_tpu_torch CUDA kernels')


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libyolo_tpu_torch_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the sources unless the library for them is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory, then rename the library: a
    # concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                                   f'{" ".join(cmd)}\n{log}')
            logs.append(log)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, '-shared', '-o', lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
        Path(str(out) + '.log').write_text(''.join(logs))
        os.replace(lib, out)
    return out


def build_log() -> str:
    """What nvcc and ptxas printed while building the current library."""
    log = Path(str(library_path()) + '.log')
    return log.read_text() if log.exists() else ''


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every C signature."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nms_suppress_launch.argtypes = [p, p, p, p, p, p, i, i, f, i, i, i,
                                        i, p]
    lib.nms_suppress_launch.restype = i
    lib.nms_suppress_max_clusters.argtypes = [i, i, i,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.nms_suppress_max_clusters.restype = i
    lib.nms_suppress_error_string.argtypes = [i]
    lib.nms_suppress_error_string.restype = ctypes.c_char_p
    lib.conv_int8_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                     i, f, f, i, f, i, i, i, i, i, i, i, p]
    lib.conv_int8_launch.restype = i
    lib.conv_int8_error_string.argtypes = [i]
    lib.conv_int8_error_string.restype = ctypes.c_char_p
    return lib


def host_library_path() -> Path:
    """Where the host library for the current source and flags lives."""
    h = hashlib.sha256(' '.join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f'libfastpre_{h.hexdigest()[:16]}.so'


def build_host() -> Path:
    """Compile ``csrc/fastpre.cpp`` with g++ unless it is already built.
    Several processes may build at once: each writes a private name and
    renames it into place. g++'s output goes to ``host_build_log()``; a
    failed build raises ``RuntimeError`` with it."""
    out = host_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = Path(str(out) + '.log')
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ['g++', *HOST_FLAGS, str(HOST_SOURCE), '-o', tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:            # no g++ on the machine
            log.write_text(f'{" ".join(cmd)}\n{e}\n')
            raise RuntimeError(f'g++ failed: {e}') from e
        log.write_text(f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def host_build_log() -> str:
    """What g++ printed while building (or failing to build) the host
    library."""
    log = Path(str(host_library_path()) + '.log')
    return log.read_text() if log.exists() else ''
