"""Build ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers they include) into
one shared library with a plain C interface, and ``csrc/fastpre.cpp`` into
a host library of its own.

The CUDA library is compiled with ``nvcc`` for Hopper (``sm_90a``) at first
use (one ``nvcc`` per source, all started together, then one link), cached
in ``yolo_tpu_torch/_build/`` under a hash of the sources, the headers and
the flags, and loaded with ``ctypes``. A failed build or load raises:
there is no fallback.

It is also the kernels' one launch seam. Each wrapper in ``ops/`` declares
its kernel's C signature beside its one call, as ``kernel(prefix, params,
counter)``: the launcher passes device pointers and scalars, the device
index and PyTorch's current stream, raises on a refused launch and counts
the launch. ``on_card`` tells the CPU (the plain twin), CUDA (the kernel)
and other devices (no kernel) apart, and ``check_tensors`` checks the
dtypes, device, layout and alignment of a wrapper's tensors.

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

import torch

from .utils.profiler import count

CSRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'

# --fmad=false: no multiply-add contraction, so the kernels' float results
# (the NMS IoU, the int8 conv epilogue, the shortcut chain) match the plain
# PyTorch versions bit for bit. -Xptxas=-v: each kernel's registers, spills
# and shared memory go to the build log (``build_log()``).
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


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob('*.cuh'))


def library_path() -> Path:
    """Where the library for the current sources, the headers they include
    and the flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libyolo_tpu_torch_{h.hexdigest()[:16]}.so'


def _cached_build(out: Path, tool: str, steps) -> Path:
    """Build ``out`` unless it is already built. ``steps(tmp, lib)`` gives
    the build's steps, each a list of commands run together, that write
    into the private directory ``tmp`` and the library at ``lib``, which is
    then renamed to ``out``: no process loads a half-written library. What
    the commands print goes to ``<out>.log``; a failed or missing ``tool``
    raises ``RuntimeError`` with it."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        try:
            for cmds in steps(tmp, lib):
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for c in cmds]
                logs += [f'{" ".join(c)}\n{p.communicate()[0]}'
                         for c, p in zip(cmds, procs)]
                failed = [p.returncode for p in procs if p.returncode]
                if failed:
                    raise RuntimeError(f'{tool} failed ({failed[0]}):\n'
                                       + ''.join(logs))
        except OSError as e:            # no such compiler on the machine
            logs.append(f'{tool}: {e}\n')
            raise RuntimeError(f'{tool} failed: {e}') from e
        finally:
            Path(str(out) + '.log').write_text(''.join(logs))
        os.replace(lib, out)
    return out


def build() -> Path:
    """Compile the sources with nvcc, one process a source, then link them,
    unless the library for them is already built."""
    def steps(tmp, lib):
        nvcc, srcs = _nvcc(), _sources()
        objs = [os.path.join(tmp, src.stem + '.o') for src in srcs]
        return ([[nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)]
                 for src, obj in zip(srcs, objs)],
                [[nvcc, '-shared', '-o', lib, *objs]])
    return _cached_build(library_path(), 'nvcc', steps)


def build_log() -> str:
    """What nvcc and ptxas printed while building the current library."""
    log = Path(str(library_path()) + '.log')
    return log.read_text() if log.exists() else ''


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels."""
    return ctypes.CDLL(str(build()))


# the kinds of C parameters, as ``struct`` codes (spaces only group them):
# a pointer, int, long long, float
CTYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'q': ctypes.c_longlong,
          'f': ctypes.c_float}


def _bind(lib, name: str, params: str, restype=ctypes.c_int):
    """``restype name(params)`` of ``lib``, its parameters as CTYPES codes."""
    return ctypes.CFUNCTYPE(restype, *(CTYPES[c] for c in params))(
        (name, lib))


def _failed(lib, prefix: str, what: str, err: int) -> RuntimeError:
    """The error of a non-zero return ``err``, in the words of
    ``const char* <prefix>_error_string(int)``."""
    return RuntimeError(f'{prefix} {what} failed: ' + _bind(
        lib, prefix + '_error_string', 'i', ctypes.c_char_p)(err).decode())


def c_function(prefix: str, name: str, params: str):
    """``int <prefix>_<name>(params)`` of the library, declared at each
    call (for calls off the hot path); a non-zero return raises
    ``RuntimeError`` with ``<prefix>_error_string``."""
    def call(*args):
        lib = load_library()
        err = _bind(lib, call.c_name, call.params)(*args)
        if err != 0:
            raise _failed(lib, prefix, name, err)

    call.c_name, call.params = f'{prefix}_{name}', params.replace(' ', '')
    return call


def kernel(prefix: str, params: str, counter: str, load=load_library):
    """``launch(device, *args)``: ``int <prefix>_launch(params..., int
    device, void* stream)`` of the library ``load()`` on ``args``, the CUDA
    device index and PyTorch's current stream on it; ``RuntimeError`` with
    ``<prefix>_error_string`` on a non-zero return; one more ``counter``.
    Declared at the first launch. ``launch.on(lib)``: the same launcher of
    another library."""
    full = params.replace(' ', '') + 'ip'
    fn = stream = None

    def launch(device, *args):
        nonlocal fn, stream
        if fn is None:
            fn = _bind(load(), prefix + '_launch', full)
            stream = torch._C._cuda_getCurrentRawStream
        err = fn(*args, device, stream(device))
        if err != 0:
            raise _failed(load(), prefix, 'kernel launch', err)
        count(counter, 1)

    launch.c_name, launch.params = prefix + '_launch', full
    launch.on = lambda lib: kernel(prefix, params, counter, lambda: lib)
    return launch


def on_card(who: str, t) -> bool:
    """True where a call on the tensor ``t``'s device launches the kernel
    (CUDA), False where its plain twin runs (the CPU); ``ValueError``
    elsewhere."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f'{who}: no kernel for device {t.device}')


def check_tensors(who: str, specs, align: int = 1):
    """``ValueError`` ('<who>: <name> ...') unless each (name, tensor,
    dtype) of ``specs`` has that dtype, the first tensor's device, a
    contiguous layout and, where ``align`` > 1, an address that is a
    multiple of ``align``. A tensor costs one compound test; the fault is
    named only once one is found."""
    dev = specs[0][1].device
    for name, t, dtype in specs:
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or (align > 1 and t.data_ptr() % align)):
            raise ValueError(f'{who}: {name} ' + (
                f'must be {dtype}, got {t.dtype}' if t.dtype != dtype else
                f'is on {t.device}, {specs[0][0]} on {dev}' if t.device != dev
                else 'must be contiguous' if not t.is_contiguous() else
                f'must be {align}-byte aligned'))


def host_library_path() -> Path:
    """Where the host library for the current source and flags lives."""
    h = hashlib.sha256(' '.join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f'libfastpre_{h.hexdigest()[:16]}.so'


def build_host() -> Path:
    """Compile ``csrc/fastpre.cpp`` with g++ unless it is already built
    (``_cached_build``: g++'s output goes to ``host_build_log()``, a
    failed or missing g++ raises ``RuntimeError``)."""
    return _cached_build(host_library_path(), 'g++', lambda tmp, lib: (
        [['g++', *HOST_FLAGS, str(HOST_SOURCE), '-o', lib]],))


def host_build_log() -> str:
    """What g++ printed while building (or failing to build) the host
    library."""
    log = Path(str(host_library_path()) + '.log')
    return log.read_text() if log.exists() else ''
