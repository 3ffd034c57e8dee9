"""The native host kernels: build at first use, bind over ctypes.

Port of ``keystone_tpu/native/__init__.py`` (reference:
utils/external/VLFeat.scala:3-29, utils/external/EncEval.scala:3-30,
which load the C++ kernels behind JNI). The C++ sources are the port's
own copies under ``native/src/``. They are host kernels, not device
kernels, and are compiled with ``g++`` at first use into the git-ignored
``native/build/`` as two libraries:

- ``kernels`` (``dsift.cpp``, ``gmm.cpp``): ``ks_dsift`` /
  ``ks_dsift_descriptor_count`` (dense multi-scale SIFT), ``ks_gmm_fit`` /
  ``ks_fisher_encode`` (GMM EM and Fisher vectors);
- ``decode`` (``decode.cpp``, linked with ``-ljpeg``):
  ``ks_decode_jpeg_batch`` / ``ks_jpeg_dims`` / ``ks_set_threads``
  (batch JPEG ingest).

The decode library is separate because it needs libjpeg's header
``jpeglib.h``, which a machine may lack while the other kernels still
build. Each library is named by a hash of its sources, the compiler
flags and the host CPU (``-march=native`` code does not move between
CPUs). :func:`load` builds or raises with the compiler's log: there is
no ``None`` return and no fallback.

The kernels fan out over OpenMP threads (``-fopenmp``, the JAX
package's Makefile flags). A compiler without OpenMP's runtime (no
``libgomp``) cannot build them so: the build then raises, naming it,
unless ``KEYSTONE_NATIVE_OPENMP=off`` asks for a single-threaded build
(the sources guard every OpenMP pragma, so the results are the same).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..envknobs import env_disabled, env_str

SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: The JAX package's Makefile flags (keystone_tpu/native/Makefile),
#: without ``-fopenmp``, which :func:`compile_flags` adds.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LINK_FLAGS = ("-shared",)
OPENMP_FLAG = "-fopenmp"

#: library name → (sources under ``src/``, libraries to link).
LIBRARIES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "kernels": (("dsift.cpp", "gmm.cpp"), ()),
    "decode": (("decode.cpp",), ("-ljpeg",)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: Seconds each library's compile took in this process (0.0: found built).
build_seconds: Dict[str, float] = {}


def find_compiler() -> str:
    """``$CXX``, else ``g++`` on ``PATH``; raises when there is none."""
    cxx = env_str("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH to build the native host kernels")
    return cxx


_target_cache: Dict[str, bytes] = {}


def _native_target(cxx: str) -> bytes:
    """What ``-march=native`` resolves to on this host, as the compiler
    reports it (``-Q --help=target``): the CPU the library is built for."""
    if cxx not in _target_cache:
        proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True, timeout=60)
        _target_cache[cxx] = proc.stdout.encode()
    return _target_cache[cxx]


def openmp_requested() -> bool:
    """True unless ``KEYSTONE_NATIVE_OPENMP=off`` asks for a
    single-threaded build."""
    return not env_disabled("KEYSTONE_NATIVE_OPENMP")


def compile_flags() -> Tuple[str, ...]:
    """The compile and link flags of a build: ``CXX_FLAGS`` and
    ``LINK_FLAGS``, with ``-fopenmp`` unless a single-threaded build is
    asked for."""
    omp = (OPENMP_FLAG,) if openmp_requested() else ()
    return CXX_FLAGS + omp + LINK_FLAGS + omp


def has_openmp() -> bool:
    """Whether the compiler builds and links an OpenMP program (it needs
    ``libgomp``); nothing is kept."""
    proc = subprocess.run(
        [find_compiler(), "-x", "c++", OPENMP_FLAG, "-o", os.devnull, "-"],
        input="#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n",
        capture_output=True, text=True, timeout=60,
    )
    return proc.returncode == 0


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its sources, the flags, the
    compiler and the host CPU."""
    sources, libs = LIBRARIES[name]
    h = hashlib.sha256()
    for src in sources:
        h.update(src.encode() + b"\0" + (SOURCE_DIR / src).read_bytes())
    h.update(" ".join(compile_flags() + libs).encode())
    cxx = find_compiler()
    h.update(cxx.encode() + b"\0" + _native_target(cxx))
    return BUILD_DIR / f"libkeystone_native_{name}-{h.hexdigest()[:12]}.so"


def has_header(header: str) -> bool:
    """Whether the compiler finds ``#include <header>`` (a preprocessor
    run; nothing is built)."""
    proc = subprocess.run(
        [find_compiler(), "-x", "c++", "-E", "-o", os.devnull, "-"],
        input=f"#include <{header}>\n", capture_output=True, text=True, timeout=60,
    )
    return proc.returncode == 0


def build(name: str) -> Path:
    """Compile library ``name`` unless it is built; returns its path.
    Raises with the compiler's output (also kept in ``build/<name>.log``)."""
    path = library_path(name)
    build_seconds.setdefault(name, 0.0)
    if path.exists():
        return path
    sources, libs = LIBRARIES[name]
    if openmp_requested() and not has_openmp():
        raise RuntimeError(
            "the native host kernels build with -fopenmp, and this compiler cannot build an OpenMP "
            "program (no libgomp); set KEYSTONE_NATIVE_OPENMP=off to build them single-threaded"
        )
    if name == "decode" and not has_header("jpeglib.h"):
        raise RuntimeError(
            "the native JPEG decode needs libjpeg's header jpeglib.h, which the compiler does not "
            "find on this machine; install libjpeg's development files or decode with "
            "use_native=False (PIL)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_compiler(), *compile_flags(), "-o", str(tmp),
           *(str(SOURCE_DIR / s) for s in sources), *libs]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    log = BUILD_DIR / f"{name}.log"
    log.write_text(" ".join(cmd) + "\n" + proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native {name} library (exit {proc.returncode}); "
                           f"log {log}:\n{proc.stdout[-4000:]}")
    os.replace(tmp, path)
    build_seconds[name] = time.perf_counter() - t0
    return path


def _configure(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)
    if name == "kernels":
        lib.ks_dsift_descriptor_count.restype = ctypes.c_int
        lib.ks_dsift_descriptor_count.argtypes = [ctypes.c_int] * 6
        lib.ks_dsift.restype = None
        lib.ks_dsift.argtypes = [
            c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_float_p,
        ]
        lib.ks_gmm_fit.restype = ctypes.c_int
        lib.ks_gmm_fit.argtypes = [
            c_float_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_float,
            ctypes.c_float, c_float_p, c_float_p, c_float_p,
        ]
        lib.ks_fisher_encode.restype = None
        lib.ks_fisher_encode.argtypes = [
            c_float_p, ctypes.c_longlong, ctypes.c_int, c_float_p, c_float_p,
            c_float_p, ctypes.c_int, ctypes.c_float, c_float_p,
        ]
    else:
        lib.ks_decode_jpeg_batch.restype = None
        lib.ks_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(c_ubyte_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, c_float_p, c_ubyte_p,
        ]
        lib.ks_jpeg_dims.restype = ctypes.c_int
        lib.ks_jpeg_dims.argtypes = [c_ubyte_p, ctypes.c_longlong, c_int_p, c_int_p]
        lib.ks_set_threads.restype = None
        lib.ks_set_threads.argtypes = [ctypes.c_int]
    return lib


def load(name: str = "kernels") -> ctypes.CDLL:
    """The loaded library ``name`` (``"kernels"`` or ``"decode"``),
    building it first if needed; raises if it cannot be built."""
    if name not in LIBRARIES:
        raise ValueError(f"unknown native library {name!r}: expected one of {sorted(LIBRARIES)}")
    with _lock:
        if name not in _loaded:
            _loaded[name] = _configure(name, ctypes.CDLL(str(build(name))))
        return _loaded[name]


def loaded_path(name: str) -> str:
    """The file the loaded library ``name`` was read from."""
    return load(name)._name
