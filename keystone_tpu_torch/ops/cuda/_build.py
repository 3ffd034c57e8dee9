"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first use,
then loaded with ``ctypes``; a source that calls a CUDA library names it
in :data:`LINK_FLAGS`. The hash covers every file under ``csrc/`` and the
flags, so an edited source or header rebuilds and a stale library is
never loaded. Nothing is built or loaded at import time: the
CPU tests import this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from ...envknobs import env_str

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Per-source link flags. ``-lcublas`` resolves to the toolkit's
#: ``libcublas.so.<major>``; at load time the dynamic linker reuses the
#: cuBLAS that PyTorch already loaded under the same soname.
LINK_FLAGS: Dict[str, Tuple[str, ...]] = {"solver_gemm": ("-lcublas",)}

_loaded: Dict[str, ctypes.CDLL] = {}

#: ``cudaErrorMemoryAllocation``: the code a source returns when a CUDA
#: allocation of its own failed.
CUDA_ERROR_MEMORY_ALLOCATION = 2


def raise_status(name: str, text: str, out_of_memory: bool) -> None:
    """Raise for a source's non-zero return code, whose error string is
    ``text``. An allocation failure raises
    ``torch.cuda.OutOfMemoryError`` with "out of memory" in its message,
    so the reliability layer classes it as OOM (a degradation ladder
    steps down a rung); any other failure is a ``RuntimeError``, which it
    classes as permanent and re-raises."""
    import torch

    if out_of_memory:
        raise torch.cuda.OutOfMemoryError(f"{name} failed: out of memory ({text})")
    raise RuntimeError(f"{name} failed: {text}")

#: Seconds each kernel took to build in this process (0.0 when a
#: library built earlier was reused).
build_seconds: Dict[str, float] = {}


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; None when there is none."""
    cuda_home = env_str("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def library_path(name: str) -> Path:
    """The library's path, named by a hash of every file under ``csrc/``
    (so an edited header rebuilds) and the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in SOURCE_DIR.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(SOURCE_DIR)).encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the library paths; raises
    with the compiler's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, path in paths.items() if not path.exists()]
    for name in names:
        build_seconds.setdefault(name, 0.0)
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
            "the CUDA kernels of keystone_tpu_torch are built from source at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu"),
               *LINK_FLAGS.get(name, ())]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, paths[name])
        build_seconds[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``, or "" if none ran here."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
