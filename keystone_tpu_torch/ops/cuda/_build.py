"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first use,
then loaded with ``ctypes``; a source that calls a CUDA library names it
in :data:`LINK_FLAGS`. The hash covers every file under ``csrc/`` and the
flags, so an edited source or header rebuilds and a stale library is
never loaded. ``KEYSTONE_CUDA_BUILD_DIR`` puts the libraries elsewhere
(a serving boot image hydrates a fresh directory with the libraries it
bundles). Nothing is built or loaded at import time: the CPU tests
import this module on machines without ``nvcc``.
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


class DtypeMismatch(TypeError):
    """A wrapper's refusal of an operand's dtype. A ``TypeError`` like any
    other, named so the plan-time verifier (``workflow/verify.py``) can
    tell a dtype rejection (KV101) from a step that cannot run on the
    ``meta`` device (KV402)."""


def on_meta(name: str, *tensors) -> bool:
    """True when a wrapper's operands lie on the ``meta`` device, where it
    returns an empty output of the right shape and dtype (a shape rule for
    the plan-time verifier) and launches, counts and notes nothing. All or
    none: a mix of ``meta`` and other devices raises ``ValueError``, as a
    mix of devices does on the card."""
    devices = [t.device for t in tensors if t is not None]
    meta = [d.type == "meta" for d in devices]
    if not any(meta):
        return False
    if not all(meta):
        raise ValueError(f"{name} needs its tensors on one device; got {[str(d) for d in devices]}")
    return True


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


def build_dir() -> Path:
    """Where libraries are built and looked for: ``KEYSTONE_CUDA_BUILD_DIR``
    when set, else ``build/`` beside the sources."""
    return Path(env_str("KEYSTONE_CUDA_BUILD_DIR") or BUILD_DIR)


def sources_hash(link_flags: Sequence[str] = ()) -> str:
    """A hash of every file under ``csrc/`` (so an edited header
    rebuilds) and the flags. With no link flags it is what a serving boot
    image records, so an image built from other sources is refused
    (KV307)."""
    h = hashlib.sha256()
    for path in sorted(p for p in SOURCE_DIR.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(SOURCE_DIR)).encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(link_flags)).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    """The library's path, named by :func:`sources_hash` of its flags."""
    return build_dir() / f"lib{name}-{sources_hash(LINK_FLAGS.get(name, ()))}.so"


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
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
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
        (out_dir / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, paths[name])
        build_seconds[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


#: Calls of :func:`load_library` per library in this process: what a
#: serving boot image reads to bundle the libraries a model's apply uses.
use_counts: Dict[str, int] = {}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    use_counts[name] = use_counts.get(name, 0) + 1
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``, or "" if none ran here."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""
