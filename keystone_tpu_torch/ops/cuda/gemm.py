"""Solver-grade dense products at an explicit precision.

``csrc/solver_gemm.cu`` is a plain C interface over cuBLAS, built at first
use like the kernels (``_build.py``, linked with ``-lcublas``) and loaded
with ``ctypes``. It owns one cuBLAS handle per (device, thread) in
``CUBLAS_DEFAULT_MATH`` and names the compute type on every call, so a
product's precision never depends on PyTorch's process-wide TF32 flags.
It runs on the calling thread's current stream.

Product kinds (:data:`KINDS`):

- ``ieee_fp32``: IEEE fp32 (``CUBLAS_COMPUTE_32F``);
- ``tf32``: fp32 in and out, TF32 tensor-core products;
- ``bf16``: fp32 in and out, one bf16 pass: bf16 copies of the inputs
  (rounded to nearest even) multiplied with fp32 accumulation
  (``CUBLAS_COMPUTE_32F`` on bf16 operands). ``CUBLAS_COMPUTE_32F_FAST_16BF``
  on the fp32 inputs is not used: it only allows cuBLAS to down-convert
  (``csrc/solver_gemm.cu``);
- ``fp64``: float64 tensors, whatever kind was asked for;
- ``bf16_inputs``: bfloat16 tensors, fp32 output and accumulation.

:func:`gemm_batched` runs a batch of independent products as one strided
batched call (``cublasGemmStridedBatchedEx``).

On CUDA tensors :func:`gemm`, :func:`gemm_tn_chunked` and
:func:`gemm_batched` call the binding or raise; nothing falls back to
``torch.matmul``. A failed allocation in the binding (cuBLAS's own
workspace or handle) raises ``torch.cuda.OutOfMemoryError``, as
PyTorch's allocator does, so an OOM degradation ladder steps down a rung;
any other status raises ``RuntimeError``. On ``meta`` tensors they check
the operands as on the card and return an empty ``meta`` output of the
product's shape and dtype (the plan-time verifier's shape rule): nothing
launches, counts or is noted. On CPU tensors they take their
plain versions (:func:`gemm_reference` and its siblings): the inputs rounded as the kind
rounds them (:func:`round_inputs`), then a ``torch.matmul`` in the
inputs' own type (float32 for the fp32 and bf16 kinds). Each binding call
adds one to ``launches[kind]``; a chunked call counts once. Every call,
on either device, notes its shape and kind to the cost observatory
(``obs/cost.py``), which counts 2·m·n·k FLOP and (m·k + k·n + m·n) ×
itemsize bytes per product.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ...obs import cost as _cost

#: Product kind → the binding's kind code.
KINDS = {"ieee_fp32": 0, "tf32": 1, "bf16": 2, "fp64": 3, "bf16_inputs": 2}

#: Rows per partial product of :func:`gemm_tn_chunked` by default.
ROW_CHUNK = 4096


def _lib():
    lib = _build.load_library("solver_gemm")
    if lib.keystone_gemm.argtypes is None:
        ll, vp, i, d = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.keystone_gemm.argtypes = [i, i, i, ll, ll, ll, d, vp, ll, vp, ll, d, vp, ll, i, vp]
        lib.keystone_gemm.restype = i
        lib.keystone_gemm_tn_chunked.argtypes = [i, ll, ll, ll, ll, vp, ll, vp, ll, d, vp, ll, i, vp]
        lib.keystone_gemm_tn_chunked.restype = i
        lib.keystone_gemm_strided_batched.argtypes = [
            i, i, i, ll, ll, ll, d, vp, ll, ll, vp, ll, ll, d, vp, ll, ll, ll, i, vp,
        ]
        lib.keystone_gemm_strided_batched.restype = i
        lib.keystone_gemm_error.argtypes = [i]
        lib.keystone_gemm_error.restype = ctypes.c_char_p
    return lib


def resolve_kind(kind: str, dtype: torch.dtype) -> str:
    """The kind a product of ``dtype`` tensors runs at: float64 always
    ``fp64``, bfloat16 always ``bf16_inputs``, float32 the kind asked for
    (one of ``ieee_fp32``, ``tf32``, ``bf16``). Raises on other types."""
    if dtype == torch.float64:
        return "fp64"
    if dtype == torch.bfloat16:
        return "bf16_inputs"
    if dtype != torch.float32:
        raise _build.DtypeMismatch(f"solver products take float32, float64 or bfloat16 tensors; got {dtype}")
    if kind not in ("ieee_fp32", "tf32", "bf16"):
        raise ValueError(f"float32 product kind {kind!r}: expected ieee_fp32, tf32 or bf16")
    return kind


# ------------------------------------------------------------- plain version


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest, ties to even
    (non-finite values pass through)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def round_inputs(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` as the product kind reads it: rounded to nearest bf16
    (``bf16``) or TF32 (``tf32``) and held in float32; bfloat16 widened to
    float32 (``bf16_inputs``); unchanged otherwise."""
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "tf32":
        return _round_tf32(x)
    if kind == "bf16_inputs":
        return x.to(torch.float32)
    return x


def gemm_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    kind: str,
    out: Optional[torch.Tensor] = None,
    beta: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`gemm`: ``beta·out + round(a) @ round(b)``."""
    kind = resolve_kind(kind, a.dtype)
    prod = torch.matmul(round_inputs(a, kind), round_inputs(b, kind))
    if out is None:
        return prod
    return out.copy_(prod) if beta == 0.0 else out.mul_(beta).add_(prod)


def gemm_batched_reference(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version of :func:`gemm_batched`: ``round(a) @ round(b)``."""
    kind = resolve_kind(kind, a.dtype)
    return torch.matmul(round_inputs(a, kind), round_inputs(b, kind))


def gemm_tn_chunked_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    kind: str,
    out: Optional[torch.Tensor] = None,
    beta: float = 0.0,
    rows: int = ROW_CHUNK,
) -> torch.Tensor:
    """Plain version of :func:`gemm_tn_chunked`."""
    kind = resolve_kind(kind, a.dtype)
    out_dtype = torch.float32 if kind == "bf16_inputs" else a.dtype
    if out is None:
        out = torch.zeros(a.shape[1], b.shape[1], dtype=out_dtype, device=a.device)
        beta = 0.0
    elif beta == 0.0:
        out.zero_()
    elif beta != 1.0:
        out.mul_(beta)
    ar, br = round_inputs(a, kind), round_inputs(b, kind)
    for start in range(0, a.shape[0], rows):
        out.addmm_(ar[start : start + rows].T, br[start : start + rows])
    return out


# ------------------------------------------------------------------- binding


def _operand(t: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """``(storage tensor, trans, ld)`` of a 2-D operand for the row-major
    binding: a row-major tensor as it is, a transposed view of one as its
    storage with ``trans = 1``, anything else copied contiguous."""
    r, c = t.shape
    if t.stride(1) == 1 and (r <= 1 or t.stride(0) >= max(c, 1)):
        return t, 0, max(t.stride(0), c, 1) if r > 1 else max(c, 1)
    if t.stride(0) == 1 and (c <= 1 or t.stride(1) >= max(r, 1)):
        return t, 1, max(t.stride(1), r, 1) if c > 1 else max(r, 1)
    return t.contiguous(), 0, max(c, 1)


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"{name} needs its tensors on one CUDA device (or all on the CPU); "
            f"got {[str(t.device) for t in tensors]}"
        )
    if any(t.ndim != 2 for t in tensors):
        raise ValueError(f"{name} takes 2-D tensors; got {[tuple(t.shape) for t in tensors]}")
    return device


def _out_tensor(out, m, n, dtype, device, name):
    if out is None:
        return torch.empty(m, n, dtype=dtype, device=device)
    if tuple(out.shape) != (m, n) or out.dtype != dtype or out.device != device:
        raise ValueError(
            f"{name}: out is {tuple(out.shape)} {out.dtype} on {out.device}, "
            f"expected ({m}, {n}) {dtype} on {device}"
        )
    if out.stride(1) != 1 or (m > 1 and out.stride(0) < n):
        raise ValueError(f"{name}: out must be row-major (unit column stride)")
    return out


#: The binding returns a cuBLAS status offset by this (``csrc/solver_gemm.cu``).
CUBLAS_ERR_BASE = 100000

#: The binding's return codes for a failed allocation: the CUDA status
#: from ``prepare`` and ``CUBLAS_STATUS_ALLOC_FAILED`` (3).
ALLOC_FAILURES = frozenset({_build.CUDA_ERROR_MEMORY_ALLOCATION, CUBLAS_ERR_BASE + 3})


def _raise_on(rc: int, lib, name: str) -> None:
    """Raise for a non-zero binding status; an allocation failure raises
    ``torch.cuda.OutOfMemoryError`` (``_build.raise_status``)."""
    if rc != 0:
        _build.raise_status(name, lib.keystone_gemm_error(rc).decode(), rc in ALLOC_FAILURES)


def _dispatch_dtypes(a: torch.Tensor, b: torch.Tensor, kind: str, name: str):
    if a.dtype != b.dtype:
        raise _build.DtypeMismatch(f"{name}: operands differ in type ({a.dtype}, {b.dtype})")
    kind = resolve_kind(kind, a.dtype)
    return kind, (torch.float32 if kind == "bf16_inputs" else a.dtype)


def _as_bf16(a: torch.Tensor, b: torch.Tensor):
    """bf16 copies of fp32 operands for the ``bf16`` kind (strides kept,
    so a transposed view stays one); a Gram's operand is converted once."""
    a16 = a.to(torch.bfloat16)
    return a16, (a16 if b is a else b.to(torch.bfloat16))


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    kind: str = "ieee_fp32",
    out: Optional[torch.Tensor] = None,
    beta: float = 0.0,
) -> torch.Tensor:
    """``beta·out + a @ b`` at product ``kind`` (module docstring). ``a``
    (m, k) and ``b`` (k, n) may be transposed views; ``out``, when given,
    is a row-major (m, n) tensor written in place."""
    kind, out_dtype = _dispatch_dtypes(a, b, kind, "gemm")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    if _build.on_meta("gemm", a, b, out):
        return _out_tensor(out, a.shape[0], b.shape[1], out_dtype, a.device, "gemm")
    _cost.note_launch(
        "gemm", kind, m=a.shape[0], n=b.shape[1], k=a.shape[1], itemsize=a.element_size()
    )
    if all(t.device.type == "cpu" for t in (a, b) + (() if out is None else (out,))):
        return gemm_reference(a, b, kind, out=out, beta=beta)
    device = _check_cuda("gemm", a, b, *(() if out is None else (out,)))
    lib = _lib()
    m, k = a.shape
    n = b.shape[1]
    out = _out_tensor(out, m, n, out_dtype, device, "gemm")
    if k == 0:
        return out.zero_() if beta == 0.0 else out.mul_(beta)
    if kind == "bf16":
        a, b = _as_bf16(a, b)
    sa, ta, lda = _operand(a)
    sb, tb, ldb = _operand(b)
    rc = lib.keystone_gemm(
        KINDS[kind], ta, tb, m, n, k, 1.0, sa.data_ptr(), lda, sb.data_ptr(), ldb,
        float(beta), out.data_ptr(), max(out.stride(0), n, 1) if m > 1 else max(n, 1),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(rc, lib, "gemm")
    launches[kind] += 1
    return out


def gemm_tn_chunked(
    a: torch.Tensor,
    b: torch.Tensor,
    kind: str = "ieee_fp32",
    out: Optional[torch.Tensor] = None,
    beta: float = 0.0,
    rows: int = ROW_CHUNK,
) -> torch.Tensor:
    """``beta·out + aᵀ·b``, the contraction over the rows of ``a`` (n, m)
    and ``b`` (n, p) taken ``rows`` rows at a time, each partial product
    summed into the output: cuBLAS accumulates one long fp32 run over a
    contraction, and summing 4,096-row partial products keeps the error of
    a Gram over millions of rows near that of one chunk. The whole loop is
    one call into the binding. ``a`` and ``b`` must be row-major (unit
    column stride); ``out`` as in :func:`gemm`."""
    kind, out_dtype = _dispatch_dtypes(a, b, kind, "gemm_tn_chunked")
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"gemm_tn_chunked: shapes {tuple(a.shape)}, {tuple(b.shape)} differ in rows")
    if _build.on_meta("gemm_tn_chunked", a, b, out):
        return _out_tensor(out, a.shape[1], b.shape[1], out_dtype, a.device, "gemm_tn_chunked")
    _cost.note_launch(
        "gemm", kind, m=a.shape[1], n=b.shape[1], k=a.shape[0], itemsize=a.element_size()
    )
    if all(t.device.type == "cpu" for t in (a, b) + (() if out is None else (out,))):
        return gemm_tn_chunked_reference(a, b, kind, out=out, beta=beta, rows=rows)
    device = _check_cuda("gemm_tn_chunked", a, b, *(() if out is None else (out,)))
    lib = _lib()
    total, m = a.shape
    n = b.shape[1]
    out = _out_tensor(out, m, n, out_dtype, device, "gemm_tn_chunked")
    if total == 0:
        return out.zero_() if beta == 0.0 else out.mul_(beta)
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    if kind == "bf16":
        a, b = _as_bf16(a, b)
    rc = lib.keystone_gemm_tn_chunked(
        KINDS[kind], total, m, n, rows, a.data_ptr(), max(a.stride(0), m, 1),
        b.data_ptr(), max(b.stride(0), n, 1), float(beta), out.data_ptr(),
        max(out.stride(0), n, 1) if m > 1 else max(n, 1),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(rc, lib, "gemm_tn_chunked")
    launches[kind] += 1
    return out


def _batched_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """``(storage tensor, trans, ld, batch stride)`` of a 3-D operand whose
    matrices are row-major or transposed views of row-major ones; anything
    else is copied contiguous."""
    _, r, c = t.shape
    if t.stride(2) == 1 and (r <= 1 or t.stride(1) >= max(c, 1)):
        return t, 0, max(t.stride(1), c, 1) if r > 1 else max(c, 1), t.stride(0)
    if t.stride(1) == 1 and (c <= 1 or t.stride(2) >= max(r, 1)):
        return t, 1, max(t.stride(2), r, 1) if c > 1 else max(r, 1), t.stride(0)
    t = t.contiguous()
    return t, 0, max(c, 1), t.stride(0)


def gemm_batched(a: torch.Tensor, b: torch.Tensor, kind: str = "ieee_fp32") -> torch.Tensor:
    """``a[i] @ b[i]`` for every i at product ``kind``, as one strided
    batched cuBLAS call: ``a`` (B, m, k) and ``b`` (B, k, n), each batch of
    matrices row-major or a transposed view of row-major ones; returns a
    new row-major (B, m, n) tensor. Counts one launch."""
    kind, out_dtype = _dispatch_dtypes(a, b, kind, "gemm_batched")
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm_batched: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    if _build.on_meta("gemm_batched", a, b):
        return torch.empty(a.shape[0], a.shape[1], b.shape[2], dtype=out_dtype, device=a.device)
    _cost.note_launch(
        "gemm", kind, m=a.shape[1], n=b.shape[2], k=a.shape[2], batch=a.shape[0],
        itemsize=a.element_size(),
    )
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_batched_reference(a, b, kind)
    device = a.device
    if device.type != "cuda" or b.device != device:
        raise ValueError(f"gemm_batched needs both tensors on one CUDA device (or both on the CPU); "
                         f"got {a.device}, {b.device}")
    lib = _lib()
    batch, m, k = a.shape
    n = b.shape[2]
    out = torch.empty(batch, m, n, dtype=out_dtype, device=device)
    if k == 0:
        return out.zero_()
    if kind == "bf16":
        a, b = _as_bf16(a, b)
    sa, ta, lda, stride_a = _batched_operand(a)
    sb, tb, ldb, stride_b = _batched_operand(b)
    rc = lib.keystone_gemm_strided_batched(
        KINDS[kind], ta, tb, m, n, k, 1.0, sa.data_ptr(), lda, stride_a, sb.data_ptr(), ldb,
        stride_b, 0.0, out.data_ptr(), max(n, 1), m * n, batch,
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(rc, lib, "gemm_batched")
    launches[kind] += 1
    return out


#: Binding calls per product kind since the process started (or the
#: caller last reset them).
launches = {kind: 0 for kind in KINDS}


def reset_launches() -> None:
    for kind in launches:
        launches[kind] = 0


__all__ = [
    "KINDS",
    "ROW_CHUNK",
    "gemm",
    "gemm_batched",
    "gemm_batched_reference",
    "gemm_reference",
    "gemm_tn_chunked",
    "gemm_tn_chunked_reference",
    "launches",
    "reset_launches",
    "resolve_kind",
    "round_inputs",
]
