"""Shape rules for the plan-time tracer: torch ops on ``meta`` tensors
answered from their operands' shapes and dtypes alone.

Torch's ``meta`` kernels for most compute ops are written in Python
(``torch._meta_registrations``, ``torch._refs``). The first one a process
runs imports their machinery — sympy, the symbolic-shape module and the
dynamo decorators — which costs seconds in every fresh process. The
verifier (``workflow/verify.py``) traces ``apply_arrays`` on ``meta``
inside every ``Pipeline.fit`` and every ``load_fitted``, so it runs under
:class:`ShapeRules`: a ``TorchFunctionMode`` that answers the ops the
port's transformers use from the rules below, with the checks torch makes
(broadcasting, the inner dimension of a product, dimension ranges, dtype
agreement) and torch's exception types, so a rejection still reads as a
shape error (KV101). Views, conversions and factories with an explicit
shape already stay in C++ on ``meta`` and pass through. Any other op runs
torch's own ``meta`` kernel and is counted in :data:`FALLBACKS`.

Outputs are made with ``torch.empty(..., device="meta")`` only:
``empty_like`` and ``broadcast_shapes`` on ``meta`` take the Python path
too.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["FALLBACKS", "ShapeRules", "broadcast"]

#: Op names that ran torch's own ``meta`` kernel under :class:`ShapeRules`
#: (no rule here, not known to stay in C++), with their counts.
FALLBACKS: "collections.Counter[str]" = collections.Counter()

Shape = Tuple[int, ...]


def _empty(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _shape(x: Any) -> Shape:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def broadcast(*shapes: Sequence[int]) -> Shape:
    """Broadcast ``shapes`` as torch does, raising torch's ``RuntimeError``
    wording on a mismatch."""
    ndim = max((len(s) for s in shapes), default=0)
    out: List[int] = [1] * ndim
    for s in shapes:
        for i, d in enumerate(s, start=ndim - len(s)):
            if d == out[i] or d == 1:
                continue
            if out[i] == 1:
                out[i] = d
                continue
            raise RuntimeError(
                f"The size of tensor a ({out[i]}) must match the size of tensor b ({d}) "
                f"at non-singleton dimension {i - ndim + len(s)}"
            )
    return tuple(out)


def _wrap_dim(dim: int, ndim: int) -> int:
    lo, hi = -max(ndim, 1), max(ndim, 1) - 1
    if not lo <= dim <= hi:
        raise IndexError(f"Dimension out of range (expected to be in range of [{lo}, {hi}], but got {dim})")
    return dim % max(ndim, 1)


def _dims(dim: Any, ndim: int) -> Optional[List[int]]:
    if dim is None:
        return None
    if isinstance(dim, (list, tuple)):
        if not dim:
            return None
        return sorted({_wrap_dim(int(d), ndim) for d in dim})
    return [_wrap_dim(int(dim), ndim)]


def _float_of(dtype: torch.dtype) -> torch.dtype:
    """The dtype a floating op gives on ``dtype``: integers and bool
    become the default float."""
    return dtype if (dtype.is_floating_point or dtype.is_complex) else torch.get_default_dtype()


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32, torch.complex128: torch.float64, torch.complex32: torch.float16}.get(
        dtype, dtype
    )


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_complex:
        return dtype
    return {torch.float64: torch.complex128, torch.float16: torch.complex32}.get(dtype, torch.complex64)


def _arg(args: tuple, kwargs: dict, i: int, name: str, default: Any = None) -> Any:
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


# ------------------------------------------------------------ elementwise


def _unary(kind: str) -> Callable:
    def rule(args, kwargs):
        x = args[0]
        if kind == "float":
            dtype = _float_of(x.dtype)
        elif kind == "bool":
            dtype = torch.bool
        elif kind == "abs":
            dtype = _real_of(x.dtype)
        else:
            dtype = x.dtype
        return _empty(x.shape, dtype)

    return rule


def _clamp(args, kwargs):
    x = args[0]
    bounds = [b for b in (_arg(args, kwargs, 1, "min"), _arg(args, kwargs, 2, "max")) if b is not None]
    if not bounds:
        raise RuntimeError("torch.clamp: At least one of 'min' or 'max' must not be None")
    shape = broadcast(x.shape, *(_shape(b) for b in bounds))
    dtype = x.dtype
    for b in bounds:
        dtype = torch.promote_types(dtype, torch.result_type(x, b))
    return _empty(shape, dtype)


def _binary(kind: str) -> Callable:
    def rule(args, kwargs):
        a, b = args[0], _arg(args, kwargs, 1, "other")
        shape = broadcast(_shape(a), _shape(b))
        if kind == "bool":
            dtype = torch.bool
        else:
            dtype = torch.result_type(a, b)
            if kind == "div" and _arg(args, kwargs, 2, "rounding_mode") is None:
                dtype = _float_of(dtype)
            elif kind == "float":
                dtype = _float_of(dtype)
        return _empty(shape, dtype)

    return rule


def _inplace(rule: Callable) -> Callable:
    """``x.op_(...)``: the out-of-place rule's result must broadcast onto
    ``x``, which is the result. Torch's ``meta`` kernels leave the dtype
    cast unchecked, and so does this rule."""

    def inplace(args, kwargs):
        x = args[0]
        out = rule(args, kwargs)
        if tuple(out.shape) != tuple(x.shape):
            raise RuntimeError(
                f"output with shape {list(x.shape)} doesn't match the broadcast shape {list(out.shape)}"
            )
        return x

    return inplace


def _where(args, kwargs):
    if len(args) + len(kwargs) < 3:
        return NotImplemented
    cond, a, b = args[0], _arg(args, kwargs, 1, "input"), _arg(args, kwargs, 2, "other")
    if cond.dtype != torch.bool:
        raise RuntimeError(f"where expected condition to be a boolean tensor, but got a tensor with dtype {cond.dtype}")
    shape = broadcast(cond.shape, _shape(a), _shape(b))
    return _empty(shape, torch.result_type(a, b))


# --------------------------------------------------------------- products


def _matmul(args, kwargs):
    a, b = args[0], args[1]
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return NotImplemented
    if a.dim() == 0 or b.dim() == 0:
        raise RuntimeError("both arguments to matmul need to be at least 1D")
    # Torch's meta kernels for mm and matmul take mixed dtypes and give
    # the first operand's (the card's kernels refuse them; bmm's meta
    # kernel does too).
    sa, sb = tuple(a.shape), tuple(b.shape)
    lead = sa if a.dim() > 1 else (1,) + sa
    trail = sb if b.dim() > 1 else sb + (1,)
    if lead[-1] != trail[-2]:
        raise RuntimeError(
            f"mat1 and mat2 shapes cannot be multiplied ({lead[-2]}x{lead[-1]} and {trail[-2]}x{trail[-1]})"
        )
    batch = broadcast(lead[:-2], trail[:-2])
    out = batch + ((lead[-2],) if a.dim() > 1 else ()) + ((trail[-1],) if b.dim() > 1 else ())
    return _empty(out, a.dtype)


def _rmatmul(args, kwargs):
    return _matmul((args[1], args[0]), kwargs)


def _mm(ndim: int) -> Callable:
    def rule(args, kwargs):
        a, b = args[0], _arg(args, kwargs, 1, "mat2")
        if a.dim() != ndim or b.dim() != ndim:
            raise RuntimeError(f"expected {ndim}D tensors, got {a.dim()}D and {b.dim()}D")
        if ndim == 3 and a.dtype != b.dtype:
            raise RuntimeError(f"expected scalar type {a.dtype} but found {b.dtype}")
        if ndim == 3 and a.shape[0] != b.shape[0]:
            raise RuntimeError(f"batch1 and batch2 must have same number of batches, got {a.shape[0]} and {b.shape[0]}")
        return _matmul((a, b), {})

    return rule


def _outer(args, kwargs):
    a, b = args[0], _arg(args, kwargs, 1, "vec2")
    if a.dim() != 1 or b.dim() != 1:
        raise RuntimeError("outer: expected 1D tensors")
    return _empty((a.shape[0], b.shape[0]), torch.result_type(a, b))


# ------------------------------------------------------------- reductions


def _reduce(kind: str) -> Callable:
    def rule(args, kwargs):
        x = args[0]
        dim = _arg(args, kwargs, 1, "dim")
        if kind == "norm":
            # Tensor.norm(p, dim, keepdim) / linalg.vector_norm(x, ord, dim, keepdim)
            dim = _arg(args, kwargs, 2, "dim")
            keepdim = bool(_arg(args, kwargs, 3, "keepdim", False))
        elif kind in ("var", "std"):
            # var(input, dim, unbiased, keepdim): the third place is the
            # legacy ``unbiased`` flag, and a bool second place is too.
            dim = None if isinstance(dim, bool) else dim
            keepdim = bool(_arg(args, kwargs, 3, "keepdim", False))
        else:
            keepdim = bool(_arg(args, kwargs, 2, "keepdim", False))
        dims = _dims(dim, x.dim())
        if dims is None:
            shape: Shape = tuple(1 for _ in x.shape) if keepdim else ()
        else:
            shape = tuple(
                (1 if keepdim else None) if i in dims else s for i, s in enumerate(x.shape)
            )
            shape = tuple(s for s in shape if s is not None)
        dtype = kwargs.get("dtype")
        if dtype is None:
            if kind == "sum":
                dtype = x.dtype if (x.dtype.is_floating_point or x.dtype.is_complex) else torch.int64
            elif kind in ("mean", "var", "std", "norm", "logsumexp"):
                if kind == "mean" and not (x.dtype.is_floating_point or x.dtype.is_complex):
                    raise RuntimeError(
                        f"mean(): could not infer output dtype. Input dtype must be either a floating point "
                        f"or complex dtype. Got: {x.dtype}"
                    )
                dtype = _real_of(_float_of(x.dtype)) if kind != "mean" else x.dtype
            elif kind == "bool":
                dtype = torch.bool
            elif kind == "index":
                dtype = torch.int64
            else:
                dtype = x.dtype
        return _empty(shape, dtype)

    return rule


def _max_min(result: Any) -> Callable:
    """``max``/``min``: over everything, over a dim (``result``'s
    (values, indices) pair), or elementwise against another tensor."""

    def rule(args, kwargs):
        x, other = args[0], _arg(args, kwargs, 1, "dim")
        if isinstance(other, torch.Tensor):
            return _binary("same")((x, other), {})
        if other is None:
            return _empty((), x.dtype)
        d = _wrap_dim(int(other), x.dim())
        shape = list(x.shape)
        if _arg(args, kwargs, 2, "keepdim", False):
            shape[d] = 1
        else:
            del shape[d]
        return result((_empty(shape, x.dtype), _empty(shape, torch.int64)))

    return rule


def _cumulative(args, kwargs):
    x = args[0]
    _wrap_dim(int(_arg(args, kwargs, 1, "dim")), x.dim())
    dtype = kwargs.get("dtype")
    if dtype is None:
        dtype = x.dtype if (x.dtype.is_floating_point or x.dtype.is_complex) else torch.int64
    return _empty(x.shape, dtype)


def _softmax(args, kwargs):
    x = args[0]
    _wrap_dim(int(_arg(args, kwargs, 1, "dim")), x.dim())
    dtype = kwargs.get("dtype") or x.dtype
    if not dtype.is_floating_point:
        raise RuntimeError(f"softmax not implemented for '{dtype}'")
    return _empty(x.shape, dtype)


# ---------------------------------------------------------- joins and FFTs


def _cat(args, kwargs):
    tensors = list(_arg(args, kwargs, 0, "tensors"))
    dim = int(_arg(args, kwargs, 1, "dim", 0))
    live = [t for t in tensors if not (t.dim() == 1 and t.shape[0] == 0)]
    if not live:
        return _empty((0,), tensors[0].dtype if tensors else torch.get_default_dtype())
    ndim = live[0].dim()
    if ndim == 0:
        raise RuntimeError("zero-dimensional tensor cannot be concatenated")
    d = _wrap_dim(dim, ndim)
    for k, t in enumerate(live):
        if t.dim() != ndim:
            raise RuntimeError(
                f"Tensors must have same number of dimensions: got {ndim} and {t.dim()}"
            )
        for i in range(ndim):
            if i != d and t.shape[i] != live[0].shape[i]:
                raise RuntimeError(
                    f"Sizes of tensors must match except in dimension {d}. Expected size "
                    f"{live[0].shape[i]} but got size {t.shape[i]} for tensor number {k} in the list."
                )
    shape = list(live[0].shape)
    shape[d] = sum(t.shape[d] for t in live)
    return _empty(shape, _promote(live))


def _promote(tensors: Sequence[torch.Tensor]) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _stack(args, kwargs):
    tensors = list(_arg(args, kwargs, 0, "tensors"))
    dim = int(_arg(args, kwargs, 1, "dim", 0))
    if not tensors:
        raise RuntimeError("stack expects a non-empty TensorList")
    for k, t in enumerate(tensors):
        if tuple(t.shape) != tuple(tensors[0].shape):
            raise RuntimeError(
                f"stack expects each tensor to be equal size, but got {list(tensors[0].shape)} at entry 0 "
                f"and {list(t.shape)} at entry {k}"
            )
    d = _wrap_dim(dim, tensors[0].dim() + 1)
    shape = list(tensors[0].shape)
    shape.insert(d, len(tensors))
    return _empty(shape, _promote(tensors))


def _fft(kind: str) -> Callable:
    def rule(args, kwargs):
        x = args[0]
        n = _arg(args, kwargs, 1, "n")
        d = _wrap_dim(int(_arg(args, kwargs, 2, "dim", -1)), x.dim())
        size = x.shape[d]
        shape = list(x.shape)
        if kind == "rfft":
            if x.dtype.is_complex:
                raise RuntimeError(f"rfft expects a real input tensor, but got {x.dtype}")
            n = size if n is None else int(n)
            shape[d] = n // 2 + 1
            dtype = _complex_of(_float_of(x.dtype))
        elif kind == "irfft":
            n = 2 * (size - 1) if n is None else int(n)
            shape[d] = n
            dtype = _real_of(_complex_of(_float_of(x.dtype)))
        else:
            shape[d] = size if n is None else int(n)
            dtype = _complex_of(_float_of(x.dtype))
        if shape[d] < 1:
            raise RuntimeError(f"Invalid number of data points ({shape[d]}) specified")
        return _empty(shape, dtype)

    return rule


def _sort(result: Any) -> Callable:
    def rule(args, kwargs):
        x = args[0]
        _wrap_dim(int(_arg(args, kwargs, 1, "dim", -1)), x.dim())
        values, indices = _empty(x.shape, x.dtype), _empty(x.shape, torch.int64)
        return indices if result is None else result((values, indices))

    return rule


def _same_shape(args, kwargs):
    return _empty(args[0].shape, args[0].dtype)


def _arange(args, kwargs):
    """``torch.arange(end)``, ``(start, end)``, ``(start, end, step)`` on
    ``meta``: its length, and int64 unless a bound is a float."""
    import math

    bounds = list(args) if len(args) > 1 else [0, args[0]] if args else [kwargs.get("start", 0), kwargs["end"]]
    start, end = bounds[0], bounds[1]
    step = bounds[2] if len(bounds) > 2 else kwargs.get("step", 1)
    if step == 0:
        raise RuntimeError("step must be nonzero")
    n = max(0, math.ceil((end - start) / step))
    floating = any(isinstance(v, float) for v in (start, end, step))
    dtype = kwargs.get("dtype") or (torch.get_default_dtype() if floating else torch.int64)
    return _empty((n,), dtype)


def _getitem(args, kwargs):
    """``x[index]`` where ``index`` holds a tensor (or a list): torch's
    advanced indexing. The basic part (ints, slices, ``None``,
    ``Ellipsis``) runs as the view it is, with each tensor taken as a
    full slice; the tensors' broadcast shape then replaces the dims they
    index, in place when those dims are adjacent in the view, in front
    otherwise. A bool mask's result is data-dependent: refused as
    torch's ``meta`` kernel refuses it. Basic indexing passes through."""
    x, index = args[0], args[1]
    items = list(index) if isinstance(index, tuple) else [index]
    advanced = [isinstance(i, (torch.Tensor, list)) for i in items]
    if not any(advanced) or any(isinstance(i, bool) for i in items):
        return NotImplemented
    shapes = []
    for i in items:
        if isinstance(i, torch.Tensor):
            if i.dtype in (torch.bool, torch.uint8):
                raise NotImplementedError("a boolean mask index needs nonzero(), which is data-dependent on meta")
            if i.dtype.is_floating_point or i.dtype.is_complex:
                raise RuntimeError("tensors used as indices must be long, int, byte or bool tensors")
            shapes.append(tuple(i.shape))
        elif isinstance(i, list):
            import numpy as np

            shapes.append(np.shape(i))
    view = x[tuple(slice(None) if a else i for i, a in zip(items, advanced))]
    # Each item's position among the view's dims: ints take theirs away,
    # None adds one, an Ellipsis stands for the dims no other item names.
    spans = sum(1 for i in items if i is not None and i is not Ellipsis)
    dims, d = [], 0
    for i, a in zip(items, advanced):
        if a:
            dims.append(d)
        if i is Ellipsis:
            d += x.dim() - spans
        elif not isinstance(i, int):
            d += 1
    for k, d in enumerate(dims):
        if view.shape[d] == 0 and any(shapes[k]):
            raise IndexError(f"index is out of bounds for dimension {d} with size 0")
    batch = broadcast(*shapes)
    rest = [s for k, s in enumerate(view.shape) if k not in dims]
    if dims == list(range(dims[0], dims[0] + len(dims))):
        shape = rest[: dims[0]] + list(batch) + rest[dims[0]:]
    else:
        shape = list(batch) + rest
    return _empty(shape, x.dtype)


def _like(args, kwargs):
    x = args[0]
    return _empty(x.shape, kwargs.get("dtype") or x.dtype)


def _index_select(args, kwargs):
    x, dim, index = args[0], _arg(args, kwargs, 1, "dim"), _arg(args, kwargs, 2, "index")
    d = _wrap_dim(int(dim), x.dim())
    if index.dim() > 1:
        raise IndexError("index_select(): Index is supposed to be a vector")
    shape = list(x.shape)
    if shape:
        shape[d] = index.numel()
    return _empty(shape, x.dtype)


def _gather(args, kwargs):
    x, dim, index = args[0], _arg(args, kwargs, 1, "dim"), _arg(args, kwargs, 2, "index")
    _wrap_dim(int(dim), x.dim())
    if index.dim() != x.dim():
        raise RuntimeError("Index tensor must have the same number of dimensions as input tensor")
    return _empty(index.shape, x.dtype)


def _pad(args, kwargs):
    x, pad = args[0], list(_arg(args, kwargs, 1, "pad"))
    if len(pad) % 2 or len(pad) // 2 > x.dim():
        raise RuntimeError("Padding length must be divisible by 2 and at most twice the input's dimensions")
    shape = list(x.shape)
    for k in range(len(pad) // 2):
        shape[-1 - k] += int(pad[2 * k]) + int(pad[2 * k + 1])
        if shape[-1 - k] < 0:
            raise RuntimeError(f"The input size {x.shape[-1 - k]}, plus negative padding gives a negative size")
    return _empty(shape, x.dtype)


def _conv_out(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _pair(v: Any, n: int) -> List[int]:
    return [int(u) for u in v] if isinstance(v, (list, tuple)) else [int(v)] * n


def _conv(nd: int) -> Callable:
    def rule(args, kwargs):
        x, w = args[0], _arg(args, kwargs, 1, "weight")
        bias = _arg(args, kwargs, 2, "bias")
        stride = _pair(_arg(args, kwargs, 3, "stride", 1), nd)
        padding = _arg(args, kwargs, 4, "padding", 0)
        if isinstance(padding, str):
            return NotImplemented
        padding = _pair(padding, nd)
        dilation = _pair(_arg(args, kwargs, 5, "dilation", 1), nd)
        groups = int(_arg(args, kwargs, 6, "groups", 1))
        batched = x.dim() == nd + 2
        if x.dim() not in (nd + 1, nd + 2) or w.dim() != nd + 2:
            raise RuntimeError(
                f"Expected {nd + 1}D (unbatched) or {nd + 2}D (batched) input to conv{nd}d, "
                f"but got input of size: {list(x.shape)}"
            )
        channels = x.shape[1] if batched else x.shape[0]
        if channels != w.shape[1] * groups:
            raise RuntimeError(
                f"Given groups={groups}, weight of size {list(w.shape)}, expected input{list(x.shape)} to have "
                f"{w.shape[1] * groups} channels, but got {channels} channels instead"
            )
        if bias is not None and tuple(bias.shape) != (w.shape[0],):
            raise RuntimeError(f"bias of size {list(bias.shape)} does not match {w.shape[0]} output channels")
        spatial = [
            _conv_out(s, k, st, p, dl)
            for s, k, st, p, dl in zip(x.shape[-nd:], w.shape[2:], stride, padding, dilation)
        ]
        if any(s < 1 for s in spatial):
            raise RuntimeError(
                f"Calculated output size: {spatial}. Output size is too small (input size {list(x.shape)})"
            )
        lead = (x.shape[0],) if batched else ()
        return _empty(lead + (w.shape[0],) + tuple(spatial), x.dtype)

    return rule


def _pool(nd: int) -> Callable:
    def rule(args, kwargs):
        x = args[0]
        k = _pair(_arg(args, kwargs, 1, "kernel_size"), nd)
        stride = _arg(args, kwargs, 2, "stride")
        stride = k if stride in (None, [], ()) else _pair(stride, nd)
        padding = _pair(_arg(args, kwargs, 3, "padding", 0), nd)
        if kwargs.get("ceil_mode") or (len(args) > 4 and args[4]):
            return NotImplemented
        if x.dim() not in (nd + 1, nd + 2):
            raise RuntimeError(f"non-empty {nd + 1}D or {nd + 2}D (batch mode) tensor expected for input")
        spatial = [_conv_out(s, kk, st, p, 1) for s, kk, st, p in zip(x.shape[-nd:], k, stride, padding)]
        if any(s < 1 for s in spatial):
            raise RuntimeError(f"Given input size: {list(x.shape)}. Calculated output size: {spatial}. Output size is too small")
        return _empty(tuple(x.shape[:-nd]) + tuple(spatial), x.dtype)

    return rule


# -------------------------------------------------------------- the table

_FLOAT_UNARY = (
    "tanh sin cos exp expm1 log log1p log2 log10 sqrt rsqrt sigmoid erf atan asin acos sinh cosh reciprocal"
).split()
_SAME_UNARY = "neg negative relu floor ceil round trunc sign square positive conj nan_to_num".split()
_BOOL_UNARY = "isnan isinf isfinite logical_not".split()
_BINARY_SAME = (
    "add sub subtract mul multiply rsub maximum minimum remainder fmod pow floor_divide "
    "bitwise_and bitwise_or bitwise_xor __add__ __radd__ __sub__ __rsub__ __mul__ __rmul__ __pow__ "
    "__rpow__ __mod__ __rmod__ __floordiv__ __rfloordiv__ __and__ __rand__ __or__ __ror__ __xor__ __rxor__"
).split()
_BINARY_DIV = "div divide true_divide __truediv__ __rtruediv__ __div__ __rdiv__".split()
_BINARY_BOOL = (
    "eq ne lt le gt ge greater less greater_equal less_equal not_equal __eq__ __ne__ __lt__ __le__ __gt__ "
    "__ge__ logical_and logical_or logical_xor"
).split()
_BINARY_FLOAT = "atan2 arctan2".split()

RULES: Dict[str, Callable] = {}
for _n in _FLOAT_UNARY:
    RULES[_n] = _unary("float")
for _n in _SAME_UNARY:
    RULES[_n] = _unary("same")
for _n in _BOOL_UNARY:
    RULES[_n] = _unary("bool")
RULES["abs"] = RULES["absolute"] = _unary("abs")
for _n in ("clamp", "clip"):
    RULES[_n] = _clamp
RULES["clamp_min"] = lambda args, kwargs: _clamp((args[0], _arg(args, kwargs, 1, "min"), None), {})
RULES["clamp_max"] = lambda args, kwargs: _clamp((args[0], None, _arg(args, kwargs, 1, "max")), {})
for _n in _BINARY_SAME:
    RULES[_n] = _binary("same")
for _n in _BINARY_DIV:
    RULES[_n] = _binary("div")
for _n in _BINARY_BOOL:
    RULES[_n] = _binary("bool")
for _n in _BINARY_FLOAT:
    RULES[_n] = _binary("float")
RULES["where"] = _where
RULES["matmul"] = RULES["__matmul__"] = _matmul
RULES["__rmatmul__"] = _rmatmul
RULES["mm"] = _mm(2)
RULES["bmm"] = _mm(3)
RULES["outer"] = _outer
for _n, _k in (
    ("sum", "sum"), ("prod", "sum"), ("mean", "mean"), ("amax", "same"), ("amin", "same"),
    ("logsumexp", "logsumexp"), ("var", "var"), ("std", "std"), ("any", "bool"), ("all", "bool"),
    ("argmax", "index"), ("argmin", "index"), ("norm", "norm"), ("linalg_vector_norm", "norm"),
):
    RULES[_n] = _reduce(_k)
RULES["max"] = _max_min(torch.return_types.max)
RULES["min"] = _max_min(torch.return_types.min)
RULES["cumsum"] = RULES["cumprod"] = _cumulative
RULES["softmax"] = RULES["log_softmax"] = _softmax
RULES["cat"] = RULES["concat"] = RULES["concatenate"] = _cat
RULES["stack"] = _stack
RULES["fft_rfft"] = _fft("rfft")
RULES["fft_irfft"] = _fft("irfft")
RULES["fft_fft"] = RULES["fft_ifft"] = _fft("fft")
for _n in ("empty_like", "zeros_like", "ones_like", "full_like", "rand_like", "randn_like"):
    RULES[_n] = _like
RULES["sort"] = _sort(torch.return_types.sort)
RULES["argsort"] = _sort(None)
RULES["flip"] = _same_shape
RULES["__getitem__"] = _getitem
RULES["index_select"] = _index_select
RULES["gather"] = RULES["take_along_dim"] = _gather
RULES["pad"] = _pad
RULES["conv2d"] = _conv(2)
RULES["avg_pool2d"] = RULES["max_pool2d"] = _pool(2)
for _n in list(RULES):
    if not _n.startswith("_") and _n + "_" not in RULES:
        RULES[_n + "_"] = _inplace(RULES[_n])
for _n in ("__iadd__", "__isub__", "__imul__", "__itruediv__", "__ipow__", "__iand__", "__ior__", "__ixor__"):
    RULES[_n] = _inplace(RULES["__" + _n[3:]])

#: Factories of a computed shape, answered when asked for ``meta``.
FACTORIES: Dict[str, Callable] = {"arange": _arange}

#: Ops that stay in C++ on ``meta`` (views, basic indexing, conversions,
#: metadata reads, factories with an explicit shape): they pass through
#: uncounted, as does a rule's own decline (``NotImplemented``) for them.
CHEAP = frozenset(
    (
        "__get__ __getitem__ __len__ __iter__ __repr__ __format__ __bool__ __index__ __hash__ __setstate__ "
        "__reduce_ex__ __deepcopy__ size dim ndimension numel nelement element_size stride storage_offset "
        "is_contiguous is_complex is_floating_point is_signed data_ptr reshape view view_as reshape_as flatten "
        "unflatten unsqueeze squeeze permute transpose swapaxes swapdims t movedim moveaxis expand expand_as "
        "broadcast_to narrow select chunk split tensor_split unbind contiguous clone detach detach_ to type "
        "float double half bfloat16 int long bool short byte char cfloat cdouble real imag view_as_real "
        "view_as_complex new_empty new_zeros new_ones new_full empty empty_strided zeros ones full arange "
        "requires_grad_ as_strided diagonal numpy tolist unfold __setitem__ as_tensor tensor copy_ fill_ zero_"
    ).split()
)


class ShapeRules(TorchFunctionMode):
    """Answer torch ops on ``meta`` tensors from :data:`RULES`; see the
    module docstring. Ops on any other device run as they are."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in FACTORIES:
            if torch.device(kwargs.get("device") or "cpu").type == "meta":
                return FACTORIES[name](args, kwargs)
            return func(*args, **kwargs)
        meta = [t.device.type == "meta" for t in _tensors(args, kwargs)]
        if any(meta):
            rule = RULES.get(name)
            # An index tensor may lie on any device: only its shape counts.
            if rule is not None and (all(meta) or name == "__getitem__"):
                out = rule(args, kwargs)
                if out is not NotImplemented:
                    return out
            if name not in CHEAP:
                FALLBACKS[name or repr(func)] += 1
        return func(*args, **kwargs)


def _tensors(args: tuple, kwargs: dict):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


