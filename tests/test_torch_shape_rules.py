"""The plan-time tracer's shape rules (``workflow/shape_rules.py``) held
against torch's own ``meta`` kernels.

Each case runs once under :class:`ShapeRules` and once without it, on the
same ``meta`` operands: the two give the same shapes and dtypes, or both
raise, and both rejections read alike to the verifier (a shape error,
KV101, or not). A fresh process verifies the MNIST plan without importing
torch's symbolic-shape machinery, the cost the rules exist to avoid.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from keystone_tpu_torch.workflow import shape_rules as sr
from keystone_tpu_torch.workflow.verify import is_shape_error

REPO = Path(__file__).resolve().parents[1]


def m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


I32, I64, F64, C64, B = torch.int32, torch.int64, torch.float64, torch.complex64, torch.bool

#: name → a function of no arguments that runs the op on ``meta`` operands.
CASES = {
    "tanh": lambda: torch.tanh(m(4, 5)),
    "tanh_int": lambda: torch.tanh(m(4, 5, dtype=I32)),
    "cos_f64": lambda: torch.cos(m(3, dtype=F64)),
    "sqrt_method": lambda: m(2, 3).sqrt(),
    "exp_log": lambda: torch.log(torch.exp(m(2, 3))),
    "abs_complex": lambda: torch.abs(m(3, 4, dtype=C64)),
    "abs_int": lambda: m(3, dtype=I32).abs(),
    "neg": lambda: -m(2, 2),
    "relu": lambda: F.relu(m(2, 7)),
    "floor_int": lambda: torch.floor(m(3, dtype=I64)),
    "sign": lambda: torch.sign(m(3, 1)),
    "isfinite": lambda: torch.isfinite(m(3, 2)),
    "clamp_scalar": lambda: torch.clamp(m(4, 3), min=0.0),
    "clamp_int_by_float": lambda: torch.clamp(m(4, 3, dtype=I32), min=0.5),
    "clamp_min": lambda: torch.clamp_min(m(4, 3), 1e-6),
    "clamp_max_tensor": lambda: m(4, 3).clamp_max(m(3)),
    "add_broadcast": lambda: m(4, 1, 3) + m(5, 1),
    "add_mismatch": lambda: m(4, 3) + m(4, 2),
    "add_int_float": lambda: m(4, dtype=I32) + m(4),
    "add_int_scalar_float": lambda: m(4, dtype=I32) + 1.5,
    "mul_f64_f32": lambda: m(4, 2, dtype=F64) * m(4, 2),
    "mul_tensor_f64_scalar": lambda: m(3) * 2.0,
    "rsub": lambda: 1.0 - m(3, 2),
    "div_int": lambda: m(3, dtype=I64) / m(3, dtype=I64),
    "div_floor": lambda: torch.div(m(3, dtype=I64), 2, rounding_mode="floor"),
    "rtruediv": lambda: 1.0 / m(2, 5),
    "pow": lambda: m(2, 5) ** 2,
    "maximum": lambda: torch.maximum(m(2, 5), m(5)),
    "remainder": lambda: torch.remainder(m(6, dtype=I64), 4),
    "eq": lambda: m(3, 4) == m(4),
    "gt_scalar": lambda: m(3, 4) > 0,
    "logical_and": lambda: torch.logical_and(m(3, dtype=B), m(3, dtype=B)),
    "atan2": lambda: torch.atan2(m(3), m(3)),
    "where": lambda: torch.where(m(4, 1, dtype=B), m(4, 3), 0.0),
    "where_mismatch": lambda: torch.where(m(4, 2, dtype=B), m(4, 3), m(4, 3)),
    "inplace_add": lambda: m(4, 3).add_(m(3)),
    "inplace_broadcast_fails": lambda: m(4, 1).add_(m(4, 3)),
    "inplace_int_by_float": lambda: m(4, dtype=I32).mul_(m(4)),
    "iadd": lambda: _iadd(m(4, 3), m(4, 3)),
    "matmul_2d": lambda: m(8, 5) @ m(5, 3),
    "matmul_mismatch": lambda: m(8, 5) @ m(4, 3),
    "matmul_vec": lambda: m(8, 5) @ m(5),
    "vec_matmul": lambda: m(5) @ m(5, 3),
    "matmul_batched": lambda: torch.matmul(m(2, 1, 8, 5), m(3, 5, 4)),
    "matmul_dtype": lambda: m(8, 5) @ m(5, 3, dtype=F64),
    "bmm_dtype": lambda: torch.bmm(m(6, 2, 3), m(6, 3, 4, dtype=F64)),
    "arange": lambda: torch.arange(7, device="meta"),
    "arange_start_step": lambda: torch.arange(2, 11, 3, device="meta"),
    "arange_float": lambda: torch.arange(0.0, 1.0, 0.25, device="meta"),
    "arange_dtype": lambda: torch.arange(5, dtype=torch.float32, device=torch.device("meta")),
    "mm": lambda: torch.mm(m(2, 3), m(3, 4)),
    "mm_3d": lambda: torch.mm(m(2, 2, 3), m(3, 4)),
    "bmm": lambda: torch.bmm(m(6, 2, 3), m(6, 3, 4)),
    "bmm_batches": lambda: torch.bmm(m(6, 2, 3), m(5, 3, 4)),
    "outer": lambda: torch.outer(m(3), m(4)),
    "sum_all": lambda: m(4, 5).sum(),
    "sum_dim": lambda: torch.sum(m(4, 5, 6), dim=1),
    "sum_dims_keep": lambda: m(4, 5, 6).sum(dim=(0, 2), keepdim=True),
    "sum_int": lambda: m(4, 5, dtype=I32).sum(0),
    "sum_bool": lambda: m(4, dtype=B).sum(),
    "sum_dtype": lambda: m(4, 5).sum(1, dtype=F64),
    "sum_bad_dim": lambda: m(4, 5).sum(2),
    "mean": lambda: torch.mean(m(4, 5), 0, keepdim=True),
    "mean_int": lambda: m(4, dtype=I32).mean(),
    "amax": lambda: m(4, 5).amax(1),
    "max_dim": lambda: m(4, 5).max(1).values,
    "max_dim_indices": lambda: torch.max(m(4, 5), dim=0, keepdim=True).indices,
    "max_all": lambda: m(4, 5).max(),
    "min_binary": lambda: torch.min(m(4, 5), m(5)),
    "argmax": lambda: torch.argmax(m(4, 5), dim=1),
    "argmax_all": lambda: m(4, 5).argmax(),
    "any_dim": lambda: m(4, 5, dtype=B).any(1),
    "logsumexp": lambda: torch.logsumexp(m(4, 5), dim=1),
    "var": lambda: m(4, 5).var(dim=0),
    "std_keep": lambda: m(4, 5).std(dim=1, keepdim=True),
    "norm_dim": lambda: m(4, 5).norm(dim=1),
    "vector_norm": lambda: torch.linalg.vector_norm(m(4, 5), 2, 1, True),
    "vector_norm_all": lambda: torch.linalg.vector_norm(m(4, 5)),
    "cumsum": lambda: torch.cumsum(m(4, 5), 1),
    "cumsum_int": lambda: m(4, 5, dtype=I32).cumsum(0),
    "softmax": lambda: torch.softmax(m(4, 5), 1),
    "log_softmax": lambda: F.log_softmax(m(4, 5), dim=-1),
    "cat": lambda: torch.cat([m(4, 2), m(4, 3)], 1),
    "cat_promote": lambda: torch.cat([m(4, 2), m(4, 3, dtype=F64)], dim=1),
    "cat_mismatch": lambda: torch.cat([m(4, 2), m(5, 3)], 1),
    "cat_ndim": lambda: torch.cat([m(4, 2), m(4, 2, 1)], 1),
    "stack": lambda: torch.stack([m(4, 2), m(4, 2)], dim=1),
    "stack_mismatch": lambda: torch.stack([m(4, 2), m(4, 3)]),
    "rfft": lambda: torch.fft.rfft(m(4, 10)),
    "rfft_n": lambda: torch.fft.rfft(m(4, 10), n=16),
    "rfft_dim": lambda: torch.fft.rfft(m(6, 10, dtype=F64), dim=0),
    "irfft": lambda: torch.fft.irfft(m(4, 9, dtype=C64)),
    "irfft_n": lambda: torch.fft.irfft(m(4, 9, dtype=C64), n=15),
    "fft": lambda: torch.fft.fft(m(4, 8)),
    "ifft_n": lambda: torch.fft.ifft(m(4, 8, dtype=C64), n=4),
    "zeros_like": lambda: torch.zeros_like(m(4, 5, dtype=I32)),
    "full_like": lambda: torch.full_like(m(4, 5), 2.0, dtype=F64),
    "empty_like": lambda: torch.empty_like(m(3, 1)),
    "index_select": lambda: torch.index_select(m(4, 5), 1, m(3, dtype=I64)),
    "getitem_rows": lambda: m(16, 5)[m(3, dtype=I64)],
    "getitem_cols": lambda: m(16, 5)[:, m(2, 3, dtype=I64)],
    "getitem_two_adjacent": lambda: m(4, 5, 6, 7)[:, m(3, dtype=I64), m(2, 1, dtype=I64)],
    "getitem_split": lambda: m(4, 5, 6, 7)[m(3, dtype=I64), :, m(3, dtype=I64)],
    "getitem_int_between": lambda: m(4, 5, 6)[m(3, dtype=I64), 1, m(3, dtype=I64)],
    "getitem_int_first": lambda: m(4, 5, 6)[0, :, m(2, dtype=I32)],
    "getitem_ellipsis": lambda: m(4, 5, 6)[..., m(2, dtype=I64)],
    "getitem_none": lambda: m(4, 5)[None, m(3, dtype=I64)],
    "getitem_slice_step": lambda: m(8, 5)[1:7:2, m(3, dtype=I64)],
    "getitem_cpu_index": lambda: m(8, 5)[torch.tensor([0, 2, 4])],
    "getitem_list": lambda: m(8, 5)[:, [0, 1]],
    "getitem_bool_mask": lambda: m(8, 5)[m(8, dtype=B)],
    "getitem_float_index": lambda: m(8, 5)[m(3)],
    "getitem_broadcast_fails": lambda: m(4, 5)[m(3, dtype=I64), m(2, dtype=I64)],
    "getitem_basic": lambda: m(8, 5)[2:, 1],
    "gather": lambda: torch.gather(m(4, 5), 1, m(4, 2, dtype=I64)),
    "sort": lambda: torch.sort(m(4, 5), dim=1).indices,
    "argsort": lambda: torch.argsort(m(4, 5), dim=0),
    "flip": lambda: torch.flip(m(4, 5), [0]),
    "pad": lambda: F.pad(m(2, 3, 4), (1, 2)),
    "pad_2d": lambda: F.pad(m(2, 3, 4), (1, 2, 0, 3), value=-1.0),
    "conv2d": lambda: F.conv2d(m(2, 3, 16, 16), m(8, 3, 5, 5), m(8), stride=2, padding=1),
    "conv2d_channels": lambda: F.conv2d(m(2, 4, 16, 16), m(8, 3, 5, 5)),
    "conv2d_groups": lambda: F.conv2d(m(2, 4, 9, 9), m(8, 2, 3, 3), groups=2, dilation=2),
    "avg_pool2d": lambda: F.avg_pool2d(m(2, 3, 16, 15), (4, 1), stride=1),
    "avg_pool2d_pad": lambda: F.avg_pool2d(m(2, 3, 16, 16), 3, stride=2, padding=1),
    "max_pool2d": lambda: F.max_pool2d(m(2, 3, 16, 16), 2),
}


def _iadd(a, b):
    a += b
    return a


def _leaves(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _run(case, rules: bool):
    sr.FALLBACKS.clear()
    try:
        if rules:
            with sr.ShapeRules():
                out = CASES[case]()
        else:
            out = CASES[case]()
    except Exception as e:  # noqa: BLE001 - the exception is the reading
        return "raised", e
    return "ok", [(tuple(t.shape), t.dtype) for t in _leaves(out)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_equals_torchs_meta_kernel(case):
    kind, want = _run(case, rules=False)
    got_kind, got = _run(case, rules=True)
    assert sr.FALLBACKS == {}, f"{case} ran torch's own meta kernel: {dict(sr.FALLBACKS)}"
    assert got_kind == kind, (case, want, got)
    if kind == "ok":
        assert got == want
    else:
        assert is_shape_error(got) == is_shape_error(want), (case, want, got)


def test_broadcast_reads_as_torch_does():
    assert sr.broadcast((4, 1, 3), (5, 1), ()) == (4, 5, 3)
    with pytest.raises(RuntimeError, match="must match the size"):
        sr.broadcast((4, 3), (4, 2))


@pytest.mark.parametrize("op,want", [("kron", (8, 15)), ("conv1d", (2, 4, 16))])
def test_an_op_without_a_rule_runs_torchs_kernel_and_is_counted(op, want):
    sr.FALLBACKS.clear()
    with sr.ShapeRules():
        if op == "kron":
            out = torch.kron(m(2, 3), m(4, 5))
        else:
            out = F.conv1d(m(2, 3, 20), m(4, 3, 5))
    assert tuple(out.shape) == want
    assert sr.FALLBACKS[op] == 1


def test_ops_off_meta_run_as_they_are():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    sr.FALLBACKS.clear()
    with sr.ShapeRules():
        out = torch.tanh(a @ a.T).sum(1)
    assert torch.allclose(out, torch.tanh(a @ a.T).sum(1))
    assert out.device.type == "cpu" and sr.FALLBACKS == {}


_FRESH = r"""
import json, sys
import numpy as np
import torch
from keystone_tpu_torch.workflow import shape_rules as sr
a = torch.empty(16, 64, device="meta")
# Every op the rules pass through uncounted (sr.CHEAP) on a meta tensor.
a.reshape(4, 256).T.contiguous().view(-1).unsqueeze(0).squeeze(0).clone().detach()
a[:, :3]; a.narrow(1, 0, 3); a.select(0, 1); a.permute(1, 0).flatten(); a.expand(2, 16, 64)
a.to(torch.float64).float().double().half(); a.chunk(2, 1); a.split(32, 1); a.unbind(0); a.movedim(0, 1)
torch.empty(3, 4, device="meta"); torch.zeros(3, device="meta"); torch.ones(3, device="meta")
torch.full((2,), 1.0, device="meta"); a.new_empty((2, 3)); a.new_zeros((2,))
torch.empty_strided((3, 4), (4, 1), device="meta"); torch.as_tensor(a); a.unfold(1, 4, 4)
b = a.clone(); b[:, :3] = a[:, :3]; b.fill_(0); b.zero_(); b.copy_(a)
assert "torch.fx.experimental.symbolic_shapes" not in sys.modules, "a CHEAP op imported it"
from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.data.loaders.csv import LabeledData
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.verify import verify_graph
rng = np.random.default_rng(0)
data = LabeledData(ArrayDataset(rng.integers(0, 10, 64).astype(np.int32), device="cpu"),
                   ArrayDataset(rng.standard_normal((64, WIDTH)).astype(np.float32), device="cpu"))
config = MnistRandomFFTConfig(num_ffts=2, block_size=256)
graph, _ = PipelineEnv.get_or_create().optimizer.execute(build_pipeline(config, data, device="cpu").graph)
report = verify_graph(graph, context="fresh")
print(json.dumps({"codes": sorted({d.code for d in report.diagnostics}), "errors": len(report.errors()),
                  "fallbacks": dict(sr.FALLBACKS),
                  "symbolic_shapes": "torch.fx.experimental.symbolic_shapes" in sys.modules}))
"""


@pytest.mark.parametrize("width,refused", [(784, False), (783, True)])
def test_a_fresh_process_verifies_the_mnist_plan_without_torchs_meta_machinery(width, refused):
    """The fit hook's cost in a new process: the MNIST random-FFT plan
    (and its seeded 783-wide KV101) verify with every op answered by a
    rule, so torch's symbolic-shape machinery (sympy, dynamo) is never
    imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", _FRESH.replace("WIDTH", str(width))],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert (out["errors"] > 0) == refused, out
    assert ("KV101" in out["codes"]) == refused, out
    assert out["fallbacks"] == {} and out["symbolic_shapes"] is False, out
