"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's own name, ``keystone_tpu_torch``,
begins with the JAX package's); ``kbench/reference/`` imports nothing of
the port either."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from kbench.harness.env import FORBIDDEN_TOP_LEVEL, forbidden_modules
from kbench.harness.layout import KBENCH_DIR

ROOT = KBENCH_DIR.parent


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_source_file_imports_jax_or_the_jax_package():
    for path in KBENCH_DIR.rglob("*.py"):
        found = set(_imported_top_levels(path)) & set(FORBIDDEN_TOP_LEVEL)
        assert not found, f"{path} imports {found}"


def test_reference_sources_import_nothing_of_the_port():
    for path in (KBENCH_DIR / "reference").rglob("*.py"):
        tops = set(_imported_top_levels(path))
        assert "keystone_tpu_torch" not in tops, path
        assert tops <= {"__future__", "typing", "contextlib", "numpy", "torch", "kbench"}, (path, tops)


def test_forbidden_names_are_compared_whole():
    modules = {"keystone_tpu_torch": 1, "keystone_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen.x": 1}
    assert forbidden_modules(modules) == []
    assert forbidden_modules({"keystone_tpu.ops": 1, "jax": 1, "jax.numpy": 1}) == ["jax", "jax.numpy", "keystone_tpu.ops"]


_PROBE = r"""
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
mode = sys.argv[2]
if mode == "reference":
    for name in ("common", "timit_cosine", "cifar_random_patch"):
        importlib.import_module("kbench.reference." + name)
else:
    import torch
    from kbench.tests.tiny import tiny_run
    run = tiny_run("timit.fit", seconds=0.3)
    assert run.readings
tops = sorted({m.split(".", 1)[0] for m in sys.modules})
print(json.dumps(tops))
"""


def _top_levels_after(mode):
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT), mode], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT), env=dict(os.environ, KEYSTONE_PROFILE_STORE="off"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_modules_load_nothing_of_the_port():
    tops = _top_levels_after("reference")
    assert "keystone_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN_TOP_LEVEL)


def test_a_whole_run_loads_no_jax():
    tops = _top_levels_after("run")
    assert "keystone_tpu_torch" in tops
    assert not tops & set(FORBIDDEN_TOP_LEVEL)
