"""The port's own keystone-lint (``keystone_tpu_torch/lint/``) over the
port.

``keystone_tpu_torch.lint`` parses its registries (the metric names of
``obs/names.py``, the probe sites of ``reliability/faultinject.py``) out
of the linted package's own source, so the port is held to the port's
registries. KV501–KV504 and KV506, and the KV6xx concurrency tier, must
read a clean tree; each rule must still fire on a seeded source; and on
the rules both packages have, the port's linter and the JAX package's
find the same things on the same seeded sources (the test imports the
JAX linter; the port never does).
"""

import os
import textwrap

import pytest

import keystone_tpu_torch
from keystone_tpu.lint import analyze_sources as j_analyze_sources
from keystone_tpu.lint.rules import lint_source as j_lint_source
from keystone_tpu_torch.lint import (
    CONCURRENCY_CODES,
    LINT_CODES,
    analyze_paths,
    analyze_sources,
    build_context,
    lint_paths,
    lint_source,
)

PORT_ROOT = os.path.dirname(os.path.abspath(keystone_tpu_torch.__file__))


@pytest.fixture(scope="module")
def port_findings():
    return lint_paths([PORT_ROOT])


@pytest.fixture(scope="module")
def port_concurrency():
    return analyze_paths([PORT_ROOT])


@pytest.mark.parametrize("rule", ["KV501", "KV502", "KV503", "KV504", "KV506"])
def test_port_tree_is_clean(port_findings, rule):
    found = [f.to_json() for f in port_findings if f.rule == rule]
    assert found == []


def test_port_tree_has_no_finding_at_all(port_findings):
    assert port_findings == []
    assert sorted(LINT_CODES) == ["KV501", "KV502", "KV503", "KV504", "KV506"]


def test_context_is_parsed_from_the_port():
    ctx = build_context(PORT_ROOT)
    assert "BlockLeastSquaresEstimator.solve" in ctx.probe_sites
    assert "keystone_solver_rung_attempts_total" in ctx.metric_names
    assert "keystone_executor_node_seconds" in ctx.metric_names


SEEDED = {
    "KV504": 'from keystone_tpu_torch.reliability import probe\nprobe("no.such.site")\n',
    "KV503": 'from keystone_tpu_torch.obs import names\nnames.metric("keystone_undeclared_series_total")\n',
    "KV501": 'import os\nknob = os.environ.get("KEYSTONE_SOMETHING")\n',
    "KV502": "import torch\n\ndef step(x):\n    return float(x.sum().item())\n",
    "KV506": "from keystone_tpu_torch.obs.cost import CostFacts\n\nfacts = CostFacts(1.0, 2.0)\n",
}

#: Where each seeded source is linted: KV502 looks only at the hot
#: modules (``workflow/executor.py`` is one).
SEEDED_PATH = {"KV502": os.path.join("workflow", "executor.py")}


def _seeded_path(rule):
    return os.path.join(PORT_ROOT, SEEDED_PATH.get(rule, os.path.join("workflow", "seeded.py")))


REGISTERED = (
    "from keystone_tpu_torch.obs import metrics\n"
    "from keystone_tpu_torch.reliability import probe\n"
    'probe("BlockLeastSquaresEstimator.solve")\n'
    'metrics.get_registry().counter("keystone_solver_rung_attempts_total")\n'
)


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_violation_is_caught_in_the_port_context(rule):
    ctx = build_context(PORT_ROOT)
    found = [f.rule for f in lint_source(SEEDED[rule], path=_seeded_path(rule), context=ctx)]
    assert found == [rule]


def test_registered_site_and_declared_metric_pass():
    ctx = build_context(PORT_ROOT)
    path = os.path.join(PORT_ROOT, "workflow", "seeded.py")
    assert lint_source(REGISTERED, path=path, context=ctx) == []


SYNC_CASES = {
    "item": "def f(x):\n    return x.item()\n",
    "cpu": "def f(x):\n    return x.cpu()\n",
    "tolist": "def f(x):\n    return x.tolist()\n",
    "cuda-synchronize": "import torch\n\ndef f():\n    torch.cuda.synchronize()\n",
    "event-synchronize": "def f(done):\n    done.synchronize()\n",
    "numpy-asarray": "import numpy as np\n\ndef f(x):\n    return np.asarray(x)\n",
}


@pytest.mark.parametrize("call", sorted(SYNC_CASES))
def test_kv502_sync_calls_gated_and_annotated(call):
    """Each of the port's sync calls is KV502 on a hot path, and passes
    under a ``sync`` gate, in a ``*sync*`` function, with the pragma, and
    anywhere off the hot modules."""
    hot = os.path.join(PORT_ROOT, "serving", "server.py")
    src = SYNC_CASES[call]
    assert [f.rule for f in lint_source(src, path=hot)] == ["KV502"]
    body = src.split("\n")
    gated = "\n".join(
        line if not line.startswith("    ") else "    if sync:\n    " + line for line in body
    ).replace("def f(", "def f(sync, ")
    assert lint_source(gated, path=hot) == []
    assert lint_source(src.replace("def f(", "def wait_sync("), path=hot) == []
    pragma = src.replace("\n    ", "\n    # keystone: allow-sync (reviewed)\n    ", 1)
    assert lint_source(pragma, path=hot) == []
    assert lint_source(src, path=os.path.join(PORT_ROOT, "ops", "cold.py")) == []


def test_kv502_args_and_foreign_asarray_are_not_syncs():
    hot = os.path.join(PORT_ROOT, "workflow", "streaming.py")
    src = "import torch\n\ndef f(x, d):\n    a = x.cpu(memory_format=d)\n    return torch.asarray(a), x.item(0)\n"
    assert lint_source(src, path=hot) == []


def test_kv506_harvest_home_is_clean_and_a_second_home_is_not():
    home = os.path.join(PORT_ROOT, "obs", "cost.py")
    inside = "def harvest_cost_facts(s):\n    return CostFacts(1.0, 2.0)\n"
    outside = "def other(s):\n    return CostFacts(1.0, 2.0)\n"
    assert lint_source(inside, path=home) == []
    assert [f.rule for f in lint_source(outside, path=home)] == ["KV506"]
    call = "from keystone_tpu_torch.obs import cost\n\ncost.harvest_cost_facts('gemm', None, {})\n"
    assert [f.rule for f in lint_source(call, path=os.path.join(PORT_ROOT, "ops", "x.py"))] == ["KV506"]
    assert lint_source(call, path=home) == []


def test_kv505_has_no_counterpart_in_the_port():
    """The port donates no buffer: a donation call is no finding, and the
    code is not in its table."""
    src = "import jax\n\nf = jax.jit(lambda x: x, donate_argnums=(0,))\n"
    assert "KV505" not in LINT_CODES
    assert lint_source(src, path=os.path.join(PORT_ROOT, "ops", "x.py")) == []
    assert [f.rule for f in j_lint_source(src, path="keystone_tpu/ops/x.py")] == ["KV505"]


CROSS = dict(SEEDED)
CROSS["KV501-getenv"] = "import os\nknob = os.getenv('KEYSTONE_X')\n"
CROSS["KV501-pragma"] = "import os\nknob = os.environ['X']  # keystone: allow-env (pass-through)\n"
CROSS["clean"] = "x = 1\n"


@pytest.mark.parametrize("case", sorted(c for c in CROSS if c not in ("KV502", "KV506")))
def test_port_and_jax_linters_agree_on_the_rules_both_have(case):
    """KV501, KV503 and KV504 (and a clean file): the same findings, line
    for line, from both packages' linters over the same seeded source,
    with the port's registries."""
    ctx = build_context(PORT_ROOT)
    from keystone_tpu.lint.rules import build_context as j_build_context

    jctx = j_build_context(PORT_ROOT)
    path = os.path.join(PORT_ROOT, "workflow", "seeded.py")
    got = [(f.rule, f.line) for f in lint_source(CROSS[case], path=path, context=ctx)]
    want = [(f.rule, f.line) for f in j_lint_source(CROSS[case], path=path, context=jctx)]
    assert got == want


def test_kv502_item_agrees_with_the_jax_linter():
    """``.item()`` and numpy's ``asarray`` are syncs in both packages."""
    hot = os.path.join(PORT_ROOT, "serving", "server.py")
    for src in (SYNC_CASES["item"], SYNC_CASES["numpy-asarray"]):
        got = [(f.rule, f.line) for f in lint_source(src, path=hot)]
        want = [(f.rule, f.line) for f in j_lint_source(src, path=hot)]
        assert got == want == [("KV502", src.count("\n"))]


# ------------------------------------------------------------ concurrency


def test_port_concurrency_is_clean(port_concurrency):
    findings, model = port_concurrency
    assert [f.to_json() for f in findings] == []
    assert len(model.locks) >= 40 and model.edges


def test_port_lock_graph_is_acyclic(port_concurrency):
    """No KV602 cycle in the port's serving, fleet or scheduler code: the
    static lock-order graph has none, with or without the pragmas."""
    _findings, model = port_concurrency
    assert model.find_cycles() == []


def _codes(src):
    findings, _model = analyze_sources({"mod.py": textwrap.dedent(src)})
    return [f.rule for f in findings]


SEEDED_CONCURRENCY = {
    "KV601": """
        import threading

        class Telemetry:
            def __init__(self):
                self._lock = threading.Lock()
                self._served = 0
                self._t = threading.Thread(target=self._loop, daemon=True)

            def _loop(self):
                while True:
                    self._served += 1

            def record(self):
                with self._lock:
                    self._served += 1

            def snapshot(self):
                with self._lock:
                    return self._served
    """,
    "KV602": """
        import threading

        class Gate:
            def __init__(self, ledger: "Ledger"):
                self._lock = threading.Lock()
                self._ledger = ledger

            def poke(self):
                with self._lock:
                    pass

            def admit(self):
                with self._lock:
                    self._ledger.poke()

        class Ledger:
            def __init__(self, gate: Gate):
                self._lock = threading.Lock()
                self._gate = gate

            def poke(self):
                with self._lock:
                    pass

            def settle(self):
                with self._lock:
                    self._gate.poke()
    """,
    "KV603": """
        import threading
        import time

        class Waiter:
            def __init__(self):
                self._lock = threading.Lock()

            def wait(self):
                with self._lock:
                    time.sleep(1.0)
    """,
    "KV604": """
        import threading

        def spawn(fn):
            t = threading.Thread(target=fn)
            t.start()
            return None
    """,
    "KV605": """
        def finish(future, value):
            future.set_result(value)
    """,
}


@pytest.mark.parametrize("code", sorted(SEEDED_CONCURRENCY))
def test_seeded_concurrency_violation_is_caught(code):
    assert code in CONCURRENCY_CODES
    assert _codes(SEEDED_CONCURRENCY[code]) == [code]


@pytest.mark.parametrize("code", sorted(SEEDED_CONCURRENCY))
def test_port_and_jax_concurrency_tiers_agree(code):
    sources = {"mod.py": textwrap.dedent(SEEDED_CONCURRENCY[code])}
    got, model = analyze_sources(sources)
    want, jmodel = j_analyze_sources(sources)
    assert [(f.rule, f.line, f.message) for f in got] == [(f.rule, f.line, f.message) for f in want]
    assert model.to_json() == jmodel.to_json()


PRAGMAS = {
    "KV601": ("self._served += 1\n", "self._served += 1  # keystone: allow-unguarded(benign)\n"),
    "KV603": ("time.sleep(1.0)\n", "time.sleep(1.0)  # keystone: allow-block-under-lock(test)\n"),
    "KV604": ("t = threading.Thread(target=fn)\n", "t = threading.Thread(target=fn)  # keystone: allow-unjoined(x)\n"),
    "KV605": ("future.set_result(value)\n", "future.set_result(value)  # keystone: allow-settle(single owner)\n"),
}


@pytest.mark.parametrize("code", sorted(PRAGMAS))
def test_concurrency_pragmas_silence_one_site(code):
    old, new = PRAGMAS[code]
    src = SEEDED_CONCURRENCY[code]
    assert old in src
    assert _codes(src.replace(old, new, 1)) == []


def test_settles_in_the_ports_config_module_are_the_helpers():
    findings, _model = analyze_sources(
        {os.path.join("serving", "config.py"): "def settle_result(f, v):\n    f.set_result(v)\n"}
    )
    assert findings == []
