"""The JAX package's keystone-lint rules over the port.

``keystone_tpu.lint`` parses its registries (the metric names of
``obs/names.py``, the probe sites of ``reliability/faultinject.py``) out
of the linted package's own source, so pointed at ``keystone_tpu_torch``
it holds the port to the port's registries. The test imports the linter;
the port never does.
"""

import os

import pytest

import keystone_tpu_torch
from keystone_tpu.lint.rules import build_context, lint_paths, lint_source

PORT_ROOT = os.path.dirname(os.path.abspath(keystone_tpu_torch.__file__))


@pytest.fixture(scope="module")
def port_findings():
    return lint_paths([PORT_ROOT])


@pytest.mark.parametrize("rule", ["KV501", "KV503", "KV504"])
def test_port_tree_is_clean(port_findings, rule):
    found = [f.to_json() for f in port_findings if f.rule == rule]
    assert found == []


def test_context_is_parsed_from_the_port():
    ctx = build_context(PORT_ROOT)
    assert "BlockLeastSquaresEstimator.solve" in ctx.probe_sites
    assert "keystone_solver_rung_attempts_total" in ctx.metric_names
    assert "keystone_executor_node_seconds" in ctx.metric_names


SEEDED = {
    "KV504": 'from keystone_tpu_torch.reliability import probe\nprobe("no.such.site")\n',
    "KV503": 'from keystone_tpu_torch.obs import names\nnames.metric("keystone_undeclared_series_total")\n',
    "KV501": 'import os\nknob = os.environ.get("KEYSTONE_SOMETHING")\n',
}

REGISTERED = (
    "from keystone_tpu_torch.obs import metrics\n"
    "from keystone_tpu_torch.reliability import probe\n"
    'probe("BlockLeastSquaresEstimator.solve")\n'
    'metrics.get_registry().counter("keystone_solver_rung_attempts_total")\n'
)


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_violation_is_caught_in_the_port_context(rule):
    ctx = build_context(PORT_ROOT)
    path = os.path.join(PORT_ROOT, "workflow", "seeded.py")
    found = [f.rule for f in lint_source(SEEDED[rule], path=path, context=ctx)]
    assert found == [rule]


def test_registered_site_and_declared_metric_pass():
    ctx = build_context(PORT_ROOT)
    path = os.path.join(PORT_ROOT, "workflow", "seeded.py")
    assert lint_source(REGISTERED, path=path, context=ctx) == []
