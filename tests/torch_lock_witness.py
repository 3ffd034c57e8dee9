"""The port's lock-witness fixture, shared by its threaded test files.

The root ``tests/conftest.py`` witness fixture is the JAX package's. A
port test file imports :func:`_port_lock_witness` by name, which makes
the autouse fixture apply to every test in that file:
``KEYSTONE_LOCK_WITNESS`` then arms the port's witness
(``keystone_tpu_torch/lint/lockwitness.py``) over each test; otherwise
it is a no-op.
"""

import pytest


@pytest.fixture(autouse=True)
def _port_lock_witness(request):
    from keystone_tpu_torch.lint.lockwitness import armed_for_test

    with armed_for_test(request.node.nodeid):
        yield
