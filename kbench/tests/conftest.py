"""The benchmark's tests: the port's profile store stays off, so no test
writes under the user's home (a run sets the same)."""

import pytest


@pytest.fixture(autouse=True)
def _no_profile_store(monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", "off")
