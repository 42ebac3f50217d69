"""The port's SanLock hook for pytest (``-p repro_torch.analysis.pytest_plugin``).

With ``REPRO_TORCH_SANLOCK=1`` this plugin installs the port's sanitizer
(``repro_torch.analysis.sanlock``) when pytest loads it, before collection
imports any test module, so the locks the port allocates at import
(``kernels/build.py``'s) are wrapped too. After every test it fails the
test if the recorded lock-acquisition graph has a cycle (a potential
deadlock between the pipeline, serving, ingest or retrieval threads), or
if a cluster created by the test still holds MEM-PS row pins
(``pscheck_allow_pins`` marks intentional leaks). The graph accumulates
across the session on purpose: cross-test edges are real edges.

    REPRO_TORCH_SANLOCK=1 PYTHONPATH=src python -m pytest \\
        -p repro_torch.analysis.pytest_plugin tests/test_torch_*.py

Without the variable the plugin does nothing.
"""

from __future__ import annotations

import pytest

from repro_torch.analysis import sanlock

_ACTIVE = sanlock.install_from_env()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "pscheck_allow_pins: test intentionally leaves MEM-PS pins at teardown "
        "(skips the residual-pin assertion)",
    )


@pytest.fixture(autouse=True)
def _repro_torch_sanlock(request):
    if not _ACTIVE:
        yield
        return
    mark = sanlock.cluster_mark()
    yield
    cycle = sanlock.find_cycle()
    assert cycle is None, (
        "SanLock: lock-acquisition cycle (potential deadlock): " + " -> ".join(cycle)
    )
    if request.node.get_closest_marker("pscheck_allow_pins") is None:
        leaks = sanlock.pin_leaks(mark)
        assert not leaks, f"residual MEM-PS pins at teardown: {leaks}"
    sanlock.prune_dead_clusters()
