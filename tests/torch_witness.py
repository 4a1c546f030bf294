"""The port's lock-order witness for one test: import
``torch_lock_witness`` into a test module and take it as a fixture.

``trivy_tpu_torch.analysis.witness`` wraps every lock a
``trivy_tpu_torch`` module constructs while it is installed and
raises on an acquisition-order cycle or a host-pool self-join, so the
port's seeded storms fail loudly on those deadlock classes instead of
waiting for the interleaving that deadlocks. A
witness already active (``TRIVY_TPU_LOCK_WITNESS=1`` in a CLI
subprocess's parent, or another fixture) is reused and left
installed. The reference's ``lock_witness`` (tests/conftest.py) may
be installed too: each wraps only its own package's locks."""

import pytest


@pytest.fixture
def torch_lock_witness():
    from trivy_tpu_torch.analysis import witness as w

    pre = w.active_witness()
    wit = w.install_witness()
    try:
        yield wit
    finally:
        if pre is None:
            w.uninstall_witness()


def assert_witnessed_clean(wit) -> dict:
    """A storm ran under ``wit``: locks were wrapped and taken, and no
    order cycle or pool self-join was seen (one raised on a worker
    thread may have been caught there; the books still count it)."""
    st = wit.stats()
    assert st["wrapped_locks"] > 0, st
    assert st["acquisitions"] > 0, st
    assert st["violations"] == 0, (st, wit.violations)
    assert st["pool_joins_checked"] == 0, st
    return st
