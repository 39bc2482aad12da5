"""Fixtures shared by the tests of the port's server (``tests/test_torch_*``).

Import ``port_loop_under_lockdep`` by name into a test module; being
autouse and module-scoped, it then applies to every test of that module.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def port_loop_under_lockdep():
    """Register every loop thread of the port's servers with the
    repository's lockdep, which ``tests/conftest.py`` checks."""
    from trino_tpu.lint import lockdep
    from trino_tpu_torch.server import eventloop

    def hook(ident, running):
        if running:
            lockdep.register_loop_thread(ident)
        else:
            lockdep.unregister_loop_thread(ident)

    eventloop.LOOP_THREAD_HOOKS.append(hook)
    yield
    eventloop.LOOP_THREAD_HOOKS.remove(hook)
