"""Shared test fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see
the real single CPU device; multi-device tests spawn subprocesses."""
import jax
import pytest

from _jit_guard import failures


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "allow_recompile: opt out of the jit-cache guard for tests that "
        "legitimately compile several signatures of one step callable")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips where torch.cuda.is_available() "
        "is False (tests/test_torch_cuda.py)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _jit_cache_guard(request):
    """Snapshot jit cache sizes on every decode/verify callable built
    during the test; fail on silent recompilation (>1 signature)."""
    from repro.serving import scheduler

    watched = []
    prev = scheduler.JIT_WATCH
    scheduler.JIT_WATCH = watched
    try:
        yield watched
    finally:
        scheduler.JIT_WATCH = prev
    if request.node.get_closest_marker("allow_recompile"):
        return
    bad = failures(watched)
    if bad:
        pytest.fail("silent recompilation detected — "
                    + "; ".join(bad), pytrace=False)
