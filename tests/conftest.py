"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the host's
real single CPU device (the 512 fake devices exist only in dryrun.py).

``hypothesis`` is optional: offline images don't ship it, so a stub is
installed into sys.modules before test modules import — ``@given`` tests
then collect normally and skip at runtime instead of erroring collection.
"""

import sys
import types

import pytest


def _install_hypothesis_stub() -> None:
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass

    def given(*_args, **_kwargs):
        def deco(fn):
            # *args-only signature: pytest must not see the wrapped test's
            # parameters, or it would try to resolve them as fixtures
            def skipper(*args, **kwargs):
                pytest.skip("hypothesis not installed")

            skipper.__name__ = getattr(fn, "__name__", "hypothesis_test")
            skipper.__doc__ = fn.__doc__
            return skipper

        return deco

    def settings(*_args, **_kwargs):
        return lambda fn: fn

    class _Anything:
        """Placeholder for strategies / HealthCheck members."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    stub = types.ModuleType("hypothesis")
    stub.given = given
    stub.settings = settings
    stub.HealthCheck = _Anything()
    stub.strategies = types.ModuleType("hypothesis.strategies")
    stub.strategies.__getattr__ = lambda name: _Anything()
    stub.__is_repro_stub__ = True
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = stub.strategies


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")

from repro.core import Mode, PMDevice, USplit, Volume, VolumeGeometry  # noqa: E402

SMALL_GEOMETRY = VolumeGeometry(meta_blocks=64, journal_blocks=128,
                                oplog_slots=2, oplog_blocks=64)


@pytest.fixture
def device():
    return PMDevice(size=64 * 1024 * 1024)


@pytest.fixture
def volume(device):
    return Volume.format(device, SMALL_GEOMETRY)


def make_store(volume, mode=Mode.POSIX, **kw):
    kw.setdefault("staging_file_bytes", 1024 * 1024)
    kw.setdefault("staging_prealloc", 2)
    kw.setdefault("staging_background", False)
    return USplit(volume, mode=mode, **kw)


@pytest.fixture
def store(volume):
    return make_store(volume)


@pytest.fixture
def strict_store(volume):
    return make_store(volume, mode=Mode.STRICT, oplog_slot=0)
