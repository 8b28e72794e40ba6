"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real (1-device) platform; multi-device coverage runs in its own
subprocess via :func:`forced_multidevice_run` (and launch/dryrun.py forces
512 fake devices the same way)."""
import os
import subprocess
import sys

try:                # real hypothesis wins whenever it is installed
    import hypothesis  # noqa: F401
except ImportError:
    # this container cannot pip-install; property tests fall back to the
    # deterministic shim (src/_hypothesis_shim.py, on PYTHONPATH=src)
    import _hypothesis_shim

    sys.modules["hypothesis"] = _hypothesis_shim
    sys.modules["hypothesis.strategies"] = _hypothesis_shim.strategies

import jax
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# set in child processes spawned by forced_multidevice_run: tests that need
# a real multi-device platform skip themselves unless this is present
FORCED_MULTIDEVICE_ENV = "BISWIFT_FORCED_MULTIDEVICE"


def forced_multidevice_env(n_devices: int = 4) -> dict:
    """Environment for a subprocess with ``n_devices`` fake CPU devices.

    XLA only honours --xla_force_host_platform_device_count before the
    first jax import, which has already happened in the test process —
    hence a fresh subprocess rather than a fixture-scoped flag."""
    env = dict(os.environ)
    # append (not clobber) so caller/CI XLA flags survive; ours wins on
    # conflict because XLA takes the last occurrence
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env[FORCED_MULTIDEVICE_ENV] = str(n_devices)
    src = os.path.join(REPO_ROOT, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def forced_multidevice_run(pytest_target: str, n_devices: int = 4,
                           timeout: float = 900.0,
                           extra_args: list | None = None):
    """Run ``pytest <pytest_target>`` in a forced-multi-device subprocess.

    ``extra_args`` (e.g. a ``-k`` selection) keeps the child from
    re-running tests already covered in the parent process."""
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x",
         "-p", "no:cacheprovider", *(extra_args or []), pytest_target],
        env=forced_multidevice_env(n_devices), cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=timeout)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration test (still tier-1; "
        "deselect with -m 'not slow' for a quick pass)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; its fixture skips without one")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
