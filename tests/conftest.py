import os
import sys

# Tests run on host CPU devices — the dry-run (and only the dry-run)
# forces 512 devices via its own XLA_FLAGS before jax init.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Force an 8-device CPU ring for the whole suite (must land before the
# first jax backend init) so the period-program executor and every
# shard_map path are tested on a real multi-device mesh without TPUs
# (launch.mesh.make_test_mesh picks these up).
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count=8 {_flags}".strip())

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # The runtime image ships without hypothesis.  Install the deterministic
    # stub (tests/_hypothesis_stub.py) under both module names so the
    # property-test modules still collect and run their checks with a fixed
    # sample budget instead of erroring out the whole session.
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub as _stub

    sys.modules.setdefault("hypothesis", _stub)
    sys.modules.setdefault("hypothesis.strategies", _stub)
    _stub.strategies = _stub
    settings = _stub.settings

settings.register_profile("ci", max_examples=25, deadline=None)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips where "
                   "there is none")
