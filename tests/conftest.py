"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on host-platform virtual devices (the
same SPMD code path in XLA). Tests marked ``chip`` need a GPU and skip
here; on a machine with a card,
``EPIVO_TEST_GPU=1 python -m pytest -m chip tests/test_chip.py`` runs
them (the CPU stays available as their reference).
"""

import os

# Must be set before jax import.
ON_GPU = os.environ.get("EPIVO_TEST_GPU") == "1"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if ON_GPU else "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_threefry_partitionable", True)


# The XLA CPU compiler can segfault after ~180 compilations accumulate in
# one pytest process (observed twice at r3, at a nondeterministic late
# test, inside backend_compile_and_load; any suite subset passes in
# isolation). Periodically dropping JAX's in-process caches bounds the
# accumulated compiler state; the cost is recompiling shared helpers a
# few times per run.
import pytest as _pytest

_TEST_COUNT = {"n": 0}


@_pytest.fixture(autouse=True)
def _bound_compiler_state():
    yield
    _TEST_COUNT["n"] += 1
    if _TEST_COUNT["n"] % 50 == 0:
        jax.clear_caches()


@_pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _pytest.skip("needs a GPU (run with EPIVO_TEST_GPU=1 on the card)")
    return dev
