"""Test configuration.

Tests run on the JAX CPU backend with 8 virtual devices so multi-device
sharding (mesh/shard_map paths) is exercised without accelerators, per
SURVEY.md §4. Must run before jax is imported anywhere.

`JAX_PLATFORMS` is only defaulted, so the card tests (`-m gpu`, see
tests/test_gpu.py) run on a GPU with `JAX_PLATFORMS=cuda,cpu`.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo_root)
# Subprocess CLI tests import the package from this checkout.
os.environ["PYTHONPATH"] = _repo_root

import jax  # noqa: E402

from opticalflowclustering_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

# The suite is compile-dominated; cache small programs too.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)
