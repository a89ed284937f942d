"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

All tests run on CPU so they are hermetic and fast; multi-chip sharding
paths are exercised on the 8 virtual devices (the driver separately
dry-runs the multichip path via __graft_entry__.dryrun_multichip).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# persistent compilation cache: the suite's cost is dominated by XLA
# compiles of the fixed-shape kernels, which are identical across runs —
# a warm cache cuts the e2e tier severalfold
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_hfnet_tests")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache_hfnet_tests")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy e2e tier (~8 min). Default run: pytest -m 'not slow' "
        "(<5 min); slow tier: pytest -m slow")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips without one (README: the port)")
