# Root conftest: run the tests on a virtual 8-device CPU mesh.
#
# JAX_PLATFORMS=cpu is set before jax is imported, so a test process never
# opens (or reserves memory on) an accelerator; the 8 virtual host devices
# let the sharded solvers run their real meshes on the CPU.
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from sqd_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

# Persistent compilation cache: the suite compiles many (shape, dtype) solver
# buckets; caching them across runs cuts wall-clock dramatically.
configure_compile_cache(os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
assert jax.devices()[0].platform == "cpu", jax.devices()
