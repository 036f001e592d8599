"""Test configuration.

Tests run on the CPU with 8 virtual devices so sharded code paths are
exercised without accelerators, and with x64 enabled so numerical-parity
assertions against the all-double reference hold (the reference uses
``std::vector<double>`` throughout).

Note: platform selection uses ``jax.config`` (not ``JAX_PLATFORMS``) because
pytest plugins (jaxtyping) import jax before this conftest runs, freezing the
env-derived defaults; config updates still apply as long as no backend has
been initialised.
"""

import jax

from multigrid_prj_tpu.utils.cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# XLA compiles dominate the suite's run time; the persistent cache makes
# re-runs fast.
enable_compile_cache()
