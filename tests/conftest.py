import os

# Every test runs on the CPU with 8 virtual devices, so the multi-device
# paths run without a card.  XLA_FLAGS takes effect only before a backend
# initializes.  Tests that need a card live in tests/test_gpu.py (marked
# ``gpu``) and skip here; ``chip_smoke.py`` runs that file on the card
# without this conftest.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8

