"""Shared test configuration.

float64 is enabled globally so the JAX job model matches the pure-Python
float64 oracle bit-for-bit in the equivalence property tests; neural-net
code paths pin their own dtypes explicitly and are unaffected.

NOTE: XLA_FLAGS / device-count forcing is deliberately NOT set here — tests
and benches must see the single real CPU device.  Only ``launch/dryrun.py``
forces 512 placeholder devices, in its own process.
"""

import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (with a reason) without one")
