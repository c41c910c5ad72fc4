"""Test harness: on the CPU backend, 8 virtual devices.

Mirrors the reference's ContextTest fixture role
(/root/reference/mcmc/test.h:10-52) — every test gets a real (virtual)
device mesh; sharding tests use all 8. Tests marked ``gpu`` take the
``gpu`` fixture and skip unless JAX's backend is a GPU; run them on a
card with ``python -m pytest tests -m gpu``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

# Persistent XLA compile cache at a fixed path inside the checkout —
# MUST be set before `import jax` (the config reads these env vars at
# import time; subprocess tests inherit them). Different tests re-trace
# identical programs through fresh Learner closures, which miss the
# in-memory jit cache but hash to the same HLO — the on-disk cache
# dedupes those compiles within one suite run and across edit-test
# iterations. Opt out with MCMC_AMMSB_NO_COMPILE_CACHE=1.
if not os.environ.get("MCMC_AMMSB_NO_COMPILE_CACHE"):
    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache", "tests"))
    os.environ.setdefault(
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    os.environ.setdefault(
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

import numpy as np
import pytest

import jax  # noqa: E402  (after env setup)

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges


@pytest.fixture(scope="session")
def small_dataset():
    """Synthetic graph in the spirit of wg-phi-test.cc:116-125."""
    n, u, v = synthetic_edges(num_nodes=400, avg_degree=16, seed=7)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=3)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    return n, split, graph


@pytest.fixture(scope="session")
def small_config(small_dataset):
    n, split, graph = small_dataset
    cfg = Config(K=16, mini_batch_size=8, num_node_sample=8)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out)


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at
    test time, so every pytest-xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: python -m pytest tests -m gpu on a card")
