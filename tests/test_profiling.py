"""Trace-based per-stage attribution of the PRODUCTION fused program
(the analog of the reference's per-kernel device-event timers,
/root/reference/mcmc/learner.cc:252-299 — unlike the unfused
profile_stages upper bounds, these shares sum to the fused step time)."""

import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.utils import profiling

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def make_learner(**cfg_kw):
    n, u, v = synthetic_edges(300, 8, seed=41)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=42)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4, **cfg_kw)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return Learner(cfg, graph, split, prefetch=False)


def test_hlo_op_scope_map():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(x):
        with jax.named_scope("phi_update"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("beta_grads"):
            z = jnp.sum(y ** 2)
        return z

    txt = f.lower(jnp.ones((16, 16))).compile().as_text()
    m = profiling.hlo_op_scope_map(txt)
    assert m, "no op_name metadata parsed from compiled HLO"
    scopes = set(profiling._stage_of(p, profiling.STAGE_NAMES)
                 for p in m.values())
    assert "phi_update" in scopes
    assert "beta_grads" in scopes


def test_fused_stage_profile_device_sampled():
    """The flagship fully-fused loop: stages must be attributed, and
    per-stage seconds must sum to the captured device-op total."""
    lrn = make_learner(device_sampling=True, steps_per_call=10)
    prof = lrn.fused_stage_profile(iters=40)
    assert prof["source"] in ("tf_op", "hlo")
    assert prof["total_op_seconds"] > 0
    np.testing.assert_allclose(sum(prof["stages"].values()),
                               prof["total_op_seconds"], rtol=1e-6)
    got = set(prof["stages"])
    # the big three must be individually visible in the fused program
    assert "phi_update" in got
    assert "device_sampling" in got
    assert ("beta_grads" in got) or ("theta_update" in got)
    lrn.close()


def test_fused_stage_profile_host_sampled_scan():
    lrn = make_learner(steps_per_call=5)
    prof = lrn.fused_stage_profile(iters=20)
    assert prof["source"] in ("tf_op", "hlo")
    assert prof["stages"].get("phi_update", 0) > 0
    lrn.close()


def test_sharded_fused_stage_profile():
    """ShardedLearner's trace attribution (the multi-chip analog of the
    reference's per-kernel timers): the shard_map bodies' named scopes
    must survive into the compiled program and attribute device time,
    with pi_gather/pi_scatter covering the collectives."""
    from mcmc_ammsb.parallel.mesh import make_mesh
    from mcmc_ammsb.parallel.sharded import ShardedLearner

    n, u, v = synthetic_edges(300, 8, seed=41)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=42)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=10)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    mesh = make_mesh(2, 4)
    lrn = ShardedLearner(cfg, graph, split, mesh, prefetch=False)
    prof = lrn.fused_stage_profile(iters=40)
    assert prof["source"] in ("tf_op", "hlo")
    assert prof["total_op_seconds"] > 0
    np.testing.assert_allclose(sum(prof["stages"].values()),
                               prof["total_op_seconds"], rtol=1e-6)
    got = set(prof["stages"])
    assert "phi_update" in got
    assert ("pi_gather" in got) or ("pi_scatter" in got)
    lines = []
    lrn.print_stage_profile(log=lines.append, iters=20)
    assert any("us/step" in l for l in lines)
    lrn.close()


def test_print_stage_profile_smoke(capsys):
    lrn = make_learner(device_sampling=True, steps_per_call=10)
    lines = []
    lrn.print_stage_profile(log=lines.append, iters=20)
    out = "\n".join(lines)
    assert "PHI_UPDATE" in out
    assert "us/step" in out
    lrn.close()
