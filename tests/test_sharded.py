"""Multi-chip shard_map tests on the 8-device virtual CPU mesh.

The reference has nothing distributed to test (SURVEY.md §4); the key
new property here is that the sharded step is *semantically equivalent*
to the single-device step: same math, same scatter discipline — only
the neighbor/noise RNG partitioning differs (keys fold in the data-shard
index). So we check equivalence with noise disabled and neighbors fed
identically via fixed per-step keys, plus invariants on the live path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.parallel import ShardedLearner, make_mesh

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def make_pair(n_nodes=256, avg_deg=8, seed=33, cfg_kw=None):
    n, u, v = synthetic_edges(n_nodes, avg_deg, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 **(cfg_kw or {}))
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return cfg, graph, split


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["data"] * mesh.shape["model"] == 8


def test_sharded_runs_and_improves():
    cfg, graph, split = make_pair()
    mesh = make_mesh(2, 4)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    p0 = lrn.heldout_perplexity()
    lrn.run(60)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite([p0, p1]).all()
    assert p1 < p0
    assert int(lrn.state.step_count) == 61


def test_sharded_scan_runs():
    cfg, graph, split = make_pair(cfg_kw={"steps_per_call": 5})
    mesh = make_mesh(4, 2)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    lrn.run(10)
    assert int(lrn.state.step_count) == 11
    assert np.isfinite(np.asarray(lrn.state.pi)).all()


def test_sharded_matches_single_device_ppx():
    """With zero training steps, sharded and single-device perplexity
    must agree exactly (same init, same heldout population)."""
    cfg, graph, split = make_pair()
    single = Learner(cfg, graph, split, prefetch=False)
    mesh = make_mesh(2, 4)
    sharded = ShardedLearner(cfg, graph, split, mesh)
    p_single = single.heldout_perplexity()
    p_sharded = sharded.heldout_perplexity()
    np.testing.assert_allclose(p_sharded, p_single, rtol=1e-5)
    single.close()


def test_sharded_pi_rows_stay_normalized():
    cfg, graph, split = make_pair()
    mesh = make_mesh(2, 4)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    lrn.run(20)
    pi = np.asarray(lrn.state.pi)[: cfg.N]
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)


def test_sharded_device_sampling():
    """Fully-fused sharded loop: on-device sampling + hoisted scan."""
    cfg, graph, split = make_pair(cfg_kw={"device_sampling": True,
                                          "steps_per_call": 10})
    mesh = make_mesh(2, 4)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    p0 = lrn.heldout_perplexity()
    lrn.run(40)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 41
    assert np.isfinite([p0, p1]).all() and p1 < p0
    pi = np.asarray(lrn.state.pi)[: cfg.N]
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)


def test_model_sharding_is_semantically_invisible():
    """Golden cross-mesh equivalence (the sharding analog of the
    reference's cross-mode kernel tests): with the data axis fixed at 1,
    every RNG key law is identical, so a (1,8)-mesh run must reproduce
    the (1,1)-mesh trajectory to fp tolerance — the gather-psum row
    fetch and all_gather write-back must be exact no-ops semantically."""
    cfg, graph, split = make_pair(seed=55)
    a = ShardedLearner(cfg, graph, split, make_mesh(1, 1, allow_subset=True))
    b = ShardedLearner(cfg, graph, split, make_mesh(1, 8))
    a.run(30)
    b.run(30)
    n = cfg.N
    np.testing.assert_allclose(np.asarray(a.state.pi)[:n],
                               np.asarray(b.state.pi)[:n],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.state.theta),
                               np.asarray(b.state.theta),
                               rtol=2e-4, atol=1e-7)
    pa = a.heldout_perplexity()
    pb = b.heldout_perplexity()
    np.testing.assert_allclose(pa, pb, rtol=1e-4)


def test_make_mesh_subset_requires_opt_in():
    with pytest.raises(ValueError, match="allow_subset"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="available"):
        make_mesh(4, 4)


def test_sharded_shared_neighbors_trains():
    """shared_neighbors on a mesh: one step-wide draw identical on all
    data shards; n rows fetched per device instead of B_local*n."""
    cfg, graph, split = make_pair(cfg_kw={"shared_neighbors": True,
                                          "steps_per_call": 5})
    lrn = ShardedLearner(cfg, graph, split, make_mesh(2, 4))
    p0 = lrn.heldout_perplexity()
    lrn.run(40)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite([p0, p1]).all() and p1 < p0
    pi = np.asarray(lrn.state.pi)[: cfg.N]
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    lrn.close()


def test_sharded_shared_neighbors_cross_mesh_equivalence():
    """Model sharding stays semantically invisible with shared draws:
    with the data axis fixed at 1 the RNG laws coincide, so (1,8) must
    reproduce (1,1) to fp tolerance."""
    cfg, graph, split = make_pair(seed=77,
                                  cfg_kw={"shared_neighbors": True})
    a = ShardedLearner(cfg, graph, split,
                       make_mesh(1, 1, allow_subset=True))
    b = ShardedLearner(cfg, graph, split, make_mesh(1, 8))
    a.run(30)
    b.run(30)
    np.testing.assert_allclose(np.asarray(a.state.pi)[: cfg.N],
                               np.asarray(b.state.pi)[: cfg.N],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(a.heldout_perplexity(),
                               b.heldout_perplexity(), rtol=1e-4)
    a.close(); b.close()


def test_sharded_rejects_reference_rng_loudly():
    """The reference RNG's per-thread streams are single-device
    semantics; requesting them sharded must error, not silently swap
    (round-1 behavior)."""
    from mcmc_ammsb.config import RngBackend
    cfg, graph, split = make_pair(
        cfg_kw={"rng_backend": RngBackend.REFERENCE})
    with pytest.raises(ValueError, match="native"):
        ShardedLearner(cfg, graph, split, make_mesh(2, 4))


def test_sharded_training_perplexity_matches_single_chip():
    """Train-ppx parity (learner.cc:204-212): same state, same
    population -> same value on a mesh as on one chip."""
    cfg, graph, split = make_pair(
        cfg_kw={"calc_train_ppx": True, "training_ppx_ratio": 0.2})
    single = Learner(cfg, graph, split, prefetch=False)
    sharded = ShardedLearner(cfg, graph, split, make_mesh(2, 4))
    t_single = single.training_perplexity()
    t_sharded = sharded.training_perplexity()
    np.testing.assert_allclose(t_sharded, t_single, rtol=1e-5)
    # running-average statefulness: second call folds into the first
    t2_single = single.training_perplexity()
    t2_sharded = sharded.training_perplexity()
    np.testing.assert_allclose(t2_sharded, t2_single, rtol=1e-5)
    single.close(); sharded.close()


def test_sharded_ppx_stats_include_likelihoods():
    cfg, graph, split = make_pair()
    lrn = ShardedLearner(cfg, graph, split, make_mesh(2, 4))
    lrn.heldout_perplexity()
    st = lrn.last_ppx_stats
    assert {"link_count", "non_link_count", "link_likelihood",
            "non_link_likelihood"} <= set(st)
    assert np.isfinite(st["link_likelihood"])
    lrn.close()


def test_sharded_prefetch_resume_bit_exact(tmp_path):
    """The pipelined sharded configuration must checkpoint its in-flight
    host batches and resume bit-exactly — the sharded mirror of the
    single-chip test (reference: learner.cc:307-315)."""
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint
    from mcmc_ammsb.config import Config

    def build():
        n, u, v = synthetic_edges(256, 8, seed=71)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=72)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     steps_per_call=5, host_sampler="numpy")
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return ShardedLearner(cfg, graph, split, make_mesh(2, 4),
                              prefetch=True)

    path = str(tmp_path / "sharded_prefetch.npz")
    a = build()
    a.run(10)
    save_checkpoint(path, a)
    assert a._pending  # the drained in-flight chunk was captured
    a.run(10)
    ppx_a = a.heldout_perplexity()
    a.close()

    b = build()
    load_checkpoint(path, b)
    b.run(10)
    ppx_b = b.heldout_perplexity()
    b.close()
    assert ppx_a == ppx_b
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))


def test_sharded_fused_ppx_series_matches_host_loop():
    """ShardedLearner.run_with_ppx composes the exact fused-chunk +
    collective-eval bodies inside one shard_map program; the series
    must reproduce the host loop bit-exactly (Learner contract)."""
    kw = {"device_sampling": True, "steps_per_call": 40,
          "host_sampler": "numpy"}
    cfg, graph, split = make_pair(cfg_kw=kw)
    mesh = make_mesh(2, 4)
    a = ShardedLearner(cfg, graph, split, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)

    series = a.run_with_ppx(40, 10)
    assert [ev["step"] for ev in series] == [11, 21, 31, 41]

    for ev in series:
        b.run(10)
        ppx = b.heldout_perplexity()
        assert ev["ppx"] == ppx
        assert ev["link_count"] == b.last_ppx_stats["link_count"]
        assert (ev["non_link_likelihood"]
                == b.last_ppx_stats["non_link_likelihood"])
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    # series state keeps its mesh shardings
    assert "model" in str(a.state.pi.sharding)


def test_sharded_fused_ppx_series_carries_train_ppx():
    """calc_train_ppx rides inside the sharded fused series (round-4:
    it used to force the host loop) — per-eval train-ppx values match
    the host-loop ordering and the running-average state matches."""
    kw = {"device_sampling": True, "steps_per_call": 40,
          "host_sampler": "numpy", "calc_train_ppx": True,
          "training_ppx_ratio": 0.2}
    cfg, graph, split = make_pair(cfg_kw=kw)
    mesh = make_mesh(2, 4)
    a = ShardedLearner(cfg, graph, split, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)

    series = a.run_with_ppx(40, 10)
    for ev in series:
        b.run(10)
        ppx = b.heldout_perplexity()
        tppx = b.training_perplexity()
        assert ev["ppx"] == ppx
        np.testing.assert_allclose(ev["train_ppx"], tppx, rtol=1e-6)
    assert int(a.state.train_ppx_count) == 4
    np.testing.assert_array_equal(
        np.asarray(a.state.train_ppx_per_edge),
        np.asarray(b.state.train_ppx_per_edge))
    a.close(); b.close()


def test_sharded_device_sampling_with_link_cap():
    """Degree-capped NodeLink flows through the sharded fused loop:
    a heavy-tailed graph trains on the mesh with buffers sized by the
    cap (rounded to mesh multiples), not the hub degree."""
    from mcmc_ammsb.data import synthetic_powerlaw_edges

    n, u, v = synthetic_powerlaw_edges(400, 6, exponent=2.2,
                                       max_degree=80, seed=44)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=45)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=10,
                 ds_link_cap=8)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    assert graph.max_fan_out > 8          # the cap must actually bind
    assert cfg.max_batch_edges == 8
    mesh = make_mesh(2, 4)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    p0 = lrn.heldout_perplexity()
    lrn.run(40)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 41
    assert np.isfinite([p0, p1]).all() and p1 < p0
