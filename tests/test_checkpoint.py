"""Checkpoint round-trip tests — the EndToEnd pattern of
/root/reference/mcmc/serialize-test.cc:90-134: run, checkpoint, run on;
restore, run the same steps; trajectories must be bit-exact."""

import numpy as np
import pytest

from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint
from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def fresh_learner(seed=17):
    n, u, v = synthetic_edges(250, 8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return Learner(cfg, graph, split, prefetch=False)


def test_bit_exact_resume(tmp_path):
    path = str(tmp_path / "ck.npz")

    a = fresh_learner()
    a.heldout_perplexity()
    a.run(20)
    save_checkpoint(path, a)
    a.run(15)
    ppx_a = a.heldout_perplexity()

    b = fresh_learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == int(21)
    b.run(15)
    ppx_b = b.heldout_perplexity()

    # bit-exact: same device program, same restored state + RNG streams
    assert ppx_a == ppx_b
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.theta),
                                  np.asarray(b.state.theta))
    np.testing.assert_array_equal(np.asarray(a.state.ppx_per_edge),
                                  np.asarray(b.state.ppx_per_edge))
    a.close(); b.close()


def test_checkpoint_rejects_geometry_mismatch(tmp_path):
    path = str(tmp_path / "ck.npz")
    a = fresh_learner()
    save_checkpoint(path, a)
    n, u, v = synthetic_edges(100, 6, seed=99)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=100)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4).finalize(
        n, split.total_edges, graph.max_fan_out)
    b = Learner(cfg, graph, split, prefetch=False)
    with pytest.raises(ValueError, match="geometry"):
        load_checkpoint(path, b)
    a.close(); b.close()


def test_checkpoint_preserves_timers(tmp_path):
    path = str(tmp_path / "ck.npz")
    a = fresh_learner()
    a.run(5)
    save_checkpoint(path, a)
    b = fresh_learner()
    load_checkpoint(path, b)
    assert b.timers.seconds["total"] == a.timers.seconds["total"]
    assert b.timers.calls["device_step"] == a.timers.calls["device_step"]
    a.close(); b.close()


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Sharded save -> sharded restore continues identically."""
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges

    def build():
        n, u, v = synthetic_edges(200, 8, seed=61)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=62)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     host_sampler="numpy")
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return ShardedLearner(cfg, graph, split, make_mesh(2, 4))

    path = str(tmp_path / "sck.npz")
    a = build()
    a.run(10)
    save_checkpoint(path, a)
    a.run(10)

    b = build()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == 11
    b.run(10)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    # restored pi keeps its mesh sharding
    assert "model" in str(b.state.pi.sharding)


def test_orbax_bit_exact_resume(tmp_path):
    """Same EndToEnd contract through the orbax directory backend."""
    path = str(tmp_path / "ck_orbax")

    a = fresh_learner()
    a.run(20)
    save_checkpoint(path, a, backend="orbax")
    a.run(15)
    ppx_a = a.heldout_perplexity()

    b = fresh_learner()
    load_checkpoint(path, b)  # backend detected: directory -> orbax
    assert int(b.state.step_count) == 21
    assert b.timers.calls["device_step"] > 0
    b.run(15)
    ppx_b = b.heldout_perplexity()
    assert ppx_a == ppx_b
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def test_orbax_sharded_roundtrip(tmp_path):
    """Orbax restore places each leaf directly on its mesh sharding."""
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh

    def build():
        n, u, v = synthetic_edges(200, 8, seed=61)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=62)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     host_sampler="numpy")
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return ShardedLearner(cfg, graph, split, make_mesh(2, 4))

    path = str(tmp_path / "sck_orbax")
    a = build()
    a.run(10)
    save_checkpoint(path, a, backend="orbax")
    a.run(10)

    b = build()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == 11
    assert "model" in str(b.state.pi.sharding)
    b.run(10)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))


def test_orbax_overwrite_is_atomic(tmp_path):
    """Saving over an existing orbax checkpoint replaces it whole."""
    path = str(tmp_path / "ck_orbax")
    a = fresh_learner()
    save_checkpoint(path, a, backend="orbax")
    a.run(10)
    save_checkpoint(path, a, backend="orbax")
    b = fresh_learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == int(a.state.step_count)
    a.close(); b.close()


def test_orbax_crash_mid_promote_recovers_from_parking_spot(tmp_path):
    """A crash between the promote renames leaves the previous
    checkpoint at .orbax-old; load_checkpoint falls back to it."""
    import shutil

    path = str(tmp_path / "ck_orbax")
    a = fresh_learner()
    a.run(10)
    save_checkpoint(path, a, backend="orbax")
    # simulate the crash window: old parked aside, new never promoted
    shutil.move(path, path + ".orbax-old")
    b = fresh_learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == int(a.state.step_count)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def test_unknown_backend_raises(tmp_path):
    a = fresh_learner()
    with pytest.raises(ValueError, match="backend"):
        save_checkpoint(str(tmp_path / "x"), a, backend="hdf5")
    a.close()


@pytest.mark.parametrize("host_sampler", ["numpy", "auto"])
def test_bit_exact_resume_with_prefetch(tmp_path, host_sampler):
    """The default pipelined configuration (prefetch producer thread,
    native sampler when available, scan chunks) must also resume
    bit-exactly: the checkpoint captures the full host-sampling
    position including produced-but-unconsumed chunks — the in-flight
    state the reference serializes (learner.cc:307-315)."""
    from mcmc_ammsb import native
    if host_sampler == "auto" and not native.available():
        pytest.skip("no C++ toolchain")
    path = str(tmp_path / f"ck_{host_sampler}.npz")

    def build():
        n, u, v = synthetic_edges(250, 8, seed=17)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=18)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     steps_per_call=5, host_sampler=host_sampler)
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return Learner(cfg, graph, split, prefetch=True)

    a = build()
    a.run(20)
    save_checkpoint(path, a)
    a.run(15)
    ppx_a = a.heldout_perplexity()
    a.close()

    b = build()
    load_checkpoint(path, b)
    b.run(15)
    ppx_b = b.heldout_perplexity()
    b.close()
    assert ppx_a == ppx_b
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))


def test_orbax_async_save_is_a_snapshot(tmp_path):
    """async_save returns once the state is on host; training can
    continue immediately (donated device buffers don't corrupt the
    snapshot), and the finalized checkpoint holds the state AT save
    time — resume from it is bit-exact."""
    from mcmc_ammsb.checkpoint import wait_for_async_saves

    path = str(tmp_path / "ck_async")
    a = fresh_learner()
    a.run(10)
    save_checkpoint(path, a, backend="orbax", async_save=True)
    a.run(20)          # keeps training while the save is in flight
    wait_for_async_saves()

    b = fresh_learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == 11   # the snapshot, not step 31
    b.run(20)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def test_orbax_async_save_finalized_by_load(tmp_path):
    """load_checkpoint finalizes an in-flight async save implicitly."""
    path = str(tmp_path / "ck_async2")
    a = fresh_learner()
    a.run(5)
    save_checkpoint(path, a, backend="orbax", async_save=True)
    b = fresh_learner()
    load_checkpoint(path, b)   # no explicit wait
    assert int(b.state.step_count) == 6
    a.close(); b.close()


def test_async_requires_orbax(tmp_path):
    a = fresh_learner()
    with pytest.raises(ValueError, match="orbax"):
        save_checkpoint(str(tmp_path / "x.npz"), a, async_save=True)
    a.close()


def test_npz_save_finalizes_pending_async_first(tmp_path):
    """A pending async orbax save to the same path is promoted before
    an npz save proceeds — the deferred promote can never rename a
    freshly-written npz away."""
    import os

    path = str(tmp_path / "ck")
    a = fresh_learner()
    a.run(5)
    save_checkpoint(path, a, backend="orbax", async_save=True)
    save_checkpoint(path + ".npz", a, backend="npz")
    # the orbax promote for `path` still pending -> force via npz save
    # to the SAME path string
    save_checkpoint(path, a, backend="orbax")  # sync save waits first
    assert os.path.isdir(path)
    b = fresh_learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == 6
    a.close(); b.close()
