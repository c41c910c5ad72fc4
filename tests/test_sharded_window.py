"""Windowed sharded engine (parallel/sharded.py::_sharded_windowed_scan):
one collective pi row fetch per T-step window, replicated window compute
over the data axis, local per-shard write application.

Correctness contract mirrors tests/test_window.py (the cross-mode
validation pattern of /root/reference/mcmc/wg-phi-test.cc:116-158):
the windowed sharded trajectory must reproduce the UNwindowed sharded
trajectory (same RNG laws per lane — only float reduction order
differs), and model-axis sharding must stay semantically invisible. Runs on the
8-device virtual CPU mesh (conftest)."""

import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.parallel import ShardedLearner, make_mesh

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def make_cfg(n_nodes=256, seed=91, **kw):
    n, u, v = synthetic_edges(n_nodes, 8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    base = dict(K=8, mini_batch_size=8, num_node_sample=8,
                steps_per_call=24, device_sampling=True,
                shared_neighbors=True)
    base.update(kw)
    cfg = Config(**base).finalize(n, split.total_edges,
                                  graph.max_fan_out)
    return cfg, graph, split


@pytest.mark.parametrize("window", [8])  # single-chip module sweeps 2,8; one sharded T suffices
def test_sharded_windowed_matches_sequential_sharded(window):
    """window=T on a (2,2) mesh reproduces the window=0 sharded
    trajectory: identical per-lane RNG streams and update math, only
    the beta-gradient reduction order differs (one global sum vs psum
    of per-shard partials)."""
    cfg, graph, split = make_cfg()
    seq = ShardedLearner(cfg, graph, split,
                         make_mesh(2, 2, allow_subset=True))
    win = ShardedLearner(cfg.replace(window=window),
                         graph, split,
                         make_mesh(2, 2, allow_subset=True))
    seq.run(24)
    win.run(24)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi)[: cfg.N],
                               np.asarray(seq.state.pi)[: cfg.N],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(win.heldout_perplexity(),
                               seq.heldout_perplexity(), rtol=1e-4)
    seq.close(); win.close()


def test_sharded_windowed_tail_steps():
    """A chunk not divisible by T: the tail runs the sequential
    global-batch body and the trajectory still matches."""
    cfg, graph, split = make_cfg(steps_per_call=23)
    seq = ShardedLearner(cfg, graph, split,
                         make_mesh(2, 2, allow_subset=True))
    win = ShardedLearner(cfg.replace(window=5),
                         graph, split,
                         make_mesh(2, 2, allow_subset=True))
    seq.run(23)
    win.run(23)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi)[: cfg.N],
                               np.asarray(seq.state.pi)[: cfg.N],
                               rtol=2e-4, atol=1e-7)
    seq.close(); win.close()


def test_sharded_windowed_model_axis_invisible():
    """With the data axis fixed, widening the model axis must not
    change the windowed trajectory (the RNG laws depend only on
    n_data): (2,1) vs (2,4) coincide to fp tolerance."""
    cfg, graph, split = make_cfg(seed=95)
    wcfg = cfg.replace(window=4)
    a = ShardedLearner(wcfg, graph, split,
                       make_mesh(2, 1, allow_subset=True))
    b = ShardedLearner(wcfg, graph, split, make_mesh(2, 4))
    a.run(24)
    b.run(24)
    np.testing.assert_allclose(np.asarray(a.state.pi)[: cfg.N],
                               np.asarray(b.state.pi)[: cfg.N],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(a.heldout_perplexity(),
                               b.heldout_perplexity(), rtol=1e-4)
    a.close(); b.close()


def test_sharded_windowed_fused_ppx_series():
    """run_with_ppx rides the windowed sharded scan: the eval series
    matches the unwindowed sharded engine's."""
    cfg, graph, split = make_cfg(steps_per_call=24)
    seq = ShardedLearner(cfg, graph, split,
                         make_mesh(2, 2, allow_subset=True))
    win = ShardedLearner(cfg.replace(window=4),
                         graph, split,
                         make_mesh(2, 2, allow_subset=True))
    s1 = seq.run_with_ppx(24, 6)
    s2 = win.run_with_ppx(24, 6)
    assert [e["step"] for e in s1] == [e["step"] for e in s2]
    for e1, e2 in zip(s1, s2):
        np.testing.assert_allclose(e2["ppx"], e1["ppx"], rtol=1e-4)
    seq.close(); win.close()


def test_sharded_windowed_bf16_pi():
    """bf16 pi storage through the windowed sharded path: rows are
    quantized at the local write application, upcast in the collective
    fetch; training proceeds and rows stay normalized."""
    cfg, graph, split = make_cfg(pi_dtype="bfloat16")
    lrn = ShardedLearner(cfg.replace(window=4),
                         graph, split, make_mesh(2, 4))
    p0 = lrn.heldout_perplexity()
    lrn.run(48)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite([p0, p1]).all() and p1 < p0
    pi = np.asarray(lrn.state.pi)[: cfg.N].astype(np.float32)
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=2e-2)
    lrn.close()


def test_sharded_window_requires_fast_path():
    """window > 1 without device_sampling (or without shared draws)
    must error loudly, not silently fall back."""
    cfg, graph, split = make_cfg()
    with pytest.raises(ValueError, match="window"):
        ShardedLearner(cfg.replace(window=4, device_sampling=False),
                       graph, split, make_mesh(2, 2, allow_subset=True))
    with pytest.raises(ValueError, match="shared_neighbors"):
        ShardedLearner(cfg.replace(window=4, shared_neighbors=False),
                       graph, split, make_mesh(2, 2, allow_subset=True))
