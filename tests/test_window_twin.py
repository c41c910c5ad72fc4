"""Quick-tier golden test of the windowed engine (ops/window.py): on a
tiny collision-heavy graph the windowed trajectory equals the
sequential scan's. tests/test_window.py holds the full sweep."""

import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner


@pytest.mark.parametrize("window", [2, 4])
def test_window_matches_sequential_scan(window):
    n, u, v = synthetic_edges(120, 6, seed=3)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=4)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=4, mini_batch_size=6, num_node_sample=6,
                 steps_per_call=8, device_sampling=True,
                 shared_neighbors=True).finalize(
        n, split.total_edges, graph.max_fan_out)
    seq = Learner(cfg, graph, split, prefetch=False)
    win = Learner(cfg.replace(window=window), graph, split,
                  prefetch=False)
    seq.run(8)
    win.run(8)
    assert int(win.state.step_count) == int(seq.state.step_count) == 9
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=1e-6, atol=1e-9)
    seq.close()
    win.close()
