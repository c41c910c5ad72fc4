"""T-step windowed fused loop (ops/window.py): exact-semantics golden
tests against the sequential scan — the cross-mode validation pattern
of the reference (wg-phi-test.cc:116-158) applied to the window engine:
two schedules of the same trajectory (sequential scan, windowed) must
coincide.

The small graph (N=300, B=16) makes intra-window collisions FREQUENT,
so the dirty/clean lax.cond branches are both exercised heavily — the
exactness claim is tested where it is hardest, not on collision-free
data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, RngBackend
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def make_pair(n_nodes=300, window=4, seed=9, **kw):
    n, u, v = synthetic_edges(n_nodes, 8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    base = dict(K=8, mini_batch_size=8, num_node_sample=8,
                steps_per_call=24, device_sampling=True,
                shared_neighbors=True)
    base.update(kw)
    cfg = Config(**base).finalize(n, split.total_edges,
                                  graph.max_fan_out)
    seq = Learner(cfg, graph, split, prefetch=False)
    win = Learner(cfg.replace(window=window), graph, split,
                  prefetch=False)
    return cfg, seq, win


def test_dirty_windows_unit():
    """Constructed collisions: read-after-write, write-after-write,
    neighbor-read-after-write, and the clean case."""
    from mcmc_ammsb.ops.window import _dirty_windows

    T, B, n = 2, 2, 2
    nodes = np.array([
        [[1, 2], [3, 4]],       # clean
        [[1, 2], [1, 9]],       # step1 writes row step0 wrote (ww + rw)
        [[1, 2], [3, 4]],       # neighbor read of written row (below)
        [[5, 6], [7, 8]],       # clean
    ], np.int32)
    mask = np.ones_like(nodes, bool)
    nbrs = np.array([
        [[7, 8], [9, 9]],
        [[7, 8], [9, 9]],
        [[7, 8], [2, 9]],       # step1 neighbor 2 == step0 write
        [[1, 2], [3, 4]],       # same-step overlap only: still clean
    ], np.int32)
    got = np.asarray(_dirty_windows(jnp.asarray(nodes),
                                    jnp.asarray(mask),
                                    jnp.asarray(nbrs), T))
    np.testing.assert_array_equal(got, [False, True, True, False])

    # masked lanes never collide, even when the padded ids coincide
    mask2 = mask.copy()
    mask2[1, 1, 0] = False      # the colliding write is masked out
    got2 = np.asarray(_dirty_windows(jnp.asarray(nodes),
                                     jnp.asarray(mask2),
                                     jnp.asarray(nbrs), T))
    assert not got2[1]

    # padded lanes at DIFFERENT steps share the sentinel id; they are
    # non-writes and must not register as write-after-write (the
    # round-3 bug that flagged 100% of real windows dirty)
    pad_nodes = np.array([[[50, 99], [60, 99]]], np.int32)
    pad_mask = np.array([[[True, False], [True, False]]])
    pad_nbrs = np.array([[[7, 8], [9, 9]]], np.int32)
    got3 = np.asarray(_dirty_windows(jnp.asarray(pad_nodes),
                                     jnp.asarray(pad_mask),
                                     jnp.asarray(pad_nbrs), T))
    assert not got3[0]


@pytest.mark.parametrize("window", [2, 8])  # boundary Ts; 4 adds no distinct schedule
def test_windowed_jnp_matches_sequential(window):
    """The windowed jnp schedule reproduces the sequential scan's
    trajectory on collision-heavy data (24 steps, windows of T —
    including a non-dividing tail at T=8 since 24 % 8 == 0; T=5 below
    covers tails)."""
    cfg, seq, win = make_pair(window=window)
    seq.run(24)
    win.run(24)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(win.heldout_perplexity(),
                               seq.heldout_perplexity(), rtol=1e-6)
    seq.close(); win.close()


def test_windowed_tail_steps():
    """steps not divisible by T: the tail runs sequentially and the
    trajectory still matches."""
    cfg, seq, win = make_pair(window=5)
    seq.run(23)
    win.run(23)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=1e-6, atol=1e-9)
    seq.close(); win.close()


def test_windowed_fused_ppx_series_matches():
    """run_with_ppx rides the windowed scan: the eval series matches
    the sequential engine's."""
    cfg, seq, win = make_pair(window=4)
    s1 = seq.run_with_ppx(24, 6)
    s2 = win.run_with_ppx(24, 6)
    assert [e["step"] for e in s1] == [e["step"] for e in s2]
    for e1, e2 in zip(s1, s2):
        np.testing.assert_allclose(e2["ppx"], e1["ppx"], rtol=1e-6)
    seq.close(); win.close()


@pytest.mark.parametrize("m,n_smpl,k,window", [
    (5, 7, 12, 3),      # everything odd / non-power-of-two, K%8!=0, tail
    (2, 2, 2, 2),       # degenerate minimum (wg-sum-test.cc wg=2)
])
def test_windowed_odd_shapes(m, n_smpl, k, window):
    """Non-power-of-two / ragged shape sweep (the reference tests its
    kernels at wg sizes {2,4,16,32,64,96,113} and ragged lengths,
    wg-sum-test.cc:22-130): the sequential scan and the windowed
    schedule must coincide at shapes that exercise padding and
    masking off the friendly tiles."""
    cfg, seq, win = make_pair(window=window,
                              K=k, mini_batch_size=m,
                              num_node_sample=n_smpl,
                              steps_per_call=4 * window)
    steps = 4 * window
    seq.run(steps)
    win.run(steps)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=1e-6, atol=1e-9)
    seq.close(); win.close()


def test_window_requires_fast_path():
    n, u, v = synthetic_edges(300, 8, seed=9)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 window=4).finalize(n, split.total_edges,
                                    graph.max_fan_out)
    with pytest.raises(ValueError, match="window"):
        Learner(cfg, graph, split, prefetch=False)
