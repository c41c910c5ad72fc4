"""End-to-end learner tests: the minimum slice of SURVEY.md §7 —
perplexity must decrease on a synthetic graph — plus scan-fusion
equivalence and sampling-strategy invariants."""

import jax
import numpy as np
import pytest

from mcmc_ammsb.config import Config, RngBackend, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.sampling import MiniBatchSampler
from mcmc_ammsb.types import pack_edges

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def make_learner(cfg_kw=None, n_nodes=300, avg_deg=12, seed=21):
    n, u, v = synthetic_edges(n_nodes, avg_deg, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    # numpy sampler: single-step and scan paths share one RNG stream,
    # which the cross-path equivalence tests rely on (the native C++
    # sampler reseeds per chunk call)
    kw = dict(K=8, mini_batch_size=8, num_node_sample=8,
              host_sampler="numpy")
    kw.update(cfg_kw or {})
    cfg = Config(**kw)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return Learner(cfg, graph, split, prefetch=False), split


def test_perplexity_decreases():
    learner, _ = make_learner()
    ppx0 = learner.heldout_perplexity()
    learner.run(150)
    ppx1 = learner.heldout_perplexity()
    learner.run(150)
    ppx2 = learner.heldout_perplexity()
    learner.close()
    assert np.isfinite([ppx0, ppx1, ppx2]).all()
    assert ppx2 < ppx0, f"perplexity did not improve: {ppx0} -> {ppx2}"


def test_scan_matches_single_steps():
    """steps_per_call fusion must be trajectory-identical to the
    step-at-a-time path given the same minibatch stream."""
    l1, _ = make_learner()
    l2, _ = make_learner({"steps_per_call": 5})
    # identical host sampler streams
    assert l1.cfg.sample_seed == l2.cfg.sample_seed
    l1.run(10)
    l2.run(10)
    # the scan path hoists RNG/membership out of the loop, so XLA
    # fuses (and reassociates fp32 sums) differently — draws and math
    # are identical, tolerance covers rounding only
    np.testing.assert_allclose(np.asarray(l1.state.pi),
                               np.asarray(l2.state.pi),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(l1.state.theta),
                               np.asarray(l2.state.theta),
                               rtol=2e-4, atol=1e-7)
    assert int(l1.state.step_count) == int(l2.state.step_count) == 11
    l1.close(); l2.close()


def test_state_counters_and_shapes():
    learner, split = make_learner()
    st = learner.state
    cfg = learner.cfg
    assert st.pi.shape == (cfg.N, cfg.K)
    assert st.phi_sum.shape == (cfg.N,)
    assert st.theta.shape == (cfg.K, 2)
    assert st.ppx_per_edge.shape == (len(split.heldout_edges_u),)
    # pi rows normalized, phi_sum consistent with raw gamma draws
    np.testing.assert_allclose(np.asarray(st.pi).sum(-1), 1.0, rtol=1e-5)
    learner.close()


@pytest.mark.parametrize("strategy,check", [
    (SampleStrategy.NODE_LINK, "link"),
    (SampleStrategy.NODE_NON_LINK, "nonlink"),
    (SampleStrategy.BF_LINK, "link"),
    (SampleStrategy.BF_NON_LINK, "nonlink"),
])
def test_sampling_strategies(strategy, check):
    learner, split = make_learner({"strategy": strategy})
    cfg, graph = learner.cfg, learner.graph
    sampler = MiniBatchSampler(cfg, graph, split)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    for _ in range(5):
        eu, ev, w = sampler._sample_raw()
        assert np.all(eu < ev)
        keys = pack_edges(eu, ev)
        assert len(set(keys.tolist())) == len(keys)  # batch is a *set*
        if check == "link":
            assert all(int(k) in training for k in keys)
            expected_w = (cfg.N if strategy == SampleStrategy.NODE_LINK
                          else cfg.E / cfg.mini_batch_size)
        else:
            assert not any(int(k) in training for k in keys)
            assert len(eu) == cfg.mini_batch_size
            expected_w = (2.0 * cfg.E / cfg.mini_batch_size
                          if strategy == SampleStrategy.NODE_NON_LINK
                          else (cfg.N * (cfg.N - 1) / 2.0 - cfg.E)
                          / cfg.mini_batch_size)
        assert np.isclose(w, expected_w)
    learner.close()


def test_node_link_is_single_node_fan():
    learner, split = make_learner({"strategy": SampleStrategy.NODE_LINK})
    sampler = MiniBatchSampler(learner.cfg, learner.graph, split)
    eu, ev, w = sampler._node_link()
    # all edges share one endpoint (sample.cc:253-268)
    common = set(eu.tolist()) & set(ev.tolist())
    nodes, counts = np.unique(np.concatenate([eu, ev]), return_counts=True)
    pivot = nodes[counts.argmax()]
    assert counts.max() == len(eu)
    deg = len(learner.graph.neighbors_of(int(pivot)))
    assert len(eu) == deg
    learner.close()


def test_training_perplexity():
    """MCMC_CALC_TRAIN_PPX parity: population = ratio of training links
    + proportional non-links; running averages in dedicated state."""
    learner, split = make_learner({"calc_train_ppx": True,
                                   "training_ppx_ratio": 0.05})
    cfg = learner.cfg
    num_links = int(0.05 * len(split.training_u))
    total = cfg.N * (cfg.N - 1) // 2
    assert learner.train_ppx_u.shape[0] == num_links + int(
        num_links * total / float(cfg.E))
    t0 = learner.training_perplexity()
    learner.run(100)
    t1 = learner.training_perplexity()
    assert np.isfinite([t0, t1]).all() and t0 > 0 and t1 > 0
    # population is dominated by easy non-links, so short-run movement
    # is small; just require it not to blow up
    assert t1 < t0 * 1.1
    assert int(learner.state.train_ppx_count) == 2
    learner.close()


def test_empty_heldout_guard():
    """heldout_ratio too small for the graph -> informative error at
    evaluation, not a NaN (the reference only evaluates when the split
    is non-empty, data.cc:89-98)."""
    n, u, v = synthetic_edges(120, 6, seed=77)
    split = generate_sets(n, u, v, heldout_ratio=0.0, seed=78)
    assert len(split.heldout_edges_u) == 0
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=4, mini_batch_size=4, num_node_sample=4,
                 host_sampler="numpy")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    lrn.run(3)  # training itself is fine
    with pytest.raises(RuntimeError, match="held-out"):
        lrn.heldout_perplexity()
    lrn.close()


@pytest.mark.parametrize("cfg_kw", [
    {"steps_per_call": 4, "rng_backend": RngBackend.REFERENCE},
])
def test_scan_in_loop_body_paths(cfg_kw):
    """The scan's in-loop body branch (reference RNG backend) trains
    and advances counters like the hoisted path."""
    learner, _ = make_learner(cfg_kw)
    p0 = learner.heldout_perplexity()
    learner.run(12)
    p1 = learner.heldout_perplexity()
    assert int(learner.state.step_count) == 13
    assert np.isfinite([p0, p1]).all()
    learner.close()


def test_reference_scan_hoisted_labels_bit_exact():
    """The reference-RNG scan hoists edge labels + endpoint lane maps
    and reads the beta stage's endpoint rows from the staged phi rows
    (round 4); the trajectory must stay BIT-identical to the
    step-at-a-time train_step path (spc=1), whose beta stage gathers
    from pi and re-queries membership."""
    kw = {"rng_backend": RngBackend.REFERENCE}
    a, _ = make_learner({**kw, "steps_per_call": 6})
    b, _ = make_learner({**kw, "steps_per_call": 1})
    a.run(12); b.run(12)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.theta),
                                  np.asarray(b.state.theta))
    np.testing.assert_array_equal(
        np.asarray(a.state.ref_seeds.phi),
        np.asarray(b.state.ref_seeds.phi))
    assert a.heldout_perplexity() == b.heldout_perplexity()
    a.close(); b.close()


def test_edgeset_backends_trajectory_identical():
    """Membership backends answer identical queries, so full training
    trajectories must be bit-identical across them — pins the perfect
    hash as a pure drop-in for the CSR search."""
    from mcmc_ammsb.config import EdgeSetBackend

    a, _ = make_learner({"steps_per_call": 5,
                         "edgeset_backend": EdgeSetBackend.CSR})
    b, _ = make_learner({"steps_per_call": 5,
                         "edgeset_backend": EdgeSetBackend.PERFECT})
    a.run(20); b.run(20)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.beta),
                                  np.asarray(b.state.beta))
    pa = a.heldout_perplexity(); pb = b.heldout_perplexity()
    assert pa == pb
    a.close(); b.close()


def test_fused_ppx_series_matches_host_loop():
    """run_with_ppx composes the exact fused-chunk + eval functions
    inside one dispatch, so its series must reproduce the host loop
    (run(interval); heldout_perplexity()) bit-exactly — values, link
    stats, and final state."""
    kw = {"device_sampling": True, "steps_per_call": 40}
    a, _ = make_learner(kw)
    b, _ = make_learner(kw)

    series = a.run_with_ppx(40, 10)
    assert [ev["step"] for ev in series] == [11, 21, 31, 41]

    host = []
    for _ in range(4):
        b.run(10)
        host.append((b.heldout_perplexity(), dict(b.last_ppx_stats)))

    for ev, (ppx, st) in zip(series, host):
        assert ev["ppx"] == ppx
        assert ev["link_count"] == st["link_count"]
        assert ev["non_link_count"] == st["non_link_count"]
        assert ev["link_likelihood"] == st["link_likelihood"]
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.ppx_per_edge),
                                  np.asarray(b.state.ppx_per_edge))
    a.close(); b.close()


def test_fused_ppx_series_carries_train_ppx():
    """With calc_train_ppx the fused series carries the train-ppx
    value per eval (round-4: it used to force the host loop) and the
    running-average state matches the host loop's
    (run(interval); heldout_perplexity(); training_perplexity())
    ordering bit-exactly."""
    kw = {"device_sampling": True, "steps_per_call": 40,
          "calc_train_ppx": True, "training_ppx_ratio": 0.2}
    a, _ = make_learner(kw)
    b, _ = make_learner(kw)

    series = a.run_with_ppx(40, 10)
    host = []
    for _ in range(4):
        b.run(10)
        ppx = b.heldout_perplexity()
        host.append((ppx, b.training_perplexity()))

    for ev, (ppx, tppx) in zip(series, host):
        assert ev["ppx"] == ppx
        np.testing.assert_allclose(ev["train_ppx"], tppx, rtol=1e-6)
    assert int(a.state.train_ppx_count) == 4
    np.testing.assert_array_equal(
        np.asarray(a.state.train_ppx_per_edge),
        np.asarray(b.state.train_ppx_per_edge))
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def test_fused_ppx_tail_and_guards():
    kw = {"device_sampling": True, "steps_per_call": 40}
    a, _ = make_learner(kw)
    series = a.run_with_ppx(25, 10)   # 2 evals + 5-step tail, no eval
    assert len(series) == 2
    assert int(a.state.step_count) == 26
    a.close()
    b, _ = make_learner({})
    import pytest as _pytest
    with _pytest.raises(RuntimeError, match="device_sampling"):
        b.run_with_ppx(10, 5)
    b.close()


def test_batch_nodes_cap_below_minimum_rejected():
    """A user cap below max(2m, max_fan_out+1) would truncate the
    deduped node prefix and silently corrupt the edge-lane maps
    (ADVICE r2); finalize must reject it loudly."""
    cfg = Config(K=8, mini_batch_size=8, batch_nodes_cap=10)
    with pytest.raises(ValueError, match="batch_nodes_cap"):
        cfg.finalize(N=100, E=300, max_fan_out=20)
    # at or above the derived minimum it passes through
    ok = Config(K=8, mini_batch_size=8, batch_nodes_cap=32).finalize(
        N=100, E=300, max_fan_out=20)
    assert ok.max_batch_nodes == 32


def test_cli_fast_default_resolution():
    """resolve_fast_defaults: fast path auto-on for Node-family +
    native RNG; reference-exact combos stay on the host path;
    explicit flags always win."""
    from mcmc_ammsb import cli

    args = cli.build_arg_parser().parse_args(["--synthetic", "100,4"])
    cli.resolve_fast_defaults(args)
    assert args.device_sampling and args.shared_neighbors
    assert args.steps_per_call == 1000

    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "100,4", "--rng", "reference"])
    cli.resolve_fast_defaults(args)
    assert not args.device_sampling and not args.shared_neighbors
    assert args.steps_per_call == 100  # one dispatch per eval period

    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "100,4", "-s", "BF"])
    cli.resolve_fast_defaults(args)
    # breadth-first auto-defaults to the fused device family; shared
    # draws / windows stay Node-family-only
    assert args.device_sampling
    assert not args.shared_neighbors
    assert args.window == 0

    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "100,4", "-s", "BFLink", "--rng", "reference"])
    cli.resolve_fast_defaults(args)
    # the bit-exact RNG backend keeps the host-sampled reference path
    assert not args.device_sampling

    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "100,4", "--rng", "reference",
         "--no-ref-rng-block"])
    assert not args.ref_rng_block  # faithful per-draw loops, CLI-reachable

    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "100,4", "--no-device-sampling",
         "--steps-per-call", "7"])
    cli.resolve_fast_defaults(args)
    assert not args.device_sampling and not args.shared_neighbors
    assert args.steps_per_call == 7
