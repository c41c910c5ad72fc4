"""Checks of the compiled program at the bench widths (N=317,080,
K=256, m=n=32), shared by the card-only tests (tests/test_card.py,
marked ``gpu``) and ``chip_smoke.py``. Each check raises
AssertionError on a mismatch and returns a short summary string.

These are the places where the GPU's numerics differ from the CPU's:
a f32 contraction left to TF32 rounds node ids and one-hot selects,
and scatter order is not fixed. The CPU tests cannot see either."""

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import Config, EdgeSetBackend, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb.ops.edgeset import build_edge_set

from oracle import (beta_grads_oracle, bf_oracle, device_edges, phi_oracle,
                    theta_step_oracle)

#: com-DBLP rung of the config ladder, as ``--synthetic 317080,7``
BENCH_NODES, BENCH_DEGREE = 317_080, 7


def bench_graph():
    """The graph the CLI builds for ``--synthetic 317080,7``."""
    n, u, v = synthetic_edges(BENCH_NODES, BENCH_DEGREE, seed=1)
    split = generate_sets(n, u, v, 0.01)
    return Graph.from_edges(n, split.training_u, split.training_v), split


def bench_config(graph, split, **kw) -> Config:
    base = dict(K=256, mini_batch_size=32, num_node_sample=32,
                device_sampling=True, shared_neighbors=True)
    base.update(kw)
    return Config(**base).finalize(graph.num_nodes, split.total_edges,
                                   graph.max_fan_out)


def check_window_matches_sequential(graph, split, window=12, steps=48):
    """The windowed engine reproduces the sequential scan's trajectory
    (pi, theta) at the bench widths."""
    cfg = bench_config(graph, split, steps_per_call=steps)
    seq = Learner(cfg, graph, split, prefetch=False)
    win = Learner(cfg.replace(window=window), graph, split,
                  prefetch=False)
    try:
        seq.run(steps)
        win.run(steps)
        pi_s, pi_w = np.asarray(seq.state.pi), np.asarray(win.state.pi)
        np.testing.assert_allclose(pi_w, pi_s, rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(np.asarray(win.state.theta),
                                   np.asarray(seq.state.theta),
                                   rtol=2e-4, atol=1e-7)
        return (f"window={window} vs sequential over {steps} steps: "
                f"max|dpi|={np.max(np.abs(pi_w - pi_s)):.3g}")
    finally:
        seq.close()
        win.close()


def check_phi_beta_vs_oracle(graph, split, seed=0):
    """phi (private and shared neighbor draws) and beta/theta updates
    against the float64 numpy oracle at K=256."""
    cfg = bench_config(graph, split)
    rng = np.random.RandomState(seed)
    pi_raw = rng.gamma(1.0, 1.0, size=(cfg.N, cfg.K)).astype(np.float32)
    phi_sum = pi_raw.sum(-1)
    pi = pi_raw / phi_sum[:, None]
    theta = rng.gamma(1.0, 1.0, size=(cfg.K, 2)).astype(np.float32)
    beta = theta[:, 1] / theta.sum(-1)
    es = build_edge_set(EdgeSetBackend.CSR, cfg.N, graph.edges_u,
                        graph.edges_v)
    b, n_s, step = cfg.mini_batch_size + 1, cfg.num_node_sample, 5
    nodes = rng.choice(cfg.N, b, replace=False).astype(np.int32)
    # half the private draws are real neighbors (linked pairs)
    nbrs = rng.randint(0, cfg.N, size=(b, n_s)).astype(np.int32)
    for i, a in enumerate(nodes):
        real = graph.neighbors_of(int(a))[: n_s // 2]
        nbrs[i, : len(real)] = real
    noise = rng.randn(b, cfg.K).astype(np.float32)
    got = jax.jit(lambda *a: phi_ops.phi_update_rows(cfg, *a))(
        jnp.asarray(pi), jnp.asarray(phi_sum), jnp.asarray(beta), es,
        jnp.asarray(nodes), jnp.asarray(nbrs),
        jnp.asarray(step, jnp.int32), jnp.asarray(noise))
    want = phi_oracle(cfg, pi, phi_sum, beta, graph.has_edge, nodes,
                      nbrs, step, noise)
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(got[1]), want[1], rtol=2e-4)

    # shared draw: one neighbor set for every node (no self-collisions)
    shared = np.setdiff1d(rng.choice(cfg.N, 2 * n_s, replace=False),
                          nodes)[:n_s].astype(np.int32)
    y = np.array([[graph.has_edge(min(a, v), max(a, v)) for v in shared]
                  for a in nodes])
    got = jax.jit(lambda *a: phi_ops.phi_update_core(cfg, *a))(
        jnp.asarray(pi[nodes]), jnp.asarray(phi_sum[nodes]),
        jnp.asarray(pi[shared][None]), jnp.asarray(y), jnp.asarray(beta),
        jnp.asarray(step, jnp.int32), jnp.asarray(noise),
        jnp.ones((b, n_s), bool))
    want = phi_oracle(cfg, pi, phi_sum, beta, graph.has_edge, nodes,
                      np.broadcast_to(shared, (b, n_s)), step, noise)
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=2e-4,
                               atol=1e-7)

    e_cap = cfg.max_batch_edges
    eu = np.concatenate([graph.edges_u[:16],
                         rng.randint(0, cfg.N, 16).astype(np.int32)])
    ev = np.concatenate([graph.edges_v[:16],
                         rng.randint(0, cfg.N, 16).astype(np.int32)])
    keep = eu != ev
    eu, ev = eu[keep], ev[keep]
    peu = np.zeros(e_cap, np.int32)
    pev = np.zeros(e_cap, np.int32)
    peu[: len(eu)], pev[: len(ev)] = eu, ev
    mask = np.arange(e_cap) < len(eu)
    tnoise = rng.randn(cfg.K, 2).astype(np.float32)
    scale, count = 37.5, 3
    got_theta, got_beta = jax.jit(
        lambda *a: beta_ops.update_beta(cfg, *a))(
        jnp.asarray(theta), jnp.asarray(beta), jnp.asarray(pi), es,
        jnp.asarray(peu), jnp.asarray(pev), jnp.asarray(mask),
        jnp.asarray(scale, jnp.float32), jnp.asarray(count, jnp.int32),
        jnp.asarray(tnoise))
    grads = beta_grads_oracle(cfg, theta, beta, pi, graph.has_edge, eu,
                              ev)
    want_theta, want_beta = theta_step_oracle(cfg, theta, grads, scale,
                                              count, tnoise)
    np.testing.assert_allclose(np.asarray(got_theta), want_theta,
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_beta), want_beta,
                               rtol=2e-4, atol=1e-6)
    return f"phi (private, shared) and beta match the oracle at K={cfg.K}"


def check_device_bf_bitwise(graph, split, s_len=8, seed=7):
    """Device BFLink minibatches equal the python replay of the
    sampler bit for bit at the bench graph's node ids."""
    cfg = bench_config(graph, split, strategy=SampleStrategy.BF_LINK,
                       shared_neighbors=False)
    tr = build_edge_set(EdgeSetBackend.CSR, cfg.N, graph.edges_u,
                        graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, cfg.N, split.heldout_u,
                        split.heldout_v)
    adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                 jnp.asarray(graph.cols, jnp.int32))
    key = jax.random.PRNGKey(seed)
    _, k_link, _ = jax.random.split(key, 3)
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=adjacency))(key)
    want = bf_oracle(cfg, graph, None, k_link, s_len, "link")
    n_edges = 0
    for s in range(s_len):
        got = device_edges(ds, s)
        assert got == want[s], f"step {s}: device {got} != oracle {want[s]}"
        n_edges += len(got)
    top = max(max(max(e) for e in w) for w in want if w)
    return (f"device BFLink == oracle over {s_len} steps ({n_edges} "
            f"edges, largest node id {top})")
