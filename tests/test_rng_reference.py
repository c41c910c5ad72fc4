"""Reference RNG backend tests.

Patterns from /root/reference/mcmc/random-test.cc: seed-law layout check
(:27-33), randn moment test over bulk draws (:80-98); plus bit-exactness
of the emulated 64-bit xorshift128+ core against a numpy uint64 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.rng import reference as ref


def xorshift128p_oracle(state, steps):
    """numpy uint64 oracle of random.cl.inc:13-25."""
    x, y = np.uint64(state[0]), np.uint64(state[1])
    out = []
    with np.errstate(over="ignore"):
        for _ in range(steps):
            s1, s0 = x, y
            x = s0
            s1 ^= np.uint64((int(s1) << 23) & 0xFFFFFFFFFFFFFFFF)
            y = s1 ^ s0 ^ (s1 >> np.uint64(17)) ^ (s0 >> np.uint64(26))
            out.append(np.uint64((int(y) + int(s0)) & 0xFFFFFFFFFFFFFFFF))
    return out


def test_seed_law():
    seeds = np.asarray(ref.make_seeds((42, 43), 5))
    for i in range(5):
        x = (int(seeds[i, 0]) << 32) | int(seeds[i, 1])
        y = (int(seeds[i, 2]) << 32) | int(seeds[i, 3])
        assert x == 42 + i and y == 43 + i


def test_xorshift_bit_exact():
    seeds = ref.make_seeds((123456789, 987654321), 3)
    got = []
    s = seeds
    step = jax.jit(ref.rand_u64)
    for _ in range(50):
        rh, rl, s = step(s)
        got.append((np.asarray(rh), np.asarray(rl)))
    for lane in range(3):
        oracle = xorshift128p_oracle((123456789 + lane, 987654321 + lane), 50)
        for t in range(50):
            want = int(oracle[t])
            have = (int(got[t][0][lane]) << 32) | int(got[t][1][lane])
            assert have == want, (lane, t, hex(have), hex(want))


def test_masked_lanes_freeze():
    seeds = ref.make_seeds((7, 9), 4)
    mask = jnp.asarray([True, False, True, False])
    _, _, s2 = ref.rand_u64(seeds, mask)
    s0 = np.asarray(seeds)
    s2 = np.asarray(s2)
    np.testing.assert_array_equal(s2[1], s0[1])
    np.testing.assert_array_equal(s2[3], s0[3])
    assert not np.array_equal(s2[0], s0[0])


def test_uniform_range():
    # note: xorshift128+ warms up from low-entropy consecutive seeds —
    # the first draw from seed (1+i, 2+i) is tiny (faithful to the
    # reference core); pool several rounds for the moment check
    seeds = ref.make_seeds((0x9E3779B97F4A7C15, 0xD1B54A32D192ED03), 4096)
    fn = jax.jit(ref.uniform)
    pools, s = [], seeds
    for _ in range(8):
        u, s = fn(s)
        pools.append(np.asarray(u))
    u = np.concatenate(pools)
    assert (u >= 0).all() and (u <= 1.0).all()
    assert abs(u.mean() - 0.5) < 0.02


def test_randint_range_and_mod_law():
    seeds = ref.make_seeds((11, 13), 2048)
    r, _ = jax.jit(lambda s: ref.randint(s, 0, 999))(seeds)
    r = np.asarray(r)
    assert (r >= 0).all() and (r <= 999).all()
    # exact mod law vs oracle
    for lane in (0, 1, 17):
        want = int(xorshift128p_oracle((11 + lane, 13 + lane), 1)[0] %
                   np.uint64(1000))
        assert r[lane] == want


def test_randn_moments():
    """10k-lane x 20-draw moment check (random-test.cc:80-98 logs
    mean/stdev over 10M; we use 200k draws, loose bounds)."""
    seeds = ref.make_seeds((42, 43), 10_000)
    draws = []
    s = seeds
    fn = jax.jit(ref.randn)
    for _ in range(20):
        x, s = fn(s)
        draws.append(np.asarray(x))
    x = np.concatenate(draws)
    # consecutive seeds (the reference's seed_i = base+i law) leave the
    # streams mildly correlated before xorshift mixes; a KS test with
    # well-separated seeds gives p=0.74, so bounds here are loosened
    # only for that correlation, not distribution error
    assert abs(x.mean()) < 0.01, x.mean()
    assert abs(x.std() - 1.0) < 0.02, x.std()
    assert abs((x < 0).mean() - 0.5) < 0.01
    # tail sanity: beyond the base strip R
    assert (np.abs(x) > ref.PARAM_R).mean() < 1e-3
    assert np.abs(x).max() > ref.PARAM_R  # tail does get sampled


def test_gamma_moments():
    # burn in the streams first: consecutive small seeds produce tiny
    # first uniforms until xorshift mixes (the reference shares this)
    seeds = ref.make_seeds((5, 6), 50_000)
    for _ in range(12):
        _, _, seeds = ref.rand_u64(seeds)
    g, _ = jax.jit(lambda s: ref.rand_gamma(s, 1.0, 1.0))(seeds)
    g = np.asarray(g)
    assert (g > 0).all()
    assert abs(g.mean() - 1.0) < 0.03      # Gamma(1,1): mean 1
    assert abs(g.var() - 1.0) < 0.06       # var 1
    g2, _ = jax.jit(lambda s: ref.rand_gamma(s, 0.5, 2.0))(seeds)
    g2 = np.asarray(g2)
    assert abs(g2.mean() - 1.0) < 0.03     # mean a*b = 1
    assert abs(g2.var() - 2.0) < 0.15      # var a*b^2 = 2


def test_ziggurat_tables_structural():
    ytab = np.asarray(ref._YTAB)
    wtab = np.asarray(ref._WTAB)
    assert ytab[0] == pytest.approx(1.0, abs=5e-3)
    assert ytab[-1] == pytest.approx(np.exp(-0.5 * ref.PARAM_R**2), rel=1e-5)
    assert (np.diff(ytab) < 0).all()
    # wtab[126] * 2^24 = x_127 = R
    assert wtab[126] * 2**24 == pytest.approx(ref.PARAM_R, rel=1e-5)


@pytest.mark.slow  # e2e Learner run; the unit bit-exactness tests above are the quick tier
def test_learner_with_reference_backend():
    """End-to-end: training with the reference RNG backend converges and
    is deterministic across runs (same seeds -> same trajectory)."""
    from mcmc_ammsb.config import Config, RngBackend
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.learner import Learner

    def build():
        n, u, v = synthetic_edges(200, 8, seed=41)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=42)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     rng_backend=RngBackend.REFERENCE)
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return Learner(cfg, graph, split, prefetch=False)

    a = build()
    assert a.state.ref_seeds is not None
    seeds_before = np.asarray(a.state.ref_seeds.beta).copy()
    p0 = a.heldout_perplexity()
    a.run(40)
    p1 = a.heldout_perplexity()
    assert np.isfinite([p0, p1]).all() and p1 < p0
    # streams advanced and are part of state
    assert not np.array_equal(np.asarray(a.state.ref_seeds.beta),
                              seeds_before)

    b = build()
    b.heldout_perplexity()
    b.run(40)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def _nbr_oracle(state, node, n, num):
    """numpy oracle of generate_random_int_kernel (sample.cc:13-78)."""
    x, y = np.uint64(state[0]), np.uint64(state[1])
    capacity = 2 * num

    def rand():
        nonlocal x, y
        with np.errstate(over="ignore"):
            s1, s0 = x, y
            x = s0
            s1 ^= np.uint64((int(s1) << 23) & 0xFFFFFFFFFFFFFFFF)
            y = s1 ^ s0 ^ (s1 >> np.uint64(17)) ^ (s0 >> np.uint64(26))
            return np.uint64((int(y) + int(s0)) & 0xFFFFFFFFFFFFFFFF)

    out = [n] * capacity
    stride = 1 + (capacity << 1)
    for _ in range(num):
        while True:
            while True:
                r = int(rand() % np.uint64(n))
                if r != node:
                    break
            l1 = (r ^ 553105253) % capacity
            val = None
            i = 0
            while True:
                off = (l1 + i * stride) % capacity
                val = out[off]
                if val == r:
                    break
                if val == n:
                    out[off] = r
                    break
                i += 1
            if val != r:
                break
    packed = [v for v in out if v != n][:num]
    return packed, (int(x), int(y))


def test_neighbor_sampler_reference_bit_exact():
    """The reference neighbor sampler (hash-dedup, slot-order packing)
    must match a per-lane numpy oracle bit for bit, including stream
    positions after the call."""
    n, num, b = 97, 4, 6
    base = (123456789, 987654321)
    seeds = ref.make_seeds(base, b)
    nodes = jnp.asarray([3, 10, 50, 96, 0, 7], jnp.int32)
    packed, seeds2 = jax.jit(
        lambda s, nd: ref.sample_neighbors_reference(s, nd, n, num)
    )(seeds, nodes)
    packed = np.asarray(packed)
    seeds2 = np.asarray(seeds2)
    for lane in range(b):
        want, (wx, wy) = _nbr_oracle(
            (base[0] + lane, base[1] + lane), int(nodes[lane]), n, num)
        assert packed[lane].tolist() == want, (lane, packed[lane], want)
        gx = (int(seeds2[lane, 0]) << 32) | int(seeds2[lane, 1])
        gy = (int(seeds2[lane, 2]) << 32) | int(seeds2[lane, 3])
        assert (gx, gy) == (wx, wy), lane
    # invariants
    for lane in range(b):
        row = packed[lane]
        assert len(set(row.tolist())) == num
        assert int(nodes[lane]) not in row
        assert row.min() >= 0 and row.max() < n


def test_neighbor_sampler_rejects_impossible_draw():
    """num >= num_nodes would spin the device while_loop forever; the
    wrapper must refuse at trace time."""
    seeds = ref.make_seeds((1, 2), 2)
    nodes = jnp.asarray([0, 1], jnp.int32)
    with pytest.raises(ValueError, match="distinct"):
        ref.sample_neighbors_reference(seeds, nodes, 4, 4)
