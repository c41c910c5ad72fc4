"""bf16 pi storage (Config.pi_dtype): compute stays fp32, only the
stored rows are quantized — the capacity and bandwidth lever for large
K, where the step's row gathers and scatters move the most bytes.

Contract tested here: state dtype, row normalization within bf16
quantization, convergence tracking the fp32 run, bit-exact checkpoint
resume through the fp32 npz round-trip, and loud errors on the
unsupported engines."""

import numpy as np
import pytest

import jax.numpy as jnp

from mcmc_ammsb.config import Config, RngBackend
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges
from mcmc_ammsb.learner import Learner

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def _setup(seed=8, **kw):
    n, u, v = synthetic_sbm_edges(400, 4, p_in=0.12, p_out=0.005,
                                  seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=10, device_sampling=True, **kw)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out), \
        graph, split


def test_bf16_state_and_convergence():
    cfg, graph, split = _setup(pi_dtype="bfloat16")
    lrn = Learner(cfg, graph, split, prefetch=False)
    assert lrn.state.pi.dtype == jnp.bfloat16
    assert lrn.state.phi_sum.dtype == jnp.float32
    p0 = lrn.heldout_perplexity()
    lrn.run(300)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite(p1) and p1 < p0
    pi = np.asarray(lrn.state.pi, np.float32)
    # rows were normalized in fp32 then quantized: sums off by at most
    # K * 2^-9 relative
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=0.05)
    lrn.close()


def test_bf16_tracks_fp32_ppx():
    cfg, graph, split = _setup(pi_dtype="bfloat16")
    a = Learner(cfg, graph, split, prefetch=False)
    b = Learner(cfg.replace(pi_dtype="float32"), graph, split,
                prefetch=False)
    a.run(300); b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    # same seeds, same draws; only storage quantization differs
    assert abs(pa - pb) / pb < 0.05
    a.close(); b.close()


def test_bf16_checkpoint_bit_exact_resume(tmp_path):
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint

    cfg, graph, split = _setup(pi_dtype="bfloat16")
    a = Learner(cfg, graph, split, prefetch=False)
    a.run(20)
    path = str(tmp_path / "bf16.npz")
    save_checkpoint(path, a)
    a.run(30)

    b = Learner(cfg, graph, split, prefetch=False)
    load_checkpoint(path, b)
    assert b.state.pi.dtype == jnp.bfloat16
    b.run(30)
    np.testing.assert_array_equal(
        np.asarray(a.state.pi, np.float32),
        np.asarray(b.state.pi, np.float32))
    a.close(); b.close()


def test_bf16_unsupported_engines_raise():
    cfg, graph, split = _setup(pi_dtype="bfloat16")
    with pytest.raises(ValueError, match="pi_dtype|fp32"):
        Learner(cfg.replace(rng_backend=RngBackend.REFERENCE,
                            device_sampling=False), graph, split,
                prefetch=False)
    from mcmc_ammsb.chains import MultiChainLearner
    with pytest.raises(ValueError, match="fp32"):
        MultiChainLearner(cfg, graph, split, 2)


def test_bf16_windowed_single_chip_tracks_fp32():
    """bf16 pi through the single-chip T-step window engine: the bulk
    gather upcasts, staged compute is fp32, the window scatter
    quantizes (round 3 lifted the fp32-only window restriction)."""
    cfg, graph, split = _setup(pi_dtype="bfloat16",
                               shared_neighbors=True)
    cfg = cfg.replace(window=5)
    a = Learner(cfg, graph, split, prefetch=False)
    b = Learner(cfg.replace(pi_dtype="float32"), graph, split,
                prefetch=False)
    a.run(300); b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert np.isfinite(pa)
    np.testing.assert_allclose(pa, pb, rtol=0.05)
    a.close(); b.close()


def test_bf16_flat_chains_state_and_tracks_fp32():
    """bf16 pi on the flat multi-chain engine (round 3): storage
    quantized at the scatter, fp32 compute — per-chain ppx tracks the
    fp32 chains. The capacity knee this exists for: fp32 pi at C=16 x
    N=317k x K=256 is 5.2 GB; bf16 halves it."""
    from mcmc_ammsb.chains_flat import FlatChainLearner

    cfg, graph, split = _setup(pi_dtype="bfloat16")
    a = FlatChainLearner(cfg, graph, split, 3)
    assert a.state.pi.dtype == jnp.bfloat16
    assert a.state.phi_sum.dtype == jnp.float32
    b = FlatChainLearner(cfg.replace(pi_dtype="float32"), graph,
                         split, 3)
    a.run(300); b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert np.all(np.isfinite(pa))
    np.testing.assert_allclose(pa, pb, rtol=0.05)


def test_bf16_flat_chains_windowed_tracks_fp32():
    """The windowed path under bf16 pi: gather upcasts,
    staged compute is fp32, the window scatter quantizes."""
    from mcmc_ammsb.chains_flat import FlatChainLearner

    cfg, graph, split = _setup(pi_dtype="bfloat16",
                               shared_neighbors=True)
    cfg = cfg.replace(window=5)
    a = FlatChainLearner(cfg, graph, split, 2)
    b = FlatChainLearner(cfg.replace(pi_dtype="float32"), graph,
                         split, 2)
    a.run(300); b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert np.all(np.isfinite(pa))
    np.testing.assert_allclose(pa, pb, rtol=0.05)


def test_bf16_sharded_chains_state_and_convergence():
    """bf16 pi on the ('chains',) whole-chain mesh
    (parallel/chains_sharded.py): the same _chunk path, per-group
    blocks stored bf16."""
    import jax
    from jax.sharding import Mesh

    from mcmc_ammsb.parallel.chains_sharded import (
        CHAIN_AXIS, ShardedChainLearner)

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    mesh = Mesh(np.array(jax.devices()[:2]), (CHAIN_AXIS,))
    cfg, graph, split = _setup(pi_dtype="bfloat16")
    lrn = ShardedChainLearner(cfg, graph, split, 4, mesh)
    assert lrn.state.pi.dtype == jnp.bfloat16
    p0 = lrn.heldout_perplexity()
    lrn.run(300)
    p1 = lrn.heldout_perplexity()
    assert np.all(np.isfinite(p1)) and np.all(p1 < p0)


def test_bf16_sharded_state_and_convergence():
    """bf16 pi on the ('data','model') mesh: rows quantized at the
    all_gather write-back, upcast in _fetch_rows — the capacity lever
    composed WITH the row sharding (the RowPartitionedMatrix
    generalization, partitioned-alloc.h:87-131)."""
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh

    cfg, graph, split = _setup(pi_dtype="bfloat16")
    lrn = ShardedLearner(cfg, graph, split, make_mesh(2, 4),
                         prefetch=False)
    assert lrn.state.pi.dtype == jnp.bfloat16
    assert lrn.state.phi_sum.dtype == jnp.float32
    p0 = lrn.heldout_perplexity()
    lrn.run(300)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite(p1) and p1 < p0
    pi = np.asarray(lrn.state.pi, np.float32)[:cfg.N]
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=0.05)
    lrn.close()


def test_bf16_sharded_tracks_single_chip():
    """Cross-engine contract: the sharded bf16 trajectory's held-out
    ppx matches the single-chip bf16 run closely (same draws; the only
    deltas are collective reduction order and per-data-shard noise
    stream splits)."""
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh

    cfg, graph, split = _setup(pi_dtype="bfloat16")
    a = ShardedLearner(cfg, graph, split, make_mesh(2, 4),
                       prefetch=False)
    b = Learner(cfg, graph, split, prefetch=False)
    a.run(300); b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert abs(pa - pb) / pb < 0.05
    a.close(); b.close()


def test_bf16_sharded_checkpoint_bit_exact_resume(tmp_path):
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh

    cfg, graph, split = _setup(pi_dtype="bfloat16")
    mesh = make_mesh(2, 4)
    a = ShardedLearner(cfg, graph, split, mesh, prefetch=False)
    a.run(20)
    path = str(tmp_path / "bf16_sharded.npz")
    save_checkpoint(path, a)
    a.run(30)

    b = ShardedLearner(cfg, graph, split, mesh, prefetch=False)
    load_checkpoint(path, b)
    assert b.state.pi.dtype == jnp.bfloat16
    b.run(30)
    np.testing.assert_array_equal(
        np.asarray(a.state.pi, np.float32),
        np.asarray(b.state.pi, np.float32))
    a.close(); b.close()


def test_unknown_pi_dtype_raises():
    cfg, graph, split = _setup()
    with pytest.raises(ValueError, match="unknown pi_dtype"):
        Learner(cfg.replace(pi_dtype="float16"), graph, split,
                prefetch=False)
