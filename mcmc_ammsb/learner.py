"""Learner: state container, fused train step, run loop, evaluation.

The re-design of /root/reference/mcmc/learner.{h,cc}. Key structural
difference from the reference: where the reference's hot loop launches
7+ kernels with a full queue sync after each (learner.cc:214-250,
phi.cc:728-763, beta.cc:334-384), here one pure function

    state' = train_step(state, batch)

is traced once and compiled by XLA into a single fused device program;
``run`` further folds ``steps_per_call`` consecutive steps into one
``lax.scan`` dispatch, so per-step launch overhead amortizes to ~zero.
Host minibatch sampling overlaps device compute through a producer
thread (the analog of MCMC_SAMPLE_PARALLEL, learner.cc:216-246).

State initialization follows learner.cc:149-155:
  theta ~ Gamma(eta0, eta1), beta = pairwise-normalized copy;
  pi rows ~ Gamma(eta0, eta1) then row-normalized, phi = raw row sums.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import Config, RngBackend
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import perplexity as ppx_ops
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set
from mcmc_ammsb.ops.neighbor import sample_neighbors
from mcmc_ammsb.rng import native as native_rng
from mcmc_ammsb.sampling import (MiniBatch, MiniBatchSampler,
                                 PrefetchingSampler, StackedBatches)
from mcmc_ammsb.utils.timing import StageTimers


class RefRngState(NamedTuple):
    """Per-thread xorshift128+ seed arrays for the reference RNG backend.

    Stream assignment mirrors the reference kernels: one stream per
    minibatch node lane for phi noise (PHI_NODE_PER_THREAD law,
    /root/reference/mcmc/phi.cc:140-150, K sequential draws per step)
    and one stream per community for theta noise (update_theta draws
    r0, r1 per k, /root/reference/mcmc/beta.cc:57-80). Streams persist
    across steps exactly like the checkpointed rand->base_ arrays.
    """

    phi: jnp.ndarray       # [max_batch_nodes, 4] uint32
    beta: jnp.ndarray      # [K, 4] uint32
    neighbor: jnp.ndarray  # [max_batch_nodes, 4] uint32 (sample.cc:56)


class TrainState(NamedTuple):
    """Full sampler state — a pytree; every leaf is a device array.

    Mirrors the reference learner's device buffers + counters
    (learner.h:40-88): pi/phi_sum/theta/beta, the global step counter,
    the beta updater's own call counter (beta.cc:336), the perplexity
    running-average state (perplexity.cc:52,194-203), and the RNG keys.
    """

    pi: jnp.ndarray            # [N, K] row-normalized memberships
    phi_sum: jnp.ndarray       # [N] membership row sums
    theta: jnp.ndarray         # [K, 2]
    beta: jnp.ndarray          # [K]
    step_count: jnp.ndarray    # scalar i32, starts at 1 (learner.cc:117)
    beta_count: jnp.ndarray    # scalar i32, starts at 0
    ppx_per_edge: jnp.ndarray  # [H] running per-edge likelihood averages
    ppx_count: jnp.ndarray     # scalar i32, number of ppx calls so far
    phi_key: jax.Array
    beta_key: jax.Array
    neighbor_key: jax.Array
    ref_seeds: Optional[RefRngState]  # only with RngBackend.REFERENCE
    sample_key: jax.Array      # device-sampling stream (per chain)
    # training-perplexity running state (empty unless cfg.calc_train_ppx;
    # the reference gates the same state behind MCMC_CALC_TRAIN_PPX,
    # learner.cc:47-75, 204-212)
    train_ppx_per_edge: jnp.ndarray
    train_ppx_count: jnp.ndarray


class DeviceBatch(NamedTuple):
    """Device-resident minibatch (padded, static shapes)."""

    edges_u: jnp.ndarray
    edges_v: jnp.ndarray
    edge_mask: jnp.ndarray
    nodes: jnp.ndarray
    node_mask: jnp.ndarray
    weight: jnp.ndarray

    @classmethod
    def from_host(cls, b: MiniBatch) -> "DeviceBatch":
        return cls(
            jnp.asarray(b.edges_u), jnp.asarray(b.edges_v),
            jnp.asarray(b.edge_mask), jnp.asarray(b.nodes),
            jnp.asarray(b.node_mask), jnp.asarray(b.weight),
        )

    @classmethod
    def from_stacked(cls, s: StackedBatches) -> "DeviceBatch":
        return cls(
            jnp.asarray(s.edges_u), jnp.asarray(s.edges_v),
            jnp.asarray(s.edge_mask), jnp.asarray(s.nodes),
            jnp.asarray(s.node_mask), jnp.asarray(s.weight),
        )


def pi_storage_dtype(cfg: Config):
    """Storage dtype of the pi rows (Config.pi_dtype). Everything else
    in TrainState — phi_sum, theta, beta, ppx state — stays fp32, and
    all COMPUTE is fp32: gathered rows are upcast, staged rows are
    quantized only at the write-back."""
    if cfg.pi_dtype == "bfloat16":
        return jnp.bfloat16
    if cfg.pi_dtype == "float32":
        return jnp.float32
    raise ValueError(f"unknown pi_dtype {cfg.pi_dtype!r} "
                     "(float32 | bfloat16)")


def _init_gamma_reference(cfg: Config, dtype):
    """theta/pi init draws through the reference RNG backend.

    pi follows the device law of RandomGammaAndNormalize
    (/root/reference/mcmc/random.cc:106-167): 32 streams per row seeded
    {11,113} with seed_i = base + i; stream (row*32 + l) supplies
    columns l, l+32, ... in order. theta uses gamma draws from the
    init-seed streams (the reference's host std::mt19937 bit stream is
    library-specific and is not reproduced; distribution and stream
    discipline are).
    """
    from mcmc_ammsb.rng import reference as ref

    theta_seeds = ref.make_seeds(
        (cfg.init_seed & 0xFFFFFFFF, cfg.init_seed >> 32), 2 * cfg.K)
    th, _ = ref.rand_gamma(theta_seeds, cfg.eta0, cfg.eta1)
    theta = th.reshape(cfg.K, 2).astype(dtype)

    lanes = 32
    pi_seeds = ref.make_seeds((11, 113), cfg.N * lanes)
    cols = []
    for t in range((cfg.K + lanes - 1) // lanes):
        base = t * lanes
        width = min(lanes, cfg.K - base)
        mask = jnp.ones((cfg.N * lanes,), jnp.bool_) if width == lanes else (
            jnp.tile(jnp.arange(lanes) < width, cfg.N))
        g, pi_seeds = ref.rand_gamma(pi_seeds, cfg.eta0, cfg.eta1, mask)
        cols.append(g.reshape(cfg.N, lanes)[:, :width])
    phi_raw = jnp.concatenate(cols, axis=1).astype(dtype)
    return theta, phi_raw


def chunked_gamma_rows(cfg: Config, key: jax.Array,
                       dtype=jnp.float32) -> jnp.ndarray:
    """[N, K] gamma draws in row blocks: jax.random.gamma's rejection
    sampler holds ~10 output-sized temporaries, which at
    N=317k x K=1024 would exceed HBM in one shot."""
    block = max(1, (1 << 24) // max(cfg.K, 1))
    chunks = []
    for i, start in enumerate(range(0, cfg.N, block)):
        rows = min(block, cfg.N - start)
        chunks.append(native_rng.gamma(
            jax.random.fold_in(key, i), (rows, cfg.K),
            cfg.eta0, cfg.eta1, dtype))
    return (chunks[0] if len(chunks) == 1
            else jnp.concatenate(chunks, axis=0))


@partial(jax.jit, donate_argnums=(0, 1))
def _fill_rows(pi, phi_sum, pi_chunk, sum_chunk, start):
    """In-place (donated) row-block write: the list-then-concatenate
    alternative peaks at 2x the [N,K] array — an OOM at
    com-LiveJournal scale (pi is 8.2 GB at N=4M/K=1024 bf16)."""
    pi = jax.lax.dynamic_update_slice(pi, pi_chunk, (start, 0))
    phi_sum = jax.lax.dynamic_update_slice(phi_sum, sum_chunk, (start,))
    return pi, phi_sum


def chunked_pi_rows(cfg: Config, key: jax.Array, store_dtype,
                    dtype=jnp.float32):
    """Gamma init + row normalize + quantize PER BLOCK: returns
    (pi [N,K] store_dtype, phi_sum [N] fp32) without ever holding a
    second [N,K] — blocks are written into a donated buffer, so peak
    memory is pi + one block's gamma temporaries regardless of N*K
    (bf16 storage exists so K>=8192 fits on one chip; an fp32 phi_raw
    intermediate or a concatenate peak would defeat it). Same keys
    and block size as chunked_gamma_rows, and the per-block g/s
    division is elementwise — the values are bit-identical to the
    normalize-then-cast whole-array path."""
    block = max(1, (1 << 24) // max(cfg.K, 1))
    pi = jnp.zeros((cfg.N, cfg.K), store_dtype)
    phi_sum = jnp.zeros((cfg.N,), dtype)
    for i, start in enumerate(range(0, cfg.N, block)):
        rows = min(block, cfg.N - start)
        g = native_rng.gamma(jax.random.fold_in(key, i), (rows, cfg.K),
                             cfg.eta0, cfg.eta1, dtype)
        s = jnp.sum(g, axis=-1)
        # _fill_rows compiles once per chunk shape (two programs: the
        # full block and the ragged tail)
        pi, phi_sum = _fill_rows(pi, phi_sum,
                                 (g / s[:, None]).astype(store_dtype),
                                 s, jnp.asarray(start, jnp.int32))
    return pi, phi_sum


def init_state(cfg: Config, heldout_size: int,
               train_ppx_size: int = 0,
               dtype=jnp.float32) -> TrainState:
    """Initialize model state (init laws of learner.cc:149-155)."""
    pi = phi_sum = None
    if cfg.rng_backend == RngBackend.REFERENCE:
        from mcmc_ammsb.rng import reference as ref
        theta, phi_raw = _init_gamma_reference(cfg, dtype)
        ref_seeds = RefRngState(
            phi=ref.make_seeds(cfg.phi_seed, cfg.max_batch_nodes),
            beta=ref.make_seeds(cfg.beta_seed, cfg.K),
            neighbor=ref.make_seeds(cfg.neighbor_seed,
                                    cfg.max_batch_nodes),
        )
    else:
        root = native_rng.key_from_seed((cfg.init_seed & 0xFFFFFFFF,
                                         cfg.init_seed >> 32))
        k_theta, k_pi = jax.random.split(root)
        theta = native_rng.gamma(k_theta, (cfg.K, 2), cfg.eta0, cfg.eta1,
                                 dtype)
        # fp32 goes through the chunked path too: values are
        # bit-identical to normalize-the-whole-array (elementwise g/s)
        # and peak init memory stays pi + one block instead of 2x pi
        # (the 2x was an OOM at com-LiveJournal scale)
        pi, phi_sum = chunked_pi_rows(cfg, k_pi,
                                      pi_storage_dtype(cfg), dtype)
        ref_seeds = None
    if cfg.theta_init == "libstdc++":
        # the reference's exact host bit stream (learner.cc:149-153):
        # sequential std::gamma_distribution draws filling the
        # interleaved (k,0),(k,1) theta buffer — see Config.theta_init
        from mcmc_ammsb import native
        theta = jnp.asarray(
            native.ref_theta_init(cfg.eta0, cfg.eta1, cfg.init_seed,
                                  2 * cfg.K).reshape(cfg.K, 2), dtype)
    beta = theta[:, 1] / (theta[:, 0] + theta[:, 1])
    if pi is None:
        phi_sum = jnp.sum(phi_raw, axis=-1)
        pi = phi_raw / phi_sum[:, None]
    return TrainState(
        pi=pi.astype(pi_storage_dtype(cfg)),
        phi_sum=phi_sum,
        theta=theta,
        beta=beta,
        step_count=jnp.asarray(1, jnp.int32),
        beta_count=jnp.asarray(0, jnp.int32),
        ppx_per_edge=jnp.zeros(heldout_size, dtype),
        ppx_count=jnp.asarray(0, jnp.int32),
        phi_key=native_rng.key_from_seed(cfg.phi_seed),
        beta_key=native_rng.key_from_seed(cfg.beta_seed),
        neighbor_key=native_rng.key_from_seed(cfg.neighbor_seed),
        ref_seeds=ref_seeds,
        sample_key=native_rng.key_from_seed((cfg.sample_seed, 0x5A)),
        train_ppx_per_edge=jnp.zeros(train_ppx_size, dtype),
        train_ppx_count=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# The fused train step
# ---------------------------------------------------------------------------

def train_step(cfg: Config, edge_set: EdgeSet, state: TrainState,
               batch: DeviceBatch, beta_hoisted=None) -> TrainState:
    """One SGRLD step: neighbor sampling + phi/pi update + theta/beta
    update. Pure; jit/scan/shard_map compatible.

    ``beta_hoisted``: optional (y_edges, lanes_u, lanes_v) precomputed
    labels + edge-endpoint lane maps (state-independent, hoisted by
    the caller). The beta stage then reads endpoint rows from this
    step's STAGED phi rows through the lane maps instead of
    re-gathering from pi and re-querying membership — bit-identical
    (edge endpoints are a subset of the batch nodes by construction,
    ExtractNodesFromMiniBatch dedups exactly them, learner.cc:162-173,
    and the staged rows are the exact floats the scatter wrote). Used
    by the reference-RNG scan, whose stateful noise streams keep the
    body in-loop but whose labels hoist like the native path's."""
    step = state.step_count
    ref_seeds = state.ref_seeds

    # 1. device neighbor sampling (sample.cc:13-78)
    with jax.named_scope("neighbor_draws"):
        if cfg.rng_backend == RngBackend.REFERENCE:
            # exact reference algorithm: per-lane xorshift streams +
            # open-addressing hash dedup, bit-exact draw discipline;
            # block decode by default (refblock.py — same bits, no
            # per-draw while regions)
            if cfg.ref_rng_block:
                from mcmc_ammsb.rng import refblock
                neighbors, nbr_seeds = refblock.sample_neighbors_block(
                    ref_seeds.neighbor, batch.nodes, cfg.N,
                    cfg.num_node_sample, batch.node_mask)
            else:
                from mcmc_ammsb.rng import reference as ref
                neighbors, nbr_seeds = ref.sample_neighbors_reference(
                    ref_seeds.neighbor, batch.nodes, cfg.N,
                    cfg.num_node_sample, batch.node_mask)
            ref_seeds = ref_seeds._replace(neighbor=nbr_seeds)
        elif cfg.shared_neighbors:
            # ONE shared draw per step (validity: config.py knob doc);
            # the sentinel "node" N never collides with a draw, so the
            # sampler's != -node fixup is a no-op here
            k_nbr = jax.random.fold_in(state.neighbor_key, step)
            neighbors = sample_neighbors(
                k_nbr, jnp.full((1,), cfg.N, jnp.int32), cfg.N,
                cfg.num_node_sample)                     # [1, n]
        else:
            k_nbr = jax.random.fold_in(state.neighbor_key, step)
            neighbors = sample_neighbors(
                k_nbr, batch.nodes, cfg.N, cfg.num_node_sample
            )

    # 2. phi/pi update (phi.cc:76-175)
    b = batch.nodes.shape[0]
    if cfg.phi_disable_noise:
        phi_noise = jnp.ones((b, cfg.K), state.phi_sum.dtype)
    elif cfg.rng_backend == RngBackend.REFERENCE:
        # K sequential ziggurat draws per active node lane, matching
        # the per-thread loop order of phi.cc:114-121; padded lanes
        # consume nothing (threads with i >= num nodes exit early)
        if cfg.ref_rng_block:
            from mcmc_ammsb.rng import refblock
            noise, seeds = refblock.randn_block(
                ref_seeds.phi, cfg.K, batch.node_mask)
            phi_noise = noise.astype(state.phi_sum.dtype)
        else:
            from mcmc_ammsb.rng import reference as ref
            seeds = ref_seeds.phi
            cols = []
            for _ in range(cfg.K):
                x, seeds = ref.randn(seeds, batch.node_mask)
                cols.append(x)
            phi_noise = jnp.stack(cols, axis=-1).astype(
                state.phi_sum.dtype)
        ref_seeds = ref_seeds._replace(phi=seeds)
    else:
        phi_noise = native_rng.randn(
            jax.random.fold_in(state.phi_key, step), (b, cfg.K),
            state.phi_sum.dtype,
        )
    with jax.named_scope("phi_update"):
        if cfg.shared_neighbors:
            with jax.named_scope("pi_gather"):
                cdt = state.phi_sum.dtype
                pi_n = state.pi[batch.nodes].astype(cdt)
                phis = state.phi_sum[batch.nodes]
                pi_nb = state.pi[neighbors].astype(cdt)  # [1, n, K]
            with jax.named_scope("membership"):
                y = edge_set.has_edges(batch.nodes[:, None], neighbors)
            nbr_mask = neighbors != batch.nodes[:, None]  # [B, n]
            pi_rows, sums = phi_ops.phi_update_core(
                cfg, pi_n, phis, pi_nb, y, state.beta, step, phi_noise,
                nbr_mask)
        else:
            pi_rows, sums = phi_ops.phi_update_rows(
                cfg, state.pi, state.phi_sum, state.beta, edge_set,
                batch.nodes, neighbors, step, phi_noise,
            )
    with jax.named_scope("pi_scatter"):
        pi, phi_sum = phi_ops.scatter_rows(
            state.pi, state.phi_sum, batch.nodes, batch.node_mask,
            pi_rows, sums
        )

    # 3. theta/beta update (beta.cc:334-384); reads the *new* pi like the
    # reference (its beta kernels run after update_pi in the same stream)
    beta_count = state.beta_count + 1
    if cfg.rng_backend == RngBackend.REFERENCE:
        # r0 then r1 per community stream (beta.cc:60-78)
        if cfg.ref_rng_block:
            from mcmc_ammsb.rng import refblock
            bn, bseeds = refblock.randn_block(ref_seeds.beta, 2)
            beta_noise = bn.astype(state.phi_sum.dtype)
        else:
            from mcmc_ammsb.rng import reference as ref
            r0, bseeds = ref.randn(ref_seeds.beta)
            r1, bseeds = ref.randn(bseeds)
            beta_noise = jnp.stack([r0, r1], axis=-1).astype(
                state.phi_sum.dtype)
        ref_seeds = ref_seeds._replace(beta=bseeds)
    else:
        beta_noise = native_rng.randn(
            jax.random.fold_in(state.beta_key, step), (cfg.K, 2),
            state.phi_sum.dtype,
        )
    with jax.named_scope("beta_grads"):
        if beta_hoisted is not None:
            y_e, lane_u, lane_v = beta_hoisted
            cdt = state.theta.dtype
            # exactly the floats the scatter wrote (storage-precision
            # round-trip), read from the staging buffer; masked lanes
            # sanitized so staging garbage never reaches the grads
            rows_safe = jnp.where(
                batch.node_mask[:, None],
                pi_rows.astype(pi.dtype).astype(cdt), 1.0 / cfg.K)
            grads = beta_ops.beta_gradients_core(
                cfg, state.theta, state.beta, rows_safe[lane_u],
                rows_safe[lane_v], y_e, batch.edge_mask)
            theta, beta = beta_ops.theta_step(
                cfg, state.theta, grads, batch.weight, beta_count,
                beta_noise)
        else:
            theta, beta = beta_ops.update_beta(
                cfg, state.theta, state.beta, pi, edge_set,
                batch.edges_u, batch.edges_v, batch.edge_mask,
                batch.weight, beta_count, beta_noise,
            )

    return state._replace(
        pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
        step_count=step + 1, beta_count=beta_count,
        ref_seeds=ref_seeds,
    )


def train_steps_scan(cfg: Config, edge_set: EdgeSet, state: TrainState,
                     batches: DeviceBatch) -> TrainState:
    """Fold S pre-sampled steps into one device dispatch via lax.scan.

    With the native RNG backend, everything state-INdependent is hoisted
    out of the loop and computed for all S steps in one vectorized
    block: neighbor draws, phi/theta noise (their keys are pure
    functions of the step index), and edge-membership labels (the
    training set is static). The scan body then reduces to pi gathers,
    the fused elementwise update, one scatter, and the gradient
    reduction — a handful of kernels per step instead of dozens, which
    is what per-step latency is made of at minibatch sizes this small.
    Trajectories are bit-identical to the step-at-a-time path (asserted
    by tests/test_learner.py::test_scan_matches_single_steps).
    """
    if cfg.rng_backend != RngBackend.NATIVE:
        # reference backend: the noise/neighbor streams are STATEFUL
        # (a ziggurat/hash-rejection draw consumes a data-dependent
        # number of uniforms, so streams cannot be jumped forward) and
        # stay in-loop — but the edge labels and endpoint lane maps
        # are state-independent and hoist exactly like the native
        # path's, and the beta stage reads endpoint rows from the
        # step's staged phi rows instead of two more random gathers
        # (bit-identical; train_step beta_hoisted contract).
        with jax.named_scope("membership"):
            y_edges = edge_set.has_edges(batches.edges_u,
                                         batches.edges_v)
        with jax.named_scope("edge_lanes"):
            lanes_u = jnp.argmax(batches.edges_u[:, :, None]
                                 == batches.nodes[:, None, :],
                                 axis=-1).astype(jnp.int32)
            lanes_v = jnp.argmax(batches.edges_v[:, :, None]
                                 == batches.nodes[:, None, :],
                                 axis=-1).astype(jnp.int32)

        def body_ref(s, xs):
            batch, y_e, lane_u, lane_v = xs
            return train_step(cfg, edge_set, s, batch,
                              beta_hoisted=(y_e, lane_u, lane_v)), None

        state, _ = jax.lax.scan(body_ref, state,
                                (batches, y_edges, lanes_u, lanes_v),
                                unroll=cfg.scan_unroll)
        return state

    s_len, b = batches.nodes.shape
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)

    with jax.named_scope("neighbor_draws"):
        nbr_keys = jax.vmap(
            lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
        if cfg.shared_neighbors:
            sentinel = jnp.full((1,), cfg.N, jnp.int32)
            neighbors = jax.vmap(
                lambda k: sample_neighbors(k, sentinel, cfg.N,
                                           cfg.num_node_sample)
            )(nbr_keys)                                      # [S, 1, n]
        else:
            neighbors = jax.vmap(
                lambda k, nd: sample_neighbors(k, nd, cfg.N,
                                               cfg.num_node_sample)
            )(nbr_keys, batches.nodes)                       # [S, B, n]
    with jax.named_scope("membership"):
        y_phi = edge_set.has_edges(batches.nodes[:, :, None], neighbors)
        y_edges = edge_set.has_edges(batches.edges_u, batches.edges_v)
    with jax.named_scope("edge_lanes"):
        # Edge endpoints are a subset of the minibatch nodes by
        # construction (ExtractNodesFromMiniBatch dedups exactly these
        # endpoints, learner.cc:162-173), so the beta stage can read
        # endpoint pi rows from the step's STAGED phi rows instead of
        # re-gathering them from the [N, K] array — the reference's
        # beta kernels re-read global memory (beta.cc:86-137); here
        # that saves two random row gathers per step. Lane maps are
        # state-independent, hoisted here.
        lanes_u = jnp.argmax(batches.edges_u[:, :, None]
                             == batches.nodes[:, None, :],
                             axis=-1).astype(jnp.int32)      # [S, E]
        lanes_v = jnp.argmax(batches.edges_v[:, :, None]
                             == batches.nodes[:, None, :],
                             axis=-1).astype(jnp.int32)
    with jax.named_scope("noise"):
        if cfg.phi_disable_noise:
            phi_noise = jnp.ones((s_len, b, cfg.K), state.phi_sum.dtype)
        else:
            phi_noise = jax.vmap(lambda s: native_rng.randn(
                jax.random.fold_in(state.phi_key, s), (b, cfg.K),
                state.phi_sum.dtype))(steps)                 # [S, B, K]
        beta_noise = jax.vmap(lambda s: native_rng.randn(
            jax.random.fold_in(state.beta_key, s), (cfg.K, 2),
            state.phi_sum.dtype))(steps)                     # [S, K, 2]

    body = partial(_hoisted_step_body, cfg)
    xs = (batches, neighbors, y_phi, phi_noise, beta_noise, y_edges,
          lanes_u, lanes_v)
    if cfg.window > 1 and cfg.shared_neighbors:
        from mcmc_ammsb.ops.window import windowed_scan
        return windowed_scan(cfg, state, xs, body)
    state, _ = jax.lax.scan(body, state, xs, unroll=cfg.scan_unroll)
    return state


def _hoisted_step_body(cfg: Config, s: TrainState, xs):
    """One SGRLD step on hoisted per-step operands — the lax.scan body
    of train_steps_scan, factored out so the windowed engine
    (ops/window.py) can reuse it verbatim for its exact sequential
    branch."""
    batch, nbrs, y_n, n_phi, n_beta, y_e, lane_u, lane_v = xs
    with jax.named_scope("pi_gather"):
        cdt = s.phi_sum.dtype
        pi_n = s.pi[batch.nodes].astype(cdt)
        phis = s.phi_sum[batch.nodes]
        pi_nb = s.pi[nbrs].astype(cdt)  # [B,n,K], or [1,n,K] shared
    with jax.named_scope("phi_update"):
        nbr_mask = (nbrs != batch.nodes[:, None]
                    if cfg.shared_neighbors else None)
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, pi_nb, y_n, s.beta, s.step_count,
            n_phi, nbr_mask)
    with jax.named_scope("pi_scatter"):
        pi, phi_sum = phi_ops.scatter_rows(
            s.pi, s.phi_sum, batch.nodes, batch.node_mask, rows, sums)
    beta_count = s.beta_count + 1
    with jax.named_scope("beta_grads"):
        # endpoint rows from the staged phi rows (see edge_lanes
        # above). Masked NODE lanes hold non-finite staging garbage
        # (padded gathers) that the scatter drops; any edge mapped
        # there is itself masked, but NaN*0 != 0, so sanitize the
        # staging buffer once before the small-array lane gathers
        # (uniform 1/K rows keep every downstream denominator
        # strictly positive).
        rows_safe = jnp.where(batch.node_mask[:, None], rows,
                              1.0 / cfg.K)
        grads = beta_ops.beta_gradients_core(
            cfg, s.theta, s.beta, rows_safe[lane_u],
            rows_safe[lane_v], y_e, batch.edge_mask)
    with jax.named_scope("theta_update"):
        theta, beta = beta_ops.theta_step(
            cfg, s.theta, grads, batch.weight, beta_count, n_beta)
    s = s._replace(pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
                   step_count=s.step_count + 1, beta_count=beta_count)
    return s, None


def train_step_device_sampled(cfg: Config, edge_set: EdgeSet,
                              heldout_set: EdgeSet,
                              state: TrainState,
                              adjacency=None) -> TrainState:
    """One step with the minibatch sampled ON DEVICE — no host data.

    The sampling key is derived from (sample_seed, step), so the fused
    loop stays a pure function of state. ``adjacency`` is the training
    CSR pair for non-CSR membership backends."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatch_device

    key = jax.random.fold_in(state.sample_key, state.step_count)
    ds = sample_minibatch_device(cfg, edge_set, heldout_set, key,
                                 adjacency)
    batch = DeviceBatch(ds.edges_u, ds.edges_v, ds.edge_mask,
                        ds.nodes, ds.node_mask, ds.weight)
    return train_step(cfg, edge_set, state, batch)


def train_steps_fused(cfg: Config, edge_set: EdgeSet,
                      heldout_set: EdgeSet, state: TrainState,
                      num_steps: int, adjacency=None) -> TrainState:
    """num_steps fully-fused steps (device sampling + update) in ONE
    dispatch — the zero-host-round-trip training loop. Minibatches for
    all steps are drawn in one vectorized block (vmapped device
    sampler), then the hoisted scan of train_steps_scan consumes them."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device

    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    with jax.named_scope("device_sampling"):
        ds = sample_minibatches_device(cfg, edge_set, heldout_set,
                                       chunk_key, num_steps, adjacency)
    batches = DeviceBatch(ds.edges_u, ds.edges_v, ds.edge_mask,
                          ds.nodes, ds.node_mask, ds.weight)
    return train_steps_scan(cfg, edge_set, state, batches)


def train_steps_fused_ppx(cfg: Config, edge_set: EdgeSet,
                          heldout_set: EdgeSet, state: TrainState,
                          heldout_u: jnp.ndarray, heldout_v: jnp.ndarray,
                          num_evals: int, interval: int,
                          adjacency=None, train_u=None, train_v=None):
    """num_evals x (interval fused steps + one held-out ppx eval) in ONE
    device dispatch — the reference's primary output loop (train
    ppx_interval iters, log ``ppx[i]``, main.cc:160-168) with zero host
    round-trips between evals.

    Without this, the CLI's eval cadence caps the scan depth: ``-i 100``
    forces 100-step dispatches even when steps_per_call=1000 is the
    measured sweet spot. Here the eval rides INSIDE the program as the
    ys of an outer scan over eval periods, so the fusion depth is
    ``num_evals * interval`` regardless of cadence. Composes the exact
    train_steps_fused + heldout_perplexity_step functions, so the
    trajectory and the running-average ppx state are bit-identical to
    the chunked host loop (asserted by
    tests/test_learner.py::test_fused_ppx_series_matches_host_loop).

    With ``train_u``/``train_v`` set (cfg.calc_train_ppx), each eval
    additionally scores the training-ppx population AFTER the held-out
    eval — the same order as the host loop (CLI logs ppx then
    train_ppx), so the running-average states stay bit-identical to
    the chunked host path. This keeps the reference's
    MCMC_CALC_TRAIN_PPX mode (learner.cc:204-212) usable at the fused
    eval-inclusive rates instead of forcing the slow host loop.

    Returns (state, series) where series is (PpxResult, train_neg_avg
    or None) of [num_evals]-leading arrays."""
    def outer(s: TrainState, _):
        s = train_steps_fused(cfg, edge_set, heldout_set, s, interval,
                              adjacency)
        s, res = heldout_perplexity_step(cfg, heldout_set, heldout_u,
                                         heldout_v, s)
        train_neg = None
        if train_u is not None:
            s, tres = training_perplexity_step(cfg, edge_set,
                                               train_u, train_v, s)
            train_neg = tres.neg_avg_log
        # the [H] running averages live in state; don't stack per eval
        return s, (res._replace(ppx_per_edge=None), train_neg)

    return jax.lax.scan(outer, state, None, length=num_evals)


#: Minimum steps per fused-eval dispatch: each dispatch's packed
#: readback is a host-blocking transfer whose latency does not shrink
#: with its size, so chunks carry enough device work to hide it behind
#: the depth-2 pipeline.
EVAL_CHUNK_FLOOR = 8000


def eval_series_call_steps(spc: int, interval: int,
                           dispatches: int = 4) -> int:
    """Steps one engine ``run_with_ppx`` call should cover so the
    series driver gets ``dispatches`` equal chunks to pipeline (the
    CLI's fused loops use this; a call smaller than one chunk degrades
    to a serialized single dispatch)."""
    group = max(1, max(spc, EVAL_CHUNK_FLOOR) // max(1, interval))
    return dispatches * group * interval


def run_fused_eval_series(timers, spc: int, max_iters: int,
                          interval: int, dispatch, fence, record, tail,
                          depth: int = 2,
                          chunk_floor: int = EVAL_CHUNK_FLOOR):
    """Shared driver for every engine's ``run_with_ppx``: group fused
    eval periods into ~steps_per_call dispatches, number each eval by
    its absolute step, train any non-multiple tail without a trailing
    eval. Parameterized by the engine's jitted call and record builder
    so the bookkeeping lives in exactly one place.

    dispatch(take) -> DEVICE array(s) holding ``take`` fused eval
    periods' results — an async ENQUEUE that must not block;
    fence() -> step_count before the first dispatch (one device
    readback);
    record(arr, i, step) -> the series entry for eval i of the
    MATERIALIZED (numpy) result;
    tail(steps) -> train ``steps`` remaining steps (< interval).

    The driver software-pipelines the host loop: up to ``depth``
    chunks are enqueued before a chunk's results are materialized
    (np.asarray), so chunk k's device->host round-trip overlaps chunk
    k+1's execution. Fencing after EVERY dispatch to number the evals
    would serialize the loop against one device->host round-trip per
    dispatch; step numbers are instead computed arithmetically from
    one up-front fence: every
    dispatch advances exactly take*interval steps (the engines'
    _chunk_ppx contract, pinned by the series tests).

    Each entry additionally carries ``"t"``: the absolute
    ``time.perf_counter()`` at which its chunk's results materialized
    on the host (entries of one chunk share it). Time-to-target
    consumers (bench.py seconds_to_ppx_target) read per-eval walls
    from a SINGLE large call — the pipeline only overlaps dispatches
    within one call, so per-eval host timestamping from outside would
    force one call per eval and re-serialize the loop.

    Dispatches are sized to at least ``chunk_floor`` steps (not just
    spc // interval): see EVAL_CHUNK_FLOOR."""
    from collections import deque

    group = max(1, max(spc, chunk_floor) // max(1, interval))
    series = []
    evals_left = max_iters // interval
    with timers.stage("total"):
        step0 = fence() if evals_left else None
        done = 0
        queue = deque()
        while evals_left or queue:
            if evals_left and len(queue) < depth:
                take = min(group, evals_left)
                with timers.stage("device_step"):
                    res = dispatch(take)          # async enqueue
                queue.append((take, res))
                evals_left -= take
                continue
            take, res = queue.popleft()
            with timers.stage("device_step"):
                arr = np.asarray(res)             # blocks on chunk k only
            tm = time.perf_counter()
            for i in range(take):
                done += 1
                entry = record(arr, i, step0 + done * interval)
                entry.setdefault("t", tm)
                series.append(entry)
        t = max_iters % interval
        if t:
            tail(t)
    return series


def heldout_perplexity_step(
    cfg: Config, heldout_set: EdgeSet,
    heldout_u: jnp.ndarray, heldout_v: jnp.ndarray,
    state: TrainState,
) -> Tuple[TrainState, ppx_ops.PpxResult]:
    """One perplexity evaluation; updates the running-average state."""
    count = state.ppx_count + 1
    with jax.named_scope("ppx"):
        res = ppx_ops.perplexity_step(
            cfg, state.pi, state.beta, heldout_set,
            heldout_u, heldout_v, state.ppx_per_edge, count,
        )
    state = state._replace(ppx_per_edge=res.ppx_per_edge, ppx_count=count)
    return state, res


def training_perplexity_step(
    cfg: Config, training_set: EdgeSet,
    edges_u: jnp.ndarray, edges_v: jnp.ndarray,
    state: TrainState,
) -> Tuple[TrainState, ppx_ops.PpxResult]:
    """Training-perplexity evaluation over the MCMC_CALC_TRAIN_PPX
    population (learner.cc:204-212); labels come from the training
    set, running averages live in their own state."""
    count = state.train_ppx_count + 1
    with jax.named_scope("ppx"):
        res = ppx_ops.perplexity_step(
            cfg, state.pi, state.beta, training_set,
            edges_u, edges_v, state.train_ppx_per_edge, count,
        )
    state = state._replace(train_ppx_per_edge=res.ppx_per_edge,
                           train_ppx_count=count)
    return state, res


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

class HostSamplingPipeline:
    """Host minibatch prefetch pipeline + checkpointable in-flight state.

    The MCMC_SAMPLE_PARALLEL analog (/root/reference/mcmc/learner.cc:
    216-246): a producer thread draws batches ahead of device compute;
    produced-but-unconsumed batches are drainable into a pending list
    that checkpoints serialize (learner.cc:307-315) and resumed runs
    consume first. Shared by Learner and parallel.ShardedLearner.
    """

    def _init_pipeline(self, sampler: MiniBatchSampler,
                       prefetch: bool) -> None:
        self.sampler = sampler
        self._prefetcher: Optional[PrefetchingSampler] = None
        self._use_prefetch = prefetch
        self._pending = []

    def _get_prefetcher(self, chunk: int) -> PrefetchingSampler:
        if self._prefetcher is None or self._prefetcher._chunk != chunk:
            if self._prefetcher is not None:
                # keep already-drawn batches (stream position) intact
                self._pending.extend(self._prefetcher.drain())
            self._prefetcher = PrefetchingSampler(
                self.sampler, depth=2, chunk=chunk
            )
        return self._prefetcher

    def _next_pending(self, want_cls):
        """Pop a checkpoint-restored in-flight batch, if type-compatible
        with the current run mode."""
        if self._pending and isinstance(self._pending[0], want_cls):
            return self._pending.pop(0)
        return None

    def drain_sampling(self):
        """Quiesce the prefetch pipeline; any produced-but-unconsumed
        batches move to the pending list (checkpointable in-flight
        state)."""
        if self._prefetcher is not None:
            self._pending.extend(self._prefetcher.drain())
            self._prefetcher = None
        return self._pending

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None


class Learner(HostSamplingPipeline):
    """Owns config, graph structures, device state, and compiled programs.

    The single-device orchestrator (multi-chip: parallel/sharded.py).
    """

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 prefetch: bool = True):
        if cfg.shared_neighbors and cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError(
                "shared_neighbors requires rng_backend=native (the "
                "reference RNG's per-lane streams assume per-node "
                "neighbor rows)")
        if (pi_storage_dtype(cfg) != jnp.float32
                and cfg.rng_backend != RngBackend.NATIVE):
            raise ValueError(
                "pi_dtype=bfloat16 requires rng_backend=native "
                "(bit-exact reference trajectories are fp32 semantics)")
        if cfg.window > 1 and (
                not cfg.shared_neighbors
                or cfg.rng_backend != RngBackend.NATIVE):
            raise ValueError(
                "window > 1 (the T-step fused window engine, "
                "ops/window.py) requires shared_neighbors and "
                "rng_backend=native")
        heldout_size = len(split.heldout_edges_u)
        self.cfg = cfg
        self.graph = graph
        self.split = split
        self.training_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v
        )
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v
        )
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)
        if cfg.calc_train_ppx:
            from mcmc_ammsb.data import make_training_ppx_edges
            tr_u, tr_v = make_training_ppx_edges(
                split, cfg.training_ppx_ratio)
            self.train_ppx_u = jnp.asarray(tr_u)
            self.train_ppx_v = jnp.asarray(tr_v)
            train_ppx_size = len(tr_u)
        else:
            self.train_ppx_u = self.train_ppx_v = None
            train_ppx_size = 0
        self.state = init_state(cfg, heldout_size, train_ppx_size)
        # training CSR adjacency for the device samplers (shared with
        # the CSR edge-set backend; other membership backends need it
        # passed separately)
        self.adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                          jnp.asarray(graph.cols, jnp.int32))
        self._init_pipeline(MiniBatchSampler(cfg, graph, split), prefetch)
        self.timers = StageTimers()
        self.last_ppx_stats = {}

        # Edge sets and heldout arrays are jit *arguments* (donatable
        # device inputs), not trace-time constants.
        # state args are donated: the caller always replaces self.state
        # with the result, letting XLA reuse the [N, K] pi buffer
        # in place instead of holding input + output copies
        self._step_fn = jax.jit(partial(train_step, cfg),
                                donate_argnums=(1,))
        self._scan_fn = jax.jit(partial(train_steps_scan, cfg),
                                donate_argnums=(1,))
        self._fused_fn = jax.jit(partial(train_steps_fused, cfg),
                                 static_argnames="num_steps",
                                 donate_argnums=(2,))
        self._fused_ppx_fn = jax.jit(
            partial(train_steps_fused_ppx, cfg),
            static_argnames=("num_evals", "interval"),
            donate_argnums=(2,))
        self._ppx_fn = jax.jit(partial(heldout_perplexity_step, cfg),
                               donate_argnums=(3,))
        self._train_ppx_fn = jax.jit(partial(training_perplexity_step, cfg),
                                     donate_argnums=(3,))

    # -- training ----------------------------------------------------------

    def run(self, max_iters: int) -> None:
        """Run ``max_iters`` SGRLD steps (learner.cc:214-250)."""
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            if self.cfg.device_sampling:
                self._run_fused(max_iters, spc)
            elif spc == 1:
                self._run_single(max_iters)
            else:
                self._run_scanned(max_iters, spc)

    def _run_fused(self, max_iters: int, spc: int) -> None:
        done = 0
        while done < max_iters:
            take = min(spc, max_iters - done)
            with self.timers.stage("device_step"):
                self.state = self._fused_fn(
                    self.training_set, self.heldout_set, self.state,
                    num_steps=take, adjacency=self.adjacency)
            done += take
        self._fence()

    def _fence(self) -> None:
        """Scalar device->host readback: waits for the device work that
        produced the state."""
        int(self.state.step_count)

    def _run_single(self, max_iters: int) -> None:
        src = (self._get_prefetcher(1) if self._use_prefetch else None)
        for _ in range(max_iters):
            with self.timers.stage("sampling"):
                hb = (self._next_pending(MiniBatch)
                      or (src.get() if src else self.sampler.sample()))
                batch = DeviceBatch.from_host(hb)
            with self.timers.stage("device_step"):
                self.state = self._step_fn(self.training_set, self.state,
                                           batch)
        self._fence()

    def _run_scanned(self, max_iters: int, spc: int) -> None:
        done = 0
        src = (self._get_prefetcher(spc) if self._use_prefetch else None)
        while done < max_iters:
            take = min(spc, max_iters - done)
            with self.timers.stage("sampling"):
                stacked = (self._next_pending(StackedBatches)
                           or (src.get() if src
                               else self.sampler.sample_many(spc)))
                if take < spc:  # tail: slice the stacked chunk
                    stacked = StackedBatches(
                        *(a[:take] for a in (
                            stacked.edges_u, stacked.edges_v,
                            stacked.edge_mask, stacked.nodes,
                            stacked.node_mask, stacked.weight,
                        ))
                    )
                batches = DeviceBatch.from_stacked(stacked)
            with self.timers.stage("device_step"):
                self.state = self._scan_fn(self.training_set, self.state,
                                           batches)
            done += take
        self._fence()

    def run_with_ppx(self, max_iters: int, interval: int):
        """Train max_iters steps with a held-out ppx eval every
        ``interval`` steps, fused into single device dispatches
        (train_steps_fused_ppx): the eval cadence no longer caps the
        scan depth and there are no host round-trips between evals.
        Requires cfg.device_sampling. Yields the eval series as a list
        of dicts (step, ppx, link/non-link stats) matching the host
        loop's heldout_perplexity() trajectory bit-exactly; any
        non-multiple tail trains WITHOUT a trailing eval (the
        reference's loop likewise only evaluates on the interval,
        main.cc:160-168).

        Eval groups per dispatch are capped so steps per call stay near
        steps_per_call (dispatch amortization) while SIGINT between
        calls stays responsive."""
        if not self.cfg.device_sampling:
            raise RuntimeError("run_with_ppx requires device_sampling "
                               "(the host-batch loop evaluates between "
                               "chunks instead)")
        if self.heldout_u.shape[0] == 0:
            raise RuntimeError("no held-out edges")
        spc = max(1, self.cfg.steps_per_call)

        train_ppx = self.cfg.calc_train_ppx

        def dispatch(take):
            self.state, (res, train_neg) = self._fused_ppx_fn(
                self.training_set, self.heldout_set, self.state,
                self.heldout_u, self.heldout_v,
                num_evals=take, interval=interval,
                adjacency=self.adjacency,
                train_u=self.train_ppx_u, train_v=self.train_ppx_v)
            # Pack ppx + the 4 stats into ONE device array; the driver
            # materializes it AFTER the next chunk is enqueued
            # (run_fused_eval_series pipelining) — per-field readbacks
            # would each pay a device->host round trip. exp stays XLA's
            # (1 ulp from numpy's; the series contract is bit-exact
            # equality with the host loop). Counts ride as f32 —
            # exact below 2^24, and the eval population H bounds them
            # (an H >= 2^24 single-chip split doesn't exist; asserted).
            # The train-ppx series (calc_train_ppx) rides as row 5 of
            # the same packed transfer — zero extra round-trips.
            assert self.heldout_u.shape[0] < (1 << 24)
            rows = [
                jnp.exp(res.neg_avg_log),
                res.link_likelihood, res.non_link_likelihood,
                res.link_count.astype(jnp.float32),
                res.non_link_count.astype(jnp.float32)]
            if train_ppx:
                rows.append(jnp.exp(train_neg))
            return jnp.stack(rows)

        def record(stats, i, step):
            entry = {
                "step": step,
                "ppx": float(stats[0, i]),
                "link_count": int(stats[3, i]),
                "non_link_count": int(stats[4, i]),
                "link_likelihood": float(stats[1, i]),
                "non_link_likelihood": float(stats[2, i]),
            }
            if train_ppx:
                entry["train_ppx"] = float(stats[5, i])
            return entry

        return run_fused_eval_series(
            self.timers, spc, max_iters, interval, dispatch,
            lambda: int(self.state.step_count), record,
            lambda t: self._run_fused(t, spc))

    # -- evaluation --------------------------------------------------------

    def heldout_perplexity(self) -> float:
        """exp(-avg log running-averaged likelihood) (learner.cc:196-202)."""
        if self.heldout_u.shape[0] == 0:
            raise RuntimeError(
                "no held-out edges: heldout_ratio too small for this "
                "graph (the reference likewise only evaluates when the "
                "split is non-empty, data.cc:89-98)")
        with self.timers.stage("ppx"):
            self.state, res = self._ppx_fn(
                self.heldout_set, self.heldout_u, self.heldout_v, self.state
            )
            # one packed readback instead of five scalar round trips
            stats = np.asarray(jnp.stack([
                jnp.exp(res.neg_avg_log),
                res.link_likelihood, res.non_link_likelihood,
                res.link_count.astype(jnp.float32),
                res.non_link_count.astype(jnp.float32)]))
            value = float(stats[0])
        self.last_ppx_stats = {
            "link_count": int(stats[3]),
            "non_link_count": int(stats[4]),
            "link_likelihood": float(stats[1]),
            "non_link_likelihood": float(stats[2]),
        }
        return value

    def training_perplexity(self) -> float:
        """exp(-avg log likelihood) over the training-ppx population
        (TrainingPerplexity, learner.cc:204-212); requires
        cfg.calc_train_ppx."""
        if not self.cfg.calc_train_ppx:
            raise RuntimeError("enable cfg.calc_train_ppx")
        with self.timers.stage("train_ppx"):
            self.state, res = self._train_ppx_fn(
                self.training_set, self.train_ppx_u, self.train_ppx_v,
                self.state)
            return float(jnp.exp(res.neg_avg_log))

    # -- reporting ---------------------------------------------------------

    def print_stats(self, log=print) -> None:
        """Stage-seconds table (PrintStats parity, learner.cc:252-299)."""
        self.timers.print_table(log)

    def _production_hlo_text(self, spc: int) -> str:
        """Optimized HLO of the current production chunk program — the
        op->stage map for trace events that carry no scope path (CPU
        thunks, GPU kernels inside command buffers)."""
        if self.cfg.device_sampling:
            lowered = self._fused_fn.lower(
                self.training_set, self.heldout_set, self.state,
                num_steps=spc, adjacency=self.adjacency)
        else:
            # draw example batches WITHOUT advancing the host stream
            rng_state = self.sampler.rng.get_state()
            ncc = getattr(self.sampler, "_native_call_count", 0)
            try:
                if spc > 1:
                    batches = DeviceBatch.from_stacked(
                        self.sampler.sample_many(spc))
                    lowered = self._scan_fn.lower(
                        self.training_set, self.state, batches)
                else:
                    batch = DeviceBatch.from_host(self.sampler.sample())
                    lowered = self._step_fn.lower(
                        self.training_set, self.state, batch)
            finally:
                self.sampler.rng.set_state(rng_state)
                self.sampler._native_call_count = ncc
        return lowered.compile().as_text()

    def fused_stage_profile(self, iters: Optional[int] = None) -> dict:
        """TRUE per-stage attribution of the production fused program —
        the analog of the reference's per-kernel device-event timers
        (/root/reference/mcmc/learner.cc:252-299): runs a traced
        production chunk under jax.profiler and aggregates device-op
        time by the named_scope stages annotated in the step functions.
        These shares sum to the measured fused step time."""
        from mcmc_ammsb.utils import profiling

        spc = max(1, self.cfg.steps_per_call)
        return profiling.traced_stage_profile(
            self.run, self._production_hlo_text(spc), spc, iters)

    def print_stage_profile(self, log=print,
                            iters: Optional[int] = None) -> None:
        """Fused per-stage table from a profiler trace; raises when the
        trace yields nothing attributable."""
        from mcmc_ammsb.utils import profiling

        profiling.print_stage_profile(self.fused_stage_profile(iters), log)
