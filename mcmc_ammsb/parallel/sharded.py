"""Multi-chip training via shard_map over a ('data', 'model') mesh.

Layout (SURVEY.md §2 parallelism inventory, §5.8):

  pi [N_pad, K]   — row-sharded over 'model' (the generalization of the
                    reference's RowPartitionedMatrix, which splits pi
                    across <=32 allocations on ONE device,
                    /root/reference/mcmc/partitioned-alloc.h:87-131);
                    replicated over 'data'.
  phi_sum [N_pad] — sharded like pi's rows.
  theta/beta [K]  — replicated everywhere (they are tiny).
  minibatch       — nodes and edges sharded over 'data'.
  heldout eval    — edges + running ppx state sharded over 'data'.

Collectives per step (NVLink between the cards of one host):
  * row fetch:   masked local gather + psum over 'model' — the standard
                 distributed embedding lookup; the minibatch's
                 (1+n)·B/d rows per device are tiny, so this is latency-
                 not bandwidth-bound.
  * write-back:  all_gather of the staged rows over 'data', each model
                 shard applies the rows that land in its range (the
                 node list is globally deduplicated, so writes are
                 collision-free).
  * beta grads:  psum of per-edge partial gradients over 'data' — the
                 multi-chip version of the reference's sum_grads fan-in
                 kernel (/root/reference/mcmc/beta.cc:39-49).

theta/beta updates are computed redundantly on every device from
identical psum'd gradients and identical RNG keys, so replicated state
stays bit-identical without a broadcast.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import (DeviceBatch, HostSamplingPipeline,
                                TrainState, init_state)
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import perplexity as ppx_ops
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set
from mcmc_ammsb.ops.neighbor import sample_neighbors
from mcmc_ammsb.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mcmc_ammsb.rng import native as native_rng
from mcmc_ammsb.sampling import MiniBatchSampler, StackedBatches
from mcmc_ammsb.utils.timing import StageTimers


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Per-device step body (runs inside shard_map)
# ---------------------------------------------------------------------------

def _fetch_rows(pi_local: jnp.ndarray, idx: jnp.ndarray,
                rows_per_shard: int) -> jnp.ndarray:
    """Cross-shard row gather: local masked gather + psum over 'model'.

    Gathered rows are upcast to fp32 BEFORE the collective — compute
    (and the cross-device reduction) stays fp32 even when pi storage is bf16,
    mirroring the single-chip gather-then-upcast discipline
    (learner.train_steps_scan pi_gather)."""
    m_idx = jax.lax.axis_index(MODEL_AXIS)
    local = idx - m_idx * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    li = jnp.clip(local, 0, rows_per_shard - 1)
    rows = (pi_local[li].astype(jnp.float32)
            * ok.astype(jnp.float32)[..., None])
    return jax.lax.psum(rows, MODEL_AXIS)


def _fetch_scalars(x_local: jnp.ndarray, idx: jnp.ndarray,
                   rows_per_shard: int) -> jnp.ndarray:
    m_idx = jax.lax.axis_index(MODEL_AXIS)
    local = idx - m_idx * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    li = jnp.clip(local, 0, rows_per_shard - 1)
    return jax.lax.psum(x_local[li] * ok.astype(x_local.dtype), MODEL_AXIS)


def _sharded_step_body(cfg: Config, rows_per_shard: int,
                       edge_set: EdgeSet, state: TrainState,
                       batch: DeviceBatch) -> TrainState:
    """One SGRLD step, per-device view. Mirrors learner.train_step."""
    step = state.step_count
    d_idx = jax.lax.axis_index(DATA_AXIS)
    m_idx = jax.lax.axis_index(MODEL_AXIS)

    # --- neighbor sampling for the local node slice ----------------------
    # shared draws: ONE step-wide set identical on every data shard (no
    # d_idx fold), so each device fetches n rows instead of B_local*n
    with jax.named_scope("neighbor_draws"):
        if cfg.shared_neighbors:
            k_nbr = jax.random.fold_in(state.neighbor_key, step)
            neighbors = sample_neighbors(
                k_nbr, jnp.full((1,), cfg.N, jnp.int32), cfg.N,
                cfg.num_node_sample)                         # [1, n]
        else:
            k_nbr = jax.random.fold_in(
                jax.random.fold_in(state.neighbor_key, step), d_idx)
            neighbors = sample_neighbors(k_nbr, batch.nodes, cfg.N,
                                         cfg.num_node_sample)

    # --- phi update on gathered rows -------------------------------------
    b_local = batch.nodes.shape[0]
    with jax.named_scope("pi_gather"):
        pi_n = _fetch_rows(state.pi, batch.nodes, rows_per_shard)
        phis = _fetch_scalars(state.phi_sum, batch.nodes, rows_per_shard)
        pi_nb = _fetch_rows(
            state.pi, neighbors.reshape(-1), rows_per_shard
        ).reshape(neighbors.shape[0], cfg.num_node_sample, cfg.K)
    with jax.named_scope("membership"):
        y = edge_set.has_edges(batch.nodes[:, None], neighbors)
    nbr_mask = (neighbors != batch.nodes[:, None]
                if cfg.shared_neighbors else None)
    with jax.named_scope("noise"):
        # noise (like all compute) is fp32 even under bf16 pi storage
        if cfg.phi_disable_noise:
            noise = jnp.ones((b_local, cfg.K), state.phi_sum.dtype)
        else:
            noise = native_rng.randn(
                jax.random.fold_in(
                    jax.random.fold_in(state.phi_key, step), d_idx),
                (b_local, cfg.K), state.phi_sum.dtype)
    with jax.named_scope("phi_update"):
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, pi_nb, y, state.beta, step, noise, nbr_mask)

    # --- write-back: all_gather staged rows over 'data', apply locally ---
    with jax.named_scope("pi_scatter"):
        g_nodes = jax.lax.all_gather(batch.nodes, DATA_AXIS).reshape(-1)
        g_mask = jax.lax.all_gather(batch.node_mask,
                                    DATA_AXIS).reshape(-1)
        g_rows = jax.lax.all_gather(rows, DATA_AXIS).reshape(-1, cfg.K)
        g_sums = jax.lax.all_gather(sums, DATA_AXIS).reshape(-1)
        local = g_nodes - m_idx * rows_per_shard
        ok = (local >= 0) & (local < rows_per_shard) & g_mask
        safe = jnp.where(ok, local, rows_per_shard)
        # staged rows are fp32; quantize only at the write-back
        # (scatter_rows discipline) when pi storage is bf16
        pi = state.pi.at[safe].set(g_rows.astype(state.pi.dtype),
                                   mode="drop")
        phi_sum = state.phi_sum.at[safe].set(g_sums, mode="drop")

    # --- theta/beta from the local edge slice ----------------------------
    with jax.named_scope("beta_grads"):
        pi_u = _fetch_rows(pi, batch.edges_u, rows_per_shard)
        pi_v = _fetch_rows(pi, batch.edges_v, rows_per_shard)
        y_e = edge_set.has_edges(batch.edges_u, batch.edges_v)
        partial_grads = beta_ops.beta_gradients_core(
            cfg, state.theta, state.beta, pi_u, pi_v, y_e,
            batch.edge_mask)
        grads = jax.lax.psum(partial_grads, DATA_AXIS)
    beta_count = state.beta_count + 1
    with jax.named_scope("theta_update"):
        beta_noise = native_rng.randn(
            jax.random.fold_in(state.beta_key, step), (cfg.K, 2),
            state.phi_sum.dtype)
        theta, beta = beta_ops.theta_step(
            cfg, state.theta, grads, batch.weight, beta_count,
            beta_noise)

    return state._replace(
        pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
        step_count=step + 1, beta_count=beta_count,
    )


def _sharded_scan_body(cfg, rows_per_shard, edge_set, state, batches):
    """Scan over S pre-sampled steps, per-device view.

    Mirrors the hoisting of learner.train_steps_scan: neighbor draws,
    noise, and membership labels for ALL steps are produced in one
    vectorized block before the loop (their keys depend only on the
    step index and the data-shard index), leaving the loop with the
    state-dependent gathers, collectives, and updates."""
    s_len, b_local = batches.nodes.shape
    d_idx = jax.lax.axis_index(DATA_AXIS)
    m_idx = jax.lax.axis_index(MODEL_AXIS)
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)

    with jax.named_scope("neighbor_draws"):
        if cfg.shared_neighbors:
            nbr_keys = jax.vmap(lambda s: jax.random.fold_in(
                state.neighbor_key, s))(steps)  # same on all data shards
            sentinel = jnp.full((1,), cfg.N, jnp.int32)
            neighbors = jax.vmap(
                lambda k: sample_neighbors(k, sentinel, cfg.N,
                                           cfg.num_node_sample)
            )(nbr_keys)                                       # [S, 1, n]
        else:
            nbr_keys = jax.vmap(lambda s: jax.random.fold_in(
                jax.random.fold_in(state.neighbor_key, s), d_idx))(steps)
            neighbors = jax.vmap(
                lambda k, nd: sample_neighbors(k, nd, cfg.N,
                                               cfg.num_node_sample)
            )(nbr_keys, batches.nodes)                        # [S, Bl, n]
    with jax.named_scope("membership"):
        y_phi = edge_set.has_edges(batches.nodes[:, :, None], neighbors)
        y_edges = edge_set.has_edges(batches.edges_u, batches.edges_v)
    with jax.named_scope("noise"):
        # fp32 noise regardless of pi storage precision
        if cfg.phi_disable_noise:
            phi_noise = jnp.ones((s_len, b_local, cfg.K),
                                 state.phi_sum.dtype)
        else:
            phi_noise = jax.vmap(lambda s: native_rng.randn(
                jax.random.fold_in(jax.random.fold_in(state.phi_key, s),
                                   d_idx),
                (b_local, cfg.K), state.phi_sum.dtype))(steps)
        beta_noise = jax.vmap(lambda s: native_rng.randn(
            jax.random.fold_in(state.beta_key, s), (cfg.K, 2),
            state.phi_sum.dtype))(steps)
    with jax.named_scope("edge_lanes"):
        # the local edge slice's endpoints live somewhere in the GLOBAL
        # deduped node list; the write-back all_gathers every shard's
        # staged rows anyway, so the beta stage can read endpoint rows
        # from that buffer instead of two more cross-shard _fetch_rows
        # collectives (mirrors learner.train_steps_scan's edge_lanes;
        # the reference re-reads global memory, beta.cc:86-137). The
        # lane maps are state-independent and hoisted.
        g_nodes_all = jnp.moveaxis(
            jax.lax.all_gather(batches.nodes, DATA_AXIS), 0, 1
        ).reshape(s_len, -1)                                  # [S, Bg]
        lanes_u = jnp.argmax(batches.edges_u[:, :, None]
                             == g_nodes_all[:, None, :],
                             axis=-1).astype(jnp.int32)       # [S, El]
        lanes_v = jnp.argmax(batches.edges_v[:, :, None]
                             == g_nodes_all[:, None, :],
                             axis=-1).astype(jnp.int32)

    def body(s: TrainState, xs):
        batch, nbrs, y_n, n_phi, n_beta, y_e, lane_u, lane_v = xs
        with jax.named_scope("pi_gather"):
            pi_n = _fetch_rows(s.pi, batch.nodes, rows_per_shard)
            phis = _fetch_scalars(s.phi_sum, batch.nodes, rows_per_shard)
            pi_nb = _fetch_rows(
                s.pi, nbrs.reshape(-1), rows_per_shard
            ).reshape(nbrs.shape[0], cfg.num_node_sample, cfg.K)
        with jax.named_scope("phi_update"):
            nbr_mask = (nbrs != batch.nodes[:, None]
                        if cfg.shared_neighbors else None)
            rows, sums = phi_ops.phi_update_core(
                cfg, pi_n, phis, pi_nb, y_n, s.beta, s.step_count, n_phi,
                nbr_mask)

        with jax.named_scope("pi_scatter"):
            g_nodes = jax.lax.all_gather(batch.nodes,
                                         DATA_AXIS).reshape(-1)
            g_mask = jax.lax.all_gather(batch.node_mask,
                                        DATA_AXIS).reshape(-1)
            g_rows = jax.lax.all_gather(rows,
                                        DATA_AXIS).reshape(-1, cfg.K)
            g_sums = jax.lax.all_gather(sums, DATA_AXIS).reshape(-1)
            local = g_nodes - m_idx * rows_per_shard
            ok = (local >= 0) & (local < rows_per_shard) & g_mask
            safe = jnp.where(ok, local, rows_per_shard)
            # quantize fp32 staged rows only at the write-back
            pi = s.pi.at[safe].set(g_rows.astype(s.pi.dtype),
                                   mode="drop")
            phi_sum = s.phi_sum.at[safe].set(g_sums, mode="drop")

        with jax.named_scope("beta_grads"):
            # endpoint rows from the all_gathered staging buffer (see
            # edge_lanes above); masked lanes hold non-finite staging
            # garbage, sanitized so NaN*0 never reaches the grads
            rows_safe = jnp.where(g_mask[:, None], g_rows, 1.0 / cfg.K)
            partial_grads = beta_ops.beta_gradients_core(
                cfg, s.theta, s.beta, rows_safe[lane_u],
                rows_safe[lane_v], y_e, batch.edge_mask)
            grads = jax.lax.psum(partial_grads, DATA_AXIS)
        beta_count = s.beta_count + 1
        with jax.named_scope("theta_update"):
            theta, beta = beta_ops.theta_step(
                cfg, s.theta, grads, batch.weight, beta_count, n_beta)
        s = s._replace(pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
                       step_count=s.step_count + 1,
                       beta_count=beta_count)
        return s, None

    state, _ = jax.lax.scan(
        body, state,
        (batches, neighbors, y_phi, phi_noise, beta_noise, y_edges,
         lanes_u, lanes_v),
        unroll=cfg.scan_unroll)
    return state


def _sharded_global_step_body(cfg: Config, rows_per_shard: int,
                              s: TrainState, xs):
    """One SGRLD step on hoisted GLOBAL-batch operands, per-device view
    — the sequential tail body of the windowed sharded path. Every
    device computes the full (tiny) global minibatch redundantly; only
    the pi row fetch is collective and only the local row range is
    written (mirrors learner._hoisted_step_body with the cross-shard
    gather/write discipline of _sharded_scan_body)."""
    batch, nbrs, y_n, n_phi, n_beta, y_e, lane_u, lane_v = xs
    m_idx = jax.lax.axis_index(MODEL_AXIS)
    nbrs2 = nbrs.reshape(-1, cfg.num_node_sample)            # [1, n]
    with jax.named_scope("pi_gather"):
        pi_n = _fetch_rows(s.pi, batch.nodes, rows_per_shard)
        phis = _fetch_scalars(s.phi_sum, batch.nodes, rows_per_shard)
        pi_nb = _fetch_rows(s.pi, nbrs2.reshape(-1), rows_per_shard
                            ).reshape(nbrs2.shape[0],
                                      cfg.num_node_sample, cfg.K)
    with jax.named_scope("phi_update"):
        nbr_mask = nbrs2 != batch.nodes[:, None]     # shared draws only
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, pi_nb, y_n, s.beta, s.step_count, n_phi,
            nbr_mask)
    with jax.named_scope("pi_scatter"):
        local = batch.nodes - m_idx * rows_per_shard
        ok = batch.node_mask & (local >= 0) & (local < rows_per_shard)
        safe = jnp.where(ok, local, rows_per_shard)
        pi = s.pi.at[safe].set(rows.astype(s.pi.dtype), mode="drop")
        phi_sum = s.phi_sum.at[safe].set(sums, mode="drop")
    beta_count = s.beta_count + 1
    with jax.named_scope("beta_grads"):
        rows_safe = jnp.where(batch.node_mask[:, None], rows,
                              1.0 / cfg.K)
        grads = beta_ops.beta_gradients_core(
            cfg, s.theta, s.beta, rows_safe[lane_u], rows_safe[lane_v],
            y_e, batch.edge_mask)
    with jax.named_scope("theta_update"):
        theta, beta = beta_ops.theta_step(
            cfg, s.theta, grads, batch.weight, beta_count, n_beta)
    return s._replace(pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
                      step_count=s.step_count + 1,
                      beta_count=beta_count), None


def _sharded_windowed_scan(cfg: Config, rows_per_shard: int,
                           n_data: int, num_steps: int,
                           edge_set: EdgeSet, state: TrainState, ds):
    """T-step windowed sharded loop: ONE collective pi row fetch per
    window instead of ~7 collectives per step.

    Design: at reference minibatch shapes the global batch is tiny
    (tens of rows), so each device runs the whole window's compute
    REPLICATED over the data axis — the window body on the full global
    batch — while pi stays row-sharded over 'model'.
    Per window the only collectives are the psum row fetch of all T
    steps' read rows; the write-back is a purely LOCAL application of
    the last-write-wins staged rows to each shard's row range (the
    sequential sharded body pays 3 psum fetches + 4 all_gathers per
    step). theta/beta and the RNG keys are identical on every device,
    so replicated compute keeps replicated state bit-identical without
    broadcasts — the same argument the unwindowed body uses for its
    redundant theta update.

    Per-lane semantics (noise streams, shared neighbor draws,
    membership, eps_t) are exactly the data-sharded sequential body's:
    lane d*B_local+j consumes the same fold(fold(phi_key, s), d) draw
    shard d's lane j consumes there, so the windowed trajectory matches
    the unwindowed sharded trajectory modulo float reduction order
    (tested, tests/test_sharded_window.py)."""
    from mcmc_ammsb.ops.window import windowed_scan

    s_len = num_steps
    b_cap = cfg.max_batch_nodes
    b_local = b_cap // n_data
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    batches = DeviceBatch(
        edges_u=ds.edges_u, edges_v=ds.edges_v, edge_mask=ds.edge_mask,
        nodes=ds.nodes, node_mask=ds.node_mask, weight=ds.weight)

    with jax.named_scope("neighbor_draws"):
        nbr_keys = jax.vmap(lambda s: jax.random.fold_in(
            state.neighbor_key, s))(steps)   # same on every shard
        sentinel = jnp.full((1,), cfg.N, jnp.int32)
        neighbors = jax.vmap(
            lambda k: sample_neighbors(k, sentinel, cfg.N,
                                       cfg.num_node_sample)
        )(nbr_keys)                                          # [S, 1, n]
    with jax.named_scope("membership"):
        y_phi = edge_set.has_edges(batches.nodes[:, :, None], neighbors)
        y_edges = edge_set.has_edges(batches.edges_u, batches.edges_v)
    with jax.named_scope("edge_lanes"):
        lanes_u = jnp.argmax(batches.edges_u[:, :, None]
                             == batches.nodes[:, None, :],
                             axis=-1).astype(jnp.int32)      # [S, E]
        lanes_v = jnp.argmax(batches.edges_v[:, :, None]
                             == batches.nodes[:, None, :],
                             axis=-1).astype(jnp.int32)
    with jax.named_scope("noise"):
        if cfg.phi_disable_noise:
            phi_noise = jnp.ones((s_len, b_cap, cfg.K),
                                 state.phi_sum.dtype)
        else:
            # per-data-shard streams concatenated in shard order: lane
            # d*B_local+j carries exactly the draw the data-sharded
            # sequential body hands shard d's lane j
            def step_noise(s):
                return jnp.concatenate([
                    native_rng.randn(
                        jax.random.fold_in(
                            jax.random.fold_in(state.phi_key, s), d),
                        (b_local, cfg.K), state.phi_sum.dtype)
                    for d in range(n_data)], axis=0)
            phi_noise = jax.vmap(step_noise)(steps)          # [S, B, K]
        beta_noise = jax.vmap(lambda s: native_rng.randn(
            jax.random.fold_in(state.beta_key, s), (cfg.K, 2),
            state.phi_sum.dtype))(steps)

    def gather(cfg_, s, batch, nbrs):
        t_win = batch.nodes.shape[0]
        read_idx = jnp.concatenate([batch.nodes, nbrs], axis=1)
        g = _fetch_rows(s.pi, read_idx.reshape(-1), rows_per_shard
                        ).reshape(t_win, read_idx.shape[1], cfg_.K)
        sums_g = _fetch_scalars(s.phi_sum, batch.nodes.reshape(-1),
                                rows_per_shard).reshape(t_win, -1)
        # sentinel (masked) lanes read row id N, which is out of range
        # on EVERY shard when N % n_model == 0, so the psum fetch
        # returns 0 — and a zero phi_sum turns those lanes' staged rows
        # into NaN, which the window's one-hot correction contraction
        # then spreads through 0*NaN (the single-chip gather CLAMPS
        # out-of-range ids to a finite row instead). Masked lanes'
        # values never reach pi (last-write-wins keep excludes them;
        # the beta stage sanitizes), so flooring the fetched sums to a
        # strictly positive value is semantically invisible.
        sums_g = jnp.where(sums_g > 0.0, sums_g, 1.0)
        return g, sums_g

    def scatter(cfg_, s, batch, keep, rows_flat, sums_flat):
        m_idx = jax.lax.axis_index(MODEL_AXIS)
        flat_nodes = batch.nodes.reshape(-1)
        local = flat_nodes - m_idx * rows_per_shard
        ok = keep.reshape(-1) & (local >= 0) & (local < rows_per_shard)
        safe = jnp.where(ok, local, rows_per_shard)
        pi = s.pi.at[safe].set(rows_flat.astype(s.pi.dtype),
                               mode="drop")
        phi_sum = s.phi_sum.at[safe].set(sums_flat, mode="drop")
        return pi, phi_sum

    xs = (batches, neighbors, y_phi, phi_noise, beta_noise, y_edges,
          lanes_u, lanes_v)
    body = partial(_sharded_global_step_body, cfg, rows_per_shard)
    return windowed_scan(cfg, state, xs, body,
                         gather_fn=gather, scatter_fn=scatter)


def _sharded_fused_scan(cfg: Config, rows_per_shard: int, n_data: int,
                        num_steps: int, edge_set: EdgeSet,
                        heldout_set: EdgeSet, adjacency,
                        state: TrainState):
    """Fully-fused sharded loop: minibatches for the whole chunk are
    drawn ON DEVICE. Every device draws the identical global batch from
    the same key (the sampler is cheap and vectorized — cheaper than a
    broadcast), then slices its data-shard portion; the scan body is the
    hoisted one. With cfg.window > 1 the chunk runs the windowed path
    (_sharded_windowed_scan) on the global batch instead."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device

    d_idx = jax.lax.axis_index(DATA_AXIS)
    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    with jax.named_scope("device_sampling"):
        ds = sample_minibatches_device(cfg, edge_set, heldout_set,
                                       chunk_key, num_steps, adjacency)

    if cfg.window > 1 and cfg.shared_neighbors:
        return _sharded_windowed_scan(cfg, rows_per_shard, n_data,
                                      num_steps, edge_set, state, ds)

    def dslice(x, cap):
        per = cap // n_data
        return jax.lax.dynamic_slice_in_dim(x, d_idx * per, per, axis=1)

    e_cap, b_cap = cfg.max_batch_edges, cfg.max_batch_nodes
    batches = DeviceBatch(
        edges_u=dslice(ds.edges_u, e_cap),
        edges_v=dslice(ds.edges_v, e_cap),
        edge_mask=dslice(ds.edge_mask, e_cap),
        nodes=dslice(ds.nodes, b_cap),
        node_mask=dslice(ds.node_mask, b_cap),
        weight=ds.weight,
    )
    return _sharded_scan_body(cfg, rows_per_shard, edge_set, state,
                              batches)


def _sharded_ppx_body(cfg: Config, rows_per_shard: int, train: bool,
                      label_set: EdgeSet,
                      eu: jnp.ndarray, ev: jnp.ndarray, mask: jnp.ndarray,
                      state: TrainState):
    """Per-device perplexity over a local edge slice.

    ``train=False``: held-out eval (labels from the heldout set, running
    averages in ppx_per_edge). ``train=True``: training perplexity
    (labels from the training set, its own running-average state — the
    MCMC_CALC_TRAIN_PPX population, /root/reference/mcmc/learner.cc:
    204-212)."""
    per_edge = state.train_ppx_per_edge if train else state.ppx_per_edge
    count = (state.train_ppx_count if train else state.ppx_count) + 1
    pi_u = _fetch_rows(state.pi, eu, rows_per_shard)
    pi_v = _fetch_rows(state.pi, ev, rows_per_shard)
    y = label_set.has_edges(eu, ev) & mask
    res = ppx_ops.perplexity_core(
        cfg, pi_u, pi_v, y, mask, state.beta, per_edge, count)
    link_lik = jax.lax.psum(res.link_likelihood, DATA_AXIS)
    non_link_lik = jax.lax.psum(res.non_link_likelihood, DATA_AXIS)
    link_count = jax.lax.psum(res.link_count, DATA_AXIS)
    non_link_count = jax.lax.psum(res.non_link_count, DATA_AXIS)
    total = (link_count + non_link_count).astype(state.phi_sum.dtype)
    neg_avg = -(link_lik + non_link_lik) / total
    if train:
        state = state._replace(train_ppx_per_edge=res.ppx_per_edge,
                               train_ppx_count=count)
    else:
        state = state._replace(ppx_per_edge=res.ppx_per_edge,
                               ppx_count=count)
    return state, ppx_ops.PpxResult(
        res.ppx_per_edge, neg_avg, link_lik, non_link_lik,
        link_count, non_link_count)


def _sharded_fused_ppx(cfg: Config, rows_per_shard: int, n_data: int,
                       num_evals: int, interval: int,
                       edge_set: EdgeSet, heldout_set: EdgeSet,
                       adjacency, eu, ev, hmask, state: TrainState,
                       tu=None, tv=None, tmask=None):
    """num_evals x (interval fused sharded steps + one collective
    held-out eval) inside ONE shard_map program — the multi-chip analog
    of learner.train_steps_fused_ppx: the eval cadence no longer caps
    the dispatch depth, and the eval's psum rides the same program as
    the training collectives. With ``tu``/``tv``/``tmask`` set
    (cfg.calc_train_ppx) each eval also scores the training-ppx
    population after the held-out eval (host-loop order), so
    MCMC_CALC_TRAIN_PPX runs at the fused eval-inclusive rate."""
    def outer(s: TrainState, _):
        s = _sharded_fused_scan(cfg, rows_per_shard, n_data, interval,
                                edge_set, heldout_set, adjacency, s)
        s, res = _sharded_ppx_body(cfg, rows_per_shard, False,
                                   heldout_set, eu, ev, hmask, s)
        train_neg = None
        if tu is not None:
            s, tres = _sharded_ppx_body(cfg, rows_per_shard, True,
                                        edge_set, tu, tv, tmask, s)
            train_neg = tres.neg_avg_log
        # [H_local] running averages live in state; don't stack per eval
        return s, (res._replace(ppx_per_edge=None), train_neg)

    return jax.lax.scan(outer, state, None, length=num_evals)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

class ShardedLearner(HostSamplingPipeline):
    """Drop-in multi-chip learner: same API as learner.Learner."""

    def __init__(self, cfg: Config, graph: Optional[Graph],
                 split: Optional[DataSplit], mesh: Mesh,
                 prefetch: bool = True, partitioned=None):
        self.mesh = mesh
        n_data = mesh.shape[DATA_AXIS]
        n_model = mesh.shape[MODEL_AXIS]
        self.n_data, self.n_model = n_data, n_model
        self.partitioned = partitioned
        if partitioned is not None:
            # multi-host capacity mode (parallel/partitioned.py): the
            # graph lives ONLY as the model-row-sharded device CSR; no
            # host Graph/DataSplit exists and host sampling is
            # impossible by construction
            if graph is not None or split is not None:
                raise ValueError("pass either (graph, split) or "
                                 "partitioned=, not both")
            if not cfg.device_sampling:
                raise ValueError(
                    "partitioned mode requires device_sampling: host "
                    "minibatch sampling needs the full host graph, "
                    "which no process holds")
            # calc_train_ppx IS supported here:
            # the population comes from the sharded structures via
            # make_training_ppx_edges_partitioned — bit-equal to the
            # replicated builder's, no host graph needed

        # pad capacities to the data axis; rows to the model axis
        from mcmc_ammsb.config import RngBackend
        # bf16 pi storage is supported sharded: rows are quantized at
        # the write-back and upcast in _fetch_rows, exactly as the
        # single-chip path — the capacity lever matters MOST here (the
        # reference's RowPartitionedMatrix exists precisely to exceed
        # one allocation's limits, partitioned-alloc.h:87-131; bf16
        # halves every shard's row bytes on top of the row split).
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError(
                "ShardedLearner requires rng_backend=native: the "
                "reference RNG's per-thread streams are single-device "
                "semantics (one xorshift128+ state per minibatch lane, "
                "/root/reference/mcmc/random.cc:31-44) and have no "
                "meaningful partitioning across a data-sharded batch")
        if cfg.window > 1:
            if not (cfg.shared_neighbors and cfg.device_sampling):
                raise ValueError(
                    "window > 1 on ShardedLearner requires "
                    "shared_neighbors and device_sampling (the windowed "
                    "sharded path, _sharded_windowed_scan, fuses the "
                    "device-sampled global batch; the host-sampled path "
                    "pre-shards batches over the data axis)")
        cfg = cfg.replace(
            batch_edges_cap=_round_up(cfg.max_batch_edges, n_data),
            batch_nodes_cap=_round_up(cfg.max_batch_nodes, n_data),
        )
        self.cfg = cfg
        self.graph = graph
        self.split = split
        self.n_padded = _round_up(cfg.N, n_model)
        self.rows_per_shard = self.n_padded // n_model

        if partitioned is not None:
            from mcmc_ammsb.parallel.partitioned import (
                build_sharded_csr)
            self.training_set = build_sharded_csr(
                mesh, cfg.N, self.rows_per_shard, partitioned.shards,
                partitioned.cols_cap)
            ho_set_u, ho_set_v = (partitioned.heldout_u,
                                  partitioned.heldout_v)
            ho_eval_u = partitioned.heldout_edges_u
            ho_eval_v = partitioned.heldout_edges_v
        else:
            self.training_set = build_edge_set(
                cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
            ho_set_u, ho_set_v = split.heldout_u, split.heldout_v
            ho_eval_u = split.heldout_edges_u
            ho_eval_v = split.heldout_edges_v
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, ho_set_u, ho_set_v)

        # heldout eval population padded to the data axis
        h = len(ho_eval_u)
        if h == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
        h_pad = _round_up(h, n_data)
        eu = np.zeros(h_pad, np.int32); eu[:h] = ho_eval_u
        ev = np.zeros(h_pad, np.int32); ev[:h] = ho_eval_v
        hmask = np.arange(h_pad) < h

        # training-perplexity population (MCMC_CALC_TRAIN_PPX parity,
        # /root/reference/mcmc/learner.cc:47-75), padded to the data axis
        if cfg.calc_train_ppx:
            if partitioned is not None:
                # sharded population source (learner.cc:48-74 law,
                # bit-equal to the replicated builder — the link head
                # via k-smallest union, non-links via the same
                # RandomState stream with collective membership)
                from mcmc_ammsb.parallel.partitioned import (
                    make_training_ppx_edges_partitioned)
                tu, tv = make_training_ppx_edges_partitioned(
                    partitioned, cfg.training_ppx_ratio)
            else:
                from mcmc_ammsb.data import make_training_ppx_edges
                tu, tv = make_training_ppx_edges(split,
                                                 cfg.training_ppx_ratio)
            t = len(tu)
            t_pad = _round_up(max(t, 1), n_data)
            teu = np.zeros(t_pad, np.int32); teu[:t] = tu
            tev = np.zeros(t_pad, np.int32); tev[:t] = tv
            tmask = np.arange(t_pad) < t
        else:
            t_pad = 0
            teu = tev = np.zeros(0, np.int32)
            tmask = np.zeros(0, np.bool_)

        state = init_state(cfg, h_pad, t_pad)
        pad_rows = self.n_padded - cfg.N
        if pad_rows:
            state = state._replace(
                pi=jnp.concatenate(
                    [state.pi,
                     jnp.full((pad_rows, cfg.K), 1.0 / cfg.K,
                              state.pi.dtype)]),
                phi_sum=jnp.concatenate(
                    [state.phi_sum, jnp.ones(pad_rows, state.pi.dtype)]),
            )

        # --- sharding specs --------------------------------------------
        self.state_spec = TrainState(
            pi=P(MODEL_AXIS, None), phi_sum=P(MODEL_AXIS),
            theta=P(), beta=P(), step_count=P(), beta_count=P(),
            ppx_per_edge=P(DATA_AXIS), ppx_count=P(),
            phi_key=P(), beta_key=P(), neighbor_key=P(),
            ref_seeds=None,  # sharded path uses the native backend
            sample_key=P(),
            train_ppx_per_edge=P(DATA_AXIS), train_ppx_count=P(),
        )
        self.batch_spec = DeviceBatch(
            edges_u=P(DATA_AXIS), edges_v=P(DATA_AXIS),
            edge_mask=P(DATA_AXIS), nodes=P(DATA_AXIS),
            node_mask=P(DATA_AXIS), weight=P(),
        )
        scan_spec = DeviceBatch(
            edges_u=P(None, DATA_AXIS), edges_v=P(None, DATA_AXIS),
            edge_mask=P(None, DATA_AXIS), nodes=P(None, DATA_AXIS),
            node_mask=P(None, DATA_AXIS), weight=P(None),
        )

        def dev_put(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        self.state: TrainState = jax.tree.map(
            dev_put, state, self.state_spec)
        self.heldout_u = dev_put(jnp.asarray(eu), P(DATA_AXIS))
        self.heldout_v = dev_put(jnp.asarray(ev), P(DATA_AXIS))
        self.heldout_mask = dev_put(jnp.asarray(hmask), P(DATA_AXIS))
        if cfg.calc_train_ppx:
            self.train_ppx_u = dev_put(jnp.asarray(teu), P(DATA_AXIS))
            self.train_ppx_v = dev_put(jnp.asarray(tev), P(DATA_AXIS))
            self.train_ppx_mask = dev_put(jnp.asarray(tmask),
                                          P(DATA_AXIS))
        else:
            self.train_ppx_u = self.train_ppx_v = None
            self.train_ppx_mask = None

        # spec for the training structures: replicated EdgeSet -> P()
        # prefix; model-row-sharded CSR -> its per-leaf spec pytree
        tspec = (self.training_set.spec() if partitioned is not None
                 else P())

        body = partial(_sharded_step_body, cfg, self.rows_per_shard)
        self._step_fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(tspec, self.state_spec, self.batch_spec),
            out_specs=self.state_spec,
            check_vma=False,
        ), donate_argnums=(1,))
        scan_body = partial(_sharded_scan_body, cfg, self.rows_per_shard)
        self._scan_fn = jax.jit(jax.shard_map(
            scan_body, mesh=mesh,
            in_specs=(tspec, self.state_spec, scan_spec),
            out_specs=self.state_spec,
            check_vma=False,
        ), donate_argnums=(1,))
        aspec = tspec if partitioned is not None else P()

        def make_fused(num_steps):
            body = partial(_sharded_fused_scan, cfg, self.rows_per_shard,
                           n_data, num_steps)
            return jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(tspec, P(), aspec, self.state_spec),
                out_specs=self.state_spec,
                check_vma=False,
            ), donate_argnums=(3,))

        self._fused_fns = {}
        self._make_fused = make_fused

        series_spec = ppx_ops.PpxResult(
            ppx_per_edge=None, neg_avg_log=P(),
            link_likelihood=P(), non_link_likelihood=P(),
            link_count=P(), non_link_count=P())

        def make_fused_ppx(num_evals, interval):
            body = partial(_sharded_fused_ppx, cfg, self.rows_per_shard,
                           n_data, num_evals, interval)
            if cfg.calc_train_ppx:
                return jax.jit(jax.shard_map(
                    body, mesh=mesh,
                    in_specs=(tspec, P(), aspec, P(DATA_AXIS),
                              P(DATA_AXIS), P(DATA_AXIS),
                              self.state_spec,
                              P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=(self.state_spec, (series_spec, P())),
                    check_vma=False,
                ), donate_argnums=(6,))
            return jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(tspec, P(), aspec, P(DATA_AXIS), P(DATA_AXIS),
                          P(DATA_AXIS), self.state_spec),
                out_specs=(self.state_spec, (series_spec, None)),
                check_vma=False,
            ), donate_argnums=(6,))

        self._fused_ppx_fns = {}
        self._make_fused_ppx = make_fused_ppx

        ppx_res_spec = ppx_ops.PpxResult(
            ppx_per_edge=P(DATA_AXIS), neg_avg_log=P(),
            link_likelihood=P(), non_link_likelihood=P(),
            link_count=P(), non_link_count=P())

        def make_ppx_fn(train: bool):
            body = partial(_sharded_ppx_body, cfg, self.rows_per_shard,
                           train)
            # the train label set is the training structure: a
            # replicated EdgeSet (P() prefix) or, in partitioned mode,
            # the model-row-sharded CSR (its per-leaf spec) — the same
            # has_edges protocol answers membership either way
            label_spec = (tspec if (train and partitioned is not None)
                          else P())
            return jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(label_spec, P(DATA_AXIS), P(DATA_AXIS),
                          P(DATA_AXIS), self.state_spec),
                out_specs=(self.state_spec, ppx_res_spec),
                check_vma=False,
            ), donate_argnums=(4,))

        self._ppx_fn = make_ppx_fn(train=False)
        self._train_ppx_fn = (make_ppx_fn(train=True)
                              if cfg.calc_train_ppx else None)

        if partitioned is not None:
            # no host sampler exists (device_sampling is mandatory);
            # the sampler adjacency IS the sharded CSR (degree /
            # row_gather collectives, partitioned.ShardedCSR)
            self._init_pipeline(None, prefetch=False)
            self.adjacency = self.training_set
        else:
            self._init_pipeline(MiniBatchSampler(cfg, graph, split),
                                prefetch)
            # replicated training CSR adjacency for the device samplers
            self.adjacency = (
                dev_put(jnp.asarray(graph.offsets, jnp.int32), P()),
                dev_put(jnp.asarray(graph.cols, jnp.int32), P()))
        self.timers = StageTimers()
        self.last_ppx_stats = {}

    @classmethod
    def from_partitioned(cls, cfg: Config, pdata, mesh: Mesh
                         ) -> "ShardedLearner":
        """Multi-host capacity construction: consume a per-process
        PartitionedData (parallel/partitioned.partitioned_ingest) —
        model-row-sharded training CSR for membership AND sampling,
        replicated small held-out structures, no host Graph anywhere.
        Trajectory is bit-identical to the replicated-graph engine on
        the same dataset (tests/test_partitioned.py)."""
        return cls(cfg, None, None, mesh, partitioned=pdata)

    # -- API (mirrors Learner) --------------------------------------------

    def run(self, max_iters: int) -> None:
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            if self.cfg.device_sampling:
                self._run_fused(max_iters, spc)
            else:
                self._run_host_sampled(max_iters, spc)
            int(self.state.step_count)  # fence inside the timer

    def _run_fused(self, max_iters: int, spc: int) -> None:
        done = 0
        while done < max_iters:
            take = min(spc, max_iters - done)
            with self.timers.stage("device_step"):
                if take not in self._fused_fns:
                    self._fused_fns[take] = self._make_fused(take)
                self.state = self._fused_fns[take](
                    self.training_set, self.heldout_set,
                    self.adjacency, self.state)
            done += take

    def _run_host_sampled(self, max_iters: int, spc: int) -> None:
        from mcmc_ammsb.sampling import MiniBatch
        src = self._get_prefetcher(spc) if self._use_prefetch else None
        done = 0
        while done < max_iters:
            take = min(spc, max_iters - done)
            with self.timers.stage("sampling"):
                if spc == 1:
                    hb = (self._next_pending(MiniBatch)
                          or (src.get() if src else self.sampler.sample()))
                    batch = DeviceBatch.from_host(hb)
                else:
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
                    batch = DeviceBatch.from_stacked(stacked)
            with self.timers.stage("device_step"):
                if spc == 1:
                    self.state = self._step_fn(
                        self.training_set, self.state, batch)
                else:
                    self.state = self._scan_fn(
                        self.training_set, self.state, batch)
            done += take

    def run_with_ppx(self, max_iters: int, interval: int):
        """Multi-chip analog of Learner.run_with_ppx: train max_iters
        steps with a held-out eval every ``interval`` steps fused into
        the shard_map program (_sharded_fused_ppx). Same series
        contract; requires cfg.device_sampling."""
        if not self.cfg.device_sampling:
            raise RuntimeError("run_with_ppx requires device_sampling")
        from mcmc_ammsb.learner import run_fused_eval_series

        spc = max(1, self.cfg.steps_per_call)

        train_ppx = self.cfg.calc_train_ppx

        def dispatch(take):
            key = (take, interval)
            if key not in self._fused_ppx_fns:
                self._fused_ppx_fns[key] = self._make_fused_ppx(
                    take, interval)
            args = (self.training_set, self.heldout_set,
                    self.adjacency, self.heldout_u, self.heldout_v,
                    self.heldout_mask, self.state)
            if train_ppx:
                args += (self.train_ppx_u, self.train_ppx_v,
                         self.train_ppx_mask)
            self.state, (res, train_neg) = self._fused_ppx_fns[key](
                *args)
            # one packed DEVICE array; the pipelined driver materializes
            # it after enqueueing the next chunk (learner.py
            # run_fused_eval_series rationale); train-ppx rides as
            # row 5 of the same transfer
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

        def tail(t):
            self._run_fused(t, spc)
            int(self.state.step_count)

        return run_fused_eval_series(
            self.timers, spc, max_iters, interval, dispatch,
            lambda: int(self.state.step_count), record, tail)

    def heldout_perplexity(self) -> float:
        with self.timers.stage("ppx"):
            self.state, res = self._ppx_fn(
                self.heldout_set, self.heldout_u, self.heldout_v,
                self.heldout_mask, self.state)
            # one packed readback (learner.py heldout_perplexity
            # rationale: per-field scalar reads pay ~7 ms each)
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
        """Training perplexity over the MCMC_CALC_TRAIN_PPX population
        (/root/reference/mcmc/learner.cc:204-212); requires
        cfg.calc_train_ppx."""
        if not self.cfg.calc_train_ppx:
            raise RuntimeError("enable cfg.calc_train_ppx")
        with self.timers.stage("train_ppx"):
            self.state, res = self._train_ppx_fn(
                self.training_set, self.train_ppx_u, self.train_ppx_v,
                self.train_ppx_mask, self.state)
            return float(jnp.exp(res.neg_avg_log))

    def print_stats(self, log=print) -> None:
        self.timers.print_table(log)

    # -- profiling (mirrors Learner.fused_stage_profile) -------------------

    def _production_hlo_text(self, spc: int) -> str:
        """Optimized HLO of the production sharded chunk program — the
        op->stage map for trace events that carry no scope path."""
        if self.cfg.device_sampling:
            if spc not in self._fused_fns:
                self._fused_fns[spc] = self._make_fused(spc)
            lowered = self._fused_fns[spc].lower(
                self.training_set, self.heldout_set, self.adjacency,
                self.state)
        else:
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
        """TRUE per-stage attribution of the sharded production program
        (the multi-chip analog of the reference's per-kernel event
        timers, /root/reference/mcmc/learner.cc:252-299): runs a traced
        production chunk under jax.profiler and aggregates device-op
        time by the named_scope stages of the shard_map bodies. The
        pi_gather/pi_scatter stages here include their collectives
        (psum row fetch, all_gather write-back)."""
        from mcmc_ammsb.utils import profiling

        spc = max(1, self.cfg.steps_per_call)
        return profiling.traced_stage_profile(
            self.run, self._production_hlo_text(spc), spc, iters)

    def print_stage_profile(self, log=print,
                            iters: Optional[int] = None) -> None:
        """Fused per-stage table from a profiler trace of the sharded
        program; raises when the trace yields nothing attributable."""
        from mcmc_ammsb.utils import profiling

        profiling.print_stage_profile(self.fused_stage_profile(iters), log)
