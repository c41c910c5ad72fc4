"""On-device minibatch sampling for the fully-fused training loop.

The reference samples minibatches on the host inside a std::async
pipeline (mcmc/learner.cc:216-246, strategies mcmc/sample.cc:241-302).
With the whole train step fused under lax.scan, host sampling becomes
the only per-step host round-trip; this module moves the random-node
strategies onto the device so hundreds of SGRLD steps run as ONE
dispatch with zero host involvement (``Config.device_sampling``).

Implemented strategies (all six — SURVEY.md §2 #13):

  NodeLink    — one random non-isolated node, all of its training
                edges, weight N          (sample.cc:253-268)
  NodeNonLink — m distinct non-links at one random node, excluding
                training and held-out edges, weight 2E/m
                (sample.cc:275-293)
  Node        — fair coin between the two (sample.cc:295-302)
  BFLink      — breadth-first training-edge collection from a random
                pivot, weight E/m        (sample.cc:210-239)
  BFNonLink   — breadth-first non-link collection (32 draws per
                expanded node), weight (N(N-1)/2 - E)/m
                (sample.cc:177-208)
  BF          — fair coin between the two (sample.cc:241-248)

The BF family's host FIFO queue becomes a fixed round schedule whose
pops never pass the round-start tail, so the device replays the exact
host expansion order with a bounded total budget (_bf_expand; knobs
``ds_bf_rounds``/``ds_bf_pops``).

Everything is *natively batched over the step axis* — a whole scan
chunk's minibatches are drawn in one vectorized block with NO
while_loop/cond (data-dependent control flow is replaced by a fixed
number of masked redraw rounds, whose residual failure probability is
negligible and handled by masking; XLA compiles this orders of
magnitude faster than a vmapped rejection loop). The link strategies
need the training graph's CSR adjacency (offsets/cols): with the CSR
edge-set backend those arrays are reused directly; any other membership
backend (e.g. the perfect hash) passes them explicitly via
``adjacency`` — the learners thread their Graph's CSR through.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_ammsb.config import Config, SampleStrategy
from mcmc_ammsb.ops.edgeset import EdgeSet


class DeviceSamples(NamedTuple):
    """A stacked batch of S device-sampled minibatches."""

    edges_u: jnp.ndarray    # [S, E_cap] int32
    edges_v: jnp.ndarray
    edge_mask: jnp.ndarray  # [S, E_cap] bool
    nodes: jnp.ndarray      # [S, B_cap] int32 (deduped; padded with N)
    node_mask: jnp.ndarray  # [S, B_cap] bool
    weight: jnp.ndarray     # [S] f32


class _TupleAdj(NamedTuple):
    """Replicated CSR adjacency view: the (offsets [N+1], cols [2E])
    pair behind the two primitives the link sampler needs. The
    model-row-sharded twin (parallel/partitioned.ShardedCSR) provides
    the same ``degree`` / ``row_gather`` protocol via collectives, so
    the sampler body is layout-agnostic and the two layouts produce
    bit-identical draws (psums of one-owner integer contributions are
    exact)."""

    offsets: jnp.ndarray
    cols: jnp.ndarray

    def degree(self, u: jnp.ndarray) -> jnp.ndarray:
        return self.offsets[u + 1] - self.offsets[u]

    def row_gather(self, u: jnp.ndarray,
                   off: jnp.ndarray) -> jnp.ndarray:
        idx = self.offsets[u][..., None] + off
        m = self.cols.shape[0]
        return self.cols[jnp.clip(idx, 0, m - 1)]


def _structural_nodes(cfg: Config, eu, ev, mask, pivot):
    """Deduped node list of a Node-family device draw WITHOUT sorting.

    Every minibatch the device samplers produce is structurally one
    PIVOT node plus distinct partners (NodeLink: the pivot's CSR row,
    distinct by construction; NodeNonLink: the dup/self-hit lanes are
    already masked out of ``mask``), so the dedup the host path does
    with a double sort (_extract_nodes) collapses to lane 0 = pivot,
    lane 1+i = edge lane i's non-pivot endpoint, with no [S, 2E] sorts.
    Set-equal to _extract_nodes per batch (golden-tested); lane
    ORDER differs, which is semantically invisible (the scatter is
    per-row, the edge-lane maps search the list, neighbor draws are
    per-stream).
    """
    sentinel = jnp.int32(cfg.N)
    partners = eu + ev - pivot[..., None]          # the other endpoint
    nodes = jnp.concatenate([pivot[..., None], partners], axis=-1)
    nmask = jnp.concatenate(
        [jnp.ones((*mask.shape[:-1], 1), jnp.bool_), mask], axis=-1)
    nodes = jnp.where(nmask, nodes, sentinel)
    b_cap = cfg.max_batch_nodes
    if nodes.shape[-1] < b_cap:
        pad = b_cap - nodes.shape[-1]
        widths = [(0, 0)] * (nodes.ndim - 1) + [(0, pad)]
        nodes = jnp.pad(nodes, widths, constant_values=sentinel)
        nmask = jnp.pad(nmask, widths)
    else:
        # valid partners always sit in the first b_cap-1 lanes
        # (NodeLink <= max_fan_out of them, NodeNonLink <= m, and
        # finalize() guarantees b_cap >= max(m, fan_out)+1)
        nodes = nodes[..., :b_cap]
        nmask = nmask[..., :b_cap]
    return nodes, nmask


def _extract_nodes(cfg: Config, eu, ev, mask):
    """Batched endpoint dedup (ExtractNodesFromMiniBatch,
    learner.cc:162-173) without jnp.unique: sort, blank repeats to the
    sentinel N, sort again so unique ids form a clean prefix.

    Kept as the strategy-agnostic golden reference for
    _structural_nodes (which exploits the pivot+partners structure of
    device draws to skip both sorts)."""
    sentinel = jnp.int32(cfg.N)
    ids = jnp.concatenate([
        jnp.where(mask, eu, sentinel),
        jnp.where(mask, ev, sentinel),
    ], axis=-1)                                   # [S, 2*E_cap]
    if ids.shape[-1] < cfg.max_batch_nodes:
        # keep the documented [*, B_cap] output shape even when the
        # node capacity exceeds twice the edge capacity
        pad = cfg.max_batch_nodes - ids.shape[-1]
        ids = jnp.pad(ids, [(0, 0)] * (ids.ndim - 1) + [(0, pad)],
                      constant_values=sentinel)
    s = jnp.sort(ids, axis=-1)
    dup = jnp.concatenate(
        [jnp.zeros((*s.shape[:-1], 1), jnp.bool_),
         s[..., 1:] == s[..., :-1]], axis=-1)
    s = jnp.sort(jnp.where(dup, sentinel, s), axis=-1)
    uniq = s[..., : cfg.max_batch_nodes]
    return uniq, uniq != sentinel


def _sample_node_link_batch(cfg: Config, adj, key,
                            s_len: int, rounds: int | None = None):
    """[S] NodeLink draws: random non-isolated pivots (masked redraw
    rounds instead of the host's unbounded retry) + their CSR rows.

    ``rounds`` defaults to ``cfg.ds_link_rounds``; a residual isolated
    pivot after all rounds yields an all-masked edge buffer (zero beta
    gradient) — probability p_iso^(rounds+1) per step.

    With ``cfg.ds_link_cap`` set (heavy-tail graphs), pivots whose
    degree exceeds the edge buffer contribute e_cap uniform
    with-replacement draws from their CSR row (keep-first dedup) and
    the per-step weight becomes the Horvitz-Thompson
    ``N / (1 - (1 - 1/d)^e_cap)`` — each distinct edge of the pivot is
    included with probability p = 1-(1-1/d)^e_cap, so
    E[weight * sum over kept lanes] = N * d exactly, the invariant the
    take-all path satisfies by construction (tested in
    test_device_sampling.py). Small-degree pivots keep the exact
    reference batch."""
    if rounds is None:
        rounds = cfg.ds_link_rounds
    e_cap = cfg.max_batch_edges
    keys = jax.random.split(key, 3)
    u = jax.random.randint(keys[0], (s_len,), 0, cfg.N, jnp.int32)

    def fixup(i, u):
        redraw = jax.random.randint(
            jax.random.fold_in(keys[1], i), (s_len,), 0, cfg.N, jnp.int32)
        isolated = adj.degree(u) == 0
        return jnp.where(isolated, redraw, u)

    u = jax.lax.fori_loop(0, rounds, fixup, u)
    deg = adj.degree(u)                                      # [S]
    lane = jnp.arange(e_cap, dtype=jnp.int32)
    in_row = jnp.broadcast_to(lane, (s_len, e_cap))
    valid = lane < deg[:, None]
    weight = jnp.full((s_len,), cfg.N, jnp.float32)
    if cfg.ds_link_cap and cfg.max_fan_out > e_cap:
        # degree-capped path: rows that overflow the buffer are
        # subsampled with replacement + HT-reweighted; fitting rows
        # keep the exact sequential slice above
        take_all = deg <= e_cap                              # [S]
        degf = jnp.maximum(deg.astype(jnp.float32), 1.0)
        off = jnp.floor(
            jax.random.uniform(keys[2], (s_len, e_cap)) * degf[:, None]
        ).astype(jnp.int32)
        off = jnp.minimum(off, deg[:, None] - 1)             # uniform(1.0) guard
        dup = jnp.any(
            (off[:, :, None] == off[:, None, :])
            & jnp.tril(jnp.ones((e_cap, e_cap), jnp.bool_), -1)[None],
            axis=-1,
        )
        in_row = jnp.where(take_all[:, None], in_row, off)
        valid = jnp.where(take_all[:, None], valid,
                          (deg[:, None] > 0) & ~dup)
        p_inc = 1.0 - (1.0 - 1.0 / degf) ** e_cap
        weight = jnp.where(take_all, weight,
                           cfg.N / jnp.maximum(p_inc, 1e-30))
    v = adj.row_gather(u, in_row)
    eu = jnp.minimum(u[:, None], v)
    ev = jnp.maximum(u[:, None], v)
    return eu, ev, valid, weight, u


def _sample_node_non_link_batch(cfg: Config, training_set, heldout_set,
                                key, s_len: int, rounds: int | None = None):
    """[S] NodeNonLink draws. ``rounds`` defaults to
    ``cfg.ds_nonlink_rounds``: each round re-runs ``bad_lanes`` (two
    edge-set membership passes + the [m, m] dup test) at full volume —
    the dominant sampling cost at reference shapes — while the final
    mask + 2E/m_eff reweight below keeps the estimator unbiased for
    ANY residual bad-lane rate, so few rounds lose nothing."""
    if rounds is None:
        rounds = cfg.ds_nonlink_rounds
    m = cfg.mini_batch_size
    e_cap = cfg.max_batch_edges
    keys = jax.random.split(key, 3)
    u = jax.random.randint(keys[0], (s_len,), 0, cfg.N, jnp.int32)
    v = jax.random.randint(keys[1], (s_len, m), 0, cfg.N, jnp.int32)

    def bad_lanes(v):
        a = jnp.minimum(u[:, None], v)
        b = jnp.maximum(u[:, None], v)
        hit = training_set.has_edges(a, b) | heldout_set.has_edges(a, b)
        dup = jnp.any(
            (v[:, :, None] == v[:, None, :])
            & jnp.tril(jnp.ones((m, m), jnp.bool_), -1)[None],
            axis=-1,
        )
        return (v == u[:, None]) | hit | dup

    def fixup(i, v):
        redraw = jax.random.randint(
            jax.random.fold_in(keys[2], i), (s_len, m), 0, cfg.N,
            jnp.int32)
        return jnp.where(bad_lanes(v), redraw, v)

    v = jax.lax.fori_loop(0, rounds, fixup, v)
    ok = ~bad_lanes(v)                    # residual collisions masked out
    eu = jnp.minimum(u[:, None], v)
    ev = jnp.maximum(u[:, None], v)
    pad = e_cap - m
    if pad:
        eu = jnp.pad(eu, ((0, 0), (0, pad)))
        ev = jnp.pad(ev, ((0, 0), (0, pad)))
        ok = jnp.pad(ok, ((0, 0), (0, pad)))
    # The reference loops until it holds exactly m good non-links and
    # scales by 2E/m (sample.cc:275-293); here residual bad lanes after
    # the fixed redraw rounds are masked out, so the minibatch holds
    # m_eff <= m non-links. Scaling by 2E/m_eff keeps the gradient
    # estimator unbiased for ANY residual rate: weight * m_eff == 2E
    # exactly, the invariant the host sampler satisfies by construction
    # (tested in test_device_sampling.py).
    m_eff = jnp.sum(ok, axis=-1).astype(jnp.float32)
    weight = 2.0 * cfg.E / jnp.maximum(m_eff, 1.0)
    return eu, ev, ok, weight, u


def _compose_rows(values: jnp.ndarray, dst: jnp.ndarray,
                  width: int) -> jnp.ndarray:
    """Batched ordered append: place ``values[s, l]`` at column
    ``dst[s, l]`` of a fresh [S, width] int32 buffer (lanes with
    ``dst >= width`` are dropped; kept dst must be unique per row).

    One flat int32 scatter-add into a [S, width + 1] buffer whose last
    column collects the dropped lanes: integer arithmetic, so exact for
    every int32 value and independent of the order the adds apply in."""
    s_len, lanes = values.shape
    col = jnp.where((dst >= 0) & (dst < width), dst, width)
    row = jnp.arange(s_len, dtype=jnp.int32)[:, None]
    flat = (row * (width + 1) + col).reshape(-1)
    out = jnp.zeros((s_len * (width + 1),), jnp.int32).at[flat].add(
        values.astype(jnp.int32).reshape(-1))
    return out.reshape(s_len, width + 1)[:, :width]


def _keep_first_dups(a: jnp.ndarray, b: jnp.ndarray,
                     valid: jnp.ndarray) -> jnp.ndarray:
    """True for lanes whose (a, b) pair already appeared at an EARLIER
    valid lane of the same row (keep-first dedup over [S, L] without
    the [S, L, L] pairwise blow-up): two stable lexicographic sorts —
    mark equal-to-predecessor in sorted order, restore lane order."""
    s_len, L = a.shape
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (s_len, L))
    # invalid lanes get unique sink keys so they never pair up
    ka = jnp.where(valid, a, jnp.int32(2**31 - 2))
    kb = jnp.where(valid, b, pos)
    sa, sb, sp = jax.lax.sort((ka, kb, pos), num_keys=2, is_stable=True)
    dup = (sa[:, 1:] == sa[:, :-1]) & (sb[:, 1:] == sb[:, :-1])
    dup = jnp.concatenate(
        [jnp.zeros((s_len, 1), jnp.bool_), dup], axis=1)
    _, restored = jax.lax.sort((sp, dup.astype(jnp.int32)), num_keys=1,
                               is_stable=True)
    return restored.astype(jnp.bool_) & valid


def _bf_expand(cfg: Config, key, s_len: int, cand_fn, cand_width: int):
    """Shared breadth-first expansion engine for the device BF family.

    Vectorized-over-steps replay of the host FIFO loop
    (sampling.py::_bf_link/_bf_non_link, mirroring the reference's
    sampleBreadthFirst* at /root/reference/mcmc/sample.cc:177-248):

      queue q, seen set, edge dict; pop u (skip seen), emit u's
      candidate edges in order (dict-deduped, stop at m), push u's
      candidates; empty queue -> fresh unseen pivot.

    Device form: ``cfg.ds_bf_rounds`` rounds each pop up to
    ``cfg.ds_bf_pops`` entries — but never past the round-start tail,
    so pops replay the host's FIFO order EXACTLY (children pushed this
    round are popped next round, precisely the entries the host would
    pop next). Seen-skips are masked expansions; the per-round
    candidate stream (pop order x in-row order) is dict-deduped
    keep-first against the edge buffer and within the round, and the
    first m survivors ARE the host's first m edges whenever the
    expansion budget 1 + (rounds-1)*pops covers the nodes the host
    expanded. Queue/edge appends are integer scatter-add composes; the queue
    is capped at the number of positions that can ever be popped, so
    the cap drops nothing reachable.

    ``cand_fn(u, expand, key) -> (v [S,P,C], cand_valid [S,P,C])``
    supplies each popped node's candidate partners (adjacency row for
    BFLink, rejection-sampled non-partners for BFNonLink).

    Returns (eu, ev, edge_mask, m_eff) with [S, m]-shaped buffers.
    """
    S, P, R = s_len, cfg.ds_bf_pops, cfg.ds_bf_rounds
    m = cfg.mini_batch_size
    q_cap = 1 + (R - 1) * P      # pops advance head <= P per round and
    x_cap = q_cap                # round 0 holds only the pivot
    L = P * cand_width

    qbuf = jnp.zeros((S, q_cap), jnp.int32)
    head = jnp.zeros((S,), jnp.int32)
    tail = jnp.zeros((S,), jnp.int32)
    seen = jnp.zeros((S, x_cap), jnp.int32)      # expanded-node list
    xcnt = jnp.zeros((S,), jnp.int32)
    ebuf_a = jnp.zeros((S, m), jnp.int32)
    ebuf_b = jnp.zeros((S, m), jnp.int32)
    ecnt = jnp.zeros((S,), jnp.int32)

    lane_q = jnp.arange(q_cap, dtype=jnp.int32)
    lane_x = jnp.arange(x_cap, dtype=jnp.int32)
    lane_m = jnp.arange(m, dtype=jnp.int32)

    for r in range(R):
        kr = jax.random.fold_in(key, r)
        # -- empty queue (start, isolated pivot, exhausted component):
        #    inject a fresh pivot at tail, exactly the host's
        #    `if not q: q.append(_fresh_pivot(seen))` -----------------
        need = (tail == head) & (ecnt < m)
        pivot = jax.random.randint(jax.random.fold_in(kr, 0), (S,),
                                   0, cfg.N, jnp.int32)
        for t in range(2):       # bounded not-in-seen redraws
            hit = jnp.any((pivot[:, None] == seen)
                          & (lane_x[None, :] < xcnt[:, None]), axis=1)
            redraw = jax.random.randint(jax.random.fold_in(kr, t + 1),
                                        (S,), 0, cfg.N, jnp.int32)
            pivot = jnp.where(hit, redraw, pivot)
        qbuf = qbuf + _compose_rows(
            pivot[:, None], jnp.where(need, tail, q_cap)[:, None], q_cap)
        tail = jnp.minimum(tail + need.astype(jnp.int32), q_cap)

        # -- pop the next (up to) P entries, FIFO ---------------------
        offs = head[:, None] + jnp.arange(P, dtype=jnp.int32)[None, :]
        pop_valid = offs < tail[:, None]
        u = jnp.take_along_axis(qbuf, jnp.minimum(offs, q_cap - 1),
                                axis=1)                       # [S, P]
        was_seen = jnp.any(
            (u[:, :, None] == seen[:, None, :])
            & (lane_x[None, None, :] < xcnt[:, None, None]), axis=2)
        dup_pop = jnp.any(
            (u[:, :, None] == u[:, None, :]) & pop_valid[:, None, :]
            & jnp.tril(jnp.ones((P, P), jnp.bool_), -1)[None], axis=2)
        expand = pop_valid & ~was_seen & ~dup_pop
        head = head + jnp.minimum(jnp.int32(P), tail - head)

        # record expansions in the seen list
        dstx = xcnt[:, None] + jnp.cumsum(expand, axis=1) - 1
        seen = seen + _compose_rows(
            u, jnp.where(expand, dstx, x_cap), x_cap)
        xcnt = xcnt + jnp.sum(expand, axis=1)

        # -- candidate edge stream (pop order x in-row order) ---------
        v, cvalid = cand_fn(u, expand, jax.random.fold_in(kr, 9))
        vf = v.reshape(S, L)
        cvalid = cvalid.reshape(S, L)
        uf = jnp.repeat(u, cand_width, axis=1)
        a = jnp.minimum(uf, vf)
        b = jnp.maximum(uf, vf)
        dup_buf = jnp.any(
            (a[:, :, None] == ebuf_a[:, None, :])
            & (b[:, :, None] == ebuf_b[:, None, :])
            & (lane_m[None, None, :] < ecnt[:, None, None]), axis=2)
        fresh = cvalid & ~dup_buf & ~_keep_first_dups(a, b, cvalid)
        before = ecnt[:, None] + jnp.cumsum(fresh, axis=1) - fresh
        keep = fresh & (before < m)
        dst_e = jnp.where(keep, before, m)
        ebuf_a = ebuf_a + _compose_rows(a, dst_e, m)
        ebuf_b = ebuf_b + _compose_rows(b, dst_e, m)
        ecnt = ecnt + jnp.sum(keep, axis=1)

        # -- queue pushes: every candidate emitted while the edge dict
        #    was still short of m (the host pushes BEFORE dict-dedup) --
        push = cvalid & (before < m)
        dst_q = tail[:, None] + jnp.cumsum(push, axis=1) - 1
        dst_q = jnp.where(push & (dst_q < q_cap), dst_q, q_cap)
        qbuf = qbuf + _compose_rows(vf, dst_q, q_cap)
        tail = jnp.minimum(tail + jnp.sum(push, axis=1), q_cap)

    mask = lane_m[None, :] < ecnt[:, None]
    return ebuf_a, ebuf_b, mask, ecnt


def _pad_bf(cfg: Config, eu, ev, mask):
    pad = cfg.max_batch_edges - eu.shape[1]
    if pad:
        eu = jnp.pad(eu, ((0, 0), (0, pad)))
        ev = jnp.pad(ev, ((0, 0), (0, pad)))
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
    return eu, ev, mask


def _sample_bf_link_batch(cfg: Config, adj, key, s_len: int):
    """[S] BFLink draws (sample.cc:210-239 / sampling.py::_bf_link):
    breadth-first training-edge collection from a random pivot,
    weight E/m. Candidate partners = the popped node's CSR row,
    truncated at the 2m gather cap — EXACT at any degree (r5 proof):
    the host walk breaks out of an expansion once the edge dict holds
    m entries, and one expansion processes at most (m - e0) fresh
    neighbors plus at most e0 dups (a dup is an existing dict entry
    involving u, each matched by exactly one distinct neighbor v), so
    <= m <= 2m row positions are ever consumed — a hub's truncated
    tail is unreachable, and queue pushes (emitted only while the dict
    is short) are bounded the same way. Pinned bit-for-bit against the
    UNBOUNDED host walk on a max_fan_out >> 2m power-law graph
    (tests/test_device_bf.py::test_bf_link_hub_graph_bitwise)."""
    r_cap = max(1, min(cfg.max_fan_out, 2 * cfg.mini_batch_size))

    def cand_fn(u, expand, _):
        uc = jnp.minimum(u, cfg.N - 1)
        deg = adj.degree(uc)                              # [S, P]
        lane = jnp.arange(r_cap, dtype=jnp.int32)
        v = adj.row_gather(uc, jnp.broadcast_to(
            lane, (*u.shape, r_cap)))
        cvalid = expand[..., None] & (lane < deg[..., None])
        return v, cvalid

    eu, ev, mask, m_eff = _bf_expand(cfg, key, s_len, cand_fn, r_cap)
    eu, ev, mask = _pad_bf(cfg, eu, ev, mask)
    weight = cfg.E / jnp.maximum(m_eff.astype(jnp.float32), 1.0)
    return eu, ev, mask, weight


def _sample_bf_non_link_batch(cfg: Config, training_set, key,
                              s_len: int):
    """[S] BFNonLink draws (sample.cc:177-208 / _bf_non_link): each
    popped node contributes up to 32 uniform non-partners (rejecting
    self and TRAINING edges only — the host BF path does not consult
    the held-out set, unlike NodeNonLink), weight (N(N-1)/2 - E)/m.
    Rejections use cfg.ds_nonlink_rounds masked redraws; residual bad
    lanes are masked (the m_eff reweight absorbs them)."""
    draws = 32                  # per-expansion budget, sampling.py:200

    def cand_fn(u, expand, kc):
        shape = (*u.shape, draws)
        v = jax.random.randint(jax.random.fold_in(kc, 0), shape,
                               0, cfg.N, jnp.int32)

        def bad(v):
            a = jnp.minimum(u[..., None], v)
            b = jnp.maximum(u[..., None], v)
            return (v == u[..., None]) | training_set.has_edges(a, b)

        for t in range(cfg.ds_nonlink_rounds):
            redraw = jax.random.randint(jax.random.fold_in(kc, t + 1),
                                        shape, 0, cfg.N, jnp.int32)
            v = jnp.where(bad(v), redraw, v)
        return v, expand[..., None] & ~bad(v)

    eu, ev, mask, m_eff = _bf_expand(cfg, key, s_len, cand_fn, draws)
    eu, ev, mask = _pad_bf(cfg, eu, ev, mask)
    total = cfg.N * (cfg.N - 1) / 2.0 - cfg.E
    weight = total / jnp.maximum(m_eff.astype(jnp.float32), 1.0)
    return eu, ev, mask, weight


def _interleave_steps(link, non, n_link: int, n_non: int, period: int):
    """Merge two per-step draw blocks so steps 0,2,4,... take the
    ``link`` rows and 1,3,5,... the ``non`` rows (``period`` draws per
    step, e.g. one per chain). Static shapes throughout."""
    def mix(a, b):
        tail_shape = a.shape[1:]
        a2 = a.reshape(n_link, period, *tail_shape)
        b2 = b.reshape(n_non, period, *tail_shape)
        out = jnp.concatenate([a2[:n_non, None], b2[:, None]],
                              axis=1).reshape(2 * n_non * period,
                                              *tail_shape)
        if n_link > n_non:     # odd step count: trailing link step
            out = jnp.concatenate(
                [out, a2[n_non:].reshape(period, *tail_shape)], axis=0)
        return out

    return tuple(mix(a, b) for a, b in zip(link, non))


def sample_minibatches_device(
    cfg: Config,
    training_set: EdgeSet,
    heldout_set: EdgeSet,
    key: jax.Array,
    s_len: int,
    adjacency=None,
    alt_period: int = 1,
) -> DeviceSamples:
    """Draw ``s_len`` minibatches (one per scan step) in one block.

    ``adjacency`` is the training graph's CSR pair (offsets [N+1],
    cols [2E]) or any object implementing the ``degree``/``row_gather``
    view (parallel/partitioned.ShardedCSR for model-row-sharded
    adjacency); defaults to the CSR edge set's own arrays.
    ``alt_period`` is the draws-per-step factor (the chain count for
    the flat multi-chain engine) used by ``node_coin='alternate'`` to
    alternate by STEP, not by flattened draw index."""
    bf_family = cfg.strategy in (SampleStrategy.BF,
                                 SampleStrategy.BF_LINK,
                                 SampleStrategy.BF_NON_LINK)
    if (cfg.strategy != SampleStrategy.NODE_NON_LINK
            and not bf_family         # BF batches hold <= m edges
            and not cfg.ds_link_cap
            and cfg.max_batch_edges < cfg.max_fan_out):
        # the host paths fail loudly on overflow (pad_batch / native
        # rc=-2); the device path must not silently truncate a pivot's
        # edge list while keeping weight N
        raise ValueError(
            f"batch edge capacity {cfg.max_batch_edges} cannot hold the "
            f"max fan-out {cfg.max_fan_out}; NodeLink batches would be "
            "silently truncated")
    if adjacency is not None and hasattr(adjacency, "row_gather"):
        adj = adjacency                 # sharded view (ShardedCSR)
    elif adjacency is not None:
        adj = _TupleAdj(*adjacency)
    elif hasattr(training_set, "row_gather"):
        adj = training_set              # ShardedCSR doubles as both
    elif training_set.backend == "csr":
        adj = _TupleAdj(*training_set.arrays)
    elif cfg.strategy in (SampleStrategy.NODE_NON_LINK,
                          SampleStrategy.BF_NON_LINK):
        adj = None                  # non-link draws never touch the CSR
    else:
        raise ValueError(
            "device sampling of link strategies with the "
            f"{training_set.backend!r} edge-set backend needs the "
            "graph's CSR adjacency passed via `adjacency`")
    k_coin, k_link, k_non = jax.random.split(key, 3)

    if cfg.strategy == SampleStrategy.NODE_LINK:
        with jax.named_scope("ds_link"):
            eu, ev, mask, weight, pivot = _sample_node_link_batch(
                cfg, adj, k_link, s_len)
    elif cfg.strategy == SampleStrategy.NODE_NON_LINK:
        with jax.named_scope("ds_nonlink"):
            eu, ev, mask, weight, pivot = _sample_node_non_link_batch(
                cfg, training_set, heldout_set, k_non, s_len)
    elif (cfg.strategy == SampleStrategy.NODE
          and cfg.node_coin == "alternate"):
        # stratified coin: steps strictly alternate link / non-link,
        # so each sampler runs at HALF volume instead of both running
        # full-volume for a select (config.py node_coin rationale)
        if s_len % alt_period:
            raise ValueError(
                f"s_len={s_len} must be a multiple of "
                f"alt_period={alt_period}")
        n_steps = s_len // alt_period
        n_link = (n_steps + 1) // 2
        n_non = n_steps // 2
        with jax.named_scope("ds_link"):
            l = _sample_node_link_batch(cfg, adj, k_link,
                                        n_link * alt_period)
        if n_non == 0:
            eu, ev, mask, weight, pivot = l
        else:
            with jax.named_scope("ds_nonlink"):
                nl = _sample_node_non_link_batch(
                    cfg, training_set, heldout_set, k_non,
                    n_non * alt_period)
            eu, ev, mask, weight, pivot = _interleave_steps(
                l, nl, n_link, n_non, alt_period)
    elif cfg.strategy == SampleStrategy.NODE:
        # per-step fair coin: compute both vectorized draws, select rows
        # (each half is cheap; data-dependent branching would force a
        # step-serial cond)
        with jax.named_scope("ds_link"):
            l = _sample_node_link_batch(cfg, adj, k_link, s_len)
        with jax.named_scope("ds_nonlink"):
            n = _sample_node_non_link_batch(
                cfg, training_set, heldout_set, k_non, s_len)
        coin = jax.random.bernoulli(k_coin, shape=(s_len,))
        eu = jnp.where(coin[:, None], l[0], n[0])
        ev = jnp.where(coin[:, None], l[1], n[1])
        mask = jnp.where(coin[:, None], l[2], n[2])
        weight = jnp.where(coin, l[3], n[3])
        pivot = jnp.where(coin, l[4], n[4])
    elif cfg.strategy == SampleStrategy.BF_LINK:
        with jax.named_scope("ds_bf_link"):
            eu, ev, mask, weight = _sample_bf_link_batch(
                cfg, adj, k_link, s_len)
        pivot = None
    elif cfg.strategy == SampleStrategy.BF_NON_LINK:
        with jax.named_scope("ds_bf_nonlink"):
            eu, ev, mask, weight = _sample_bf_non_link_batch(
                cfg, training_set, k_non, s_len)
        pivot = None
    elif cfg.strategy == SampleStrategy.BF and cfg.node_coin == "alternate":
        if s_len % alt_period:
            raise ValueError(
                f"s_len={s_len} must be a multiple of "
                f"alt_period={alt_period}")
        n_steps = s_len // alt_period
        n_link = (n_steps + 1) // 2
        n_non = n_steps // 2
        with jax.named_scope("ds_bf_link"):
            l = _sample_bf_link_batch(cfg, adj, k_link,
                                      n_link * alt_period)
        if n_non == 0:
            eu, ev, mask, weight = l
        else:
            with jax.named_scope("ds_bf_nonlink"):
                nl = _sample_bf_non_link_batch(
                    cfg, training_set, k_non, n_non * alt_period)
            eu, ev, mask, weight = _interleave_steps(
                l, nl, n_link, n_non, alt_period)
        pivot = None
    elif cfg.strategy == SampleStrategy.BF:
        # fair coin per step (sample.cc:241-248): both draws, select
        with jax.named_scope("ds_bf_link"):
            l = _sample_bf_link_batch(cfg, adj, k_link, s_len)
        with jax.named_scope("ds_bf_nonlink"):
            n = _sample_bf_non_link_batch(cfg, training_set, k_non,
                                          s_len)
        coin = jax.random.bernoulli(k_coin, shape=(s_len,))
        eu = jnp.where(coin[:, None], l[0], n[0])
        ev = jnp.where(coin[:, None], l[1], n[1])
        mask = jnp.where(coin[:, None], l[2], n[2])
        weight = jnp.where(coin, l[3], n[3])
        pivot = None
    else:
        raise ValueError(f"unknown device sampling strategy "
                         f"{cfg.strategy}")

    with jax.named_scope("ds_extract_nodes"):
        if pivot is None:
            # BF batches span many expanded nodes (no shared pivot);
            # use the strategy-agnostic sort dedup
            nodes, node_mask = _extract_nodes(cfg, eu, ev, mask)
        else:
            nodes, node_mask = _structural_nodes(cfg, eu, ev, mask,
                                                 pivot)
    return DeviceSamples(eu, ev, mask, nodes, node_mask, weight)


def sample_minibatch_device(cfg, training_set, heldout_set, key,
                            adjacency=None):
    """Single-step convenience wrapper (S = 1)."""
    s = sample_minibatches_device(cfg, training_set, heldout_set, key, 1,
                                  adjacency)
    return DeviceSamples(*(x[0] for x in s))
