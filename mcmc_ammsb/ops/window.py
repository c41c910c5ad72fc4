"""T-step windowed fused training loop.

Each scan iteration advances T steps:

  1. ONE bulk gather of all T steps' pi rows ([T*(B+n)] indices);
  2. the T sequential phi/beta updates on the gathered rows, staged in
     a [T*B, K] buffer;
  3. ONE scatter of the T*B staged rows (last-write-wins masked).

Steps 1 and 3 replace T per-step random-row gathers and scatters of
the [N, K] array with one each, which is what the sequential scan
spends its per-step time on at reference minibatch shapes.

Exactness: step t+1 may read a row an earlier step wrote. Each such
intra-window read is redirected to the staged row by an exact one-hot
select (``_correction_codes`` names the slot; the coefficients are 0
or 1 and the contraction runs at full fp32 precision). CRITICALLY, pi
itself is only READ inside the optional cond
(``window_correction='auto'``) — the scatter runs unconditionally
outside it: XLA cannot alias a donated buffer through a two-branch
conditional, so a scatter inside the branches would copy the whole
[N, K] array every dirty window. Trajectories are exactly the
sequential scan's modulo float-op scheduling (golden-tested against
the sequential scan on collision-heavy graphs).

Reference behavior reproduced: the same per-step numerics as
/root/reference/mcmc/phi.cc:84-173 and beta.cc:30-137 (via the same
formulas as ops/phi.py / ops/beta.py); the fusion itself is the
reference's own move (phi.cc:305-412 fuses its pipeline stages into
one kernel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmc_ammsb.config import Config
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import phi as phi_ops


# ---------------------------------------------------------------------------
# Window orchestration
# ---------------------------------------------------------------------------

def windowed_scan(cfg: Config, state, xs, body,
                  gather_fn=None, scatter_fn=None):
    """Scan T-step windows over the hoisted per-step operands; any
    non-multiple tail runs through the sequential ``body``.

    ``xs`` is train_steps_scan's operand tuple:
    (batches, neighbors [S,1,n], y_phi, phi_noise, beta_noise,
     y_edges, lanes_u, lanes_v).

    ``gather_fn(cfg, s, batch, nbrs) -> (g [T,B+n,K], sums [T,B])`` and
    ``scatter_fn(cfg, s, batch, keep, rows_flat, sums_flat) ->
    (pi, phi_sum)`` override the window's bulk pi read/write — the
    single-device defaults index ``s.pi`` directly; the row-sharded
    multi-chip engine (parallel/sharded.py) substitutes its psum row
    fetch and the per-shard local write application, turning its
    per-step collectives into one collective per T-step window."""
    t_win = cfg.window
    s_len = xs[1].shape[0]
    n_win = s_len // t_win
    tail = s_len - n_win * t_win
    if n_win == 0:
        state, _ = jax.lax.scan(body, state, xs, unroll=cfg.scan_unroll)
        return state

    xs_w = jax.tree.map(
        lambda a: a[: n_win * t_win].reshape(n_win, t_win, *a.shape[1:]),
        xs)
    batches_w = xs_w[0]

    if cfg.window_correction == "always":
        dirty = jnp.zeros((n_win,), bool)     # every window corrects
    else:
        with jax.named_scope("window_dirty"):
            dirty = _dirty_windows(batches_w.nodes,
                                   batches_w.node_mask,
                                   xs_w[1][:, :, 0, :], t_win)

    if gather_fn is None:
        gather_fn = _window_gather
    if scatter_fn is None:
        scatter_fn = _window_scatter

    def wbody(s, xw):
        xs_t, dirty_w = xw
        batch = xs_t[0]
        nbrs = xs_t[1][:, 0, :]                             # [T, n]
        with jax.named_scope("window_gather"):
            g, sums_g = gather_fn(cfg, s, batch, nbrs)

        def corrected(op):
            gg, ss = op
            with jax.named_scope("window_correct"):
                mcode = _correction_codes(cfg, batch.nodes,
                                          batch.node_mask, nbrs)
            return _window_core(cfg, s, xs_t, gg, ss, mcode)

        def plain(op):
            gg, ss = op
            return _window_core(cfg, s, xs_t, gg, ss, None)

        if cfg.window_correction == "always":
            # single branch: every window pays the (exact, cheap)
            # one-hot correction; no cond in the program at all
            rows_flat, sums_flat, theta, beta = corrected((g, sums_g))
        else:
            # pi is only READ inside the cond; the scatter runs
            # OUTSIDE it so the donated [N, K] buffer keeps its
            # in-place update (a scatter under a two-branch
            # conditional forces a full copy)
            rows_flat, sums_flat, theta, beta = jax.lax.cond(
                dirty_w, corrected, plain, (g, sums_g))
        with jax.named_scope("window_scatter"):
            keep = _last_write_wins(batch.nodes, batch.node_mask, t_win)
            pi, phi_sum = scatter_fn(cfg, s, batch, keep,
                                     rows_flat, sums_flat)
        s = s._replace(pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
                       step_count=s.step_count + t_win,
                       beta_count=s.beta_count + t_win)
        return s, None

    state, _ = jax.lax.scan(wbody, state, (xs_w, dirty))
    if tail:
        xs_tail = jax.tree.map(lambda a: a[n_win * t_win:], xs)
        state, _ = jax.lax.scan(body, state, xs_tail,
                                unroll=cfg.scan_unroll)
    return state


def _dirty_windows(nodes, mask, nbrs, t_win):
    """[W] bool: window has an intra-window read-after-write (a later
    step reads a row an earlier step wrote) or write-after-write.
    Shapes: nodes/mask [W,T,B], nbrs [W,T,n]."""
    writes = jnp.where(mask, nodes, -2)                    # [W,T,B]
    reads = jnp.concatenate(
        [jnp.where(mask, nodes, -1), nbrs], axis=2)        # [W,T,R]
    # masked write lanes are non-writes: they must never match each
    # other (every padded lane carries the same sentinel) nor a read
    wvalid = mask[:, :, :, None, None] & mask[:, None, None, :, :]
    t_r = jnp.arange(t_win)
    later_reads = (t_r[None, :, None, None, None]
                   > t_r[None, None, None, :, None])       # read t > write t'
    rw = (reads[:, :, :, None, None] == writes[:, None, None, :, :]
          ) & later_reads & mask[:, None, None, :, :]
    distinct = (t_r[None, :, None, None, None]
                != t_r[None, None, None, :, None])
    ww = (writes[:, :, :, None, None] == writes[:, None, None, :, :]
          ) & distinct & wvalid
    return rw.any(axis=(1, 2, 3, 4)) | ww.any(axis=(1, 2, 3, 4))


def _last_write_wins(nodes, mask, t_win):
    """[T, B] bool: valid writes NOT superseded by a later step's write
    of the same row — the bulk scatter must apply exactly the last
    write (duplicate scatter indices apply in unspecified order)."""
    wf = jnp.where(mask, nodes, -2)                        # [T, B]
    eqw = wf[:, :, None, None] == wf[None, None, :, :]     # [T,B,T,B]
    t_r = jnp.arange(t_win)
    later = (t_r[None, None, :, None] > t_r[:, None, None, None])
    superseded = (eqw & later & mask[None, None, :, :]).any(axis=(2, 3))
    return mask & ~superseded


def _correction_codes(cfg: Config, nodes, mask, nbrs):
    """[T, B+n, 1] int32: 1 + the staged-buffer slot of the LATEST
    earlier write of the row read lane (t, i) references, 0 when the
    pre-window gather is already current."""
    t_win, b_cap = nodes.shape
    lin = jnp.arange(t_win * b_cap, dtype=jnp.int32)
    writes_flat = jnp.where(mask, nodes, -2).reshape(-1)   # [T*B]
    reads = jnp.concatenate([nodes, nbrs], axis=1)         # [T, B+n]
    eq = reads[:, :, None] == writes_flat[None, None, :]   # [T,B+n,T*B]
    earlier = ((lin[None, None, :] // b_cap)
               < jnp.arange(t_win)[:, None, None])
    sel = eq & earlier
    mcode = jnp.max(jnp.where(sel, lin[None, None, :] + 1, 0), axis=-1)
    return mcode[:, :, None]


def _window_gather(cfg, s, batch, nbrs):
    b_cap, k = cfg.max_batch_nodes, cfg.K
    t_win = batch.nodes.shape[0]
    read_idx = jnp.concatenate([batch.nodes, nbrs], axis=1)  # [T, B+n]
    g = s.pi[read_idx.reshape(-1)].astype(jnp.float32).reshape(
        t_win, read_idx.shape[1], k)
    sums_g = s.phi_sum[batch.nodes.reshape(-1)].reshape(t_win, b_cap)
    return g, sums_g


def _window_scatter(cfg, s, batch, keep, rows_flat, sums_flat):
    """Single-device bulk write-back of the window's staged rows (the
    last-write-wins mask ``keep`` already excludes superseded writes)."""
    flat_nodes = batch.nodes.reshape(-1)
    safe = jnp.where(keep.reshape(-1), flat_nodes, cfg.N)
    pi = s.pi.at[safe].set(rows_flat.astype(s.pi.dtype), mode="drop")
    phi_sum = s.phi_sum.at[safe].set(sums_flat, mode="drop")
    return pi, phi_sum


# ---------------------------------------------------------------------------
# Window core
# ---------------------------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST


def window_steps(cfg: Config, theta, beta, step_count, beta_count,
                 g, sums_g, mcode, nodes, node_mask, edge_mask, weight,
                 nbrs, y_w, nphi_w, nbeta_w, ye_w, lu, lv):
    """T sequential SGRLD steps of ONE chain on bulk-gathered rows.

    Shapes (T = window): g [T, B+n, K] (node rows then the shared
    neighbor rows), sums_g [T, B], mcode [T, B+n, 1] int32 staged-slot
    codes or None (no intra-window collisions), nodes/node_mask [T, B],
    edge_mask/ye_w/lu/lv [T, E], weight [T], nbrs [T, n], y_w [T, B, n],
    nphi_w [T, B, K], nbeta_w [T, K, 2], theta [K, 2], beta [K].
    Returns (rows_buf [T*B, K], sums_buf [T*B], theta, beta); the
    chain engine vmaps this over its chain axis.

    Row selects (staged-row corrections, edge endpoint rows) are one-hot
    contractions at ``Precision.HIGHEST``: every coefficient is exactly
    0 or 1, so the f32 products and sums reproduce the selected values
    bit for bit (a TF32 contraction would round them)."""
    t_win, b_cap = nodes.shape
    k = g.shape[-1]
    lane_eye = jnp.arange(b_cap, dtype=jnp.int32)
    oh_u = (lu[..., None] == lane_eye).astype(jnp.float32)   # [T, E, B]
    oh_v = (lv[..., None] == lane_eye).astype(jnp.float32)
    lin = jnp.arange(t_win * b_cap, dtype=jnp.int32)
    rows_buf = jnp.zeros((t_win * b_cap, k), jnp.float32)
    sums_buf = jnp.zeros((t_win * b_cap,), jnp.float32)
    with jax.named_scope("window_body"):
        for t in range(t_win):
            g_t, phis = g[t], sums_g[t]
            if mcode is not None:
                m_t = (mcode[t] == lin[None, :] + 1).astype(jnp.float32)
                rs = (mcode[t] > 0).astype(jnp.float32)     # [B+n, 1]
                g_t = (jnp.dot(m_t, rows_buf, precision=_HI,
                               preferred_element_type=jnp.float32)
                       + (1.0 - rs) * g_t)
                phis = (jnp.dot(m_t[:b_cap], sums_buf, precision=_HI,
                                preferred_element_type=jnp.float32)
                        + (1.0 - rs[:b_cap, 0]) * phis)
            nbr_mask = nbrs[t][None, :] != nodes[t][:, None]
            rows, sums = phi_ops.phi_update_core(
                cfg, g_t[:b_cap], phis, g_t[b_cap:][None], y_w[t], beta,
                step_count + t, nphi_w[t], nbr_mask)
            rows_buf = jax.lax.dynamic_update_slice(
                rows_buf, rows, (t * b_cap, 0))
            sums_buf = jax.lax.dynamic_update_slice(
                sums_buf, sums, (t * b_cap,))
            # masked lanes hold staging garbage; NaN*0 != 0, so
            # sanitize before the endpoint contractions
            rows_safe = jnp.where(node_mask[t][:, None], rows, 1.0 / k)
            pi_u = jnp.dot(oh_u[t], rows_safe, precision=_HI,
                           preferred_element_type=jnp.float32)
            pi_v = jnp.dot(oh_v[t], rows_safe, precision=_HI,
                           preferred_element_type=jnp.float32)
            grads = beta_ops.beta_gradients_core(
                cfg, theta, beta, pi_u, pi_v, ye_w[t], edge_mask[t])
            theta, beta = beta_ops.theta_step(
                cfg, theta, grads, weight[t], beta_count + 1 + t,
                nbeta_w[t])
    return rows_buf, sums_buf, theta, beta


def _window_core(cfg: Config, s, xs_t, g, sums_g, mcode):
    """Single-chain window core on train_steps_scan's operand tuple.
    Returns (rows_flat, sums_flat, theta, beta)."""
    batch, nbrs_s, y_w, nphi_w, nbeta_w, ye_w, lu, lv = xs_t
    return window_steps(
        cfg, s.theta, s.beta, s.step_count, s.beta_count, g, sums_g,
        mcode, batch.nodes, batch.node_mask, batch.edge_mask,
        batch.weight, nbrs_s[:, 0, :], y_w, nphi_w, nbeta_w, ye_w, lu,
        lv)
