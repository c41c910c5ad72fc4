"""Pure-numpy oracle of the reference update math, written straight from
the formulas in /root/reference/mcmc/phi.cc:84-122, beta.cc:86-137 and
perplexity.cc:16-65. Used to validate the JAX ops (the role the
cross-mode golden tests play in the reference, wg-phi-test.cc etc.).
``bf_oracle`` replays the device breadth-first sampler in plain python,
reading the same jax.random draws the device consumes."""

import jax
import jax.numpy as jnp
import numpy as np


def eps_t(a, b, c, t):
    return a * (1.0 + t / b) ** (-c)


def phi_oracle(cfg, pi, phi_sum, beta, edge_oracle, nodes, neighbors,
               step_count, noise):
    """Staged phi update for the given nodes. Returns (pi_rows, sums)."""
    n_n = neighbors.shape[1]
    out_rows = np.zeros((len(nodes), pi.shape[1]), np.float64)
    out_sums = np.zeros(len(nodes), np.float64)
    et = eps_t(cfg.a, cfg.b, cfg.c, step_count)
    for i, node in enumerate(nodes):
        pi_a = pi[node].astype(np.float64)
        ps = float(phi_sum[node])
        grads = np.zeros(pi.shape[1], np.float64)
        for j in range(n_n):
            nbr = neighbors[i, j]
            y = edge_oracle(min(node, nbr), max(node, nbr))
            e = cfg.epsilon if y else 1.0 - cfg.epsilon
            f = (beta - cfg.epsilon) if y else (cfg.epsilon - beta)
            probs = pi_a * (pi[nbr] * f + e)
            grads += (probs / probs.sum()) / (pi_a * ps) - 1.0 / ps
        phi_a = pi_a * ps
        scale_n = cfg.N / n_n
        phi_new = np.abs(
            phi_a + et / 2.0 * (cfg.alpha_value - phi_a + scale_n * grads)
            + np.sqrt(et * phi_a) * noise[i]
        )
        phi_new = np.maximum(phi_new, 1e-24)
        out_sums[i] = phi_new.sum()
        out_rows[i] = phi_new / out_sums[i]
    return out_rows, out_sums


def beta_grads_oracle(cfg, theta, beta, pi, edge_oracle, eu, ev):
    """Gradient fan-in over minibatch edges. Returns [K, 2]."""
    k = theta.shape[0]
    grads = np.zeros((k, 2), np.float64)
    theta_sum = theta[:, 0] + theta[:, 1]
    for u, v in zip(eu, ev):
        y = 1 if edge_oracle(min(u, v), max(u, v)) else 0
        pp = pi[u].astype(np.float64) * pi[v].astype(np.float64)
        pi_sum = pp.sum()
        probs = (beta if y else 1.0 - beta) * pp
        prob_0 = (cfg.epsilon if y else 1.0 - cfg.epsilon) * (1.0 - pi_sum)
        f = probs / (probs.sum() + prob_0)
        grads[:, 0] += f * ((1 - y) / theta[:, 0] - 1.0 / theta_sum)
        grads[:, 1] += f * (y / theta[:, 1] - 1.0 / theta_sum)
    return grads


def theta_step_oracle(cfg, theta, grads, scale, count_calls, noise):
    et = eps_t(cfg.a, cfg.b, cfg.c, count_calls)
    eta = np.array([cfg.eta0, cfg.eta1])
    theta_new = np.abs(
        theta + et / 2.0 * (eta - theta + scale * grads)
        + np.sqrt(et * theta) * noise
    )
    theta_new = np.maximum(theta_new, 1e-24)
    beta_new = theta_new[:, 1] / (theta_new[:, 0] + theta_new[:, 1])
    return theta_new, beta_new


def perplexity_oracle(cfg, pi, beta, edge_oracle, eu, ev, ppx_per_edge,
                      avg_count):
    lik = np.zeros(len(eu), np.float64)
    y_arr = np.zeros(len(eu), bool)
    for i, (u, v) in enumerate(zip(eu, ev)):
        y = edge_oracle(min(u, v), max(u, v))
        pp = pi[u].astype(np.float64) * pi[v].astype(np.float64)
        if y:
            s = (pp * beta).sum()
        else:
            s = (pp * (1.0 - beta)).sum() + (1.0 - pp.sum()) * (1.0 - cfg.epsilon)
        lik[i] = max(s, 1e-30)
        y_arr[i] = y
    ppx_new = (ppx_per_edge * (avg_count - 1) + lik) / avg_count
    lg = np.log(ppx_new)
    neg_avg = -lg.mean()
    return ppx_new, neg_avg, y_arr


def mmsb_phi_oracle(cfg, pi, phi_sum, b, edge_oracle, nodes, neighbors,
                    step_count, noise):
    """Full-MMSB staged phi update (models/mmsb.py derivation):
    g = F pi_b with F = B (link) or 1-B (non-link)."""
    n_nb = neighbors.shape[1]
    rows = np.zeros((len(nodes), pi.shape[1]), np.float64)
    sums = np.zeros(len(nodes), np.float64)
    et = eps_t(cfg.a, cfg.b, cfg.c, step_count)
    for i, a_node in enumerate(nodes):
        pa = pi[a_node].astype(np.float64)
        fa = float(phi_sum[a_node])
        grads = np.zeros(pi.shape[1], np.float64)
        for j in range(n_nb):
            nb = neighbors[i, j]
            y = edge_oracle(min(a_node, nb), max(a_node, nb))
            f = b if y else 1.0 - b
            g = f @ pi[nb].astype(np.float64)
            probs = pa * g
            grads += probs / probs.sum() / (pa * fa) - 1.0 / fa
        phi_a = pa * fa
        upd = np.abs(phi_a + et / 2 * (cfg.alpha_value - phi_a
                                       + cfg.N / n_nb * grads)
                     + np.sqrt(et * phi_a) * noise[i])
        upd = np.maximum(upd, 1e-24)
        sums[i] = upd.sum()
        rows[i] = upd / upd.sum()
    return rows, sums


def mmsb_theta_grads_oracle(cfg, theta_b, b, pi, edge_oracle, eu, ev):
    """Full-MMSB responsibility fan-in, symmetrized for undirected
    graphs (models/mmsb.py)."""
    k = theta_b.shape[0]
    want = np.zeros((k, k, 2))
    ts = theta_b.sum(-1).astype(np.float64)
    for a_node, v_node in zip(eu, ev):
        y = edge_oracle(min(a_node, v_node), max(a_node, v_node))
        f = b if y else 1.0 - b
        outer = np.outer(pi[a_node], pi[v_node]).astype(np.float64)
        num = outer * f
        r = num / num.sum()
        want[..., 0] += r * ((0.0 if y else 1.0) / theta_b[..., 0]
                             - 1 / ts)
        want[..., 1] += r * ((1.0 if y else 0.0) / theta_b[..., 1]
                             - 1 / ts)
    return 0.5 * (want + want.transpose(1, 0, 2))


# ---------------------------------------------------------------------
# device breadth-first sampler: python replay on the same jax.random draws
# ---------------------------------------------------------------------

def bf_oracle(cfg, graph, training_keys, key, s_len, kind):
    """Sequential replay of ops/device_sampling._bf_expand's semantics
    on the same jax.random draws. Returns per-step ordered edge
    lists."""
    P, R, m = cfg.ds_bf_pops, cfg.ds_bf_rounds, cfg.mini_batch_size
    q_cap = 1 + (R - 1) * P
    if kind == "link":
        C = max(1, min(cfg.max_fan_out, 2 * cfg.mini_batch_size))
    else:
        C = 32

    # pre-evaluate every RNG draw the device makes, in its key order
    piv, draws = {}, {}
    for r in range(R):
        kr = jax.random.fold_in(key, r)
        for t in range(3):
            piv[(r, t)] = np.asarray(jax.random.randint(
                jax.random.fold_in(kr, t), (s_len,), 0, cfg.N, jnp.int32))
        if kind == "non":
            kc = jax.random.fold_in(kr, 9)
            for t in range(cfg.ds_nonlink_rounds + 1):
                draws[(r, t)] = np.asarray(jax.random.randint(
                    jax.random.fold_in(kc, t), (s_len, P, C), 0, cfg.N,
                    jnp.int32))

    out = []
    for s in range(s_len):
        q, head, seen, edges, eset = [], 0, set(), [], set()
        for r in range(R):
            tail = len(q)
            if tail == head and len(edges) < m:
                p = int(piv[(r, 0)][s])
                for t in range(2):
                    if p in seen:
                        p = int(piv[(r, t + 1)][s])
                if tail < q_cap:
                    q.append(p)
                    tail += 1
            pops = q[head:head + P]
            head += len(pops)
            ecnt0 = len(edges)
            fresh_so_far = 0
            level_valid = set()
            expanded_now = set()
            for i, u in enumerate(pops):
                if u in seen or u in expanded_now:
                    continue
                expanded_now.add(u)
                if kind == "link":
                    cands = [(int(v), True)
                             for v in graph.neighbors_of(u)[:C]]
                else:
                    cands = []
                    for c in range(C):
                        v = int(draws[(r, 0)][s, i, c])
                        for t in range(cfg.ds_nonlink_rounds):
                            bad = (v == u
                                   or (min(u, v), max(u, v))
                                   in training_keys)
                            if bad:
                                v = int(draws[(r, t + 1)][s, i, c])
                        bad = (v == u
                               or (min(u, v), max(u, v)) in training_keys)
                        cands.append((v, not bad))
                for v, ok in cands:
                    if not ok:
                        continue
                    ab = (min(u, v), max(u, v))
                    fresh = ab not in eset and ab not in level_valid
                    before = ecnt0 + fresh_so_far
                    if fresh:
                        fresh_so_far += 1
                        if before < m:
                            edges.append(ab)
                            eset.add(ab)
                    if before < m and len(q) < q_cap:
                        q.append(v)
                    level_valid.add(ab)
            seen |= expanded_now
        out.append(edges)
    return out


def device_edges(ds, step):
    """Ordered valid (u, v) edges of step ``step`` of a device batch."""
    mask = np.asarray(ds.edge_mask)[step]
    eu = np.asarray(ds.edges_u)[step][mask]
    ev = np.asarray(ds.edges_v)[step][mask]
    return list(zip(eu.tolist(), ev.tolist()))
