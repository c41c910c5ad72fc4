"""Device edge-membership: ``has_edges(u, v) -> bool[...]``, batched.

The reference keeps an O(E) static cuckoo hash set with an O(1) 2-probe
device lookup reading 8 random uint64 slots per query
(/root/reference/mcmc/cuckoo.cc:28-69). The backends here: a padded
adjacency-row matrix (one row gather per query group), a **CHD perfect
hash** (2 dependent gathers per query; see the perfect-backend section
below), a vectorized CSR-row binary search (log2(max_degree) gather
rounds, branch-free), a globally-sorted-edge-array backend, and a
faithful cuckoo-layout backend behind the same API for comparison
(SURVEY.md §2 #6-7, §7.3).

All backends are pytrees of device arrays; ``has_edges`` is jit-/vmap-
compatible and shape-polymorphic in the query batch. Everything is 32-bit
(JAX runs without 64-bit types by default), so the cuckoo hash of the
packed 64-bit key is evaluated with 32-bit modular arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import EdgeSetBackend
from mcmc_ammsb.data import Graph

# First prime pair of /root/reference/mcmc/cuckoo.cc:92-96.
_CUCKOO_P1 = 15485807
_CUCKOO_P2 = 920429591
_EMPTY64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# Perfect-hash (CHD) mixing constants. The bucket hash and the slot hash
# use INDEPENDENT linear bases: at E ~ 1M keys, any scheme deriving both
# hashes from one shared 32-bit intermediate suffers ~E^2/2^33 birthday
# collisions of that intermediate, which collide BOTH hashes and make
# construction fail for every seed (measured: 133 such pairs on the
# com-DBLP-scale benchmark graph).
_PH_C1 = np.uint32(0x9E3779B1)
_PH_C2 = np.uint32(0x85EBCA77)
_PH_C3 = np.uint32(0x2545F491)
_PH_C4 = np.uint32(0xC2B2AE35)
_PH_C5 = np.uint32(0x27D4EB2F)


def _fmix32(x):
    """32-bit avalanche mixer (xor-shift-multiply finalizer); works on
    numpy and jax uint32 arrays alike."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """Static edge set with batched membership lookup.

    backend 'csr':    arrays = (offsets [N+1] i32, cols [M] i32 row-sorted)
    backend 'sorted': arrays = (keys_u [E] i32, keys_v [E] i32), sorted
                      lexicographically on canonical (u < v) pairs
    backend 'cuckoo': arrays = (slots_u [2, bins, 4] i32,
                      slots_v [2, bins, 4] i32) — the reference bucket
                      layout split into 32-bit endpoint planes; empty
                      slots hold (-1, -1). meta['num_bins'] is static.
    backend 'perfect': arrays = (displacements [NB] i32, table [M, 2]
                      i32 canonical key pairs, empty = (-1, -1));
                      meta carries slot_mask/bucket_mask/seed.
    """

    backend: str
    num_nodes: int
    num_search_steps: int
    meta: Tuple[Tuple[str, int], ...]
    arrays: Tuple[jnp.ndarray, ...]

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return self.arrays, (self.backend, self.num_nodes,
                             self.num_search_steps, self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        backend, num_nodes, steps, meta = aux
        return cls(backend, num_nodes, steps, meta, tuple(children))

    # -- lookup ------------------------------------------------------------
    def has_edges(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """Batched membership test; u, v int32 arrays of equal shape.

        Queries need not be canonicalized (handled internally, matching
        the MakeEdge(min,max) canonicalization at each reference call
        site, e.g. /root/reference/mcmc/phi.cc:96).
        """
        u = jnp.asarray(u, jnp.int32)
        v = jnp.asarray(v, jnp.int32)
        if self.backend == "adjacency":
            # gathers rows for the SMALLER query side pre-broadcast —
            # must not broadcast first
            return _adjacency_has_edges(self, u, v)
        u, v = jnp.broadcast_arrays(u, v)
        if self.backend == "csr":
            return _csr_has_edges(self, u, v)
        if self.backend == "sorted":
            return _sorted_has_edges(self, u, v)
        if self.backend == "cuckoo":
            return _cuckoo_has_edges(self, u, v)
        if self.backend == "perfect":
            return _perfect_has_edges(self, u, v)
        raise ValueError(self.backend)


def _lower_bound(num_steps, lo, hi, less_fn):
    """Vectorized lower bound: smallest i in [lo, hi) with !less(i).

    Fixed-trip-count binary search (range halves per step; ``num_steps``
    covers the largest range), branch-free per lane.
    """

    def body(_, carry):
        lo, hi = carry
        active = lo < hi
        mid = (lo + hi) >> 1
        less = less_fn(mid)
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & ~less, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, num_steps, body, (lo, hi))
    return lo


# ---------------------------------------------------------------------------
# CSR backend: binary search v within the sorted adjacency row of u.
# Adjacency is symmetric, so no canonicalization is needed.
# ---------------------------------------------------------------------------

def _csr_has_edges(s: EdgeSet, u, v):
    offsets, cols = s.arrays
    m = cols.shape[0]
    lo0 = offsets[u]
    hi0 = offsets[u + 1]

    def less(mid):
        return cols[jnp.clip(mid, 0, m - 1)] < v

    pos = _lower_bound(s.num_search_steps, lo0, hi0, less)
    return (pos < hi0) & (cols[jnp.clip(pos, 0, m - 1)] == v)


# ---------------------------------------------------------------------------
# Sorted backend: lexicographic lower bound over canonical (u, v) pairs.
# ---------------------------------------------------------------------------

def _sorted_has_edges(s: EdgeSet, u, v):
    keys_u, keys_v = s.arrays
    cu = jnp.minimum(u, v)
    cv = jnp.maximum(u, v)
    n = keys_u.shape[0]
    lo0 = jnp.zeros(cu.shape, jnp.int32)
    hi0 = jnp.full(cu.shape, n, jnp.int32)

    def less(mid):
        m = jnp.clip(mid, 0, n - 1)
        mu = keys_u[m]
        mv = keys_v[m]
        return (mu < cu) | ((mu == cu) & (mv < cv))

    pos = _lower_bound(s.num_search_steps, lo0, hi0, less)
    m = jnp.clip(pos, 0, n - 1)
    return (pos < n) & (keys_u[m] == cu) & (keys_v[m] == cv)


# ---------------------------------------------------------------------------
# Adjacency-matrix backend: padded symmetric adjacency rows [N, F].
#
# Membership of (u, v) = "v appears in u's adjacency row". The row
# gather of the (smaller) query side is the same op class as the pi row
# fetches and the compare+reduce over F is elementwise work that XLA
# fuses — so the [S, B, 1] x [S, B, n] neighbor-membership block costs
# ONE row gather per minibatch NODE instead of one 2-dependent-gather
# hash probe per (node, neighbor) PAIR.
# Memory is N * max_degree * 4 bytes, so build_edge_set(AUTO) picks this
# backend only when that fits the budget.
# ---------------------------------------------------------------------------

def _adjacency_has_edges(s: EdgeSet, u, v):
    (matrix,) = s.arrays
    if v.size < u.size:
        u, v = v, u                       # adjacency is symmetric
    rows = matrix[u]                      # [*u.shape, F]
    return jnp.any(rows == v[..., None], axis=-1)


def _build_adjacency_matrix(num_nodes: int, u: np.ndarray,
                            v: np.ndarray) -> np.ndarray:
    """Padded [N, F] adjacency matrix; pad value -1 (matches no vertex,
    including the N sentinel used for padded query lanes)."""
    g = Graph.from_edges(num_nodes, u, v)
    deg = g.offsets[1:] - g.offsets[:-1]
    f = max(1, int(deg.max()) if len(deg) else 1)
    matrix = np.full((num_nodes, f), -1, np.int32)
    row = np.repeat(np.arange(num_nodes), deg)
    pos = np.arange(len(g.cols)) - np.repeat(g.offsets[:-1], deg)
    matrix[row, pos] = g.cols
    return matrix


# Default memory budget for the AUTO backend's adjacency matrix.
ADJACENCY_AUTO_BUDGET_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Cuckoo backend: reference bucket layout, 2 hashes x 4 slots.
#   hash1 = (P1 * key) % bins, hash2 = (key ^ P2) % bins on the packed
#   64-bit key (mcmc/cuckoo.cc:39-43), decomposed into 32-bit modular
#   arithmetic: key = u * 2^32 + v, so
#   hash1 = (mulmod(P1 % m, u) * (2^32 % m) + mulmod(P1 % m, v)) % m
#   hash2 = (u * (2^32 % m) + (v ^ P2)) % m.
# ---------------------------------------------------------------------------

def _mulmod_u32(a, b, m: int):
    """(a * b) % m with uint32 lanes, m < 2^31 (shift-add "peasant" mulmod).

    a is reduced below m on entry, so a + a and acc + a never overflow.
    """
    a = a % np.uint32(m)
    acc = jnp.zeros_like(a)

    def body(_, carry):
        acc, a, b = carry
        take = (b & np.uint32(1)).astype(jnp.bool_)
        acc = jnp.where(take, (acc + a) % np.uint32(m), acc)
        a = (a + a) % np.uint32(m)
        b = b >> np.uint32(1)
        return acc, a, b

    acc, _, _ = jax.lax.fori_loop(0, 32, body, (acc, a, b))
    return acc


def _mul32x32(a, b):
    """Full 32x32 -> 64-bit product as a (hi, lo) uint32 pair,
    via 16-bit limbs (no 64-bit integer types under JAX's defaults)."""
    mask = np.uint32(0xFFFF)
    a_lo, a_hi = a & mask, a >> np.uint32(16)
    b_lo, b_hi = b & mask, b >> np.uint32(16)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> np.uint32(16)) + (lh & mask) + (hl & mask)
    lo = (ll & mask) | (mid << np.uint32(16))
    hi = hh + (lh >> np.uint32(16)) + (hl >> np.uint32(16)) + (mid >> np.uint32(16))
    return hi, lo


def _cuckoo_has_edges(s: EdgeSet, u, v):
    slots_u, slots_v = s.arrays
    meta = dict(s.meta)
    num_bins = meta["num_bins"]
    cu = jnp.minimum(u, v).astype(jnp.uint32)
    cv = jnp.maximum(u, v).astype(jnp.uint32)

    pow32 = (1 << 32) % num_bins
    pow32_arr = jnp.full(cu.shape, pow32, jnp.uint32)
    p1_arr = jnp.full(cu.shape, _CUCKOO_P1, jnp.uint32)
    # hash1 = ((P1 * key) mod 2^64) % bins, key = u*2^32 + v. The 2^64
    # wrap is C uint64 semantics (mcmc/cuckoo.cc:39-40):
    #   P1*key mod 2^64 = (hi(P1*v) + lo(P1*u)) * 2^32 + lo(P1*v)
    h_v, l_v = _mul32x32(p1_arr, cv)
    _, l_u = _mul32x32(p1_arr, cu)
    prod_hi = h_v + l_u                               # wraps mod 2^32
    t1 = _mulmod_u32(prod_hi, pow32_arr, num_bins)    # hi*2^32 mod m
    h1 = (t1 + l_v % np.uint32(num_bins)) % np.uint32(num_bins)
    # hash2 = (u * 2^32 + (v ^ P2)) % bins (xor touches the low word only)
    h2 = (_mulmod_u32(cu, pow32_arr, num_bins)
          + (cv ^ np.uint32(_CUCKOO_P2)) % np.uint32(num_bins)) % np.uint32(num_bins)

    cu32 = cu.astype(jnp.int32)
    cv32 = cv.astype(jnp.int32)

    def probe(bucket, h):
        su = slots_u[bucket, h.astype(jnp.int32)]  # [*, 4]
        sv = slots_v[bucket, h.astype(jnp.int32)]
        return jnp.any((su == cu32[..., None]) & (sv == cv32[..., None]), axis=-1)

    return probe(0, h1) | probe(1, h2)


# ---------------------------------------------------------------------------
# Perfect-hash backend (CHD / "hash, displace" — Belazzougui, Botelho,
# Dietzfelbinger 2009): a static two-level scheme built once on the host.
#   bucket  = fmix32(u*C1 + v*C2 + seed)        & (n_buckets - 1)
#   slot    = (fmix32(u*C4 + v*C5 + seed^C3) + displacement[bucket]) & (M-1)
# Lookup is TWO dependent scalar gathers (displacement, then the stored
# key pair) + branch-free 32-bit hashing — vs ~8 dependent gather rounds
# for the CSR binary search. Replaces the lookup role of the reference's
# cuckoo set (mcmc/cuckoo.cc:28-69) with a 2-probe structure.
# ---------------------------------------------------------------------------

def _perfect_has_edges(s: EdgeSet, u, v):
    d_arr, table = s.arrays
    meta = dict(s.meta)
    mask = np.uint32(meta["slot_mask"])
    bmask = np.uint32(meta["bucket_mask"])
    seed = np.uint32(meta["seed"])
    cu = jnp.minimum(u, v).astype(jnp.uint32)
    cv = jnp.maximum(u, v).astype(jnp.uint32)
    b = (_fmix32(cu * _PH_C1 + cv * _PH_C2 + seed) & bmask).astype(jnp.int32)
    h2 = _fmix32(cu * _PH_C4 + cv * _PH_C5 + (seed ^ _PH_C3)) & mask
    d = d_arr[b].astype(jnp.uint32)
    slot = ((h2 + d) & mask).astype(jnp.int32)
    pair = table[slot]                                     # [..., 2]
    return ((pair[..., 0] == cu.astype(jnp.int32))
            & (pair[..., 1] == cv.astype(jnp.int32)))


def _chd_attempt_numpy(cu, cv, M: int, NB: int, s: np.uint32):
    """One construction attempt in vectorized numpy (fallback when the
    native extension is unavailable). Returns (d_arr, slot_of in
    original edge order) or None when this seed fails."""
    E = len(cu)
    b = (_fmix32(cu * _PH_C1 + cv * _PH_C2 + s)
         & np.uint32(NB - 1)).astype(np.int64)
    h2 = (_fmix32(cu * _PH_C4 + cv * _PH_C5 + (s ^ _PH_C3))
          & np.uint32(M - 1)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    bs, h2s = b[order], h2[order]
    starts = np.searchsorted(bs, np.arange(NB))
    ends = np.searchsorted(bs, np.arange(NB), side="right")
    sizes = ends - starts
    bucket_order = np.argsort(-sizes, kind="stable")
    taken = np.zeros(M, bool)
    d_arr = np.zeros(NB, np.int32)
    slot_sorted = np.empty(E, np.int64)
    mask = M - 1
    trial_block = np.arange(64)
    for bi in bucket_order:
        k = sizes[bi]
        if k == 0:
            continue
        hs = h2s[starts[bi]:ends[bi]]
        if len(np.unique(hs)) != int(k):
            return None             # same slot for every displacement
        found = -1
        for dbase in range(0, 1 << 16, 64):
            cand = (hs[None, :] + (trial_block + dbase)[:, None]) & mask
            good = np.nonzero(~taken[cand].any(axis=1))[0]
            if len(good):
                found = dbase + int(good[0])
                slots = cand[good[0]]
                break
        if found < 0:
            return None
        d_arr[bi] = found
        taken[slots] = True
        slot_sorted[starts[bi]:ends[bi]] = slots
    slot_of = np.empty(E, np.int64)
    slot_of[order] = slot_sorted
    return d_arr, slot_of


def _build_perfect_host(u: np.ndarray, v: np.ndarray, seed: int = 1):
    """CHD construction: greedy displacement search, largest buckets
    first. Load factor <= ~0.53 (M = next pow2 of E/0.8) keeps the
    expected trials per bucket small; power-of-two table/bucket counts
    turn every mod into a bitwise AND on device. Retries with fresh
    hash seeds on the (rare, ~e^-1-probability) within-bucket slot-hash
    collision. The construction runs in the C++ extension when built
    (csrc/sampler.cpp::chd_build — same greedy and hashes, identical
    tables; ~50x faster at millions of edges), with this module's
    numpy implementation as the fallback. Returns (displacements,
    table[M,2], slot_mask, bucket_mask, seed)."""
    from mcmc_ammsb import native

    E = len(u)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    M = 1 << int(np.ceil(np.log2(max(2, E / 0.8))))
    NB = 1 << max(0, int(np.ceil(np.log2(max(1, E // 4)))))
    use_native = native.available()
    with np.errstate(over="ignore"):
        cu = u.astype(np.uint32)
        cv = v.astype(np.uint32)
        for attempt in range(16):
            s = np.uint32((seed + attempt * 0x9E3779B9) & 0xFFFFFFFF)
            if use_native:
                res = native.chd_build(
                    u.astype(np.int32), v.astype(np.int32), M, NB, int(s))
            else:
                res = _chd_attempt_numpy(cu, cv, M, NB, s)
            if res is None:
                continue
            d_arr, slot_of = res
            table = np.full((M, 2), -1, np.int32)
            table[slot_of, 0] = u
            table[slot_of, 1] = v
            return d_arr, table, M - 1, NB - 1, int(s)
    raise RuntimeError(
        f"perfect-hash build failed after 16 seeds (E={E}, M={M})")


# ---------------------------------------------------------------------------
# Builders (host side, numpy)
# ---------------------------------------------------------------------------

def build_edge_set(
    backend: EdgeSetBackend,
    num_nodes: int,
    u: np.ndarray,
    v: np.ndarray,
) -> EdgeSet:
    """Build a device EdgeSet from canonical host edges (u < v).

    ``AUTO`` resolves to ADJACENCY when the padded [N, max_degree]
    matrix fits ADJACENCY_AUTO_BUDGET_BYTES (measured 7x faster
    membership at bench shape), else to PERFECT (O(E) memory always)."""
    if backend == EdgeSetBackend.AUTO:
        deg = np.bincount(np.concatenate([u, v]).astype(np.int64),
                          minlength=num_nodes)
        f = max(1, int(deg.max()) if len(deg) else 1)
        fits = num_nodes * f * 4 <= ADJACENCY_AUTO_BUDGET_BYTES
        backend = (EdgeSetBackend.ADJACENCY if fits
                   else EdgeSetBackend.PERFECT)
    if backend == EdgeSetBackend.ADJACENCY:
        matrix = _build_adjacency_matrix(num_nodes, u, v)
        return EdgeSet("adjacency", num_nodes, 1, (),
                       (jnp.asarray(matrix),))
    if backend == EdgeSetBackend.CSR:
        g = Graph.from_edges(num_nodes, u, v)
        max_deg = g.max_fan_out
        steps = max(1, math.ceil(math.log2(max_deg + 1)) + 1)
        return EdgeSet(
            "csr", num_nodes, steps, (),
            (
                jnp.asarray(g.offsets, jnp.int32),
                jnp.asarray(g.cols, jnp.int32),
            ),
        )
    if backend == EdgeSetBackend.SORTED:
        order = np.lexsort((v, u))
        su, sv = np.asarray(u)[order], np.asarray(v)[order]
        steps = max(1, math.ceil(math.log2(len(su) + 1)) + 1)
        return EdgeSet(
            "sorted", num_nodes, steps, (),
            (jnp.asarray(su, jnp.int32), jnp.asarray(sv, jnp.int32)),
        )
    if backend == EdgeSetBackend.CUCKOO:
        slots_u, slots_v, num_bins = _build_cuckoo_host(u, v)
        return EdgeSet(
            "cuckoo", num_nodes, 1, (("num_bins", num_bins),),
            (jnp.asarray(slots_u), jnp.asarray(slots_v)),
        )
    if backend == EdgeSetBackend.PERFECT:
        d_arr, table, slot_mask, bucket_mask, seed = _build_perfect_host(u, v)
        return EdgeSet(
            "perfect", num_nodes, 1,
            (("slot_mask", slot_mask), ("bucket_mask", bucket_mask),
             ("seed", seed)),
            (jnp.asarray(d_arr), jnp.asarray(table)),
        )
    raise ValueError(backend)


def _cuckoo_hashes(key: np.uint64, num_bins: int):
    h1 = int((np.uint64(_CUCKOO_P1) * key) % np.uint64(num_bins))
    h2 = int((key ^ np.uint64(_CUCKOO_P2)) % np.uint64(num_bins))
    return h1, h2


def _build_cuckoo_host(u: np.ndarray, v: np.ndarray):
    """Host cuckoo build: 2 buckets x bins x 4 slots, load factor 1/1.15,
    random-walk displacement (mcmc/cuckoo.cc:98-189 semantics).
    uint64 hash arithmetic intentionally wraps; overflow warnings are
    suppressed only within this scope."""
    with np.errstate(over="ignore"):
        return _build_cuckoo_host_impl(u, v)


def _cuckoo_try_py(keys: np.ndarray, num_bins: int,
                   rng: np.random.RandomState):
    """One numpy placement attempt; returns slots or None on failure.
    Fallback for images without a C++ toolchain — the native
    csrc/sampler.cpp::cuckoo_try runs the same walk ~1000x faster
    (the walk is inherently sequential; python pays an interpreter
    iteration per displacement)."""
    n = len(keys)
    slots = np.full((2, num_bins, 4), _EMPTY64)
    for key in keys:
        k = np.uint64(key)
        placed = False
        bucket = 0
        for _disp in range(max(64, n // 2 + 1)):
            h1, h2 = _cuckoo_hashes(k, num_bins)
            h = h1 if bucket == 0 else h2
            row = slots[bucket, h]
            empty = np.nonzero(row == _EMPTY64)[0]
            if len(empty):
                row[empty[0]] = k
                placed = True
                break
            # evict a random occupant, retry it in the other bucket
            j = rng.randint(4)
            k, row[j] = row[j], k
            bucket = 1 - bucket
        if not placed:
            return None
    return slots


def _build_cuckoo_host_impl(u: np.ndarray, v: np.ndarray):
    n = len(u)
    keys = (np.asarray(u, np.uint64) << np.uint64(32)) | np.asarray(
        v, np.uint64
    ).astype(np.uint64)
    num_bins = int(1 + np.ceil((1.15 * max(n, 1)) / (2 * 4)))
    from mcmc_ammsb import native
    use_native = native.available()
    rng = np.random.RandomState(42)
    for attempt in range(12):
        if use_native:
            slots = native.cuckoo_try(keys, num_bins, seed=42 + attempt)
        else:
            slots = _cuckoo_try_py(keys, num_bins, rng)
        if slots is not None:
            break
        num_bins = int(num_bins * 1.3) + 1
    else:
        raise RuntimeError("cuckoo build failed")
    su = (slots >> np.uint64(32)).astype(np.uint32).astype(np.int64).astype(np.int32)
    sv = (slots & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int64).astype(np.int32)
    # empty slots become (-1, -1): 0xFFFFFFFF bit pattern in int32 lanes
    su = su.copy()
    sv = sv.copy()
    return su, sv, num_bins
