"""Partitioned (multi-host capacity) graph structures: a model-row-
sharded CSR living ON the mesh, plus the per-process ingest that builds
it without any process ever materializing the full graph.

This is the end-to-end generalization of the reference's capacity
lever: RowPartitionedMatrix splits pi across <=32 allocations on ONE
device (/root/reference/mcmc/partitioned-alloc.h:87-131); here BOTH
E-sized structures — the membership set and the sampling adjacency —
are row-sharded over the mesh's 'model' axis, and the SNAP ETL
(/root/reference/mcmc/data.cc:36-78 semantics) is split by byte range
so each process parses, exchanges, and keeps only O(E/P) edges
(parallel/multihost.py provides the byte-range + vocabulary plumbing).

Membership and adjacency queries become collectives with the same
shape discipline as the pi row fetches (parallel/sharded.py
_fetch_rows): the owner of row u answers from its local CSR slice and
a psum over 'model' broadcasts the answer. Queries are minibatch-sized
([B, n] / [E] lanes), so like the row fetches they are latency- not
bandwidth-bound. Answers are EXACT (integer/boolean psums), so a
partitioned run's trajectory is bit-identical to the replicated-graph
engine's (asserted by tests/test_partitioned.py).

The held-out structures stay replicated: they are ratio-sized
(~1-10% of E) and the eval population must be globally visible anyway.

Split semantics deviation (documented in PARITY.md): the replicated
loader splits by global shuffle position (data.cc:80-128); a
partitioned ingest cannot order-shuffle edges it never gathers, so the
held-out links are chosen by a deterministic per-edge hash
(splitmix64(pack(u,v)) < ratio/2 * 2^64) — order-independent, so P
processes make identical choices without communication, and the fake
non-link population is drawn from one shared PRNG stream with
distributed membership rejection. Same distribution, same expected
sizes, different (but seed-reproducible) realization.

Collective-ordering discipline: every cross-process helper below runs
the SAME sequence of allgathers on every process regardless of which
shards a process owns (one pass over all shards; owners merely keep
their rounds), so mixed ownership cannot deadlock the KV store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_ammsb.parallel.mesh import MODEL_AXIS

# ---------------------------------------------------------------------------
# Device structure: model-row-sharded CSR
# ---------------------------------------------------------------------------


def _lower_bound(num_steps, lo, hi, less_fn):
    """Branch-free vectorized lower bound (ops/edgeset.py discipline)."""

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


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Symmetric CSR adjacency row-sharded over the mesh 'model' axis.

    Global arrays (one shard per model index m):
      offsets [n_model * (rows_per_shard + 1)] int32 — shard-LOCAL
          offsets (each shard's slice starts at 0);
      cols    [n_model * cols_cap] int32 — GLOBAL column ids, each
          shard's rows sorted (row-major, ascending within a row),
          padded to the common cap.

    Every method must run INSIDE shard_map (it reads
    ``axis_index('model')`` and psums): the owner of row u answers
    locally, everyone else contributes zero. Implements both the
    EdgeSet membership protocol (``has_edges``) and the device-sampler
    adjacency protocol (``degree`` / ``row_gather``), so the sharded
    engine's bodies consume it exactly where they consumed the
    replicated EdgeSet + (offsets, cols) pair.
    """

    offsets: jnp.ndarray
    cols: jnp.ndarray
    num_nodes: int
    rows_per_shard: int
    num_search_steps: int
    backend: str = "sharded_csr"

    def tree_flatten(self):
        return ((self.offsets, self.cols),
                (self.num_nodes, self.rows_per_shard,
                 self.num_search_steps, self.backend))

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, cols = children
        num_nodes, rows_per_shard, steps, backend = aux
        return cls(offsets, cols, num_nodes, rows_per_shard, steps,
                   backend)

    # -- local helpers (shard view) -----------------------------------

    def _local(self, u):
        """(local_row, owned) for global node ids ``u`` on this shard."""
        m_idx = jax.lax.axis_index(MODEL_AXIS)
        lu = u - m_idx * self.rows_per_shard
        ok = (lu >= 0) & (lu < self.rows_per_shard)
        return jnp.clip(lu, 0, self.rows_per_shard - 1), ok

    # -- EdgeSet protocol ----------------------------------------------

    def has_edges(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """Collective membership: exact, one owner answers per query."""
        u, v = jnp.broadcast_arrays(u, v)
        lu, ok = self._local(u)
        lo0 = self.offsets[lu]
        hi0 = self.offsets[lu + 1]
        m = self.cols.shape[0]

        def less(mid):
            return self.cols[jnp.clip(mid, 0, m - 1)] < v

        pos = _lower_bound(self.num_search_steps, lo0, hi0, less)
        hit = ok & (pos < hi0) & (self.cols[jnp.clip(pos, 0, m - 1)] == v)
        return jax.lax.psum(hit.astype(jnp.int32), MODEL_AXIS) > 0

    # -- device-sampler adjacency protocol ------------------------------

    def degree(self, u: jnp.ndarray) -> jnp.ndarray:
        lu, ok = self._local(u)
        deg = (self.offsets[lu + 1] - self.offsets[lu]) * ok.astype(
            jnp.int32)
        return jax.lax.psum(deg, MODEL_AXIS)

    def row_gather(self, u: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
        """cols of row u at in-row offsets ``off`` ([*u.shape, L]);
        out-of-row offsets return clamped garbage exactly like the
        replicated gather — callers mask those lanes
        (ops/device_sampling.py)."""
        lu, ok = self._local(u)
        idx = self.offsets[lu][..., None] + off
        m = self.cols.shape[0]
        vals = self.cols[jnp.clip(idx, 0, m - 1)]
        vals = vals * ok.astype(jnp.int32)[..., None]
        return jax.lax.psum(vals, MODEL_AXIS)

    # -- sharding helper -------------------------------------------------

    def spec(self) -> "ShardedCSR":
        """shard_map in_specs pytree: both leaves split over 'model'."""
        return ShardedCSR(
            offsets=P(MODEL_AXIS), cols=P(MODEL_AXIS),
            num_nodes=self.num_nodes,
            rows_per_shard=self.rows_per_shard,
            num_search_steps=self.num_search_steps)


class ShardSlice(NamedTuple):
    """Host-side CSR of one model shard's rows [row_lo, row_hi)."""

    row_lo: int
    row_hi: int
    offsets: np.ndarray   # [row_hi - row_lo + 1] local offsets
    cols: np.ndarray      # global ids, sorted within each row


def build_sharded_csr(mesh: Mesh, num_nodes: int, rows_per_shard: int,
                      shards: Dict[int, ShardSlice],
                      cols_cap: Optional[int] = None) -> ShardedCSR:
    """Assemble the device ShardedCSR from host-side per-shard slices.

    ``shards`` must cover every model shard whose devices this process
    can address (all shards on a single-process mesh). ``cols_cap``
    (the common padded column count) must be identical across
    processes; multi-process callers pass the allgathered max.
    """
    n_model = mesh.shape[MODEL_AXIS]
    if cols_cap is None:
        cols_cap = max((len(s.cols) for s in shards.values()), default=1)
    cols_cap = max(int(cols_cap), 1)
    row_len = rows_per_shard + 1

    def shard_arrays(m: int) -> Tuple[np.ndarray, np.ndarray]:
        s = shards[m]
        offs = np.zeros(row_len, np.int32)
        n_rows = s.row_hi - s.row_lo
        offs[: n_rows + 1] = s.offsets
        offs[n_rows + 1:] = s.offsets[-1]   # padded rows are empty
        cols = np.zeros(cols_cap, np.int32)
        cols[: len(s.cols)] = s.cols
        return offs, cols

    def assemble(global_len, per_shard_len, pick):
        sharding = NamedSharding(mesh, P(MODEL_AXIS))
        arrays = []
        devs = []
        idx_map = sharding.addressable_devices_indices_map((global_len,))
        for dev, idx in idx_map.items():
            start = idx[0].start or 0
            m = start // per_shard_len
            arrays.append(jax.device_put(pick(m), dev))
            devs.append(dev)
        return jax.make_array_from_single_device_arrays(
            (global_len,), sharding, arrays)

    offsets = assemble(n_model * row_len, row_len,
                       lambda m: shard_arrays(m)[0])
    cols = assemble(n_model * cols_cap, cols_cap,
                    lambda m: shard_arrays(m)[1])
    steps = int(np.ceil(np.log2(max(cols_cap, 2)))) + 1
    return ShardedCSR(offsets=offsets, cols=cols, num_nodes=num_nodes,
                      rows_per_shard=rows_per_shard,
                      num_search_steps=steps)


# ---------------------------------------------------------------------------
# Deterministic split + ingest
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Finalizer of splitmix64 — a high-quality 64-bit mix."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _SPLITMIX_C1
        x = (x ^ (x >> np.uint64(27))) * _SPLITMIX_C2
        return x ^ (x >> np.uint64(31))


def _pack(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return ((np.asarray(u).astype(np.uint64) << np.uint64(32))
            | np.asarray(v).astype(np.uint64))


def _unpack(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return ((p >> np.uint64(32)).astype(np.int32),
            (p & np.uint64(0xFFFFFFFF)).astype(np.int32))


def heldout_link_mask(u: np.ndarray, v: np.ndarray,
                      heldout_ratio: float, seed: int) -> np.ndarray:
    """Deterministic per-edge held-out choice: order-independent, so
    every process classifies its local edges identically without
    communication. P(heldout) = ratio/2 per edge (the replicated
    loader's heldout_len/E, data.cc:80-128, realized binomially)."""
    h = _splitmix64(_pack(u, v) ^ _splitmix64(np.uint64(seed)))
    thresh = np.uint64(int((heldout_ratio / 2.0) * float(2**64 - 1)))
    return h < thresh


class PartitionedData(NamedTuple):
    """Per-process view of a partitioned dataset."""

    num_nodes: int
    num_edges: int              # global unique-edge count E
    max_fan_out: int            # global max degree (training graph)
    shards: Dict[int, ShardSlice]   # my model shards' TRAINING csr
    cols_cap: int               # global max shard cols (padding target)
    heldout_u: np.ndarray       # real held-out links (full, small)
    heldout_v: np.ndarray
    fake_u: np.ndarray          # sampled non-links (full, small)
    fake_v: np.ndarray
    local_parse_edges: int = 0  # this process's byte-range edge count
    max_shard_edges: int = 0    # largest per-shard edge count held

    @property
    def heldout_edges_u(self) -> np.ndarray:
        return np.concatenate([self.heldout_u, self.fake_u])

    @property
    def heldout_edges_v(self) -> np.ndarray:
        return np.concatenate([self.heldout_v, self.fake_v])


def my_model_shards(mesh: Mesh, rows_per_shard: int,
                    num_nodes: int) -> Dict[int, Tuple[int, int]]:
    """Model-shard row ranges this process's devices own (clamped to
    real rows: the top shard may be pure padding on tall meshes)."""
    axes = list(mesh.axis_names)
    m_pos = axes.index(MODEL_AXIS)
    dev_grid = np.asarray(mesh.devices)
    mine = {}
    for idx in np.ndindex(dev_grid.shape):
        dev = dev_grid[idx]
        if dev.process_index != jax.process_index():
            continue
        m = idx[m_pos]
        lo = min(m * rows_per_shard, num_nodes)
        hi = min((m + 1) * rows_per_shard, num_nodes)
        mine[int(m)] = (lo, hi)
    return mine


def _shard_owner(mesh: Mesh, m: int) -> int:
    """Lowest process index holding model shard ``m`` (dedup rule for
    global reductions when the model axis is replicated across
    processes' data rows)."""
    axes = list(mesh.axis_names)
    m_pos = axes.index(MODEL_AXIS)
    dev_grid = np.asarray(mesh.devices)
    owners = [dev_grid[idx].process_index
              for idx in np.ndindex(dev_grid.shape) if idx[m_pos] == m]
    return min(owners)


def _allgather_concat(arr: np.ndarray) -> np.ndarray:
    """Variable-length cross-process concat via the fixed-width
    allgather (multihost.global_vocab discipline). Single-process:
    identity.

    64-bit arrays ride as uint32 views: process_allgather goes
    through jax, whose default x64-disabled mode SILENTLY truncates
    (u)int64 payloads to 32 bits — packed edge keys would lose their
    entire u half."""
    if jax.process_count() == 1:
        return arr
    if arr.dtype.itemsize == 8:
        return _allgather_concat(arr.view(np.uint32)).view(arr.dtype)
    from jax.experimental import multihost_utils

    n_local = np.int64(len(arr))
    lens = np.asarray(multihost_utils.process_allgather(n_local))
    max_len = int(lens.max())
    padded = np.zeros(max(max_len, 1), arr.dtype)
    padded[: len(arr)] = arr
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return np.concatenate(
        [gathered[p, : int(lens[p])] for p in range(len(lens))])


def _allreduce_max(x: int) -> int:
    if jax.process_count() == 1:
        return int(x)
    from jax.experimental import multihost_utils

    return int(np.asarray(
        multihost_utils.process_allgather(np.int64(x))).max())


def _allreduce_sum(x: int) -> int:
    if jax.process_count() == 1:
        return int(x)
    from jax.experimental import multihost_utils

    return int(np.asarray(
        multihost_utils.process_allgather(np.int64(x))).sum())


def _allreduce_any_rows(local_bad: np.ndarray) -> np.ndarray:
    if jax.process_count() == 1:
        return local_bad > 0
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(local_bad)).max(axis=0) > 0


def exchange_edges(u: np.ndarray, v: np.ndarray,
                   row_cuts: np.ndarray,
                   my_shards: Dict[int, Tuple[int, int]]
                   ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]],
                              int]:
    """Route locally-parsed edges to the shards they touch; return
    {shard -> deduplicated canonical edges touching its rows} for MY
    shards, plus the largest per-shard edge count (memory telemetry).

    ONE allgather round per model shard, executed by EVERY process
    (collective-ordering discipline); each round carries only the
    edges destined for that shard, so peak transient memory is
    O(max_shard_edges), never O(E). Single-process: pure local filter.
    """
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    max_edges = 0
    n_shards = len(row_cuts) - 1
    for s in range(n_shards):
        lo, hi = int(row_cuts[s]), int(row_cuts[s + 1])
        sel = ((u >= lo) & (u < hi)) | ((v >= lo) & (v < hi))
        packed = _pack(u[sel], v[sel])
        if jax.process_count() > 1:
            packed = _allgather_concat(packed)
        if s in my_shards:
            packed = np.unique(packed)
            out[s] = _unpack(packed)
            max_edges = max(max_edges, len(packed))
        del packed
    return out, max_edges


def _csr_slice(u: np.ndarray, v: np.ndarray, row_lo: int,
               row_hi: int) -> ShardSlice:
    """Symmetric CSR restricted to rows [row_lo, row_hi) (the device
    form of multihost.shard_csr, cols sorted within each row)."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    keep = (src >= row_lo) & (src < row_hi)
    src = src[keep] - row_lo
    dst = dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=max(row_hi - row_lo, 1))
    offsets = np.zeros(max(row_hi - row_lo, 0) + 1, np.int64)
    if row_hi > row_lo:
        np.cumsum(counts[: row_hi - row_lo], out=offsets[1:])
    return ShardSlice(row_lo, row_hi, offsets.astype(np.int32),
                      dst.astype(np.int32))


def sample_fake_nonlinks(num_nodes: int, target: int, seed: int,
                         local_edges_packed: np.ndarray,
                         owned_ranges: List[Tuple[int, int]]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``target`` uniform non-edges, chosen identically on every
    process (data.cc:100-127 semantics: exclude real edges and each
    other). Candidates come from one shared PRNG stream; membership is
    rejected DISTRIBUTEDLY — each process tests the candidates whose u
    falls in a row range it owns against its local edge set, verdict
    bitmaps are allgathered (candidate-sized, tiny) and every process
    applies the identical accept rule, so the loop runs the same
    number of collective rounds everywhere."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    chosen = np.zeros(0, np.uint64)
    rounds = 0
    while len(chosen) < target and rounds < 64:
        rounds += 1
        n_prop = max(64, 2 * (target - len(chosen)))
        a = rng.randint(0, num_nodes, size=n_prop).astype(np.int64)
        b = rng.randint(0, num_nodes, size=n_prop).astype(np.int64)
        cu = np.minimum(a, b).astype(np.int32)
        cv = np.maximum(a, b).astype(np.int32)
        packed = _pack(cu, cv)
        mine = np.zeros(n_prop, np.bool_)
        for lo, hi in owned_ranges:
            mine |= (cu >= lo) & (cu < hi)
        local_bad = np.zeros(n_prop, np.int8)
        local_bad[mine] = np.isin(packed[mine],
                                  local_edges_packed).astype(np.int8)
        bad = _allreduce_any_rows(local_bad)
        ok = ~bad & (cu != cv) & ~np.isin(packed, chosen)
        # dedup within the round, keep first occurrences in order
        _, first = np.unique(packed[ok], return_index=True)
        keep = packed[ok][np.sort(first)]
        chosen = np.concatenate([chosen, keep])[: target]
    if len(chosen) < target:
        raise RuntimeError(
            f"could not sample {target} non-links in 64 rounds "
            "(graph too dense?)")
    return _unpack(chosen)


def partitioned_ingest(mesh: Mesh, *, heldout_ratio: float, seed: int,
                       path: Optional[str] = None,
                       edges: Optional[Tuple[np.ndarray,
                                             np.ndarray]] = None,
                       num_nodes: Optional[int] = None
                       ) -> PartitionedData:
    """Per-process dataset build: parse MY byte range, agree on the
    vocabulary, exchange edges to their owning model shards, split
    held-out links by hash, and build MY shards' training CSR.

    ``path``: SNAP file, split by ``multihost.byte_ranges`` across
    processes. ``edges`` + ``num_nodes``: pre-parsed LOCAL (this
    process's share) renumbered edge arrays — the synthetic-graph
    entry used by tests. No process ever holds more than
    O(E/P + max_shard_edges) edge records (P processes), asserted by
    the returned telemetry fields.
    """
    from mcmc_ammsb.parallel import multihost

    if path is not None:
        pid, np_ = jax.process_index(), jax.process_count()
        ranges = multihost.byte_ranges(path, np_)
        raw_u, raw_v = multihost.load_snap_edges_range(
            path, *ranges[pid])
        vocab = multihost.global_vocab(
            np.concatenate([raw_u, raw_v]))
        num_nodes = len(vocab)
        u, v = multihost.renumber_edges(raw_u, raw_v, vocab)
        del raw_u, raw_v
    else:
        assert edges is not None and num_nodes is not None
        u = np.asarray(edges[0], np.int32)
        v = np.asarray(edges[1], np.int32)
        u, v = np.minimum(u, v), np.maximum(u, v)
    local_parse_edges = len(u)

    n_model = mesh.shape[MODEL_AXIS]
    rows_per_shard = -(-num_nodes // n_model)   # == ShardedLearner's
    row_cuts = np.minimum(
        np.arange(n_model + 1) * rows_per_shard, num_nodes)
    mine = my_model_shards(mesh, rows_per_shard, num_nodes)

    shard_edges, max_shard_edges = exchange_edges(u, v, row_cuts, mine)
    del u, v  # the byte-range parse is no longer needed

    # global E: the owner process of each shard counts the unique
    # edges whose canonical u lands in that shard's rows
    my_e = 0
    for m, (su, sv) in shard_edges.items():
        if _shard_owner(mesh, m) != jax.process_index():
            continue
        lo, hi = mine[m]
        my_e += int(((su >= lo) & (su < hi)).sum())
    num_edges = _allreduce_sum(my_e)

    # held-out links: hash rule, classified by each shard's owner,
    # gathered globally (small)
    ho_parts_u, ho_parts_v = [], []
    for m, (su, sv) in shard_edges.items():
        if _shard_owner(mesh, m) != jax.process_index():
            continue
        lo, hi = mine[m]
        own = (su >= lo) & (su < hi)
        hm = heldout_link_mask(su[own], sv[own], heldout_ratio, seed)
        ho_parts_u.append(su[own][hm])
        ho_parts_v.append(sv[own][hm])
    ho_u = (np.concatenate(ho_parts_u) if ho_parts_u
            else np.zeros(0, np.int32))
    ho_v = (np.concatenate(ho_parts_v) if ho_parts_v
            else np.zeros(0, np.int32))
    heldout_packed = np.sort(_allgather_concat(_pack(ho_u, ho_v)))
    heldout_u, heldout_v = _unpack(heldout_packed)

    # fake non-links: shared stream + distributed membership rejection
    if shard_edges:
        all_local_packed = np.unique(np.concatenate(
            [_pack(su, sv) for su, sv in shard_edges.values()]))
    else:
        all_local_packed = np.zeros(0, np.uint64)
    fake_u, fake_v = sample_fake_nonlinks(
        num_nodes, len(heldout_u), seed + 1, all_local_packed,
        list(mine.values()))

    # training CSR per shard: drop held-out links, build symmetric CSR
    shards: Dict[int, ShardSlice] = {}
    max_deg = 0
    for m, (su, sv) in shard_edges.items():
        lo, hi = mine[m]
        keep = ~np.isin(_pack(su, sv), heldout_packed)
        sl = _csr_slice(su[keep], sv[keep], lo, hi)
        shards[m] = sl
        if len(sl.offsets) > 1:
            max_deg = max(max_deg, int(np.diff(sl.offsets).max()))
    max_fan_out = _allreduce_max(max_deg)
    cols_cap = _allreduce_max(max(
        (len(s.cols) for s in shards.values()), default=1))

    return PartitionedData(
        num_nodes=num_nodes, num_edges=num_edges,
        max_fan_out=max_fan_out, shards=shards, cols_cap=cols_cap,
        heldout_u=heldout_u, heldout_v=heldout_v,
        fake_u=fake_u, fake_v=fake_v,
        local_parse_edges=local_parse_edges,
        max_shard_edges=max_shard_edges)


def to_datasplit(pdata: PartitionedData):
    """TEST-ONLY: gather a PartitionedData back into the replicated
    Graph + DataSplit pair, to run the replicated engine on the
    identical dataset for trajectory-parity assertions. Materializes
    the full graph — never call this in a capacity-constrained run."""
    from mcmc_ammsb.data import DataSplit, Graph

    pairs = []
    for s in pdata.shards.values():
        for r in range(s.row_hi - s.row_lo):
            cols = s.cols[s.offsets[r]: s.offsets[r + 1]]
            row = np.full(len(cols), s.row_lo + r, np.int32)
            pairs.append(_pack(np.minimum(row, cols),
                               np.maximum(row, cols)))
    local = (np.unique(np.concatenate(pairs)) if pairs
             else np.zeros(0, np.uint64))
    allp = np.unique(_allgather_concat(local))
    tu, tv = _unpack(allp)
    split = DataSplit(
        num_nodes=pdata.num_nodes,
        training_u=tu, training_v=tv,
        heldout_u=pdata.heldout_u, heldout_v=pdata.heldout_v,
        heldout_edges_u=pdata.heldout_edges_u,
        heldout_edges_v=pdata.heldout_edges_v,
        total_edges=pdata.num_edges)
    graph = Graph.from_edges(pdata.num_nodes, tu, tv)
    return graph, split


def _local_packed_training_edges(pdata: PartitionedData) -> np.ndarray:
    """This process's view of the training edge set as sorted unique
    canonical-packed uint64 (each shard CSR row contributes its
    adjacency; undirected edges appearing from both endpoint rows
    dedup here). O(local shard edges) memory — never the full list."""
    pairs = []
    for s in pdata.shards.values():
        for r in range(s.row_hi - s.row_lo):
            cols = s.cols[s.offsets[r]: s.offsets[r + 1]]
            row = np.full(len(cols), s.row_lo + r, np.int32)
            pairs.append(_pack(np.minimum(row, cols),
                               np.maximum(row, cols)))
    if not pairs:
        return np.zeros(0, np.uint64)
    return np.unique(np.concatenate(pairs))


def make_training_ppx_edges_partitioned(
        pdata: PartitionedData, ratio: float, seed: int = 777
) -> Tuple[np.ndarray, np.ndarray]:
    """Training-perplexity population in partitioned mode — BIT-EQUAL
    to ``data.make_training_ppx_edges(to_datasplit(pdata)[1], ratio)``
    (MakeEdgesForTrainingPerplexity, learner.cc:48-74) without ever
    materializing the full edge list:

      - the replicated population's link half is the first num_links
        training edges in global canonical-packed order (to_datasplit
        sorts by packed id); here each process contributes its local
        num_links-smallest and a k-smallest union over one allgather
        reproduces the same head — O(P * num_links) communicated;
      - the non-link half replays the replicated RandomState rejection
        stream exactly: identical rounds and draws, with the
        training-membership test answered by local searchsorted +
        allreduce-OR instead of a host edge set.

    Every process returns the identical arrays (collective)."""
    n = pdata.num_nodes
    e = pdata.num_edges
    train_count = e - len(pdata.heldout_u)
    total = n * (n - 1) // 2
    num_links = int(ratio * train_count)
    num_non_links = int(num_links * total / float(e))

    local = _local_packed_training_edges(pdata)
    head = np.unique(_allgather_concat(local[:num_links]))
    if len(head) < num_links:
        raise ValueError(
            f"training graph has only {len(head)} edges visible; "
            f"needs {num_links} for training_ppx_ratio={ratio}")
    lu, lv = _unpack(head[:num_links])

    ho = np.sort(_pack(pdata.heldout_u, pdata.heldout_v))

    def member(sorted_arr: np.ndarray, p: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(sorted_arr, p)
        ok = idx < len(sorted_arr)
        out = np.zeros(len(p), np.bool_)
        out[ok] = sorted_arr[idx[ok]] == p[ok]
        return out

    rng = np.random.RandomState(seed)
    fu = np.empty(num_non_links, np.int32)
    fv = np.empty(num_non_links, np.int32)
    count = 0
    rounds = 0
    while count < num_non_links:
        rounds += 1
        if rounds > 200:
            raise ValueError(
                f"make_training_ppx_edges_partitioned: found only "
                f"{count}/{num_non_links} non-edges after 200 "
                "rejection rounds — the graph is too dense")
        need = num_non_links - count
        ra = rng.randint(0, n, size=2 * need + 16)
        rb = rng.randint(0, n, size=2 * need + 16)
        keep = ra != rb
        cu = np.minimum(ra[keep], rb[keep])
        cv = np.maximum(ra[keep], rb[keep])
        p = _pack(cu, cv)
        # training membership is sharded; heldout is replicated host
        hit = member(local, p) | member(ho, p)
        hit = _allreduce_any_rows(hit)
        for j in range(len(p)):
            if hit[j]:
                continue
            fu[count], fv[count] = cu[j], cv[j]
            count += 1
            if count == num_non_links:
                break
    return (np.concatenate([lu, fu]).astype(np.int32),
            np.concatenate([lv, fv]).astype(np.int32))
