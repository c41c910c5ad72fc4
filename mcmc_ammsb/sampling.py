"""Host-side minibatch sampling: the 6 reference strategies + prefetching.

Re-implements the strategy semantics of /root/reference/mcmc/sample.cc:
135-302 (Node/NodeLink/NodeNonLink and the breadth-first variants) over
CSR adjacency, each returning the importance weight ("scale") consumed by
the beta gradient:

  NodeLink    -> N                        (sample.cc:253-268)
  NodeNonLink -> 2E / m                   (sample.cc:275-293)
  Node        -> fair coin between the two (sample.cc:295-302)
  BFLink      -> E / m                    (sample.cc:210-239)
  BFNonLink   -> (N(N-1)/2 - E) / m      (sample.cc:177-208)
  BF          -> fair coin                (sample.cc:241-248)

Batches are padded to the static device shapes (max_batch_edges /
max_batch_nodes, the same capacities the reference allocates,
sample.cc:129-131) so one XLA compilation serves every step.

A 2-deep producer thread replicates the reference's
MCMC_SAMPLE_PARALLEL double-buffered pipeline (learner.cc:216-246):
host sampling of batch t+1 overlaps device compute of batch t. A C++
fast-path sampler (mcmc_ammsb.native) slots in behind the same
interface for graphs where numpy can't keep the device fed.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from mcmc_ammsb.config import Config, SampleStrategy
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.types import VERTEX_DTYPE, canonicalize, pack_edges


class SamplerExhausted(RuntimeError):
    """A rejection-sampling loop ran out of retry budget: the graph
    cannot supply the requested minibatch (e.g. a near-complete graph
    asked for more non-links than exist). Mirrors the native sampler's
    rc=-4 (csrc/sampler.cpp:50,193) so both host paths fail the same
    way instead of the numpy fallback spinning forever."""


@dataclasses.dataclass
class MiniBatch:
    """One padded minibatch (host numpy)."""

    edges_u: np.ndarray    # [max_batch_edges] int32
    edges_v: np.ndarray    # [max_batch_edges]
    edge_mask: np.ndarray  # [max_batch_edges] bool
    nodes: np.ndarray      # [max_batch_nodes] int32 (deduped endpoints)
    node_mask: np.ndarray  # [max_batch_nodes] bool
    weight: np.float32     # strategy importance weight


class MiniBatchSampler:
    """Stateful host sampler over the training graph.

    Chunked sampling (`sample_many`) dispatches to the native C++
    sampler (mcmc_ammsb.native / csrc/sampler.cpp) when available —
    the reference's host samplers are C++ too (mcmc/sample.cc) — and
    falls back to the numpy strategies below. ``cfg.host_sampler``
    forces one path ("native"/"numpy"; "auto" probes the toolchain).
    """

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.graph = graph
        self.seed0 = cfg.sample_seed if seed is None else seed
        self.rng = np.random.RandomState(self.seed0)
        # membership oracles for NodeNonLink exclusion (sample.cc:286-287)
        self._heldout_sorted = np.sort(
            pack_edges(split.heldout_u, split.heldout_v))
        self._heldout = set(self._heldout_sorted.tolist())
        if cfg.host_sampler == "numpy":
            self.use_native = False
        else:
            from mcmc_ammsb import native
            self.use_native = native.available()
            if cfg.host_sampler == "native" and not self.use_native:
                raise RuntimeError("native sampler requested but the "
                                   "C++ build is unavailable")
        self._native_call_count = 0

    # -- strategies --------------------------------------------------------

    def _budget(self, extra: int = 0) -> int:
        """Rejection-retry budget, matching the native path's rc=-4
        semantics (csrc/sampler.cpp:63-114: 100*(m+N)+1000 attempts):
        pathological inputs (near-complete graphs, m close to the
        number of possible non-links, all-isolated node sets) fail
        loudly instead of spinning forever."""
        return 100 * (self.graph.num_nodes + extra) + 1000

    def _exhausted(self, what: str) -> "SamplerExhausted":
        return SamplerExhausted(
            f"{what}: retry budget exhausted after "
            f"{self._budget(self.cfg.mini_batch_size)} attempts — the "
            "graph cannot supply this minibatch (native sampler "
            "returns rc=-4 for the same condition)")

    def _node_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        g = self.graph
        for _ in range(self._budget()):
            u = self.rng.randint(g.num_nodes)
            nbrs = g.neighbors_of(u)
            if len(nbrs):
                break
        else:
            raise self._exhausted("NodeLink (no non-isolated pivot)")
        uu = np.full(len(nbrs), u, VERTEX_DTYPE)
        eu, ev = canonicalize(uu, nbrs.astype(VERTEX_DTYPE))
        return eu, ev, float(self.cfg.N)

    def _node_non_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        u = self.rng.randint(g.num_nodes)
        chosen_v = set()
        eu = np.empty(m, VERTEX_DTYPE)
        ev = np.empty(m, VERTEX_DTYPE)
        count = 0
        attempts = 0
        budget = self._budget(m)
        while count < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"NodeNonLink (found {count}/{m} non-links at "
                    f"pivot {u})")
            v = self.rng.randint(g.num_nodes)
            if v == u or v in chosen_v:
                continue
            a, b = (u, v) if u < v else (v, u)
            if g.has_edge(a, b) or int(pack_edges(a, b)) in self._heldout:
                continue
            chosen_v.add(v)
            eu[count], ev[count] = a, b
            count += 1
        return eu, ev, 2.0 * cfg.E / m

    def _fresh_pivot(self, seen_u) -> int:
        for _ in range(self._budget()):
            u = self.rng.randint(self.graph.num_nodes)
            if u not in seen_u:
                return u
        raise self._exhausted("BF (no unseen pivot left)")

    def _bf_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        seen_u, q, edges = set(), [], {}
        attempts = 0
        budget = self._budget(m)
        while len(edges) < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"BFLink (found {len(edges)}/{m} edges)")
            if not q:
                q.append(self._fresh_pivot(seen_u))
            u = q.pop(0)
            if u in seen_u:
                continue
            seen_u.add(u)
            for v in g.neighbors_of(u):
                if len(edges) >= m:
                    break
                q.append(int(v))
                a, b = (u, int(v)) if u < v else (int(v), u)
                edges[(a, b)] = None
        eu = np.fromiter((e[0] for e in edges), VERTEX_DTYPE, len(edges))
        ev = np.fromiter((e[1] for e in edges), VERTEX_DTYPE, len(edges))
        return eu, ev, float(cfg.E) / m

    def _bf_non_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        seen_u, q, edges = set(), [], {}
        attempts = 0
        budget = self._budget(m)
        while len(edges) < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"BFNonLink (found {len(edges)}/{m} non-links)")
            if not q:
                q.append(self._fresh_pivot(seen_u))
            u = q.pop(0)
            if u in seen_u:
                continue
            seen_u.add(u)
            nbrs = set(g.neighbors_of(u).tolist())
            for _ in range(32):
                if len(edges) >= m:
                    break
                for _ in range(self._budget()):
                    v = self.rng.randint(g.num_nodes)
                    if v != u and v not in nbrs:
                        break
                else:
                    raise self._exhausted(
                        f"BFNonLink (pivot {u} is adjacent to every "
                        "other node)")
                q.append(v)
                a, b = (u, v) if u < v else (v, u)
                edges[(a, b)] = None
        eu = np.fromiter((e[0] for e in edges), VERTEX_DTYPE, len(edges))
        ev = np.fromiter((e[1] for e in edges), VERTEX_DTYPE, len(edges))
        return eu, ev, (cfg.N * (cfg.N - 1) / 2.0 - cfg.E) / m

    def _sample_raw(self) -> Tuple[np.ndarray, np.ndarray, float]:
        s = self.cfg.strategy
        if s == SampleStrategy.NODE:
            s = (SampleStrategy.NODE_LINK if self.rng.randint(2)
                 else SampleStrategy.NODE_NON_LINK)
        elif s == SampleStrategy.BF:
            s = (SampleStrategy.BF_LINK if self.rng.randint(2)
                 else SampleStrategy.BF_NON_LINK)
        if s == SampleStrategy.NODE_LINK:
            return self._node_link()
        if s == SampleStrategy.NODE_NON_LINK:
            return self._node_non_link()
        if s == SampleStrategy.BF_LINK:
            return self._bf_link()
        if s == SampleStrategy.BF_NON_LINK:
            return self._bf_non_link()
        raise ValueError(s)

    # -- padded batch assembly --------------------------------------------

    def sample(self) -> MiniBatch:
        eu, ev, weight = self._sample_raw()
        return pad_batch(self.cfg, eu, ev, weight)

    def sample_many(self, count: int) -> "StackedBatches":
        """Sample ``count`` minibatches stacked along a leading axis —
        the input of the fused lax.scan driver."""
        if self.use_native:
            return self._sample_many_native(count)
        batches = [self.sample() for _ in range(count)]
        return StackedBatches(
            edges_u=np.stack([b.edges_u for b in batches]),
            edges_v=np.stack([b.edges_v for b in batches]),
            edge_mask=np.stack([b.edge_mask for b in batches]),
            nodes=np.stack([b.nodes for b in batches]),
            node_mask=np.stack([b.node_mask for b in batches]),
            weight=np.asarray([b.weight for b in batches], np.float32),
        )

    def _sample_many_native(self, count: int) -> "StackedBatches":
        from mcmc_ammsb import native

        cfg, g = self.cfg, self.graph
        self._native_call_count += 1
        seed = (self.seed0 * 0x9E3779B9 + self._native_call_count)
        eu, ev, em, nd, nm, w = native.sample_batches(
            g.offsets, g.cols, g.num_nodes, self._heldout_sorted,
            cfg.strategy.value, cfg.mini_batch_size,
            float(cfg.N), float(cfg.E), count,
            cfg.max_batch_edges, cfg.max_batch_nodes, seed,
        )
        return StackedBatches(eu, ev, em, nd, nm, w)


@dataclasses.dataclass
class StackedBatches:
    edges_u: np.ndarray    # [S, max_batch_edges]
    edges_v: np.ndarray
    edge_mask: np.ndarray
    nodes: np.ndarray      # [S, max_batch_nodes]
    node_mask: np.ndarray
    weight: np.ndarray     # [S]


def pad_batch(cfg: Config, eu: np.ndarray, ev: np.ndarray,
              weight: float) -> MiniBatch:
    """Pad a raw edge list to static shapes; dedup endpoint nodes
    (ExtractNodesFromMiniBatch, learner.cc:162-173)."""
    ne = len(eu)
    cap_e, cap_n = cfg.max_batch_edges, cfg.max_batch_nodes
    if ne > cap_e:
        raise ValueError(f"minibatch of {ne} edges exceeds capacity {cap_e}")
    edges_u = np.zeros(cap_e, VERTEX_DTYPE)
    edges_v = np.zeros(cap_e, VERTEX_DTYPE)
    edges_u[:ne], edges_v[:ne] = eu, ev
    edge_mask = np.arange(cap_e) < ne

    uniq = np.unique(np.concatenate([eu, ev]))
    nn = len(uniq)
    if nn > cap_n:
        raise ValueError(f"{nn} minibatch nodes exceed capacity {cap_n}")
    nodes = np.zeros(cap_n, VERTEX_DTYPE)
    nodes[:nn] = uniq
    node_mask = np.arange(cap_n) < nn
    return MiniBatch(edges_u, edges_v, edge_mask, nodes, node_mask,
                     np.float32(weight))


class PrefetchingSampler:
    """Producer-thread wrapper: keeps ``depth`` batches ready.

    The counterpart of the reference's std::async double-buffered sampling
    (learner.cc:216-246): JAX dispatch is already asynchronous, so a
    depth-2 host queue fully hides sampling latency behind device work.

    Producer exceptions propagate to the consumer (re-raised from
    ``get``), and ``drain()`` quiesces the thread and hands back every
    produced-but-unconsumed item — the in-flight state a checkpoint must
    capture for bit-exact resume (the reference serializes its
    in-flight minibatch the same way, learner.cc:307-315).
    """

    def __init__(self, sampler: MiniBatchSampler, depth: int = 2,
                 chunk: int = 1):
        self._sampler = sampler
        self._chunk = chunk
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        while not self._stop.is_set():
            try:
                item = (self._sampler.sample() if self._chunk == 1
                        else self._sampler.sample_many(self._chunk))
            except BaseException as e:  # surface instead of deadlock
                self._error = e
                self._q.put(_ProducerFailed(e))
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue_mod.Full:
                    continue

    def get(self):
        item = self._q.get()
        if isinstance(item, _ProducerFailed):
            raise RuntimeError("sampling producer failed") from item.error
        return item

    def drain(self):
        """Stop the producer and return the unconsumed in-flight items,
        in production order."""
        self._stop.set()
        self._thread.join()
        pending = []
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _ProducerFailed):
                    raise RuntimeError("sampling producer failed") \
                        from item.error
                pending.append(item)
        except queue_mod.Empty:
            pass
        return pending

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass


class _ProducerFailed:
    def __init__(self, error: BaseException):
        self.error = error
