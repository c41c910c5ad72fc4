"""Graph ETL: SNAP loading, renumbering, train/held-out split, CSR adjacency.

Re-implements the behavior of /root/reference/mcmc/data.cc with vectorized
numpy (and an optional C++ fast path for billion-edge graphs, see
``mcmc_ammsb.native``):

  * ``load_snap_edges``     — parse an edge list, canonicalize, renumber
                              vertices to [0, N), dedup, shuffle
                              (data.cc:36-78).
  * ``generate_sets``       — split into training / held-out, and generate
                              an equal count of "fake" held-out non-edges
                              (data.cc:80-128).
  * ``Graph``               — CSR adjacency + max fan-out (data.cc:12-25).
  * ``dump_dataset`` / ``load_dataset`` — compressed dataset cache,
                              the parity of main.cc:109-149's gzip dump.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Optional, Tuple

import numpy as np

from mcmc_ammsb.types import VERTEX_DTYPE, canonicalize, pack_edges, unpack_edges


@dataclasses.dataclass
class Graph:
    """Undirected graph in CSR form.

    The reference's ``Graph`` keeps per-vertex adjacency vectors and
    ``MaxFanOut`` (/root/reference/mcmc/data.cc:12-25); CSR is the
    flat-array equivalent that both the host samplers and the device
    edge-membership binary search consume.
    """

    num_nodes: int
    edges_u: np.ndarray  # [E] int32, canonical u < v
    edges_v: np.ndarray  # [E] int32
    offsets: np.ndarray  # [N+1] int64 CSR row offsets
    cols: np.ndarray     # [2E] int32, sorted within each row

    @classmethod
    def from_edges(cls, num_nodes: int, u: np.ndarray, v: np.ndarray) -> "Graph":
        u = np.asarray(u, VERTEX_DTYPE)
        v = np.asarray(v, VERTEX_DTYPE)
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=num_nodes)
        offsets = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(num_nodes, u, v, offsets, dst)

    @property
    def num_edges(self) -> int:
        return len(self.edges_u)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def max_fan_out(self) -> int:
        return int(self.degrees.max()) if self.num_nodes else 0

    def neighbors_of(self, u: int) -> np.ndarray:
        return self.cols[self.offsets[u] : self.offsets[u + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors_of(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)


def load_snap_edges(
    path: str, shuffle_seed: int = 0, use_native: str = "auto"
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Parse a SNAP edge-list file.

    Matches data.cc:36-78: skip header lines, canonicalize each edge to
    (min, max), renumber vertices to [0, N), dedup, shuffle. The reference
    skips exactly 4 header lines; we skip any '#'-prefixed comment lines
    (equivalent for SNAP files, robust to others). Returns (N, u, v).

    Plain-text files go through the native C++ parser when available
    (csrc/sampler.cpp — the load-bearing path for multi-GB edge lists);
    gzip files and toolchain-less hosts use the numpy path. Both are
    cross-checked by tests (test_native.py).
    """
    if use_native != "never":
        if path.endswith(".gz"):
            if use_native == "always":
                raise RuntimeError("native parser does not read gzip; "
                                   "decompress first or use the numpy path")
        else:
            from mcmc_ammsb import native
            if native.available():
                a, b = native.snap_parse(path)
                return renumber_dedup_shuffle(a, b, shuffle_seed)
            if use_native == "always":
                raise RuntimeError("native parser requested but "
                                   "unavailable")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln and not ln.lstrip().startswith("#")]
    raw = np.loadtxt(io.StringIO("\n".join(lines)), dtype=np.int64, ndmin=2)
    a, b = raw[:, 0], raw[:, 1]
    return renumber_dedup_shuffle(a, b, shuffle_seed)


def renumber_dedup_shuffle(
    a: np.ndarray, b: np.ndarray, shuffle_seed: int = 0
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Vertex renumber to [0, N), self-loop drop, dedup, shuffle."""
    keep = a != b
    a, b = a[keep], b[keep]
    uniq, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    n = len(uniq)
    a = inv[: len(a)].astype(VERTEX_DTYPE)
    b = inv[len(b) :].astype(VERTEX_DTYPE)
    u, v = canonicalize(a, b)
    packed = np.unique(pack_edges(u, v))
    rng = np.random.RandomState(shuffle_seed)
    rng.shuffle(packed)
    u, v = unpack_edges(packed)
    return n, u, v


def synthetic_edges(
    num_nodes: int, avg_degree: int, seed: int = 0
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Random graph for tests/benchmarks.

    Follows the reference test-graph recipe (wg-phi-test.cc:116-125:
    4k nodes x 32 average degree of uniformly random edges).
    """
    rng = np.random.RandomState(seed)
    m = num_nodes * avg_degree // 2
    a = rng.randint(0, num_nodes, size=2 * m)
    b = rng.randint(0, num_nodes, size=2 * m)
    n, u, v = renumber_dedup_shuffle(a, b, shuffle_seed=seed)
    # Renumbering is a no-op with overwhelming probability (all ids hit);
    # truncate to ~m edges to land near the requested average degree.
    u, v = u[:m], v[:m]
    order = np.random.RandomState(seed + 1).permutation(len(u))
    return n, u[order], v[order]


def synthetic_sbm_edges(
    num_nodes: int,
    num_communities: int,
    p_in: float = 0.05,
    p_out: float = 0.001,
    seed: int = 0,
    return_labels: bool = False,
):
    """Planted-partition (stochastic block model) graph.

    Uniform random graphs (``synthetic_edges``) carry no structure for
    the sampler to learn, so held-out perplexity plateaus quickly;
    convergence benchmarks use this generator instead: nodes split into
    equal communities, intra-community edges at ``p_in``, inter at
    ``p_out`` (sampled sparsely by pair counts, not O(N^2)).

    With ``return_labels`` also returns the planted community label per
    RENUMBERED node id (for block-recovery tests).
    """
    rng = np.random.RandomState(seed)
    sizes = np.full(num_communities, num_nodes // num_communities)
    sizes[: num_nodes % num_communities] += 1
    labels = np.repeat(np.arange(num_communities), sizes)
    rng.shuffle(labels)
    members = [np.where(labels == c)[0] for c in range(num_communities)]

    chunks = []
    # intra-community: binomial count of pairs, sampled with replacement
    for m in members:
        s = len(m)
        pairs = s * (s - 1) // 2
        count = rng.binomial(pairs, p_in)
        if count:
            a = m[rng.randint(0, s, count)]
            b = m[rng.randint(0, s, count)]
            chunks.append((a, b))
    # inter-community: global background
    total_pairs = num_nodes * (num_nodes - 1) // 2
    count = rng.binomial(total_pairs, p_out)
    if count:
        a = rng.randint(0, num_nodes, count)
        b = rng.randint(0, num_nodes, count)
        chunks.append((a, b))
    a = np.concatenate([c[0] for c in chunks])
    b = np.concatenate([c[1] for c in chunks])
    n, u, v = renumber_dedup_shuffle(a, b, shuffle_seed=seed + 1)
    if not return_labels:
        return n, u, v
    # renumbered id i corresponds to original vertex uniq[i] (the same
    # unique-sort renumbering renumber_dedup_shuffle applies)
    keep = a != b
    uniq = np.unique(np.concatenate([a[keep], b[keep]]))
    return n, u, v, labels[uniq]


def synthetic_powerlaw_edges(
    num_nodes: int,
    avg_degree: float,
    exponent: float = 2.7,
    max_degree: Optional[int] = None,
    num_communities: int = 0,
    intra_fraction: float = 0.85,
    seed: int = 0,
    return_labels: bool = False,
):
    """Degree-realistic surrogate graph: a degree-corrected planted
    partition whose degree sequence follows a truncated power law.

    The uniform (``synthetic_edges``) and planted-partition
    (``synthetic_sbm_edges``) generators both produce near-regular
    degrees (bench graph max_fan_out = 23) — nothing like the
    heavy-tailed SNAP graphs the reference's experiments target
    (com-DBLP max degree ~343, com-LiveJournal ~14k), whose hubs
    stress ``max_batch_edges`` (NodeLink returns EVERY edge of a
    pivot, sample.cc:129), NodeLink weighting, and the adjacency-
    matrix membership backend's N*max_degree*4B budget. This generator
    fills that gap for the zero-egress image: per-node propensities
    theta_i ~ 1 + Pareto(exponent-1), capped so the maximum EXPECTED
    degree lands near ``max_degree``; edges draw endpoints ∝ theta
    (a Chung-Lu / configuration-model law), with ``intra_fraction`` of
    them constrained inside ``num_communities`` planted communities
    (degree-corrected SBM) so held-out perplexity has real structure
    to learn. Returns renumbered, deduped, canonical edges like every
    other generator (isolated nodes dropped — SNAP ETL parity,
    data.cc:36-78); with ``return_labels`` also the community label
    per renumbered node id.
    """
    rng = np.random.RandomState(seed)
    theta = rng.pareto(exponent - 1.0, num_nodes) + 1.0
    if max_degree is not None:
        for _ in range(4):
            scale = avg_degree * num_nodes / theta.sum()
            theta = np.minimum(theta, max_degree / scale)
    p_global = theta / theta.sum()
    total = int(num_nodes * avg_degree) // 2
    a = rng.choice(num_nodes, size=total, p=p_global)
    if num_communities and num_communities > 1:
        labels = rng.randint(0, num_communities, num_nodes)
        b = rng.choice(num_nodes, size=total, p=p_global)
        intra = rng.rand(total) < intra_fraction
        # redirect intra edges' second endpoint into a's community,
        # endpoint ∝ theta within the community. Vectorized group-by:
        # nodes sorted by label form contiguous segments; a uniform
        # draw in a segment's cumulative-theta mass + searchsorted is
        # the ∝-theta member draw (the per-community python loop this
        # replaces was O(num_communities * N) — ~25 min at
        # LiveJournal scale, seconds now)
        order = np.argsort(labels, kind="stable")
        lab_sorted = labels[order]
        cum = np.cumsum(theta[order])
        cum0 = np.concatenate([[0.0], cum])
        seg_lo = np.searchsorted(lab_sorted, np.arange(num_communities))
        seg_hi = np.searchsorted(lab_sorted,
                                 np.arange(num_communities) + 1)
        c_edge = labels[a]
        lo, hi = seg_lo[c_edge], seg_hi[c_edge]
        redir = intra & (hi - lo >= 2)     # singleton communities keep
        #                                    the global draw (old skip)
        r = rng.rand(int(redir.sum()))
        mass = cum0[lo[redir]] + r * (cum0[hi[redir]] - cum0[lo[redir]])
        pos = np.searchsorted(cum, mass, side="left")
        pos = np.clip(pos, lo[redir], hi[redir] - 1)
        b[redir] = order[pos]
    else:
        labels = np.zeros(num_nodes, np.int64)
        b = rng.choice(num_nodes, size=total, p=p_global)
    n, u, v = renumber_dedup_shuffle(a, b, shuffle_seed=seed + 1)
    if not return_labels:
        return n, u, v
    keep = a != b
    uniq = np.unique(np.concatenate([a[keep], b[keep]]))
    return n, u, v, labels[uniq]


@dataclasses.dataclass
class DataSplit:
    """Training / held-out split plus the held-out evaluation edge list.

    ``heldout_edges_*`` holds heldout_len real edges followed by an equal
    count of sampled non-edges, exactly the evaluation population of
    data.cc:80-128. Membership of an evaluation edge in the *held-out set*
    (the real half) provides the link/non-link label during perplexity
    (perplexity.cc:47).
    """

    num_nodes: int
    training_u: np.ndarray
    training_v: np.ndarray
    heldout_u: np.ndarray      # real held-out edges only
    heldout_v: np.ndarray
    heldout_edges_u: np.ndarray  # real + fake, evaluation population
    heldout_edges_v: np.ndarray
    total_edges: int             # E = |unique edges| pre-split (main.cc:154)


def generate_sets(
    num_nodes: int,
    u: np.ndarray,
    v: np.ndarray,
    heldout_ratio: float,
    seed: int = 12345,
) -> DataSplit:
    """Split shuffled unique edges into training/held-out + fake non-edges.

    training_len = ceil((1 - ratio/2) * E); the held-out set takes the
    first E - training_len edges; fakes are uniform non-edges excluded
    from training, held-out, and each other (data.cc:86-127).
    """
    e = len(u)
    training_len = int(np.ceil((1.0 - heldout_ratio / 2.0) * e))
    heldout_len = e - training_len
    heldout_u, heldout_v = u[:heldout_len], v[:heldout_len]
    training_u, training_v = u[heldout_len:], v[heldout_len:]

    all_packed = pack_edges(u, v)  # excludes fakes from ALL real edges
    existing = set(all_packed.tolist())
    rng = np.random.RandomState(seed)
    fake_u = np.empty(heldout_len, VERTEX_DTYPE)
    fake_v = np.empty(heldout_len, VERTEX_DTYPE)
    count = 0
    rounds = 0
    while count < heldout_len:
        rounds += 1
        if rounds > 200:
            # near-complete graphs may not HAVE heldout_len distinct
            # non-edges; fail loudly instead of spinning (the same
            # retry-budget discipline as the minibatch samplers)
            raise ValueError(
                f"generate_sets: found only {count}/{heldout_len} fake "
                "non-edges after 200 rejection rounds — the graph is "
                "too dense for this heldout_ratio")
        need = heldout_len - count
        # oversample; rejection for self-loops / existing / duplicates
        ra = rng.randint(0, num_nodes, size=2 * need + 16)
        rb = rng.randint(0, num_nodes, size=2 * need + 16)
        keep = ra != rb
        ra, rb = ra[keep], rb[keep]
        cu, cv = canonicalize(ra, rb)
        for x, y in zip(cu, cv):
            key = int(pack_edges(x, y))
            if key in existing:
                continue
            existing.add(key)
            fake_u[count], fake_v[count] = x, y
            count += 1
            if count == heldout_len:
                break

    return DataSplit(
        num_nodes=num_nodes,
        training_u=training_u,
        training_v=training_v,
        heldout_u=heldout_u,
        heldout_v=heldout_v,
        heldout_edges_u=np.concatenate([heldout_u, fake_u]).astype(VERTEX_DTYPE),
        heldout_edges_v=np.concatenate([heldout_v, fake_v]).astype(VERTEX_DTYPE),
        total_edges=e,
    )


def make_training_ppx_edges(
    split: DataSplit, ratio: float, seed: int = 777
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluation population for TRAINING perplexity
    (MakeEdgesForTrainingPerplexity, /root/reference/mcmc/learner.cc:48-74):
    num_links = ratio * |training edges| real training edges, plus
    num_links * (N(N-1)/2) / E sampled non-edges (outside training and
    held-out)."""
    n = split.num_nodes
    e = split.total_edges
    total = n * (n - 1) // 2
    num_links = int(ratio * len(split.training_u))
    num_non_links = int(num_links * total / float(e))
    eu = [split.training_u[:num_links]]
    ev = [split.training_v[:num_links]]
    existing = set(pack_edges(
        np.concatenate([split.training_u, split.heldout_u]),
        np.concatenate([split.training_v, split.heldout_v]),
    ).tolist())
    rng = np.random.RandomState(seed)
    fu = np.empty(num_non_links, VERTEX_DTYPE)
    fv = np.empty(num_non_links, VERTEX_DTYPE)
    count = 0
    rounds = 0
    while count < num_non_links:
        rounds += 1
        if rounds > 200:
            raise ValueError(
                f"make_training_ppx_edges: found only {count}/"
                f"{num_non_links} non-edges after 200 rejection rounds "
                "— the graph is too dense for this ratio")
        need = num_non_links - count
        ra = rng.randint(0, n, size=2 * need + 16)
        rb = rng.randint(0, n, size=2 * need + 16)
        keep = ra != rb
        cu, cv = canonicalize(ra[keep], rb[keep])
        for x, y in zip(cu, cv):
            if int(pack_edges(x, y)) in existing:
                continue
            fu[count], fv[count] = x, y
            count += 1
            if count == num_non_links:
                break
    eu.append(fu)
    ev.append(fv)
    return (np.concatenate(eu).astype(VERTEX_DTYPE),
            np.concatenate(ev).astype(VERTEX_DTYPE))


def dump_dataset(path: str, num_nodes: int, heldout_ratio: float,
                 u: np.ndarray, v: np.ndarray, fmt: str = "npz") -> None:
    """Compressed dataset cache (parity of main.cc:109-126's gzip dump).

    ``fmt="npz"`` (default) is the native cache; ``fmt="ref"`` writes
    the reference's exact on-disk layout — a gzip stream of uint64 N,
    float32 heldout_ratio, uint64 count, then count little-endian
    uint64 (u<<32|v)-packed edges (main.cc:110-126, types.h:66-74,
    config.h:30,38) — byte-interoperable with files produced or
    consumed by the reference's --dump-data/--load-data."""
    if fmt == "ref":
        packed = np.ascontiguousarray(pack_edges(u, v), "<u8")
        with gzip.open(path, "wb") as f:
            f.write(np.uint64(num_nodes).astype("<u8").tobytes())
            f.write(np.float32(heldout_ratio).astype("<f4").tobytes())
            f.write(np.uint64(packed.size).astype("<u8").tobytes())
            f.write(packed.tobytes())
        return
    if fmt != "npz":
        raise ValueError(f"unknown dataset cache format {fmt!r}")
    np.savez_compressed(
        path,
        num_nodes=np.int64(num_nodes),
        heldout_ratio=np.float64(heldout_ratio),
        edges=pack_edges(u, v),
    )


def load_dataset(path: str) -> Tuple[int, float, np.ndarray, np.ndarray]:
    """Load a cached dataset (parity of main.cc:127-149).

    The format is sniffed from the file magic: PK (zip) -> npz cache,
    1f 8b (gzip) -> the reference's binary layout (see dump_dataset)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            head = f.read(20)
            if len(head) != 20:
                raise IOError(f"{path}: truncated reference cache header")
            num_nodes = int(np.frombuffer(head[0:8], "<u8")[0])
            ratio = float(np.frombuffer(head[8:12], "<f4")[0])
            count = int(np.frombuffer(head[12:20], "<u8")[0])
            body = f.read(count * 8)
            if len(body) != count * 8:
                raise IOError(f"{path}: reference cache holds "
                              f"{len(body) // 8} edges, header says "
                              f"{count}")
            u, v = unpack_edges(np.frombuffer(body, "<u8"))
        return num_nodes, ratio, u, v
    z = np.load(path)
    u, v = unpack_edges(z["edges"])
    return int(z["num_nodes"]), float(z["heldout_ratio"]), u, v
