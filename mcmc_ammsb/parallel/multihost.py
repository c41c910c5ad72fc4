"""Multi-host (pod-scale) execution: process init, global meshes, and
host-local dataset ingestion.

The reference is single-process (SURVEY.md §2: no distributed backend);
this module is the multi-host story for the com-Friendster-scale rung
of the config ladder (BASELINE.md). The sharded step in
parallel/sharded.py is topology-agnostic — on a global mesh XLA routes
the 'model' psum/all_gather over NVLink within a host and the network
across hosts — so multi-host adds exactly three things:

  * ``initialize()``            — jax.distributed process wiring (with
                                  gloo collectives on the CPU backend,
                                  which is how the 2-process test in
                                  tests/test_multihost.py runs it);
  * ``global_mesh()``           — ('data', 'model') mesh over every
                                  process's devices, model axis kept
                                  host-local so pi-row fetches stay on
                                  the host's links;
  * byte-range ETL              — each host parses only its slice of a
                                  billion-edge SNAP file
                                  (``byte_ranges`` +
                                  ``load_snap_edges_range``), renumbers
                                  against a shared vocabulary
                                  (``renumber_edges``), and builds only
                                  the CSR rows its model shard owns
                                  (``shard_csr``). Splitting semantics
                                  match the single-host loader
                                  (/root/reference/mcmc/data.cc:36-78:
                                  skip comments, dedup, u<v canonical).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np

from mcmc_ammsb.parallel.mesh import DATA_AXIS, MODEL_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process).

    Pass all three arguments: nothing in the environment describes the
    cluster. When the coordinator is this host (``localhost:<port>``)
    every process runs on this host, and process i binds card i
    (``local_device_ids``), so no two processes claim one card. On the
    CPU backend the gloo collectives implementation is selected so
    cross-process psum / all_gather actually execute (verified by the
    2-process test)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    host = (coordinator_address or "").rsplit(":", 1)[0]
    one_host = host in ("localhost", "127.0.0.1", "[::1]")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=[process_id] if one_host else None,
    )


def global_mesh(n_model: Optional[int] = None) -> jax.sharding.Mesh:
    """('data', 'model') mesh over ALL processes' devices.

    The model axis is kept within a host's devices when possible so pi
    row fetches (psum over 'model') stay on the host's links; the data
    axis then spans hosts and only the small gradient psums cross the
    network."""
    devices = jax.devices()  # global across processes
    n = len(devices)
    per_host = max(1, jax.local_device_count())
    if n_model is None:
        n_model = min(per_host, 4)
        while n % n_model:
            n_model //= 2
    n_data = n // n_model
    return jax.make_mesh((n_data, n_model), (DATA_AXIS, MODEL_AXIS),
                         devices=devices)


# ---------------------------------------------------------------------------
# Host-local ETL: byte-range parsing + per-shard CSR
# ---------------------------------------------------------------------------

def byte_ranges(path: str, num_ranges: int) -> list:
    """Split a text file into ``num_ranges`` newline-aligned [start, end)
    byte ranges that exactly partition it: range i starts at the first
    line boundary at-or-after i * size/num_ranges. Every line belongs to
    exactly one range, so per-host parses union to the full file."""
    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for i in range(1, num_ranges):
            target = (size * i) // num_ranges
            f.seek(target)
            f.readline()  # skip to the end of the straddling line
            cuts.append(min(f.tell(), size))
    cuts.append(size)
    # de-duplicate (tiny files can collapse ranges to empty)
    return [(cuts[i], cuts[i + 1]) for i in range(num_ranges)]


def load_snap_edges_range(path: str, start: int,
                          end: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the SNAP edge lines whose first byte lies in [start, end).

    Returns RAW (unrenumbered) endpoint arrays; self-loops dropped,
    pairs canonicalized to u < v — the same per-line semantics as the
    whole-file loader (data.py load_snap_edges, parity of
    /root/reference/mcmc/data.cc:36-78). ``start`` must be a line
    boundary (use byte_ranges)."""
    us, vs = [], []
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        while pos < end:
            line = f.readline()
            if not line:
                break
            pos += len(line)
            if line.startswith(b"#") or line.startswith(b"%"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            a, b = int(parts[0]), int(parts[1])
            if a == b:
                continue
            us.append(min(a, b))
            vs.append(max(a, b))
    return (np.asarray(us, np.int64), np.asarray(vs, np.int64))


def global_vocab(local_ids: np.ndarray) -> np.ndarray:
    """Shared vocabulary: sorted unique original vertex ids across all
    processes. Single-process: just the local uniques. Multi-process:
    exchanged through the jax.distributed KV store via a fixed-width
    allgather (ids are metadata-sized — ~N entries — not edge-sized)."""
    local = np.unique(local_ids)
    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    # pad to the global max length, allgather, re-unique
    n_local = np.int64(len(local))
    max_len = int(multihost_utils.process_allgather(n_local).max())
    padded = np.full(max_len, -1, np.int64)
    padded[: len(local)] = local
    gathered = multihost_utils.process_allgather(padded)
    flat = gathered.reshape(-1)
    return np.unique(flat[flat >= 0])


def renumber_edges(u_raw: np.ndarray, v_raw: np.ndarray,
                   vocab: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map raw vertex ids to [0, N) positions in the shared vocabulary
    (the multi-host analog of the single-host renumbering in
    data.py / data.cc:49-66)."""
    u = np.searchsorted(vocab, u_raw).astype(np.int32)
    v = np.searchsorted(vocab, v_raw).astype(np.int32)
    return np.minimum(u, v), np.maximum(u, v)


def shard_csr(num_nodes: int, u: np.ndarray, v: np.ndarray,
              row_lo: int, row_hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR adjacency restricted to owned rows [row_lo, row_hi).

    offsets has row_hi - row_lo + 1 entries (local row indexing); cols
    are GLOBAL node ids. Concatenating all shards' adjacency lists
    reproduces the full-graph CSR (asserted by test_multihost.py) —
    the per-shard generalization of Graph.from_edges."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    keep = (src >= row_lo) & (src < row_hi)
    src = src[keep] - row_lo
    dst = dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=row_hi - row_lo)
    offsets = np.zeros(row_hi - row_lo + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst.astype(np.int32)
