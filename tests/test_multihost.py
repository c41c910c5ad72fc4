"""Multi-host subsystem tests.

The ETL pieces (byte-range parsing, shared-vocabulary renumbering,
per-shard CSR) are pure host code tested directly; the distributed
execution path runs as a REAL 2-process jax.distributed job (gloo CPU
collectives) driving ShardedLearner on a global (2 data x 2 model) mesh
— the closest a single machine gets to a pod."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mcmc_ammsb.data import Graph, load_snap_edges, synthetic_edges
from mcmc_ammsb.parallel import multihost

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def snap_file(tmp_path_factory):
    """A SNAP-format edge list with comment headers and raw (sparse,
    unrenumbered) vertex ids."""
    rng = np.random.RandomState(11)
    n_raw = 500
    ids = rng.choice(100_000, size=n_raw, replace=False)
    a = rng.randint(0, n_raw, 3000)
    b = rng.randint(0, n_raw, 3000)
    keep = a != b
    lines = ["# Directed graph (each unordered pair once)",
             "# Nodes: x Edges: y", "# extra comment", "# FromNodeId\tToNodeId"]
    lines += [f"{ids[x]}\t{ids[y]}" for x, y in zip(a[keep], b[keep])]
    p = tmp_path_factory.mktemp("mh") / "graph.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_byte_ranges_partition_exactly(snap_file):
    size = os.path.getsize(snap_file)
    for k in (1, 2, 3, 7):
        ranges = multihost.byte_ranges(snap_file, k)
        assert ranges[0][0] == 0 and ranges[-1][1] == size
        for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
            assert a1 == b0  # contiguous, no gap/overlap
        # every cut is a line boundary
        with open(snap_file, "rb") as f:
            data = f.read()
        for start, _ in ranges[1:]:
            assert start == 0 or data[start - 1:start] == b"\n"


def test_range_parses_union_to_full_load(snap_file):
    full_u, full_v = multihost.load_snap_edges_range(
        snap_file, 0, os.path.getsize(snap_file))
    for k in (2, 3, 5):
        parts = [multihost.load_snap_edges_range(snap_file, s, e)
                 for s, e in multihost.byte_ranges(snap_file, k)]
        u = np.concatenate([p[0] for p in parts])
        v = np.concatenate([p[1] for p in parts])
        # same multiset of canonical pairs, order-independent
        key = lambda x, y: np.sort(x.astype(np.int64) * 200_000 + y)
        np.testing.assert_array_equal(key(u, v), key(full_u, full_v))


def test_renumber_matches_single_host_loader(snap_file):
    """Byte-range parse + shared-vocab renumber reproduces the
    single-host loader's edge set exactly (data.cc:36-78 semantics)."""
    n_ref, ur, vr = load_snap_edges(snap_file)
    raw_u, raw_v = multihost.load_snap_edges_range(
        snap_file, 0, os.path.getsize(snap_file))
    vocab = multihost.global_vocab(np.concatenate([raw_u, raw_v]))
    assert len(vocab) == n_ref
    u, v = multihost.renumber_edges(raw_u, raw_v, vocab)
    ref = set(zip(ur.tolist(), vr.tolist()))
    got = set(zip(u.tolist(), v.tolist()))
    assert got == ref  # loader dedups; range loader keeps raw lines


def test_shard_csr_concatenates_to_full_graph():
    n, u, v = synthetic_edges(300, 8, seed=5)
    graph = Graph.from_edges(n, u, v)
    cuts = [0, 77, 150, 300]
    all_offsets, all_cols = [], []
    for lo, hi in zip(cuts, cuts[1:]):
        offs, cols = multihost.shard_csr(n, u, v, lo, hi)
        assert len(offs) == hi - lo + 1
        for r in range(lo, hi):
            got = np.sort(cols[offs[r - lo]:offs[r - lo + 1]])
            ref = np.sort(graph.cols[graph.offsets[r]:graph.offsets[r + 1]])
            np.testing.assert_array_equal(got, ref)


_WORKER = """
import os, sys
proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from mcmc_ammsb.parallel import multihost
multihost.initialize(coordinator_address=f"localhost:{{port}}",
                     num_processes=nproc, process_id=proc_id)
assert jax.process_count() == nproc
mesh = multihost.global_mesh(n_model=2)
assert dict(mesh.shape) == {{"data": 2, "model": 2}}

import numpy as np
# cross-process vocabulary from disjoint local id sets
local = np.asarray([10, 20, 30]) + 100 * proc_id
vocab = multihost.global_vocab(local)
assert vocab.tolist() == [10, 20, 30, 110, 120, 130], vocab

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.parallel import ShardedLearner
n, u, v = synthetic_edges(256, 8, seed=33)
split = generate_sets(n, u, v, heldout_ratio=0.1, seed=34)
graph = Graph.from_edges(n, split.training_u, split.training_v)
cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
             device_sampling=True, steps_per_call=5)
cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
lrn = ShardedLearner(cfg, graph, split, mesh)
p0 = lrn.heldout_perplexity()
lrn.run(10)
p1 = lrn.heldout_perplexity()
assert np.isfinite([p0, p1]).all() and p1 < p0, (p0, p1)
assert int(lrn.state.step_count) == 11
print(f"MH_OK proc={{proc_id}} ppx {{p0:.6f}} -> {{p1:.6f}}", flush=True)
"""


def test_two_process_distributed_sharded_learner(tmp_path):
    """REAL jax.distributed: 2 processes x 2 local CPU devices, global
    (2,2) mesh, fused device-sampled sharded training — both processes
    must finish, improve perplexity, and agree exactly."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    port = "39411"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [next(l for l in out.splitlines() if l.startswith("MH_OK"))
             for out, _ in outs]
    # both processes computed the identical trajectory
    assert lines[0].split("ppx")[1] == lines[1].split("ppx")[1]
