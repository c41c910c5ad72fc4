"""Partitioned (multi-host capacity) path tests.

The end-to-end contract: a ShardedLearner built from
per-shard ingest — model-row-sharded CSR for BOTH membership and
sampling adjacency, no host Graph anywhere — reproduces the
replicated-graph engine's trajectory bit-for-bit, and no process ever
materializes the full edge list. Single-process tests run on the
8-device virtual mesh; the 2-process test is a REAL jax.distributed
job with the model axis spanning processes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import synthetic_edges
from mcmc_ammsb.parallel import ShardedLearner, make_mesh
from mcmc_ammsb.parallel.mesh import MODEL_AXIS
from mcmc_ammsb.parallel.partitioned import (ShardedCSR,
                                             build_sharded_csr,
                                             heldout_link_mask,
                                             partitioned_ingest,
                                             to_datasplit)

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_pdata(n_nodes=256, deg=8, seed=33, n_data=2, n_model=4,
               heldout_ratio=0.1):
    n, u, v = synthetic_edges(n_nodes, deg, seed=seed)
    mesh = make_mesh(n_data, n_model)
    pdata = partitioned_ingest(mesh, heldout_ratio=heldout_ratio,
                               seed=7, edges=(u, v), num_nodes=n)
    return mesh, pdata, (n, u, v)


def test_hash_split_deterministic_and_ratio():
    n, u, v = synthetic_edges(400, 10, seed=3)
    m1 = heldout_link_mask(u, v, 0.2, seed=9)
    m2 = heldout_link_mask(u, v, 0.2, seed=9)
    np.testing.assert_array_equal(m1, m2)          # deterministic
    # order-independent: a shuffled view picks the same edges
    perm = np.random.RandomState(0).permutation(len(u))
    m3 = heldout_link_mask(u[perm], v[perm], 0.2, seed=9)
    np.testing.assert_array_equal(m3, m1[perm])
    # ratio/2 selection probability, binomially realized
    frac = m1.mean()
    assert 0.05 < frac < 0.15, frac
    # different seed, different realization
    assert (heldout_link_mask(u, v, 0.2, seed=10) != m1).any()


def test_ingest_reconstructs_graph_and_split():
    mesh, pdata, (n, u, v) = make_pdata()
    graph, split = to_datasplit(pdata)
    assert pdata.num_nodes == n
    assert pdata.num_edges == len(u)               # unique input edges
    assert split.total_edges == pdata.num_edges
    assert (len(split.training_u) + len(split.heldout_u)
            == pdata.num_edges)
    assert graph.max_fan_out == pdata.max_fan_out
    # heldout links + training edges == the original edge multiset
    full = set(zip(u.tolist(), v.tolist()))
    got = set(zip(split.training_u.tolist(), split.training_v.tolist()))
    got |= set(zip(split.heldout_u.tolist(), split.heldout_v.tolist()))
    assert got == full
    # fakes are genuine non-edges, distinct from each other
    fakes = set(zip(pdata.fake_u.tolist(), pdata.fake_v.tolist()))
    assert len(fakes) == len(pdata.fake_u) == len(pdata.heldout_u)
    assert not (fakes & full)


def test_sharded_csr_membership_and_adjacency_golden(small_dataset):
    """ShardedCSR's collective has_edges / degree / row_gather answer
    exactly like the replicated structures (python-set membership, the
    _TupleAdj view) — the cuckoo-test.cc pattern for the sharded
    layout."""
    from mcmc_ammsb.ops.device_sampling import _TupleAdj
    from mcmc_ammsb.data import Graph

    n, split, graph = small_dataset
    mesh = make_mesh(2, 4)
    pdata = partitioned_ingest(mesh, heldout_ratio=0.0, seed=3,
                               edges=(split.training_u,
                                      split.training_v),
                               num_nodes=n)
    rows_per_shard = -(-n // 4)
    scsr = build_sharded_csr(mesh, n, rows_per_shard, pdata.shards,
                             pdata.cols_cap)

    rng = np.random.RandomState(5)
    qu = rng.randint(0, n, 512).astype(np.int32)
    qv = rng.randint(0, n, 512).astype(np.int32)

    def member(csr, u, v):
        return csr.has_edges(u, v)

    got = jax.jit(jax.shard_map(
        member, mesh=mesh, in_specs=(scsr.spec(), P(), P()),
        out_specs=P(), check_vma=False))(scsr, jnp.asarray(qu),
                                         jnp.asarray(qv))
    ref = set(zip(split.training_u.tolist(), split.training_v.tolist()))
    want = np.array([(min(a, b), max(a, b)) in ref
                     for a, b in zip(qu.tolist(), qv.tolist())])
    np.testing.assert_array_equal(np.asarray(got), want)

    # degree + row_gather vs the replicated CSR view
    adj = _TupleAdj(jnp.asarray(graph.offsets, jnp.int32),
                    jnp.asarray(graph.cols, jnp.int32))
    off = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (512, 8))

    def adjview(csr, u, off):
        return csr.degree(u), csr.row_gather(u, off)

    deg_s, row_s = jax.jit(jax.shard_map(
        adjview, mesh=mesh, in_specs=(scsr.spec(), P(), P()),
        out_specs=(P(), P()), check_vma=False))(
            scsr, jnp.asarray(qu), off)
    deg_r = adj.degree(jnp.asarray(qu))
    np.testing.assert_array_equal(np.asarray(deg_s), np.asarray(deg_r))
    # in-row lanes must agree exactly; out-of-row lanes are clamped
    # garbage on both layouts (masked by every consumer)
    row_r = np.asarray(adj.row_gather(jnp.asarray(qu), off))
    in_row = np.arange(8)[None, :] < np.asarray(deg_r)[:, None]
    np.testing.assert_array_equal(np.asarray(row_s)[in_row],
                                  row_r[in_row])


def test_partitioned_matches_replicated_bit_exact():
    """The headline contract: per-shard ingest + sharded-CSR membership
    and sampling reproduce the replicated-graph ShardedLearner's
    trajectory bit-for-bit (psums of one-owner integer contributions
    are exact), including the fused eval series."""
    mesh, pdata, _ = make_pdata()
    graph, split = to_datasplit(pdata)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=40)
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    a = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)
    sa = a.run_with_ppx(40, 10)
    sb = b.run_with_ppx(40, 10)
    assert [e["ppx"] for e in sa] == [e["ppx"] for e in sb]
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.theta),
                                  np.asarray(b.state.theta))
    assert a.heldout_perplexity() == b.heldout_perplexity()
    a.close(); b.close()


def test_partitioned_windowed_matches_replicated():
    """The T-step windowed sharded engine runs on the sharded CSR too
    (membership rides the same has_edges protocol inside the window
    hoisting) — still bit-identical to the replicated windowed run."""
    mesh, pdata, _ = make_pdata()
    graph, split = to_datasplit(pdata)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, shared_neighbors=True,
                 steps_per_call=12, window=4)
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    a = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)
    a.run(12); b.run(12)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    a.close(); b.close()


def test_partitioned_guards():
    mesh, pdata, _ = make_pdata()
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=False)
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    with pytest.raises(ValueError, match="device_sampling"):
        ShardedLearner.from_partitioned(cfg, pdata, mesh)


def test_partitioned_train_ppx_population_bit_equal():
    """make_training_ppx_edges_partitioned reproduces the replicated
    builder's population EXACTLY (same link head in canonical order,
    same RandomState non-link stream) without the host graph
    ( learner.cc:48-74)."""
    from mcmc_ammsb.data import make_training_ppx_edges
    from mcmc_ammsb.parallel.partitioned import (
        make_training_ppx_edges_partitioned)

    mesh, pdata, _ = make_pdata()
    _, split = to_datasplit(pdata)
    for ratio in (0.05, 0.2):
        ru, rv = make_training_ppx_edges(split, ratio)
        pu, pv = make_training_ppx_edges_partitioned(pdata, ratio)
        np.testing.assert_array_equal(pu, ru)
        np.testing.assert_array_equal(pv, rv)


def test_partitioned_train_ppx_series_bit_equal():
    """calc_train_ppx runs in partitioned mode (the one mode aimed at
    the largest runs): the fused train-ppx series and the standalone
    training_perplexity() both bit-equal the replicated engine's."""
    mesh, pdata, _ = make_pdata()
    graph, split = to_datasplit(pdata)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=40,
                 calc_train_ppx=True, training_ppx_ratio=0.1)
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    a = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)
    sa = a.run_with_ppx(40, 10)
    sb = b.run_with_ppx(40, 10)
    assert [e["ppx"] for e in sa] == [e["ppx"] for e in sb]
    assert all("train_ppx" in e for e in sa)
    assert ([e["train_ppx"] for e in sa]
            == [e["train_ppx"] for e in sb])
    assert a.training_perplexity() == b.training_perplexity()
    a.close(); b.close()


@pytest.mark.parametrize("strat", ["BFLink", "BFNonLink", "BF"])
def test_partitioned_bf_family_matches_replicated(strat):
    """The breadth-first family runs in partitioned mode: the device BF
    samplers consume the
    model-row-sharded CSR through the same degree/row_gather/has_edges
    collectives the Node family uses (ops/device_sampling.py takes any
    adjacency with the protocol), so a from_partitioned run is
    bit-identical to the replicated-graph sharded engine on every BF
    strategy (/root/reference/mcmc/sample.cc:177-248 semantics)."""
    from mcmc_ammsb.config import SampleStrategy

    mesh, pdata, _ = make_pdata()
    graph, split = to_datasplit(pdata)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=20,
                 strategy=SampleStrategy.parse(strat))
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    a = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    b = ShardedLearner(cfg, graph, split, mesh)
    sa = a.run_with_ppx(20, 10)
    sb = b.run_with_ppx(20, 10)
    assert [e["ppx"] for e in sa] == [e["ppx"] for e in sb]
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.theta),
                                  np.asarray(b.state.theta))
    a.close(); b.close()


def test_ingest_from_snap_file(tmp_path):
    """The byte-range file path: single-process ingest of a SNAP file
    reproduces the full loader's edge universe (training + heldout
    links == all unique canonical edges)."""
    from mcmc_ammsb.data import load_snap_edges

    rng = np.random.RandomState(11)
    ids = rng.choice(50_000, size=300, replace=False)
    a = rng.randint(0, 300, 2000)
    b = rng.randint(0, 300, 2000)
    keep = a != b
    lines = ["# SNAP header", "# another"]
    lines += [f"{ids[x]}\t{ids[y]}" for x, y in zip(a[keep], b[keep])]
    p = tmp_path / "g.txt"
    p.write_text("\n".join(lines) + "\n")

    n_ref, ur, vr = load_snap_edges(str(p))
    mesh = make_mesh(2, 4)
    pdata = partitioned_ingest(mesh, heldout_ratio=0.1, seed=5,
                               path=str(p))
    assert pdata.num_nodes == n_ref
    assert pdata.num_edges == len(ur)
    graph, split = to_datasplit(pdata)
    full = set(zip(ur.tolist(), vr.tolist()))
    got = set(zip(split.training_u.tolist(), split.training_v.tolist()))
    got |= set(zip(split.heldout_u.tolist(), split.heldout_v.tolist()))
    assert got == full


@pytest.mark.parametrize("strategy", ["Node", "BFLink"])
def test_cli_partitioned_ingest(tmp_path, caplog, strategy):
    """--partitioned-ingest drives the full capacity path from the
    command line (single process, virtual mesh): byte-range parse,
    hash split, sharded-CSR learner, decreasing ppx series. The
    BFLink variant pins the CLI plumbing for the breadth-first family
    in partitioned mode (fast defaults route BF to device sampling,
    which partitioned mode requires)."""
    import logging

    from mcmc_ammsb import cli

    rng = np.random.RandomState(13)
    ids = rng.choice(40_000, size=300, replace=False)
    a = rng.randint(0, 300, 2400)
    b = rng.randint(0, 300, 2400)
    keep = a != b
    lines = ["# SNAP"]
    lines += [f"{ids[x]}\t{ids[y]}" for x, y in zip(a[keep], b[keep])]
    p = tmp_path / "g.txt"
    p.write_text("\n".join(lines) + "\n")

    with caplog.at_level(logging.INFO, logger="mcmc_ammsb"):
        rc = cli.main(["--file", str(p), "--partitioned-ingest",
                       "--mesh", "2,4", "-k", "8", "-m", "8", "-n", "4",
                       "-s", strategy,
                       "--heldout-ratio", "0.1", "-x", "20", "-i", "10",
                       "--steps-per-call", "5"])
    assert rc == 0
    out = caplog.text
    assert "partitioned ingest" in out
    assert "full graph never materialized" in out
    assert "ppx[0]" in out and "ppx[20]" in out


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

import numpy as np
from jax.sharding import Mesh
# model axis ACROSS processes: each process owns exactly one model
# shard's rows — the capacity layout the ingest is built for
devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
grid = np.array([[devs[0], devs[2]], [devs[1], devs[3]]])
mesh = Mesh(grid, ("data", "model"))

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import synthetic_edges
from mcmc_ammsb.parallel import ShardedLearner
from mcmc_ammsb.parallel.partitioned import partitioned_ingest

n, u, v = synthetic_edges(256, 8, seed=33)
E = len(u)
# each process "parses" a disjoint half of the edge list (the
# byte-range analogue for a synthetic graph)
half = E // 2
lo, hi = (0, half) if proc_id == 0 else (half, E)
pdata = partitioned_ingest(mesh, heldout_ratio=0.1, seed=7,
                           edges=(u[lo:hi], v[lo:hi]), num_nodes=n)
assert pdata.num_edges == E, (pdata.num_edges, E)
# memory contract: this process never held the full edge list — it
# parsed half and kept only the edges touching its shard's rows
assert pdata.local_parse_edges == hi - lo < E
assert pdata.max_shard_edges < E, (pdata.max_shard_edges, E)
assert sorted(pdata.shards) == [proc_id], pdata.shards

cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
             device_sampling=True, steps_per_call=5)
cfg = cfg.finalize(n, pdata.num_edges, pdata.max_fan_out)
lrn = ShardedLearner.from_partitioned(cfg, pdata, mesh)
p0 = lrn.heldout_perplexity()
lrn.run(10)
p1 = lrn.heldout_perplexity()
assert np.isfinite([p0, p1]).all() and p1 < p0, (p0, p1)
assert int(lrn.state.step_count) == 11
print(f"PART_OK proc={{proc_id}} ppx {{p0:.6f}} -> {{p1:.6f}}",
      flush=True)
"""


def test_two_process_partitioned_end_to_end(tmp_path):
    """REAL jax.distributed 2-process run: per-process byte-range-style
    ingest, one model shard per process, fused device-sampled training
    on the sharded CSR. Both processes finish, improve perplexity,
    agree exactly — and the memory telemetry proves no process held
    the full graph."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    port = "39413"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [next(l for l in out.splitlines() if l.startswith("PART_OK"))
             for out, _ in outs]
    assert lines[0].split("ppx")[1] == lines[1].split("ppx")[1]


def test_partitioned_resume_bit_exact(tmp_path):
    """a partitioned run can be killed and resumed to
    the same trajectory. Save at step 20 (orbax: the pod backend,
    per-host shard writes), restore into a FRESH from_partitioned
    learner, run 20 more — bit-identical to an uninterrupted 40-step
    run (the serialize-test.cc:90-134 EndToEnd contract)."""
    mesh, pdata, _ = make_pdata()
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 device_sampling=True, steps_per_call=10)
    cfg = cfg.finalize(pdata.num_nodes, pdata.num_edges,
                       pdata.max_fan_out)
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint

    straight = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    straight.run(40)

    a = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    a.run(20)
    ck = str(tmp_path / "part_ck")
    save_checkpoint(ck, a, backend="orbax")
    a.close()

    b = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    load_checkpoint(ck, b)
    assert int(b.state.step_count) == int(straight.state.step_count) - 40 + 20
    b.run(20)
    np.testing.assert_array_equal(np.asarray(b.state.pi),
                                  np.asarray(straight.state.pi))
    np.testing.assert_array_equal(np.asarray(b.state.theta),
                                  np.asarray(straight.state.theta))
    assert (b.heldout_perplexity()
            == straight.heldout_perplexity())
    straight.close(); b.close()


def test_cli_partitioned_restore_and_interval(tmp_path, caplog):
    """_main_partitioned drives --checkpoint-interval, --restore and
    --profile from the command line (a pod run can resume)."""
    import logging

    from mcmc_ammsb import cli

    rng = np.random.RandomState(17)
    ids = rng.choice(40_000, size=300, replace=False)
    a = rng.randint(0, 300, 2400)
    b = rng.randint(0, 300, 2400)
    keep = a != b
    lines = ["# SNAP"]
    lines += [f"{ids[x]}\t{ids[y]}" for x, y in zip(a[keep], b[keep])]
    p = tmp_path / "g.txt"
    p.write_text("\n".join(lines) + "\n")
    ck = str(tmp_path / "cli_part_ck")

    base = ["--file", str(p), "--partitioned-ingest", "--mesh", "2,4",
            "-k", "8", "-m", "8", "-n", "4", "--heldout-ratio", "0.1",
            "-i", "10", "--steps-per-call", "5",
            "--checkpoint", ck, "--checkpoint-backend", "orbax"]
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb"):
        rc = cli.main(base + ["-x", "20", "--checkpoint-interval", "10"])
    assert rc == 0
    out = caplog.text
    assert "[async]" in out           # periodic orbax saves are async
    caplog.clear()

    with caplog.at_level(logging.INFO, logger="mcmc_ammsb"):
        rc = cli.main(base + ["-x", "10", "--restore", ck, "--profile"])
    assert rc == 0
    out = caplog.text
    assert "restored checkpoint" in out
    assert "(step=21)" in out         # 20 steps + initial step 1
    assert "ppx[10]" in out
