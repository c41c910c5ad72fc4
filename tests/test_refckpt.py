"""Reference-checkpoint interop (refckpt.py): round-trip on a
synthetically written reference-format file — the
byte layout of /root/reference/mcmc/serialize.h:13-113 +
learner.cc:301-330, parsed without protoc by the minimal wire codec.
"""

import numpy as np

import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.refckpt import (ReferenceLayout, ReferenceParseError,
                                parse_fields, encode_bytes,
                                encode_double, encode_varint,
                                read_reference_checkpoint,
                                simulate_reference_parse,
                                to_train_state,
                                write_reference_checkpoint)


def test_wire_codec_roundtrip():
    msg = (encode_varint(1, 12345) + encode_double(2, -3.5)
           + encode_bytes(3, b"\x00\x01payload")
           + encode_varint(4, 2**40))
    fields = parse_fields(msg)
    assert fields[1] == [12345]
    assert fields[2] == [-3.5]
    assert fields[3] == [b"\x00\x01payload"]
    assert fields[4] == [2**40]


def _fake_state(n=50, k=8, h=12, seed=0):
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    phi = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    theta = rng.gamma(1.0, 1.0, size=(k, 2)).astype(np.float32)
    beta = (theta[:, 1] / theta.sum(-1)).astype(np.float32)
    ppx = rng.uniform(0.1, 0.9, size=h).astype(np.float32)
    seeds = rng.randint(0, 2**31, size=(64, 4)).astype(np.uint32)
    return dict(pi=pi, phi_sum=phi, theta=theta, beta=beta,
                ppx_per_edge=ppx, phi_seeds=seeds,
                beta_seeds=seeds[::-1].copy())


def test_reference_checkpoint_roundtrip(tmp_path):
    st = _fake_state()
    path = str(tmp_path / "ref.ckpt")
    write_reference_checkpoint(
        path, theta=st["theta"], beta=st["beta"], pi=st["pi"],
        phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
        phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
        step_count=321, beta_count=320, phi_count=320, ppx_count=4,
        weight=50.0)
    raw = read_reference_checkpoint(path)
    np.testing.assert_array_equal(raw["pi"], st["pi"])
    np.testing.assert_array_equal(raw["phi_sum"], st["phi_sum"])
    np.testing.assert_array_equal(raw["theta"], st["theta"])
    np.testing.assert_array_equal(raw["beta"], st["beta"])
    np.testing.assert_array_equal(raw["ppx_per_edge"],
                                  st["ppx_per_edge"])
    # rng seed buffers survive the ulong2 <-> uint32[4] conversion
    np.testing.assert_array_equal(raw["phi_seeds"], st["phi_seeds"])
    np.testing.assert_array_equal(raw["beta_seeds"], st["beta_seeds"])
    assert raw["step_count"] == 321
    assert raw["beta_count"] == 320
    assert raw["ppx_count"] == 4
    assert raw["weight"] == 50.0
    # interleaved layouts match the reference accessors
    np.testing.assert_array_equal(raw["beta_interleaved"][1::2],
                                  st["beta"])


def test_reference_checkpoint_multi_block_rpm(tmp_path):
    """pi split across several row blocks (the RowPartitionedMatrix
    case the format exists for, partitioned-alloc.h:87-120) parses to
    the same matrix."""
    st = _fake_state(n=53, k=8)   # ragged last block
    path = str(tmp_path / "ref_rpm.ckpt")
    write_reference_checkpoint(
        path, theta=st["theta"], beta=st["beta"], pi=st["pi"],
        phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
        phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
        rows_in_block=16)
    raw = read_reference_checkpoint(path)
    np.testing.assert_array_equal(raw["pi"], st["pi"])


@pytest.mark.slow
def test_reference_checkpoint_into_train_state(tmp_path):
    """The importer produces a TrainState the evaluator accepts: a
    Learner scoring held-out perplexity on the imported state runs and
    carries the imported counters."""
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.learner import Learner

    n, u, v = synthetic_edges(50, 6, seed=4)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=5)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=4).finalize(
        n, split.total_edges, graph.max_fan_out)
    h = len(split.heldout_edges_u)

    st = _fake_state(n=n, k=8, h=h)
    path = str(tmp_path / "ref_state.ckpt")
    write_reference_checkpoint(
        path, theta=st["theta"], beta=st["beta"], pi=st["pi"],
        phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
        phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
        step_count=100, beta_count=99, ppx_count=2)
    raw = read_reference_checkpoint(path)
    state = to_train_state(cfg, raw, h)
    assert int(state.step_count) == 100
    assert int(state.ppx_count) == 2
    np.testing.assert_array_equal(np.asarray(state.pi), st["pi"])

    lrn = Learner(cfg, graph, split, prefetch=False)
    lrn.state = state
    ppx = lrn.heldout_perplexity()
    assert np.isfinite(ppx)
    assert int(lrn.state.ppx_count) == 3   # running average continued
    lrn.run(4)
    assert int(lrn.state.step_count) == 104
    lrn.close()


@pytest.mark.slow
def test_export_reference_checkpoint_roundtrip(tmp_path):
    """export_reference_checkpoint (the --checkpoint-ref twin) writes a
    trained TrainState in the reference's byte layout; reading it back
    reproduces every exported array and counter, and importing it into
    a fresh Learner continues the run."""
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.learner import Learner
    from mcmc_ammsb.refckpt import export_reference_checkpoint

    n, u, v = synthetic_edges(60, 6, seed=8)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=9)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=4,
                 steps_per_call=5).finalize(
        n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    lrn.run(10)
    lrn.heldout_perplexity()
    path = str(tmp_path / "export.ckpt")
    export_reference_checkpoint(path, cfg, lrn.state)

    raw = read_reference_checkpoint(path)
    np.testing.assert_array_equal(raw["pi"], np.asarray(lrn.state.pi))
    np.testing.assert_array_equal(raw["phi_sum"],
                                  np.asarray(lrn.state.phi_sum))
    np.testing.assert_array_equal(raw["theta"],
                                  np.asarray(lrn.state.theta))
    np.testing.assert_array_equal(raw["beta"],
                                  np.asarray(lrn.state.beta))
    np.testing.assert_array_equal(raw["ppx_per_edge"],
                                  np.asarray(lrn.state.ppx_per_edge))
    assert raw["step_count"] == int(lrn.state.step_count)
    assert raw["beta_count"] == int(lrn.state.beta_count)
    assert raw["ppx_count"] == int(lrn.state.ppx_count)
    # seed buffers are sized to the REFERENCE's allocations (r5): the
    # default build's phi updater holds B*phi_wg_size streams
    # (phi.cc:624-629), not this repo's max_batch_nodes lanes
    layout = ReferenceLayout.from_config(cfg,
                                         len(split.heldout_edges_u))
    assert raw["phi_seeds"].shape == (layout.phi_seed_count, 4)
    assert raw["beta_seeds"].shape == (cfg.K, 4)

    # the exported file resumes in a FRESH learner at the same state
    state = to_train_state(cfg, raw, len(split.heldout_edges_u))
    lrn2 = Learner(cfg, graph, split, prefetch=False)
    lrn2.state = state
    assert int(lrn2.state.step_count) == int(lrn.state.step_count)
    lrn2.run(5)
    assert int(lrn2.state.step_count) == int(lrn.state.step_count) + 5
    lrn.close(); lrn2.close()


# ---------------------------------------------------------------------------
# Strict Learner::Parse simulation: the export must be
# accepted by a byte-for-byte replay of the reference binary's parse
# path — exact buffer sizes, full message sequence, both build layouts.
# ---------------------------------------------------------------------------


def test_layout_size_laws():
    """Pin the allocation laws the reference checks against
    (sample.cc:86-99/129-131, phi.cc:624-629, beta.cc:250-252,
    partitioned-alloc.h:125-131)."""
    L = ReferenceLayout(N=100, K=16, mini_batch_size=8,
                        num_node_sample=4, max_fan_out=30,
                        heldout_size=10)
    assert L.batch_slots == 31            # max(2*8, 1+30)
    assert L.dev_edges_len == 30          # max(8, 30)
    assert L.phi_seed_count == 31 * 32    # WG default: B * phi_wg_size
    assert L.beta_seed_count == 16        # exactly K
    assert L.ns_seed_count == 31 * 8      # B * 2*num_node_sample
    assert L.ns_data_len == 31 * 4        # B * num_node_sample
    assert L.effective_rows_in_block == (512 << 20) // (16 * 4)
    assert L.num_samples == 2             # MCMC_SAMPLE_PARALLEL ON
    Lt = ReferenceLayout(N=100, K=16, mini_batch_size=8,
                         num_node_sample=4, max_fan_out=3,
                         heldout_size=10, phi_node_per_thread=True,
                         sample_parallel=False)
    assert Lt.batch_slots == 16           # 2m dominates a low fan-out
    assert Lt.phi_seed_count == 16        # per-thread mode: B * 1
    assert Lt.num_samples == 1


def _trained(n=60, k=8, seed=8, **cfg_kw):
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.learner import Learner

    nn, u, v = synthetic_edges(n, 6, seed=seed)
    split = generate_sets(nn, u, v, heldout_ratio=0.2, seed=seed + 1)
    graph = Graph.from_edges(nn, split.training_u, split.training_v)
    cfg = Config(K=k, mini_batch_size=4, num_node_sample=4,
                 steps_per_call=5, **cfg_kw).finalize(
        nn, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    lrn.run(10)
    lrn.heldout_perplexity()
    return cfg, graph, split, lrn


@pytest.mark.slow
def test_strict_parse_accepts_default_export(tmp_path):
    """The CLI-default export (MCMC_SAMPLE_PARALLEL build, no train
    ppx) passes the strict Learner::Parse replay: every buffer at the
    reference's byte size, both Sample sections carrying a genuine
    in-flight minibatch, clean EOF."""
    from mcmc_ammsb.refckpt import export_reference_checkpoint

    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "strict.ckpt")
    export_reference_checkpoint(path, cfg, lrn.state, graph, split)
    layout = ReferenceLayout.from_config(cfg,
                                         len(split.heldout_edges_u))
    props = simulate_reference_parse(path, layout)
    assert props["learner_props"][1][0] == int(lrn.state.step_count)
    # the consumed sample holds a real minibatch (learner.cc:216-244)
    assert 0 < props["sample0_edges"] <= layout.dev_edges_len
    assert 0 < props["sample0_nodes"] <= layout.batch_slots
    assert props["sample1_edges"] > 0
    lrn.close()


@pytest.mark.slow
def test_strict_parse_accepts_all_build_layouts(tmp_path):
    """Layout switches: MCMC_CALC_TRAIN_PPX inserts the training-ppx
    section; a serial (no MCMC_SAMPLE_PARALLEL) build reads one Sample;
    PHI_NODE_PER_THREAD shrinks the phi seed buffer; a custom
    rows_in_block splits pi into multiple blocks."""
    from mcmc_ammsb.refckpt import export_reference_checkpoint

    cfg, graph, split, lrn = _trained(calc_train_ppx=True,
                                      training_ppx_ratio=0.2)
    h = len(split.heldout_edges_u)
    tp = int(np.asarray(lrn.state.train_ppx_per_edge).shape[0])
    assert tp > 0

    for kw in (dict(train_ppx=True),
               dict(train_ppx=True, sample_parallel=False),
               dict(train_ppx=True, phi_node_per_thread=True),
               dict(train_ppx=True, rows_in_block=16)):
        path = str(tmp_path / "layout.ckpt")
        export_reference_checkpoint(path, cfg, lrn.state, graph, split,
                                    **kw)
        layout = ReferenceLayout.from_config(
            cfg, h, train_ppx_size=tp, **kw)
        props = simulate_reference_parse(path, layout)
        assert props["train_ppx_props"][1][0] >= 0
        # and the WRONG layout is rejected (the binary would too)
        wrong = ReferenceLayout.from_config(
            cfg, h, train_ppx=False,
            sample_parallel=kw.get("sample_parallel", True),
            phi_node_per_thread=kw.get("phi_node_per_thread", False),
            rows_in_block=kw.get("rows_in_block", 0))
        with pytest.raises(ReferenceParseError):
            simulate_reference_parse(path, wrong)
    lrn.close()


@pytest.mark.slow
def test_strict_parse_rejects_round4_export_shape(tmp_path):
    """Regression: the round-4 exporter wrote max_batch_nodes phi
    seeds, one pi block, and NO Sample sections — all three structural
    grounds the actual binary would reject on.
    The simulator must reject such a file."""
    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "r4style.ckpt")
    from mcmc_ammsb.rng import reference as ref
    write_reference_checkpoint(
        path,
        theta=np.asarray(lrn.state.theta, np.float32),
        beta=np.asarray(lrn.state.beta, np.float32),
        pi=np.asarray(lrn.state.pi, np.float32),
        phi_sum=np.asarray(lrn.state.phi_sum, np.float32),
        ppx_per_edge=np.asarray(lrn.state.ppx_per_edge, np.float32),
        phi_seeds=np.asarray(ref.make_seeds(cfg.phi_seed,
                                            cfg.max_batch_nodes)),
        beta_seeds=np.asarray(ref.make_seeds(cfg.beta_seed, cfg.K)),
        step_count=int(lrn.state.step_count))
    layout = ReferenceLayout.from_config(cfg,
                                         len(split.heldout_edges_u))
    with pytest.raises(ReferenceParseError):
        simulate_reference_parse(path, layout)
    lrn.close()


@pytest.mark.slow
def test_strict_parse_catches_truncation_and_trailing(tmp_path):
    """Byte-level tampering: a truncated file and a file with trailing
    bytes are both rejected (the stream has no framing recovery)."""
    from mcmc_ammsb.refckpt import export_reference_checkpoint

    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "ok.ckpt")
    export_reference_checkpoint(path, cfg, lrn.state, graph, split)
    layout = ReferenceLayout.from_config(cfg,
                                         len(split.heldout_edges_u))
    blob = open(path, "rb").read()
    cut = str(tmp_path / "cut.ckpt")
    open(cut, "wb").write(blob[:-40])
    with pytest.raises(ReferenceParseError):
        simulate_reference_parse(cut, layout)
    fat = str(tmp_path / "fat.ckpt")
    open(fat, "wb").write(blob + b"\x00" * 8)
    with pytest.raises(ReferenceParseError):
        simulate_reference_parse(fat, layout)
    lrn.close()


@pytest.mark.slow
def test_strict_parse_accepts_mesh_export(tmp_path):
    """--mesh runs pad eval buffers to the data axis; the export must
    slice back to the TRUE population sizes the reference allocates
    (perplexity.cc:194) or its Parse rejects the size mismatch."""
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh
    from mcmc_ammsb.refckpt import export_reference_checkpoint

    nn, u, v = synthetic_edges(70, 6, seed=14)
    split = generate_sets(nn, u, v, heldout_ratio=0.2, seed=15)
    graph = Graph.from_edges(nn, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=4,
                 device_sampling=True, steps_per_call=5).finalize(
        nn, split.total_edges, graph.max_fan_out)
    h = len(split.heldout_edges_u)
    # pick a data-axis width that does NOT divide h, so the padding
    # path is genuinely exercised
    n_data = next(d for d in (4, 2, 8) if h % d)
    mesh = make_mesh(n_data, 8 // n_data)
    lrn = ShardedLearner(cfg, graph, split, mesh)
    lrn.run(10)
    lrn.heldout_perplexity()
    assert int(np.asarray(lrn.state.ppx_per_edge).shape[0]) > h  # padded

    path = str(tmp_path / "mesh.ckpt")
    export_reference_checkpoint(path, cfg, lrn.state, graph, split,
                                heldout_size=h)
    layout = ReferenceLayout.from_config(cfg, h)
    props = simulate_reference_parse(path, layout)
    assert props["learner_props"][1][0] == int(lrn.state.step_count)
    lrn.close()
