"""CLI end-to-end tests (the reference's CLI drives 100% of its
functionality, /root/reference/main.cc — so must ours: single-chip,
multi-chip mesh, multi-chain, train-ppx, checkpoint flags all reachable
from the command line). Runs in-process on the 8-device virtual mesh."""

import logging

import pytest

from mcmc_ammsb import cli

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'

BASE = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "4",
        "--heldout-ratio", "0.1"]


def run_cli(argv, caplog):
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb"):
        rc = cli.main(argv)
    return rc, caplog.text


def test_cli_single_chip(caplog):
    rc, out = run_cli(BASE + ["-x", "30", "-i", "10",
                              "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "ppx[0]" in out and "ppx[30]" in out
    assert "links:" in out  # per-eval diagnostics
    assert "backend" in out  # ChooseDevice parity line


def test_cli_mesh_drives_sharded_learner(caplog):
    rc, out = run_cli(BASE + ["--mesh", "2,4", "-x", "20", "-i", "10",
                              "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "mesh: data=2 model=4" in out
    assert "ppx[20]" in out


def test_cli_mesh_train_ppx(caplog):
    rc, out = run_cli(BASE + ["--mesh", "2,4", "-x", "10", "-i", "10",
                              "--calc-train-ppx",
                              "--train-ppx-ratio", "0.1"], caplog)
    assert rc == 0
    assert "train_ppx[10]" in out


def test_cli_num_chains_uses_flat_engine(caplog):
    rc, out = run_cli(BASE + ["--num-chains", "2", "-x", "20", "-i",
                              "10", "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "ppx[20]" in out


def test_cli_chain_devices_spreads_chains(caplog):
    """--chain-devices G drives ShardedChainLearner: whole chains per
    device on a ('chains',) mesh, per-chain ppx vector in the log."""
    rc, out = run_cli(BASE + ["--num-chains", "8", "--chain-devices",
                              "4", "-x", "20", "-i", "10",
                              "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "ppx[20]" in out


def test_cli_full_mmsb_model(tmp_path, caplog):
    """The beyond-reference full-MMSB family is CLI-reachable, with its
    identifiability knobs and checkpointing."""
    ck = str(tmp_path / "mmsb_ck.npz")
    rc, out = run_cli(BASE + ["--model", "mmsb", "-x", "20", "-i", "10",
                              "--steps-per-call", "5",
                              "--mmsb-prior-diag", "1.0", "8.0",
                              "--mmsb-noise-scale", "0.5",
                              "--checkpoint", ck], caplog)
    assert rc == 0
    assert "ppx[20]" in out
    caplog.clear()
    rc, out = run_cli(BASE + ["--model", "mmsb", "-x", "10", "-i", "10",
                              "--mmsb-prior-diag", "1.0", "8.0",
                              "--mmsb-noise-scale", "0.5",
                              "--restore", ck], caplog)
    assert rc == 0
    assert "restored checkpoint" in out and "step=21" in out


def test_cli_checkpoint_roundtrip(tmp_path, caplog):
    ck = str(tmp_path / "cli_ck.npz")
    rc, _ = run_cli(BASE + ["-x", "10", "-i", "10",
                            "--checkpoint", ck], caplog)
    assert rc == 0
    caplog.clear()
    rc, out = run_cli(BASE + ["-x", "10", "-i", "10",
                              "--restore", ck], caplog)
    assert rc == 0
    assert "restored checkpoint" in out and "step=11" in out


def test_cli_chains_checkpoint_roundtrip(tmp_path, caplog):
    ck = str(tmp_path / "cli_chains_ck.npz")
    rc, _ = run_cli(BASE + ["--num-chains", "2", "-x", "10", "-i", "10",
                            "--checkpoint", ck], caplog)
    assert rc == 0
    caplog.clear()
    rc, out = run_cli(BASE + ["--num-chains", "2", "-x", "10", "-i",
                              "10", "--restore", ck], caplog)
    assert rc == 0
    assert "restored checkpoint" in out and "step=11" in out


def test_cli_fused_evals_with_tail(caplog):
    """Fused in-loop evals (steps_per_call > interval) print the full
    ppx series INCLUDING the final partial-chunk eval the old host
    loop always ended on."""
    rc, out = run_cli(BASE + ["-x", "25", "-i", "10",
                              "--steps-per-call", "40",
                              "--device-sampling"], caplog)
    assert rc == 0
    assert "ppx[10]" in out and "ppx[20]" in out
    assert "ppx[25]" in out  # tail eval via the host path


def test_cli_train_ppx_rides_fused_evals(caplog):
    """--calc-train-ppx rides INSIDE the fused eval series (round-4
    fix: it used to force the slow host eval loop) — every interval logs train_ppx and the values come from the
    packed fused readback (train_steps_fused_ppx row 5)."""
    rc, out = run_cli(BASE + ["-x", "20", "-i", "10",
                              "--steps-per-call", "40",
                              "--device-sampling", "--calc-train-ppx",
                              "--train-ppx-ratio", "0.1"], caplog)
    assert rc == 0
    assert "train_ppx[10]" in out and "train_ppx[20]" in out


def test_cli_train_ppx_host_loop_still_works(caplog):
    """The host-batch path (no device sampling) keeps evaluating
    train-ppx between chunks."""
    rc, out = run_cli(BASE + ["-x", "20", "-i", "10",
                              "--calc-train-ppx",
                              "--train-ppx-ratio", "0.1"], caplog)
    assert rc == 0
    assert "train_ppx[10]" in out and "train_ppx[20]" in out


def test_cli_periodic_checkpointing(tmp_path, caplog):
    """--checkpoint-interval saves a restorable checkpoint during
    training (async via orbax), not just at exit."""
    path = str(tmp_path / "periodic_ck")
    rc, out = run_cli(BASE + ["-x", "30", "-i", "10",
                              "--steps-per-call", "40",
                              "--device-sampling",
                              "--checkpoint", path,
                              "--checkpoint-backend", "orbax",
                              "--checkpoint-interval", "10"], caplog)
    assert rc == 0
    assert "[async]" in out
    import os
    assert os.path.isdir(path)  # exit save (sync) finalized everything


def test_cli_auto_window_heavy_tail_fallback(tmp_path, caplog):
    """Auto-window falls back to the sequential scan when the node
    buffer is hub-degree-padded (max_batch_nodes > 64): the windowed
    correction scales with T*B_cap. --window N still forces."""
    # star graph: one hub of degree 80 plus a ring so every node has
    # an edge after the heldout split
    lines = ["# star + ring"]
    n = 81
    lines += [f"0\t{i}" for i in range(1, n)]
    lines += [f"{i}\t{i + 1}" for i in range(1, n - 1)]
    f = tmp_path / "star.txt"
    f.write_text("\n".join(lines) + "\n")
    rc, out = run_cli(["--file", str(f), "-k", "8", "-m", "8", "-n",
                       "4", "--heldout-ratio", "0.05", "-x", "20",
                       "-i", "10", "--steps-per-call", "10",
                       "--num-chains", "2"], caplog)
    assert rc == 0
    assert "window auto-set" in out          # auto engaged first...
    assert "window auto-disabled" in out     # ...then the fallback
    assert "ppx[20]" in out

    caplog.clear()
    # explicit --window is respected (no fallback)
    rc, out = run_cli(["--file", str(f), "-k", "8", "-m", "8", "-n",
                       "4", "--heldout-ratio", "0.05", "-x", "20",
                       "-i", "10", "--steps-per-call", "10",
                       "--window", "4"], caplog)
    assert rc == 0
    assert "window auto-disabled" not in out
    assert "ppx[20]" in out


def test_cli_auto_window_regular_graph(caplog):
    """On a regular-degree graph the auto window stays on for flat
    chains, and stays off for one chain (the measured defaults)."""
    rc, out = run_cli(BASE + ["-x", "24", "-i", "12",
                              "--steps-per-call", "12",
                              "--num-chains", "2"], caplog)
    assert rc == 0
    assert f"window auto-set to {cli.AUTO_WINDOW_CHAINS}" in out
    assert "window auto-disabled" not in out
    caplog.clear()
    rc, out = run_cli(BASE + ["-x", "24", "-i", "12",
                              "--steps-per-call", "12"], caplog)
    assert rc == 0
    assert "window auto-set" not in out


def test_cli_synthetic_powerlaw_with_cap(caplog):
    """Heavy-tailed synthetic graphs + degree-capped NodeLink are
    CLI-reachable: the cap shrinks the node buffer back under the
    auto-window threshold, so the window engine stays on."""
    rc, out = run_cli(["--synthetic-powerlaw", "500,6,60,16", "-k", "8",
                       "-m", "8", "-n", "4", "--heldout-ratio", "0.05",
                       "--ds-link-cap", "8", "-x", "24", "-i", "12",
                       "--steps-per-call", "12"], caplog)
    assert rc == 0
    assert "ppx[24]" in out
    assert "ds_link_cap=8" in out            # config echo carries it
    assert "window auto-disabled" not in out  # b_cap is cap-sized now


def test_cli_restore_ref_checkpoint(tmp_path, caplog):
    """--restore-ref imports a checkpoint the REFERENCE binary wrote
    (serialize.h byte layout) and resumes training from its counters —
    the cross-implementation bridge is CLI-reachable."""
    import numpy as np

    from mcmc_ammsb.data import generate_sets, synthetic_edges
    from mcmc_ammsb.refckpt import write_reference_checkpoint

    # replicate the CLI's --synthetic 300,8 dataset exactly
    # (synthetic seed=1, --split-seed default 12345) so the imported
    # state's dimensions match and the running ppx averages carry over
    n, u, v = synthetic_edges(300, 8, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=12345)
    h = len(split.heldout_edges_u)

    rng = np.random.RandomState(7)
    k = 8
    theta = rng.gamma(1.0, 1.0, size=(k, 2)).astype(np.float32)
    seeds = rng.randint(0, 2**31, size=(16, 4)).astype(np.uint32)
    path = str(tmp_path / "reference.ckpt")
    write_reference_checkpoint(
        path, theta=theta,
        beta=(theta[:, 1] / theta.sum(-1)).astype(np.float32),
        pi=rng.dirichlet(np.ones(k), size=n).astype(np.float32),
        phi_sum=rng.gamma(2.0, 1.0, size=n).astype(np.float32),
        ppx_per_edge=rng.uniform(0.1, 0.9, size=h).astype(np.float32),
        phi_seeds=seeds, beta_seeds=seeds[::-1].copy(),
        step_count=500, beta_count=499, ppx_count=3)

    rc, out = run_cli(BASE + ["--restore-ref", path, "-x", "20", "-i",
                              "10", "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "imported reference checkpoint" in out
    assert "(step=500)" in out
    assert "ppx[20]" in out
    assert "held-out size" not in out     # exact-match import, no reset

    # engines the reference never had refuse the single-GPU state
    rc, out = run_cli(BASE + ["--restore-ref", path, "--num-chains",
                              "2", "-x", "5", "-i", "5"], caplog)
    assert rc == 1


def test_cli_checkpoint_ref_export_reimport(tmp_path, caplog):
    """--checkpoint-ref exports the trained state in the reference's
    format; --restore-ref on the SAME dataset resumes from it — the
    bridge closes in both directions from the command line."""
    path = str(tmp_path / "export.ckpt")
    rc, out = run_cli(BASE + ["-x", "20", "-i", "10",
                              "--steps-per-call", "5",
                              "--checkpoint-ref", path], caplog)
    assert rc == 0
    assert "reference-format checkpoint saved" in out
    caplog.clear()
    rc, out = run_cli(BASE + ["--restore-ref", path, "-x", "10", "-i",
                              "10", "--steps-per-call", "5"], caplog)
    assert rc == 0
    assert "imported reference checkpoint" in out
    assert "held-out size" not in out    # same split: exact carry-over
    assert "(step=21)" in out            # 20 steps + initial step 1
