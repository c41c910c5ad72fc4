"""Quickest proof that the sampler runs on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases a-e below
    python chip_smoke.py --cards 4  # four cards: the multi-card paths only

One process; every phase runs in it, through the entry points a user
calls, at the com-DBLP rung's full width (N=317,080, K=256, m=n=32,
random weights from the CLI's fixed seeds):

  a. ``mcmc_ammsb.cli.main`` on the default fast path (device sampling,
     shared neighbor draws, the auto window): every held-out ppx is
     finite and the last is below the first;
  b. the same with ``--no-shared-neighbors`` (reference semantics);
  c. ``-s BFLink`` on device, and the device BF draws equal the python
     replay of the sampler bit for bit;
  d. the card checks of tests/card_checks.py: windowed engine against
     the sequential scan, phi/beta against the float64 oracle;
  e. the per-stage profile of the traced production program attributes
     device time to the named stages.

``--cards 4`` runs the multi-card paths users rely on instead:
ShardedLearner on a (1, 4) mesh against the (1, 1) mesh, windowed and
sequential, and ``--chain-devices 4`` determinism across rebuilds.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. Otherwise the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SYNTHETIC = ["--synthetic", "317080,7", "-k", "256", "-m", "32",
             "-n", "32"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def run_cli(argv):
    """cli.main(argv) in this process. Returns (ppx series as
    [(step, ppx, wall time)], seconds)."""
    from mcmc_ammsb import cli

    logger = logging.getLogger("mcmc_ammsb")
    handler = _Records()
    logger.addHandler(handler)
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        logger.removeHandler(handler)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main{tuple(argv)} returned {rc}")
    series = []
    for r in handler.records:
        msg = r.getMessage()
        if msg.startswith("ppx["):
            step = int(msg[4:msg.index("]")])
            series.append((step, float(msg.split("= ")[1]), r.created))
    return series, secs


def report_series(label, series, secs):
    """Check a ppx series and print its rates: the first interval pays
    the compiles; the later ones are steady-state, eval included."""
    ppx = [p for _, p, _ in series]
    if len(series) < 3:
        raise AssertionError(f"{label}: only {len(series)} evals")
    if not all(map(lambda p: p == p and abs(p) != float("inf"), ppx)):
        raise AssertionError(f"{label}: non-finite ppx {ppx}")
    if not ppx[-1] < ppx[0]:
        raise AssertionError(f"{label}: ppx did not fall: {ppx}")
    rates = [(s1 - s0) / (t1 - t0) for (s0, _, t0), (s1, _, t1)
             in zip(series[1:], series[2:])]
    print(f"[{label}] ppx {ppx[0]:.4f} -> {ppx[-1]:.4f} over "
          f"{series[-1][0]} steps; first interval (compiles) "
          f"{series[1][2] - series[0][2]:.1f}s; steady rates "
          f"{', '.join(f'{r:.0f}' for r in rates)} updates/s; "
          f"run {secs:.1f}s", flush=True)


def phase(name, fn):
    t0 = time.perf_counter()
    fn()
    print(f"phase {name} ok ({time.perf_counter() - t0:.1f}s)",
          flush=True)


def one_card():
    import card_checks
    from mcmc_ammsb.learner import Learner

    default = SYNTHETIC + ["-x", "5000", "-i", "1000"]
    phase("a (CLI default fast path)", lambda: report_series(
        "default", *run_cli(default)))
    phase("b (reference semantics)", lambda: report_series(
        "no-shared-neighbors",
        *run_cli(default + ["--no-shared-neighbors"])))
    phase("c (device BFLink)", lambda: report_series(
        "BFLink", *run_cli(SYNTHETIC + ["-s", "BFLink", "-x", "3000",
                                        "-i", "1000"])))
    graph, split = card_checks.bench_graph()
    phase("c (BFLink draws vs oracle)", lambda: print(
        card_checks.check_device_bf_bitwise(graph, split)))
    phase("d (window vs sequential)", lambda: print(
        card_checks.check_window_matches_sequential(graph, split)))
    phase("d (phi/beta vs oracle)", lambda: print(
        card_checks.check_phi_beta_vs_oracle(graph, split)))

    def profile():
        from mcmc_ammsb.utils import profiling

        cfg = card_checks.bench_config(graph, split, steps_per_call=1000,
                                       window=12)
        lrn = Learner(cfg, graph, split, prefetch=False)
        try:
            prof = lrn.fused_stage_profile(iters=2000)
        finally:
            lrn.close()
        profiling.print_stage_profile(prof)
        named = sum(s for k, s in prof["stages"].items() if k != "other")
        print(f"attributed {named / prof['total_op_seconds']:.1%} of "
              f"device-op time to named stages (source={prof['source']})")
        if "phi_update" not in prof["stages"]:
            raise AssertionError(f"no phi_update time: {prof['stages']}")

    phase("e (stage profile)", profile)


def four_cards():
    import numpy as np

    import card_checks
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh
    from mcmc_ammsb.parallel.chains_sharded import (ShardedChainLearner,
                                                    make_chain_mesh)

    graph, split = card_checks.bench_graph()
    n = graph.num_nodes

    def sharded(window):
        cfg = card_checks.bench_config(graph, split, steps_per_call=48,
                                       window=window)
        one = ShardedLearner(cfg, graph, split,
                             make_mesh(1, 1, allow_subset=True))
        four = ShardedLearner(cfg, graph, split, make_mesh(1, 4))
        try:
            for lrn in (one, four):
                lrn.run(48)
                t0 = time.perf_counter()
                lrn.run(480)
                int(lrn.state.step_count)
                print(f"  mesh {dict(lrn.mesh.shape)} window={window}: "
                      f"{480 / (time.perf_counter() - t0):.0f} updates/s")
            pi1 = np.asarray(one.state.pi)[:n]
            pi4 = np.asarray(four.state.pi)[:n]
            np.testing.assert_allclose(pi4, pi1, rtol=2e-4, atol=1e-7)
            np.testing.assert_allclose(np.asarray(four.state.theta),
                                       np.asarray(one.state.theta),
                                       rtol=2e-4, atol=1e-7)
            print(f"(1,4) vs (1,1) window={window}: "
                  f"max|dpi|={np.max(np.abs(pi4 - pi1)):.3g}")
        finally:
            one.close()
            four.close()

    phase("mesh (1,4) vs (1,1), windowed", lambda: sharded(12))
    phase("mesh (1,4) vs (1,1), sequential", lambda: sharded(0))

    def chains():
        cfg = card_checks.bench_config(graph, split, steps_per_call=96,
                                       window=6, node_coin="alternate")
        runs = []
        for _ in range(2):
            lrn = ShardedChainLearner(cfg, graph, split, 16,
                                      make_chain_mesh(4))
            lrn.run(192)
            runs.append(np.asarray(lrn.state.pi))
            ppx = np.asarray(lrn.heldout_perplexity())
            if not np.isfinite(ppx).all():
                raise AssertionError(f"non-finite chain ppx {ppx}")
        np.testing.assert_array_equal(runs[0], runs[1])
        print("--chain-devices 4 (16 chains): bitwise equal across "
              "rebuilds")

    phase("chain devices 4", chains)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="1: the one-card phases; 4: the multi-card "
                        "paths only")
    args = p.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from mcmc_ammsb.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    t0 = time.perf_counter()
    (four_cards if args.cards == 4 else one_card)()
    print(f"all phases ok in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
