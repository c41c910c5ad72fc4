#!/usr/bin/env python
"""Run the BASELINE.md config ladder and write one ppx[i] time-series
artifact per rung — the reference's primary experiment output
(/root/reference/main.cc:160-168).

With real SNAP files in --data it runs them; otherwise it substitutes
scale-matched synthetic graphs so a trajectory artifact exists per rung
attempted (flagged "synthetic" in the output JSON).

    python scripts/run_ladder.py --out ladder_out/ [--data data/]
    python scripts/run_ladder.py --rungs ca-HepPh com-dblp --iters 2000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root (package not pip-installed)

# rung -> (dataset file stem, K,
#          degree-realistic fallback (nodes, avg_deg, max_deg),
#          extra Config overrides)
# The fallback is a degree-corrected power-law surrogate matched to
# each SNAP graph's published size / average degree / max degree
# (data.synthetic_powerlaw_edges) — heavy tails exercise the
# hub-sized NodeLink capacities and the adjacency-budget fallback
# that a uniform random graph (max degree ~23 at DBLP scale) never
# does. com-youtube/com-lj shaped max degrees exceed the ADJACENCY
# AUTO budget (N * max_deg * 4B), forcing the CHD perfect hash —
# exactly the backend regime those real datasets would select.
#
# Heavy-tailed rungs run with ds_link_cap=32 (Horvitz-Thompson hub
# subsampling, beta gradient exactly unbiased): without it every
# device batch pays hub-degree buffer cost, and the cap lets the
# window engine re-engage.
#
# com-lj's reference K=4096 needs pi [4M, 4096] = 65 GB fp32 / 33 GB
# bf16 (the sharded RowPartitionedMatrix generalization over several
# cards is the faithful configuration); the single-device rung runs
# K=1024 bf16 (8.2 GB) and records K_reference in the artifact.
RUNGS = {
    "ca-HepPh": ("ca-HepPh.txt", 64, (12_008, 19.7, 491), {}),
    "com-dblp": ("com-dblp.ungraph.txt", 256, (317_080, 6.6, 343),
                 {"ds_link_cap": 32, "window": 12}),
    "com-youtube": ("com-youtube.ungraph.txt", 1024,
                    (1_134_890, 5.3, 28_754),
                    {"ds_link_cap": 32, "window": 12}),
    "com-lj": ("com-lj.ungraph.txt", 4096, (3_997_962, 17.3, 14_815),
               {"ds_link_cap": 32, "window": 12,
                "pi_dtype": "bfloat16", "K_single_chip": 1024}),
}


def run_rung(name: str, data_dir: str, out_dir: str, iters: int,
             interval: int) -> dict:
    from mcmc_ammsb.config import Config, EdgeSetBackend
    from mcmc_ammsb.data import (Graph, generate_sets,
                                 load_snap_edges,
                                 synthetic_powerlaw_edges)
    from mcmc_ammsb.learner import Learner

    stem, k, (syn_n, syn_deg, syn_max), extra = RUNGS[name]
    extra = dict(extra)
    k_ref = k
    k = extra.pop("K_single_chip", k)
    path = os.path.join(data_dir, stem)
    if os.path.exists(path):
        n, u, v = load_snap_edges(path)
        source = path
    else:
        n, u, v = synthetic_powerlaw_edges(
            syn_n, syn_deg, exponent=2.7, max_degree=syn_max,
            num_communities=min(k, 256), intra_fraction=0.85, seed=1)
        source = f"powerlaw({syn_n},{syn_deg},max={syn_max})"
    split = generate_sets(n, u, v, heldout_ratio=0.01, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    # production fast path: device sampling + shared draws + fused
    # in-loop evals (run_with_ppx) — the eval cadence doesn't cap the
    # dispatch depth
    cfg = Config(K=k, mini_batch_size=32, num_node_sample=32,
                 steps_per_call=1000, device_sampling=True,
                 shared_neighbors=True,
                 edgeset_backend=EdgeSetBackend.AUTO, **extra)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    print(f"[{name}] {source}: N={cfg.N} E={cfg.E} K={k}",
          file=sys.stderr)

    learner = Learner(cfg, graph, split)
    t0 = time.time()
    start = int(learner.state.step_count)
    series = [{"iter": 0, "ppx": learner.heldout_perplexity(),
               "seconds": time.time() - t0}]
    print(f"[{name}] ppx[0] = {series[0]['ppx']:.4f}", file=sys.stderr)
    # ONE call for all iters: the series driver pipelines the packed
    # readbacks (depth 2, 8000-step chunk floor) and stamps each eval
    # with its chunk's materialization wall clock (ev["t"]), so the
    # artifact's time axis stays real WITHOUT serializing the loop on
    # one transfer per eval
    base_t = time.perf_counter()
    wall0 = time.time() - t0
    for ev in learner.run_with_ppx(iters, min(interval, iters)):
        series.append({"iter": ev["step"] - start, "ppx": ev["ppx"],
                       "seconds": wall0 + ev["t"] - base_t})
        print(f"[{name}] ppx[{series[-1]['iter']}] = "
              f"{series[-1]['ppx']:.4f} "
              f"({series[-1]['seconds']:.1f}s)", file=sys.stderr)
    learner.close()

    artifact = {
        "rung": name, "source": source, "synthetic": source != path,
        "N": cfg.N, "E": cfg.E, "K": k,
        "m": cfg.mini_batch_size, "n": cfg.num_node_sample,
        "max_fan_out": cfg.max_fan_out,
        "ds_link_cap": cfg.ds_link_cap, "window": cfg.window,
        "pi_dtype": cfg.pi_dtype,
        "iters": iters, "ppx_interval": interval,
        "series": series,
    }
    if k_ref != k:
        artifact["K_reference"] = k_ref
        artifact["K_note"] = (
            "reference K does not fit one chip "
            f"(pi [{cfg.N},{k_ref}] fp32 = "
            f"{cfg.N * k_ref * 4 / 2**30:.0f} GB); single-chip rung "
            "runs the largest feasible K — the sharded engine "
            "(parallel/sharded.py) is the faithful configuration on "
            "a pod")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"ppx_{name}.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"[{name}] wrote {out}", file=sys.stderr)
    return artifact


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="data")
    ap.add_argument("--out", default="ladder_out")
    ap.add_argument("--rungs", nargs="*",
                    default=["ca-HepPh", "com-dblp", "com-youtube",
                             "com-lj"])
    ap.add_argument("--iters", type=int, default=10_000)
    ap.add_argument("--interval", type=int, default=1_000)
    args = ap.parse_args()
    for name in args.rungs:
        run_rung(name, args.data, args.out, args.iters, args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
