"""Benchmark: minibatch phi+beta updates/sec (BASELINE.json metric).

Runs the fused SGRLD training loop on a com-DBLP-scale synthetic graph
(N=317k, E~1.1M, generated from a seed) with the config ladder's K=256
and reference-default minibatch m=32 / n=32
(/root/reference/mcmc/config.h:70-101), and reports sustained phi+beta
updates per second on one GPU.

One update = one full reference iteration: device neighbor sampling,
phi/pi SGRLD update + renormalize, theta/beta gradient fan-in + SGRLD
update + normalize (learner.cc:214-250). The loop runs
``steps_per_call`` steps per device dispatch via lax.scan with
state-independent work hoisted and vectorized.

The reference publishes no numbers (BASELINE.md) — vs_baseline is null
until a reference GPU run exists to compare against.

Exits non-zero when JAX finds no GPU and when any phase fails: a
broken phase is an error, never a null. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extra"}.
"""

import json
import sys
import time


def _spread(rates):
    """min/median/max over a trial list."""
    s = sorted(rates)
    mid = s[len(s) // 2] if len(s) % 2 else (s[len(s) // 2 - 1]
                                             + s[len(s) // 2]) / 2
    return {"min": round(s[0], 1), "median": round(mid, 1),
            "max": round(s[-1], 1), "trials": len(s)}


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def timed_rates(learner, label, warm, iters, trials, per_step=1):
    """Warm ``learner`` (compile + first chunk) outside the timer, then
    ``trials`` fenced runs of ``iters`` steps. Returns the per-trial
    rates in updates/s (``per_step`` updates per step, e.g. chains)."""
    t0 = time.time()
    learner.run(warm)
    int(learner.state.step_count)          # fence the compile
    _log(f"[{label}] warmup (incl. compile): {time.time() - t0:.1f}s")
    rates = []
    for trial in range(trials):
        s0 = int(learner.state.step_count)
        t0 = time.perf_counter()
        learner.run(iters)
        # a scalar readback inside the timed region fences the device
        steps = int(learner.state.step_count) - s0
        dt = time.perf_counter() - t0
        assert steps == iters, steps
        rates.append(per_step * iters / dt)
        _log(f"[{label}] trial {trial}: {iters} steps in {dt:.2f}s -> "
             f"{rates[-1]:.0f} updates/s")
    return rates


def main():
    from mcmc_ammsb.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"bench: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    dev = jax.devices()[0]

    from mcmc_ammsb.autotune import tune_window
    from mcmc_ammsb.chains_flat import FlatChainLearner
    from mcmc_ammsb.cli import AUTO_WINDOW_CHAINS, AUTO_WINDOW_SINGLE
    from mcmc_ammsb.config import (Config, EdgeSetBackend, RngBackend,
                                   SampleStrategy)
    from mcmc_ammsb.data import (Graph, generate_sets, synthetic_edges,
                                 synthetic_powerlaw_edges,
                                 synthetic_sbm_edges)
    from mcmc_ammsb.learner import Learner, init_state
    from mcmc_ammsb.parallel import ShardedLearner, make_mesh

    t0 = time.time()
    n, u, v = synthetic_edges(num_nodes=317_080, avg_degree=7, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.01, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    # The CLI's default fast path: minibatches drawn ON DEVICE inside
    # the scan, 1000 steps per dispatch, ONE shared n-neighbor draw per
    # step (every node still gets an unbiased n-sample phi gradient —
    # config.py knob doc, tests/test_shared_neighbors.py), and the
    # CLI's auto window. The private-draw reference-semantics rate is
    # measured every run and reported in extras.
    cfg = Config(K=256, mini_batch_size=32, num_node_sample=32,
                 steps_per_call=1000, device_sampling=True,
                 shared_neighbors=True, window=AUTO_WINDOW_SINGLE,
                 edgeset_backend=EdgeSetBackend.AUTO)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    _log(f"dataset ready in {time.time() - t0:.1f}s: N={cfg.N} E={cfg.E} "
         f"max_fan_out={cfg.max_fan_out}; device {dev.device_kind}")

    def measure(cfg, label, iters=10_000, trials=3):
        learner = Learner(cfg, graph, split)
        rates = timed_rates(learner, label, cfg.steps_per_call, iters,
                            trials)
        ppx = float(learner.heldout_perplexity())
        learner.close()
        _log(f"[{label}] best {max(rates):.0f} updates/s; heldout ppx "
             f"{ppx:.3f}")
        return rates, ppx

    head_rates, ppx = measure(cfg, "shared-neighbors")
    ups = max(head_rates)
    ref_rates, ref_ppx = measure(
        cfg.replace(shared_neighbors=False, window=0),
        "reference-semantics")
    # strictness-ladder floor: the BIT-EXACT reference RNG backend
    # (rng/reference.py — xorshift128+/Ziggurat/Marsaglia-Tsang with
    # the reference's per-lane stream discipline, random.cl.inc:13-398)
    # through the block decoder (rng/refblock.py; bit-identical,
    # tests/test_refblock.py): shared-draw > reference-semantics >
    # bit-exact.
    bl = Learner(cfg.replace(shared_neighbors=False, window=0,
                             device_sampling=False,
                             rng_backend=RngBackend.REFERENCE,
                             steps_per_call=200), graph, split)
    bitexact_ups = max(timed_rates(bl, "bit-exact-rng", 200, 1000, 2))
    bl.close()
    # device-sampled breadth-first family: the host FIFO expansion
    # order replayed exactly inside the fused loop
    # (ops/device_sampling._bf_expand); BFLink is its representative
    bfl = Learner(cfg.replace(strategy=SampleStrategy.BF_LINK,
                              shared_neighbors=False, window=0),
                  graph, split)
    bf_link_ups = max(timed_rates(bfl, "device-bflink", 1000, 10_000, 2))
    bfl.close()
    # stratified link/non-link coin (node_coin='alternate'): exactly-
    # 1/2 marginal, lower variance than the reference's RNG coin, and
    # each device sampler runs at half volume (config.py rationale)
    alt_rates, _ = measure(cfg.replace(node_coin="alternate",
                                       steps_per_call=996),
                           "stratified-coin")
    dt = 10_000 / ups

    # multi-chain aggregate (beyond-reference capability): C=16
    # independent chains in one fused program with the stratified coin
    n_chains = 16
    cl = FlatChainLearner(cfg.replace(steps_per_call=504,
                                      window=AUTO_WINDOW_CHAINS,
                                      node_coin="alternate"),
                          graph, split, num_chains=n_chains)
    chains_aggregate = max(timed_rates(cl, f"chains-c{n_chains}", 504,
                                       4032, 3, per_step=n_chains))

    # the sharded engine on a degenerate 1x1 mesh runs the SAME
    # headline config through shard_map; its ratio to the plain
    # Learner's rate is what the multi-device program costs per device
    # before any cross-device traffic
    sl = ShardedLearner(cfg, graph, split, make_mesh(1, 1))
    sharded_1x1 = max(timed_rates(sl, "sharded-1x1", cfg.steps_per_call,
                                  10_000, 3))
    sl.close()

    # degree-realistic convergence: seconds to target held-out ppx on
    # a com-DBLP-shaped degree-corrected power-law surrogate (N~317k,
    # avg deg 6.6, max degree ~343 — the real dataset's shape,
    # BASELINE.md). Heavy tails exercise the hub-sized NodeLink
    # batches (max_batch_edges = max fan-out) and the adjacency-budget
    # regime that the near-regular graph above never does. Target =
    # 90% of the way from the initial ppx to the run's floor (fixed
    # seeds -> reproducible across runs).
    t0 = time.time()
    n3, u3, v3 = synthetic_powerlaw_edges(
        317_080, 6.6, exponent=2.7, max_degree=343,
        num_communities=256, intra_fraction=0.85, seed=5)
    split3 = generate_sets(n3, u3, v3, heldout_ratio=0.01, seed=6)
    graph3 = Graph.from_edges(n3, split3.training_u, split3.training_v)
    # window=0: the hub degree (~304) pads every batch to B_cap=305
    # lanes and the window engine's correction codes scale with
    # T*B_cap (the CLI auto-window applies the same b_cap>64 fallback)
    cfg3 = Config(K=256, mini_batch_size=32, num_node_sample=32,
                  steps_per_call=1000, device_sampling=True,
                  shared_neighbors=True, window=0,
                  edgeset_backend=EdgeSetBackend.AUTO)
    cfg3 = cfg3.finalize(n3, split3.total_edges, graph3.max_fan_out)
    _log(f"powerlaw dataset ready in {time.time() - t0:.1f}s: "
         f"N={cfg3.N} E={cfg3.E} max_fan_out={cfg3.max_fan_out}")
    # exact NodeLink semantics (uncapped, hub-sized buffers)
    l3 = Learner(cfg3, graph3, split3)
    ppx0 = l3.heldout_perplexity()
    rate3 = max(timed_rates(l3, "powerlaw-exact", 1000, 10_000, 1))
    l3.close()

    # time-to-target on the production config: degree-capped hub
    # subsampling (ds_link_cap=32, Horvitz-Thompson reweight — the beta
    # gradient stays exactly unbiased) + the window the cap re-enables
    # (buffers shrink from hub degree ~304 to max(m, 32))
    cfg3c = cfg3.replace(ds_link_cap=32, window=AUTO_WINDOW_SINGLE)
    l3c = Learner(cfg3c, graph3, split3)
    capped_ups = max(timed_rates(l3c, "powerlaw-capped", 1000, 10_000, 1))
    # warm the fused-eval program at the SAME dispatch shape the timed
    # call uses (the eval cadence is part of the compiled scan), then
    # reset to a FRESH model so the timed series measures convergence
    # from step 0
    list(l3c.run_with_ppx(8000, 500))
    int(l3c.state.step_count)
    l3c.state = init_state(cfg3c, len(split3.heldout_edges_u))
    warm_steps = int(l3c.state.step_count)
    assert warm_steps == 1, warm_steps   # fresh state (learner.cc:117)
    base_t = time.perf_counter()
    series = [(ev["t"] - base_t, ev["step"] - warm_steps, ev["ppx"])
              for ev in l3c.run_with_ppx(24_000, 500)]
    dt_c = time.perf_counter() - base_t
    steps_c = int(l3c.state.step_count) - warm_steps
    assert steps_c == 24_000, steps_c
    floor = min(p for _, _, p in series)
    target = ppx0 - 0.9 * (ppx0 - floor)
    # seconds are chunk-granular (evals of one dispatch share a
    # materialization stamp); the crossing STEP is exact
    secs, target_step = next((s, st) for s, st, p in series
                             if p <= target)
    rate_c = steps_c / dt_c
    l3c.close()
    ttp = {
        "powerlaw_N": cfg3.N, "powerlaw_E": cfg3.E,
        "powerlaw_max_fan_out": cfg3.max_fan_out,
        "powerlaw_updates_per_sec": round(rate3, 2),
        "ppx_initial": round(float(ppx0), 4),
        "ppx_floor": round(float(floor), 4),
        "ppx_target": round(float(target), 4),
        "seconds_to_ppx_target": round(float(secs), 3),
        "steps_to_ppx_target": int(target_step),
        "seconds_to_ppx_target_config":
            f"ds_link_cap=32,window={cfg3c.window},interval=500 "
            "(eval-inclusive)",
        "powerlaw_capped_updates_per_sec": round(capped_ups, 2),
        "powerlaw_capped_eval_inclusive_updates_per_sec": round(rate_c, 2),
        "powerlaw_capped_ds_link_cap": 32,
    }
    _log(f"powerlaw capped: {rate_c:.0f} updates/s eval-inclusive, ppx "
         f"{ppx0:.3f} -> {floor:.3f}, target {target:.3f} reached in "
         f"{secs:.2f}s (step {target_step})")

    # autotune: probe the window candidates on THIS device/graph/config
    # and record the table. Probe rates rank candidates only — short
    # probes under-read the production rate — so the production/probe
    # scale at the headline's window is recorded alongside.
    probe_steps, warm_steps = 2000, 1000
    best_cfg, table = tune_window(
        cfg.replace(steps_per_call=1000), lambda c: Learner(c, graph, split),
        probe_steps=probe_steps, warm_steps=warm_steps)
    headline_probe_rate = table.get(cfg.window)
    autotune_table = {
        "rates_by_window": {str(w): (round(r, 1) if r else None)
                            for w, r in table.items()},
        "probe_steps": probe_steps,
        "warm_steps": warm_steps,
        "probe_trials": 2,
        "production_over_probe_scale": (
            round(ups / headline_probe_rate, 2)
            if headline_probe_rate else None),
        "production_window": cfg.window,
    }
    _log(f"autotune table: {autotune_table['rates_by_window']} -> "
         f"window={best_cfg.window}")

    # convergence sanity on a structured (planted-partition) graph:
    # held-out perplexity must fall substantially from its start
    t0 = time.time()
    n2, u2, v2 = synthetic_sbm_edges(20_000, 32, p_in=0.01, p_out=2e-4,
                                     seed=3)
    split2 = generate_sets(n2, u2, v2, heldout_ratio=0.02, seed=4)
    graph2 = Graph.from_edges(n2, split2.training_u, split2.training_v)
    cfg2 = Config(K=32, mini_batch_size=32, num_node_sample=32,
                  steps_per_call=200, edgeset_backend=EdgeSetBackend.AUTO)
    cfg2 = cfg2.finalize(n2, split2.total_edges, graph2.max_fan_out)
    l2 = Learner(cfg2, graph2, split2)
    ppx_start = l2.heldout_perplexity()
    l2.run(6000)
    ppx_end = l2.heldout_perplexity()
    l2.close()
    _log(f"SBM convergence: ppx {ppx_start:.3f} -> {ppx_end:.3f} after "
         f"6000 steps ({time.time() - t0:.1f}s)")

    print(json.dumps({
        "metric": "minibatch phi+beta updates/sec "
                  "(com-DBLP-scale synthetic, K=256, m=32, n=32; "
                  "shared-draw estimator — the strict "
                  "reference-semantics per-node-draw rate is "
                  "co-reported in extra.reference_semantics_rate)",
        "value": round(ups, 2),
        "unit": "updates/sec",
        "vs_baseline": None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            "N": cfg.N, "E": cfg.E, "K": cfg.K,
            "steps_per_call": cfg.steps_per_call,
            "seconds": round(dt, 3),
            "heldout_ppx": round(ppx, 4),
            "headline_trials": _spread(head_rates),
            "reference_semantics_trials": _spread(ref_rates),
            "shared_neighbors": True,
            "window": cfg.window,
            "reference_semantics_rate": round(max(ref_rates), 2),
            "reference_semantics_ppx": round(ref_ppx, 4),
            "bit_exact_rng_rate": round(bitexact_ups, 2),
            "device_bflink_rate": round(bf_link_ups, 2),
            "autotune_table": autotune_table,
            "autotune_choice": best_cfg.window,
            "stratified_coin_rate": round(max(alt_rates), 2),
            "chains_aggregate_rate": round(chains_aggregate, 2),
            "chains_aggregate_num_chains": n_chains,
            "chains_aggregate_node_coin": "alternate",
            # per-device cost of the multi-device program (shard_map on
            # a 1x1 mesh vs the plain Learner, same config; 1.0 = free)
            "sharded_1x1_rate": round(sharded_1x1, 2),
            "sharded_overhead_ratio": round(sharded_1x1 / ups, 4),
            "sbm_ppx_start": round(float(ppx_start), 4),
            "sbm_ppx_end": round(float(ppx_end), 4),
            **ttp,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
