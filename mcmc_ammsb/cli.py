"""Flag-compatible CLI driver.

Mirrors the reference binary's interface (/root/reference/main.cc:43-88):
same flag names where meaningful here, same log lines (config echo,
``ppx[i] = ...`` series, final stats table), SIGINT-drains the loop, and
supports the compressed dataset dump/load cache (main.cc:109-149).

Usage:
    python -m mcmc_ammsb.cli --file graph.txt -k 64 -x 10000 -i 100
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time

import numpy as np

from mcmc_ammsb.config import (Config, EdgeSetBackend, RngBackend,
                               SampleStrategy)
from mcmc_ammsb.data import (Graph, dump_dataset, generate_sets,
                             load_dataset, load_snap_edges,
                             synthetic_edges)
from mcmc_ammsb.learner import Learner, eval_series_call_steps
from mcmc_ammsb.utils.compile_cache import enable_compile_cache

log = logging.getLogger("mcmc_ammsb")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcmc_ammsb",
        description="a-MMSB SG-MCMC sampler (JAX)",
    )
    p.add_argument("--file", "-f", help="graph data file (SNAP edge list)")
    p.add_argument("--synthetic", type=str, default=None,
                   metavar="N,AVG_DEG",
                   help="use a synthetic random graph instead of --file")
    p.add_argument("--synthetic-powerlaw", type=str, default=None,
                   metavar="N,AVG_DEG[,MAX_DEG[,COMMUNITIES]]",
                   help="use a heavy-tailed (Chung-Lu degree-corrected "
                        "planted-partition) synthetic graph — the "
                        "degree-realistic surrogate for SNAP graphs "
                        "(com-DBLP ~ 317080,6.6,343,256; "
                        "com-LiveJournal ~ 3997962,17.35,14815,5000). "
                        "Pair with --ds-link-cap on hubby graphs")
    p.add_argument("--heldout-ratio", "-r", type=float, default=0.01)
    p.add_argument("--calc-train-ppx", action="store_true")
    p.add_argument("--train-ppx-ratio", type=float, default=0.01)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("-a", dest="a", type=float, default=0.0315)
    p.add_argument("-b", dest="b", type=float, default=1024.0)
    p.add_argument("-c", dest="c", type=float, default=0.5)
    p.add_argument("--epsilon", "-e", type=float, default=1e-7)
    p.add_argument("--eta0", type=float, default=1.0)
    p.add_argument("--eta1", type=float, default=1.0)
    p.add_argument("-k", dest="K", type=int, default=32)
    p.add_argument("--mini_batch", "-m", type=int, default=32)
    p.add_argument("--neighbors", "-n", type=int, default=32)
    p.add_argument("--ppx-interval", "-i", type=int, default=100)
    p.add_argument("--max-iters", "-x", type=int, default=100)
    p.add_argument("--sample", "-s", default="Node",
                   help="Node|NodeLink|NodeNonLink|BF|BFLink|BFNonLink")
    p.add_argument("--phi-seed", type=int, nargs=2, default=(42, 43))
    p.add_argument("--beta-seed", type=int, nargs=2, default=(44, 45))
    p.add_argument("--neighbor-seed", type=int, nargs=2, default=(56, 57))
    p.add_argument("--phi-disable-noise", action="store_true")
    # runtime knobs (replace the reference's wg/vector-width flags)
    p.add_argument("--edgeset", choices=[m.value for m in EdgeSetBackend],
                   default=EdgeSetBackend.AUTO.value)
    p.add_argument("--rng", choices=[m.value for m in RngBackend],
                   default=RngBackend.NATIVE.value)
    p.add_argument("--no-ref-rng-block", dest="ref_rng_block",
                   action="store_false", default=True,
                   help="with --rng reference: use the faithful "
                        "per-draw rejection loops instead of the "
                        "bit-identical block decoder (rng/refblock.py; "
                        "same bits, 25x faster compiles — the loops "
                        "remain as the cross-check oracle)")
    p.add_argument("--theta-init", choices=["native", "libstdc++"],
                   default="native",
                   help="theta init bit stream: 'libstdc++' reproduces "
                        "the reference's exact std::mt19937 + "
                        "std::gamma_distribution host stream via the "
                        "native library (learner.cc:149-153) for "
                        "cross-implementation trajectory comparison "
                        "from step 0")
    p.add_argument("--pi-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="pi STORAGE precision (compute stays fp32): "
                        "bfloat16 halves the pi device-memory "
                        "footprint — the capacity lever for very large "
                        "K (a-MMSB single-device, --mesh and the flat "
                        "chain engine)")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="lax.scan fusion depth of the training loop; "
                        "0 = auto (1000 with device sampling, the eval "
                        "interval otherwise)")
    p.add_argument("--device-sampling",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="sample minibatches on device inside the fused "
                        "loop (Node-family strategies). Default: auto — "
                        "ON whenever the strategy/RNG support "
                        "it (the reference's defaults are its fast "
                        "path, main.cc:43-88; ours follow suit). "
                        "--no-device-sampling restores host sampling")
    p.add_argument("--shared-neighbors",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="one shared n-neighbor draw per step instead "
                        "of per minibatch node (unbiased per node; "
                        "cuts the dominant pi-row gather cost B*n -> "
                        "n; held-out ppx parity 0.2%%). Default: auto "
                        "— follows --device-sampling. "
                        "--no-shared-neighbors restores the "
                        "reference's per-node draw semantics")
    p.add_argument("--window", type=int, default=0,
                   help="T-step fused window engine: each scan "
                        "iteration advances T steps with one bulk "
                        "gather + the T steps' updates + one "
                        "scatter; intra-window collisions are "
                        "redirected via exact one-hot selects so the "
                        "trajectory is exactly the sequential scan's "
                        "(requires the fast-path defaults; 0 = auto "
                        "[6 for flat multi-chain runs, off for one "
                        "chain: the measured fastest], -1 = off)")
    p.add_argument("--node-coin", choices=["random", "alternate"],
                   default="random",
                   help="Node-strategy link/non-link choice per step: "
                        "'random' = the reference's RNG coin (device "
                        "sampling computes BOTH draws and selects); "
                        "'alternate' = strict alternation — each "
                        "device sampler runs at half volume, the "
                        "marginal stays exactly 1/2 (stratified coin; "
                        "device sampling only)")
    p.add_argument("--ds-link-rounds", type=int, default=2,
                   help="device NodeLink pivot redraw rounds (the "
                        "host sampler retries unboundedly; residual "
                        "isolated pivots after the rounds yield an "
                        "all-masked, zero-gradient batch)")
    p.add_argument("--ds-nonlink-rounds", type=int, default=1,
                   help="device NodeNonLink candidate redraw rounds; "
                        "residual bad lanes are masked and the "
                        "2E/m_eff reweight keeps the estimator "
                        "unbiased at any rate, so 1 round suffices "
                        "except on very dense graphs (each round "
                        "re-runs the full candidate check — most of "
                        "the device-sampling cost)")
    p.add_argument("--ds-link-cap", type=int, default=0,
                   help="degree cap for device NodeLink draws (0 = "
                        "off). On heavy-tailed graphs buffers shrink "
                        "from max(m, max_degree) to max(m, cap) edges; "
                        "hub rows are uniformly subsampled with the "
                        "Horvitz-Thompson reweight N/(1-(1-1/d)^cap) "
                        "so the beta gradient stays unbiased")
    p.add_argument("--auto-tune-window", action="store_true",
                   help="probe candidate window sizes on the device "
                        "before training and keep the fastest "
                        "(autotune.py; one compile per candidate — "
                        "worth it for production-length runs)")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage timing table at exit "
                        "(PrintStats-style per-kernel attribution)")
    p.add_argument("--num-chains", type=int, default=1,
                   help="run C independent MCMC chains in one fused "
                        "program (implies --device-sampling)")
    p.add_argument("--chain-engine", choices=["flat", "vmap"],
                   default="flat",
                   help="multi-chain engine: 'flat' shares one row "
                        "space (fast scatter path); 'vmap' batches a "
                        "chain axis (measured slower; kept for "
                        "cross-checks)")
    p.add_argument("--rhat-draws", type=int, default=0,
                   help="with --num-chains >= 2: after training, run "
                        "this many extra steps_per_call chunks keeping "
                        "beta after each and log the Gelman-Rubin "
                        "R-hat across chains (>= 2 draws; 0 = off)")
    p.add_argument("--chain-devices", type=int, default=1,
                   help="spread --num-chains over this many devices "
                        "(whole chains per chip, zero collectives; "
                        "requires the flat engine and "
                        "num_chains %% chain_devices == 0)")
    p.add_argument("--model", choices=["ammsb", "mmsb"], default="ammsb",
                   help="model family: 'ammsb' = the reference's "
                        "assortative MMSB (diagonal beta + epsilon "
                        "background); 'mmsb' = full [K,K] block matrix "
                        "(beyond-reference; see models/mmsb.py for the "
                        "identifiability knobs)")
    p.add_argument("--mmsb-prior-diag", type=float, nargs=2, default=None,
                   metavar=("ETA0", "ETA1"),
                   help="full-MMSB: per-cell prior for DIAGONAL theta_B "
                        "cells (assortative regularization)")
    p.add_argument("--mmsb-noise-scale", type=float, default=1.0,
                   help="full-MMSB: SGRLD noise temperature (<1 tempers)")
    p.add_argument("--mesh", type=str, default="", metavar="DATA,MODEL",
                   help="train multi-chip: shard pi rows over MODEL "
                        "devices and the minibatch over DATA devices "
                        "of a (DATA, MODEL) jax device mesh")
    # multi-host (pod-scale) execution: jax.distributed wiring +
    # per-process byte-range ingest (parallel/multihost.py,
    # parallel/partitioned.py)
    p.add_argument("--coordinator", type=str, default="",
                   metavar="HOST:PORT",
                   help="jax.distributed coordinator address (process "
                        "0's host); required with --num-processes > 1")
    p.add_argument("--num-processes", type=int, default=0,
                   help="total jax.distributed process count (0/1 = "
                        "single-process)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's jax.distributed index")
    p.add_argument("--partitioned-ingest", action="store_true",
                   help="multi-host capacity mode: each process parses "
                        "only its byte range of --file, edges are "
                        "exchanged to their owning model shards, and "
                        "BOTH E-sized device structures (membership "
                        "set, sampling adjacency) live row-sharded "
                        "over the mesh 'model' axis — no process ever "
                        "materializes the full graph. Requires --mesh "
                        "and device sampling; held-out split is the "
                        "deterministic hash rule (see "
                        "parallel/partitioned.py docstring)")
    p.add_argument("--split-seed", type=int, default=12345,
                   help="seed of the held-out split (the hash rule "
                        "under --partitioned-ingest; generate_sets' "
                        "shuffle otherwise uses its own default)")
    # dataset cache (main.cc:77-80)
    p.add_argument("--dump-data", action="store_true")
    p.add_argument("--dump-file", type=str, default="")
    p.add_argument("--load-data", action="store_true")
    p.add_argument("--load-file", type=str, default="")
    p.add_argument("--cache-format", choices=["npz", "ref"],
                   default="npz",
                   help="dump format: npz (native) or ref — the "
                        "reference's gzip binary layout, "
                        "byte-interoperable with its --dump-data "
                        "files (loading auto-detects either)")
    # checkpointing (the reference only exercises this in tests)
    p.add_argument("--checkpoint", type=str, default="",
                   help="save checkpoint here at exit / SIGINT")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   metavar="ITERS",
                   help="also checkpoint every ITERS training steps "
                        "(rounded up to eval-loop boundaries); with "
                        "--checkpoint-backend orbax the save is ASYNC "
                        "— training resumes as soon as the state is "
                        "copied off the device")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz = one file; orbax = sharding-aware "
                        "directory (pod-scale multi-host writes)")
    p.add_argument("--restore", type=str, default="",
                   help="restore checkpoint before training "
                        "(file = npz, directory = orbax)")
    p.add_argument("--restore-ref", type=str, default="",
                   help="import a checkpoint written by the REFERENCE "
                        "binary (length-prefixed protobuf stream, "
                        "serialize.h:13-113) as the initial state; the "
                        "file's layout depends on whether the writer "
                        "ran with MCMC_CALC_TRAIN_PPX — match it with "
                        "--calc-train-ppx here. Single-model engines "
                        "only (the reference is single-GPU).")
    p.add_argument("--checkpoint-ref", type=str, default="",
                   help="at the end of training, ALSO write the state "
                        "in the reference binary's checkpoint format "
                        "(the export twin of --restore-ref; a run "
                        "trained here resumes under the reference). "
                        "Buffers are sized to the reference's "
                        "allocation laws and in-flight minibatch "
                        "Sample sections are included, so its "
                        "Learner::Parse accepts the file "
                        "(refckpt.ReferenceLayout).")
    p.add_argument("--ref-rows-in-block", type=int, default=0,
                   help="rows_in_block for the exported pi "
                        "RowPartitionedMatrix: the reference REJECTS "
                        "any value that differs from the target "
                        "device's RowsPerBlock (serialize.h:100-104). "
                        "Default 0 = the CUDA build's computed "
                        "512MiB/(K*4) (partitioned-alloc.h:125-131); "
                        "pass the device's MaxAllocSize/(K*4) when "
                        "targeting an OpenCL build.")
    return p


_NODE_FAMILY = (SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                SampleStrategy.NODE_NON_LINK)
_BF_FAMILY = (SampleStrategy.BF, SampleStrategy.BF_LINK,
              SampleStrategy.BF_NON_LINK)

#: Auto window sizes (``--window 0``), from the H100 measurements at
#: N=317k, K=256, m=n=32 (PERF.md): one chain runs fastest on the
#: sequential scan (window=0 beat T=6 and T=12); 16 flat chains run
#: fastest at T=6.
AUTO_WINDOW_SINGLE = 0
AUTO_WINDOW_CHAINS = 6


def resolve_fast_defaults(args) -> None:
    """Resolve auto flags to the measured fast path (in place).

    The reference's defaults ARE its fast path (main.cc:43-88 pick the
    tuned kernels); ours mirror that: device sampling + shared
    per-step neighbor draws + deep fused dispatches whenever the
    configuration supports them.
    The reference-exact slow path stays reachable:
    --no-device-sampling --no-shared-neighbors --steps-per-call 1.
    """
    strategy = SampleStrategy.parse(args.sample)
    fast_ok = (strategy in _NODE_FAMILY
               and args.rng == RngBackend.NATIVE.value)
    # the device BF family (exact FIFO replay, ops/device_sampling.py)
    # unlocks the fused eval series; shared draws / windows stay
    # Node-family-only
    bf_ok = (strategy in _BF_FAMILY
             and args.rng == RngBackend.NATIVE.value)
    if args.device_sampling is None:
        args.device_sampling = fast_ok or bf_ok
        if fast_ok:
            log.info("device sampling auto-enabled (Node-family "
                     "strategy, native RNG); --no-device-sampling "
                     "restores host sampling")
        elif bf_ok:
            log.info("device sampling auto-enabled (breadth-first "
                     "family, exact host-FIFO replay); "
                     "--no-device-sampling restores host sampling")
    if args.shared_neighbors is None:
        # shared draws keep per-node gradients unbiased but are a
        # documented semantic deviation (one n-draw per step); only
        # auto-enable on the supported fast path
        args.shared_neighbors = fast_ok and bool(args.device_sampling)
        if args.shared_neighbors:
            log.info("shared neighbor draws auto-enabled (unbiased per "
                     "node, held-out ppx parity 0.2%%); "
                     "--no-shared-neighbors restores per-node draws")
    if args.steps_per_call <= 0:
        if args.device_sampling:
            args.steps_per_call = max(1000, args.ppx_interval)
        else:
            # host-sampled: one dispatch per eval period
            args.steps_per_call = max(1, min(200, args.ppx_interval))
        log.info("steps_per_call auto-set to %d", args.steps_per_call)
    if (args.window == 0 and args.device_sampling
            and args.shared_neighbors
            and args.model == "ammsb"
            and not (args.num_chains > 1
                     and args.chain_engine != "flat")):
        # the T-step fused window engine (ops/window.py), where it
        # measured faster than the sequential scan (AUTO_WINDOW_*)
        args.window = (AUTO_WINDOW_CHAINS if args.num_chains > 1
                       else AUTO_WINDOW_SINGLE)
        if args.window:
            args.window_auto = True
            log.info("window auto-set to %d (T-step fused windows; "
                     "--window -1 disables)", args.window)
    if args.window < 0:
        args.window = 0


def config_from_args(args) -> Config:
    return Config(
        K=args.K,
        alpha=args.alpha,
        a=args.a, b=args.b, c=args.c,
        epsilon=args.epsilon,
        eta0=args.eta0, eta1=args.eta1,
        mini_batch_size=args.mini_batch,
        num_node_sample=args.neighbors,
        strategy=SampleStrategy.parse(args.sample),
        heldout_ratio=args.heldout_ratio,
        calc_train_ppx=args.calc_train_ppx,
        training_ppx_ratio=args.train_ppx_ratio,
        device_sampling=args.device_sampling,
        shared_neighbors=args.shared_neighbors,
        ppx_interval=args.ppx_interval,
        phi_seed=tuple(args.phi_seed),
        beta_seed=tuple(args.beta_seed),
        neighbor_seed=tuple(args.neighbor_seed),
        phi_disable_noise=args.phi_disable_noise,
        edgeset_backend=EdgeSetBackend(args.edgeset),
        rng_backend=RngBackend(args.rng),
        ref_rng_block=args.ref_rng_block,
        theta_init=args.theta_init,
        pi_dtype=args.pi_dtype,
        steps_per_call=args.steps_per_call,
        window=args.window,
        node_coin=args.node_coin,
        ds_link_rounds=args.ds_link_rounds,
        ds_nonlink_rounds=args.ds_nonlink_rounds,
        ds_link_cap=args.ds_link_cap,
        mmsb_prior_diag=(tuple(args.mmsb_prior_diag)
                         if args.mmsb_prior_diag else None),
        mmsb_noise_scale=args.mmsb_noise_scale,
    )


def _main_partitioned(args) -> int:
    """Multi-host capacity driver: per-process byte-range ingest +
    ShardedLearner.from_partitioned (parallel/partitioned.py). Every
    process runs this loop; training collectives keep them in lockstep
    and each logs the identical ppx series."""
    from mcmc_ammsb.parallel import make_mesh
    from mcmc_ammsb.parallel.partitioned import partitioned_ingest

    if not args.file:
        log.fatal("--partitioned-ingest requires --file (SNAP edge "
                  "list; byte-range split across processes)")
        return 1
    if not args.mesh:
        log.fatal("--partitioned-ingest requires --mesh DATA,MODEL")
        return 1
    if not args.device_sampling:
        log.fatal("--partitioned-ingest requires device sampling (no "
                  "process holds the host graph)")
        return 1
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    mesh = make_mesh(n_data, n_model)
    pdata = partitioned_ingest(mesh, heldout_ratio=args.heldout_ratio,
                               seed=args.split_seed, path=args.file)
    log.info("partitioned ingest: N=%d E=%d max_fan_out=%d; this "
             "process parsed %d edges, largest shard holds %d "
             "(full graph never materialized)",
             pdata.num_nodes, pdata.num_edges, pdata.max_fan_out,
             pdata.local_parse_edges, pdata.max_shard_edges)
    cfg = config_from_args(args).finalize(
        pdata.num_nodes, pdata.num_edges, pdata.max_fan_out)
    log.info("config: %s", cfg)

    from mcmc_ammsb.parallel import ShardedLearner
    learner = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    if args.restore:
        # resume a killed pod run: the orbax directory restore maps
        # shards straight onto this mesh's shardings (the
        # reference's resume contract, serialize-test.cc:90-134)
        from mcmc_ammsb.checkpoint import load_checkpoint
        load_checkpoint(args.restore, learner)
        log.info("restored checkpoint %s (step=%d)", args.restore,
                 int(learner.state.step_count))

    signaled = {"flag": False}
    signal.signal(signal.SIGINT,
                  lambda _s, _f: signaled.update(flag=True))
    log.info("ppx[0] = %s", learner.heldout_perplexity())
    fused_evals = cfg.steps_per_call > cfg.ppx_interval
    ck_next = [args.checkpoint_interval or None]

    def maybe_checkpoint(i):
        """Periodic checkpoint (--checkpoint-interval): every process
        participates in the orbax save (per-host shard writes), async
        so training resumes after the device->host copy."""
        if ck_next[0] is None or i < ck_next[0] or not args.checkpoint:
            return
        from mcmc_ammsb.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, learner,
                        backend=args.checkpoint_backend,
                        async_save=args.checkpoint_backend == "orbax")
        log.info("checkpoint saved to %s (step %d)%s", args.checkpoint,
                 i, " [async]" if args.checkpoint_backend == "orbax"
                 else "")
        while ck_next[0] <= i:
            ck_next[0] += args.checkpoint_interval

    i = 0
    start_step = int(learner.state.step_count)
    while i < args.max_iters and not signaled["flag"]:
        if fused_evals and args.max_iters - i >= cfg.ppx_interval:
            take = min(args.max_iters - i,
                       eval_series_call_steps(cfg.steps_per_call,
                                              cfg.ppx_interval))
            take -= take % cfg.ppx_interval
            for ev in learner.run_with_ppx(take, cfg.ppx_interval):
                log.info("ppx[%d] = %s", ev["step"] - start_step,
                         ev["ppx"])
                if "train_ppx" in ev:
                    log.info("train_ppx[%d] = %s",
                             ev["step"] - start_step, ev["train_ppx"])
            i += take
            maybe_checkpoint(i)
        else:
            step = min(args.max_iters - i, cfg.ppx_interval)
            learner.run(step)
            i += step
            if not signaled["flag"]:
                log.info("ppx[%d] = %s", i,
                         learner.heldout_perplexity())
                if cfg.calc_train_ppx:
                    log.info("train_ppx[%d] = %s", i,
                             learner.training_perplexity())
            maybe_checkpoint(i)
    if signaled["flag"]:
        log.info("FORCED TERMINATE")
    learner.print_stats(lambda s: log.info("%s", s))
    if args.profile and hasattr(learner, "print_stage_profile"):
        learner.print_stage_profile(lambda s: log.info("%s", s))
    if args.checkpoint:
        from mcmc_ammsb.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, learner,
                        backend=args.checkpoint_backend)
        log.info("checkpoint saved to %s", args.checkpoint)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname).1s %(asctime)s %(name)s] %(message)s",
        stream=sys.stderr,
    )
    args = build_arg_parser().parse_args(argv)
    log.info(" ".join(sys.argv if argv is None else argv))
    resolve_fast_defaults(args)

    enable_compile_cache()
    # multi-host wiring BEFORE any backend touch (jax.distributed must
    # initialize before the first device query)
    if args.num_processes and args.num_processes > 1:
        from mcmc_ammsb.parallel import multihost
        multihost.initialize(
            coordinator_address=args.coordinator or None,
            num_processes=args.num_processes,
            process_id=args.process_id)
        log.info("jax.distributed: process %d of %d (coordinator %s)",
                 args.process_id, args.num_processes, args.coordinator)

    # device/backend echo (ChooseDevice parity, main.cc:17-20,94-96)
    import jax
    devices = jax.devices()
    log.info("backend %s: %d device(s), first = %s",
             jax.default_backend(), len(devices), devices[0].device_kind)

    if args.partitioned_ingest:
        return _main_partitioned(args)

    # --- dataset ----------------------------------------------------------
    if args.load_data:
        if not args.load_file:
            log.fatal("load-file is required with load-data")
            return 1
        n, ratio, u, v = load_dataset(args.load_file)
        args.heldout_ratio = ratio
    elif args.synthetic:
        nn, deg = (int(x) for x in args.synthetic.split(","))
        n, u, v = synthetic_edges(nn, deg, seed=1)
    elif args.synthetic_powerlaw:
        from mcmc_ammsb.data import synthetic_powerlaw_edges
        parts = args.synthetic_powerlaw.split(",")
        nn, deg = int(parts[0]), float(parts[1])
        max_deg = int(parts[2]) if len(parts) > 2 else None
        comms = int(parts[3]) if len(parts) > 3 else 0
        n, u, v = synthetic_powerlaw_edges(
            nn, deg, max_degree=max_deg, num_communities=comms, seed=1)
    elif args.file:
        n, u, v = load_snap_edges(args.file)
    else:
        log.fatal("one of --file / --synthetic / --synthetic-powerlaw / "
                  "--load-data is required")
        return 1

    if args.dump_data:
        if not args.dump_file:
            log.fatal("dump-file is required with dump-data")
            return 1
        dump_dataset(args.dump_file, n, args.heldout_ratio, u, v,
                     fmt=args.cache_format)
        return 0

    split = generate_sets(n, u, v, args.heldout_ratio)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config_from_args(args).finalize(n, split.total_edges,
                                          graph.max_fan_out)
    if getattr(args, "window_auto", False) and cfg.max_batch_nodes > 64:
        # heavy-tailed graph: the node buffer pads every batch to the
        # HUB degree, and the window engine's collision correction
        # scales with T*B_cap. Auto mode falls back; --window N forces.
        log.info("window auto-disabled: max_batch_nodes=%d > 64 "
                 "(hub-degree-padded batches; the windowed correction "
                 "scales with T*B_cap)", cfg.max_batch_nodes)
        cfg = cfg.replace(window=0)
    if args.auto_tune_window:
        # measured window choice (autotune.py): probe each candidate T
        # on THIS device/graph/config and keep the fastest — the
        # reference leaves its analogous kernel tunables (wg sizes,
        # vector widths) to the user (/root/reference/main.cc:61-76).
        # Each candidate pays one compile, so this is opt-in.
        if args.mesh or args.model == "mmsb" or (
                args.num_chains > 1 and args.chain_engine != "flat"):
            log.warning("--auto-tune-window supports the single-chip "
                        "and flat-chain engines; keeping window=%d",
                        cfg.window)
        else:
            from mcmc_ammsb.autotune import tune_window

            def _make(c):
                if args.num_chains > 1:
                    from mcmc_ammsb.chains_flat import (
                        FlatChainLearner)
                    return FlatChainLearner(c, graph, split,
                                            args.num_chains)
                return Learner(c, graph, split)

            cfg, table = tune_window(cfg, _make)
            log.info("window auto-tuned to %d (probed %s)", cfg.window,
                     {w: (f"{r:.0f}/s" if r else "failed")
                      for w, r in table.items()})
    log.info("Loaded %s (N=%d, E=%d, training max fan out = %d)",
             args.load_file or args.file or args.synthetic
             or args.synthetic_powerlaw,
             cfg.N, cfg.E, cfg.max_fan_out)
    log.info("config: %s", cfg)

    # --- SIGINT drain (main.cc:22-24,159-169) -----------------------------
    signaled = {"flag": False}

    def handler(_sig, _frm):
        signaled["flag"] = True

    signal.signal(signal.SIGINT, handler)

    if args.restore_ref and (args.num_chains > 1 or args.model == "mmsb"
                             or args.mesh):
        log.fatal("--restore-ref imports the reference's single-GPU "
                  "state; use the single-chip a-MMSB engine")
        return 1
    if args.rhat_draws and (args.rhat_draws < 2 or args.num_chains < 2
                            or args.model == "mmsb"):
        log.fatal("--rhat-draws needs >= 2 draws and --num-chains >= 2 "
                  "a-MMSB chains (R-hat is a between-chain statistic)")
        return 1
    if args.checkpoint_ref and (args.num_chains > 1
                                or args.model == "mmsb"):
        log.fatal("--checkpoint-ref exports the a-MMSB single-model "
                  "state the reference binary can read (chains/mmsb "
                  "have no reference-format counterpart)")
        return 1

    if args.num_chains > 1:
        if args.chain_devices > 1:
            if args.chain_engine != "flat":
                log.fatal("--chain-devices requires the flat engine")
                return 1
            from mcmc_ammsb.parallel.chains_sharded import (
                ShardedChainLearner, make_chain_mesh)
            chains = ShardedChainLearner(
                cfg, graph, split, args.num_chains,
                make_chain_mesh(args.chain_devices))
        elif args.chain_engine == "flat":
            # one shared row space, plain 1-D scatters (the vmap engine
            # batches its scatter instead)
            from mcmc_ammsb.chains_flat import FlatChainLearner
            chains = FlatChainLearner(cfg, graph, split, args.num_chains)
        else:
            from mcmc_ammsb.chains import MultiChainLearner
            chains = MultiChainLearner(cfg, graph, split, args.num_chains)
        if args.restore:
            from mcmc_ammsb.checkpoint import load_checkpoint
            load_checkpoint(args.restore, chains)
            log.info("restored checkpoint %s (step=%d)", args.restore,
                     int(chains.state.step_count))
        log.info("ppx[0] = %s", chains.heldout_perplexity())
        fused_evals = (hasattr(chains, "run_with_ppx")
                       and cfg.steps_per_call > cfg.ppx_interval)
        i = 0
        start_step = int(chains.state.step_count)
        while i < args.max_iters and not signaled["flag"]:
            if fused_evals and args.max_iters - i >= cfg.ppx_interval:
                # 4 dispatch-chunks per call: the series driver
                # pipelines readbacks across dispatches WITHIN one
                # call (run_fused_eval_series depth=2), so one-chunk
                # calls would serialize against each readback
                take = min(args.max_iters - i,
                           eval_series_call_steps(cfg.steps_per_call,
                                                  cfg.ppx_interval))
                take -= take % cfg.ppx_interval
                for ev in chains.run_with_ppx(take, cfg.ppx_interval):
                    log.info("ppx[%d] = %s", ev["step"] - start_step,
                             ev["ppx"])
                i += take
            else:
                step = min(args.max_iters - i, cfg.ppx_interval)
                chains.run(step)
                i += step
                if not signaled["flag"]:
                    log.info("ppx[%d] = %s", i,
                             chains.heldout_perplexity())
        if signaled["flag"]:
            log.info("FORCED TERMINATE")
        if (args.rhat_draws >= 2 and args.num_chains >= 2
                and not signaled["flag"]
                and hasattr(chains, "beta_rhat")):
            # population-level convergence diagnostic (Gelman-Rubin
            # PSRF over beta across the chains; values near 1 =
            # between-chain agreement)
            r = chains.beta_rhat(draws=args.rhat_draws)
            log.info("beta R-hat over %d chains (%d draws of %d "
                     "steps): max %.4f  median %.4f",
                     args.num_chains, args.rhat_draws,
                     max(1, cfg.steps_per_call),
                     float(np.max(r)), float(np.median(r)))
        chains.timers.print_table(lambda s: log.info("%s", s))
        if args.profile and hasattr(chains, "print_stage_profile"):
            chains.print_stage_profile(lambda s: log.info("%s", s))
        if args.checkpoint:
            from mcmc_ammsb.checkpoint import save_checkpoint
            save_checkpoint(args.checkpoint, chains,
                            backend=args.checkpoint_backend)
            log.info("checkpoint saved to %s", args.checkpoint)
        if hasattr(chains, "close"):
            chains.close()
        return 0

    if args.model == "mmsb":
        if args.mesh:
            log.fatal("--model mmsb is single-chip (use --num-chains "
                      "for parallelism)")
            return 1
        if args.num_chains > 1:
            from mcmc_ammsb.models.mmsb import MMSBChainLearner
            mmsb = MMSBChainLearner(cfg, graph, split, args.num_chains)
        else:
            from mcmc_ammsb.models.mmsb import FullMMSBLearner
            mmsb = FullMMSBLearner(cfg, graph, split)
        if args.restore:
            from mcmc_ammsb.checkpoint import load_checkpoint
            load_checkpoint(args.restore, mmsb)
            log.info("restored checkpoint %s (step=%d)", args.restore,
                     int(mmsb.state.step_count))
        log.info("ppx[0] = %s", mmsb.heldout_perplexity())
        # chain engines force device sampling internally; read the
        # engine's own cfg
        fused_evals = (mmsb.cfg.device_sampling
                       and cfg.steps_per_call > cfg.ppx_interval)
        i = 0
        start_step = int(mmsb.state.step_count)
        while i < args.max_iters and not signaled["flag"]:
            if fused_evals and args.max_iters - i >= cfg.ppx_interval:
                # 4 dispatch-chunks per call (pipelined readbacks —
                # see the chain loop's rationale)
                take = min(args.max_iters - i,
                           eval_series_call_steps(cfg.steps_per_call,
                                                  cfg.ppx_interval))
                take -= take % cfg.ppx_interval
                for ev in mmsb.run_with_ppx(take, cfg.ppx_interval):
                    log.info("ppx[%d] = %s", ev["step"] - start_step,
                             ev["ppx"])
                i += take
            else:
                step = min(args.max_iters - i, cfg.ppx_interval)
                mmsb.run(step)
                i += step
                if not signaled["flag"]:
                    log.info("ppx[%d] = %s", i,
                             mmsb.heldout_perplexity())
        if signaled["flag"]:
            log.info("FORCED TERMINATE")
        mmsb.print_stats(lambda s: log.info("%s", s))
        if args.checkpoint:
            from mcmc_ammsb.checkpoint import save_checkpoint
            save_checkpoint(args.checkpoint, mmsb,
                            backend=args.checkpoint_backend)
            log.info("checkpoint saved to %s", args.checkpoint)
        if hasattr(mmsb, "close"):
            mmsb.close()
        return 0

    if args.mesh:
        from mcmc_ammsb.parallel import ShardedLearner, make_mesh
        n_data, n_model = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh(n_data, n_model)
        log.info("mesh: data=%d model=%d (pi rows sharded %d-way)",
                 n_data, n_model, n_model)
        learner = ShardedLearner(cfg, graph, split, mesh)
    else:
        learner = Learner(cfg, graph, split)
    if args.restore:
        from mcmc_ammsb.checkpoint import load_checkpoint
        load_checkpoint(args.restore, learner)
        log.info("restored checkpoint %s (step=%d)", args.restore,
                 int(learner.state.step_count))
    if args.restore_ref:
        # cross-implementation bridge: resume a run the
        # REFERENCE binary checkpointed (learner.cc:301-330 byte layout)
        from mcmc_ammsb.refckpt import (read_reference_checkpoint,
                                        to_train_state)
        raw = read_reference_checkpoint(
            args.restore_ref, with_train_ppx=cfg.calc_train_ppx)
        h = len(split.heldout_edges_u)
        if len(raw["ppx_per_edge"]) != h:
            # different held-out population (e.g. another split seed):
            # the model state still imports; the running per-edge ppx
            # averages restart from zero
            log.warning("reference checkpoint held-out size %d != %d "
                        "here; ppx running averages restart",
                        len(raw["ppx_per_edge"]), h)
            raw = dict(raw, ppx_per_edge=np.zeros(h, np.float32),
                       ppx_count=0)
        learner.state = to_train_state(cfg, raw, heldout_size=h)
        log.info("imported reference checkpoint %s (step=%d)",
                 args.restore_ref, int(learner.state.step_count))

    log.info("ppx[0] = %s", learner.heldout_perplexity())

    def log_eval(i, ppx, st):
        log.info("ppx[%d] = %s", i, ppx)
        # per-eval link/non-link diagnostics (the reference logs the
        # same quadruple every ppx call, perplexity.cc:269-272)
        log.info("  links: %d (ll %.4f)  non-links: %d (ll %.4f)",
                 st["link_count"], st["link_likelihood"],
                 st["non_link_count"], st["non_link_likelihood"])
        if cfg.calc_train_ppx:
            # fused series entries carry the train-ppx value computed
            # INSIDE the fused program (same packed readback); the
            # host loop evaluates it here instead — identical running
            # averages either way (train_steps_fused_ppx order)
            log.info("train_ppx[%d] = %s", i,
                     st["train_ppx"] if "train_ppx" in st
                     else learner.training_perplexity())

    fused_evals = (cfg.device_sampling
                   and cfg.steps_per_call > cfg.ppx_interval)
    ck_next = [args.checkpoint_interval or None]

    def maybe_checkpoint(i):
        """Periodic checkpoint (--checkpoint-interval), checked at
        eval-loop boundaries; orbax saves are async so training
        resumes right after the device->host copy."""
        if ck_next[0] is None or i < ck_next[0] or not args.checkpoint:
            return
        from mcmc_ammsb.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, learner,
                        backend=args.checkpoint_backend,
                        async_save=args.checkpoint_backend == "orbax")
        log.info("checkpoint saved to %s (step %d)%s", args.checkpoint,
                 i, " [async]" if args.checkpoint_backend == "orbax"
                 else "")
        while ck_next[0] <= i:
            ck_next[0] += args.checkpoint_interval

    i = 0
    start_step = int(learner.state.step_count)
    while i < args.max_iters and not signaled["flag"]:
        if fused_evals and args.max_iters - i >= cfg.ppx_interval:
            # evals ride inside the fused program (train_steps_fused_ppx)
            # so the eval cadence doesn't cap the scan depth; each
            # run_with_ppx call dispatches ~steps_per_call steps and
            # SIGINT stays responsive between calls. Only whole eval
            # periods run fused; any final partial chunk falls to the
            # host path below, which always ends on an eval (the old
            # loop's behavior).
            # 4 dispatch-chunks per call: the series driver pipelines
            # readbacks across dispatches WITHIN one call
            # (run_fused_eval_series depth=2); one-chunk calls would
            # serialize against each readback
            take = min(args.max_iters - i,
                       eval_series_call_steps(cfg.steps_per_call,
                                              cfg.ppx_interval))
            take -= take % cfg.ppx_interval
            for ev in learner.run_with_ppx(take, cfg.ppx_interval):
                log_eval(ev["step"] - start_step, ev["ppx"], ev)
            i += take
            maybe_checkpoint(i)
        else:
            step = min(args.max_iters - i, cfg.ppx_interval)
            learner.run(step)
            i += step
            if not signaled["flag"]:
                log_eval(i, learner.heldout_perplexity(),
                         learner.last_ppx_stats)
            maybe_checkpoint(i)
    if signaled["flag"]:
        log.info("FORCED TERMINATE")
    learner.print_stats(lambda s: log.info("%s", s))
    if args.profile and hasattr(learner, "print_stage_profile"):
        learner.print_stage_profile(lambda s: log.info("%s", s))
    if args.checkpoint:
        from mcmc_ammsb.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, learner,
                        backend=args.checkpoint_backend)
        log.info("checkpoint saved to %s", args.checkpoint)
    if args.checkpoint_ref:
        from mcmc_ammsb.refckpt import export_reference_checkpoint
        # sharded engines pad the eval buffers to the data axis; the
        # reference allocates the TRUE population sizes
        tmask = getattr(learner, "train_ppx_mask", None)
        export_reference_checkpoint(
            args.checkpoint_ref, cfg, learner.state, graph, split,
            rows_in_block=args.ref_rows_in_block,
            heldout_size=len(split.heldout_edges_u),
            train_ppx_size=(int(np.asarray(tmask).sum())
                            if tmask is not None else None))
        log.info("reference-format checkpoint saved to %s (step=%d)",
                 args.checkpoint_ref, int(learner.state.step_count))
    learner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
