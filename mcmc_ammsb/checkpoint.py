"""Checkpoint / resume.

The reference serializes every stateful object as length-prefixed
protobufs wrapping raw device-buffer bytes — model arrays, all counters
and timers, RNG seed arrays, the perplexity running averages, and the
in-flight pipelined minibatch — and asserts bit-exact resume
(/root/reference/mcmc/serialize.h, learner.cc:301-361,
serialize-test.cc:90-134).

Here: the whole ``TrainState`` is a pytree of arrays, so
a checkpoint is one ``savez`` of its leaves plus a JSON manifest of the
config and host-sampler state. jax.random keys are counter-based arrays,
so restoring them restores the exact noise streams; the host sampler's
numpy RandomState pickles losslessly into bytes. Resume is bit-exact
(asserted by tests/test_checkpoint.py, the EndToEnd pattern of
serialize-test.cc).

Two storage backends share the same manifest/sidecar layout:

* ``npz`` (default) — one self-contained file; leaves are gathered to
  host. Right for single-process runs and small states.
* ``orbax`` — a checkpoint DIRECTORY written by orbax.checkpoint:
  sharding-aware (the tensorstore save is collective — each host
  writes only its own shards, the pod-scale path for ShardedLearner
  under jax.distributed; host-side filesystem surgery is process 0's,
  fenced by barriers), promoted via tmp rename with the previous
  checkpoint parked at ``.orbax-old`` until the new one is in place
  (a crash mid-promote is recoverable — load falls back to the
  parking spot), and restored directly onto the learner's mesh
  shardings. Same bit-exact-resume contract.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import (Config, EdgeSetBackend, RngBackend,
                               SampleStrategy)

_FORMAT_VERSION = 2  # v2: RefRngState gained the neighbor stream array


def _config_to_json(cfg: Config) -> dict:
    d = dataclasses.asdict(cfg)
    d["strategy"] = cfg.strategy.value
    d["edgeset_backend"] = cfg.edgeset_backend.value
    d["rng_backend"] = cfg.rng_backend.value
    return d


def _config_from_json(d: dict) -> Config:
    # Older manifests carry fields Config no longer has: the retired
    # kernel selectors (phi_impl and its tile, the window kernel's
    # selector). Every value they held ran the same math; drop them.
    known = {f.name for f in dataclasses.fields(Config)}
    d = {k: v for k, v in d.items() if k in known}
    d["strategy"] = SampleStrategy.parse(d["strategy"])
    d["edgeset_backend"] = EdgeSetBackend(d["edgeset_backend"])
    d["rng_backend"] = RngBackend(d["rng_backend"])
    d["phi_seed"] = tuple(d["phi_seed"])
    d["beta_seed"] = tuple(d["beta_seed"])
    d["neighbor_seed"] = tuple(d["neighbor_seed"])
    return Config(**d)


def _collect_host_state(learner):
    """Manifest + host-sampler position, shared by both backends."""
    pending = (learner.drain_sampling()
               if hasattr(learner, "drain_sampling") else [])
    sampler = getattr(learner, "sampler", None)
    num_leaves = len(jax.tree_util.tree_leaves(learner.state))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "config": _config_to_json(learner.cfg),
        "learner": type(learner).__name__,
        "num_chains": getattr(learner, "num_chains", None),
        "num_leaves": num_leaves,
        "timers": {k: v for k, v in learner.timers.seconds.items()},
        "timer_calls": {k: v for k, v in learner.timers.calls.items()},
        "native_call_count": getattr(sampler, "_native_call_count", 0),
    }
    sampler_rng = pickle.dumps(
        sampler.rng.get_state() if sampler is not None else None)
    pending_blob = pickle.dumps(pending)
    return manifest, sampler_rng, pending_blob


def _check_manifest(manifest: dict, learner) -> None:
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} != "
            f"{_FORMAT_VERSION}: the state leaf layout changed (v2 added "
            "the reference-backend neighbor RNG stream); re-train or "
            "migrate the checkpoint")
    saved_cfg = _config_from_json(manifest["config"])
    if saved_cfg.K != learner.cfg.K or saved_cfg.N != learner.cfg.N:
        raise ValueError("checkpoint geometry mismatch")
    saved_chains = manifest.get("num_chains")
    if saved_chains != getattr(learner, "num_chains", None):
        raise ValueError(
            f"checkpoint geometry mismatch: num_chains {saved_chains} "
            f"!= {getattr(learner, 'num_chains', None)}")
    ref_leaves = jax.tree_util.tree_leaves(learner.state)
    if manifest["num_leaves"] != len(ref_leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} state leaves, "
            f"learner expects {len(ref_leaves)} (different learner "
            f"class or config: saved by {manifest.get('learner')})")


def _apply_host_state(learner, manifest: dict, sampler_rng_blob: bytes,
                      pending_blob: Optional[bytes]) -> None:
    sampler = getattr(learner, "sampler", None)
    sampler_rng = pickle.loads(sampler_rng_blob)
    if sampler is not None and sampler_rng is not None:
        sampler.rng.set_state(sampler_rng)
        sampler._native_call_count = int(
            manifest.get("native_call_count", 0))
    if pending_blob is not None and hasattr(learner, "_pending"):
        learner._pending = pickle.loads(pending_blob)
    for k, v in manifest.get("timers", {}).items():
        learner.timers.seconds[k] = v
    for k, v in manifest.get("timer_calls", {}).items():
        learner.timers.calls[k] = v


def save_checkpoint(path: str, learner, backend: str = "npz",
                    async_save: bool = False) -> None:
    """Full-fidelity checkpoint: state pytree + config + the complete
    host-sampling position — the numpy RNG state, the native sampler's
    chunk counter, and any produced-but-unconsumed prefetched batches
    (the in-flight pipeline state; the reference serializes its
    pipelined minibatch identically, learner.cc:307-315).

    Accepts any learner with (cfg, state, timers): Learner,
    parallel.ShardedLearner, and the device-sampling chain engines
    (which have no host sampler — their sampling position is the
    sample_key inside the state pytree).

    ``backend="orbax"`` writes a checkpoint DIRECTORY via
    orbax.checkpoint instead of one npz file (module docstring).
    ``async_save=True`` (orbax only) returns as soon as the state is
    copied to host; serialization finishes on a background thread and
    the checkpoint is promoted by ``wait_for_async_saves`` (invoked
    automatically by the next save to the same path or by
    load_checkpoint — call it explicitly before process exit)."""
    if backend == "orbax":
        return _save_orbax(path, learner, async_save=async_save)
    if async_save:
        raise ValueError("async_save requires backend='orbax'")
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    # an in-flight async orbax save to this path must land first, or
    # its deferred promote would later rename this npz file away
    wait_for_async_saves(path)
    manifest, sampler_rng, pending_blob = _collect_host_state(learner)
    leaves = jax.tree_util.tree_leaves(learner.state)

    def host(leaf):
        x = np.asarray(leaf)
        if x.dtype.kind == "V" or x.dtype.name == "bfloat16":
            # npz holds builtin dtypes only; bf16 pi rows round-trip
            # losslessly through fp32 (load casts back to the learner's
            # leaf dtype)
            return x.astype(np.float32)
        return x

    arrays = {f"leaf_{i}": host(l) for i, l in enumerate(leaves)}
    np.savez_compressed(
        path,
        manifest=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
        sampler_rng=np.frombuffer(sampler_rng, np.uint8),
        pending=np.frombuffer(pending_blob, np.uint8),
        **arrays,
    )


def load_checkpoint(path: str, learner):
    """Restore state into an already-constructed learner (same dataset).

    The graph/split/edge-sets are rebuilt from data (the reference
    likewise reloads the dataset and only restores learner state,
    serialize-test.cc:90-134).

    The backend is detected from the path: a directory is an orbax
    checkpoint, a file is npz. If an orbax save crashed between its
    promote renames, the previous checkpoint is recovered from the
    ``.orbax-old`` parking spot.
    """
    wait_for_async_saves(path)  # an in-flight async save must land
    if os.path.isdir(path):
        return _load_orbax(path, learner)
    if not os.path.exists(path) and os.path.isdir(path + ".orbax-old"):
        return _load_orbax(path + ".orbax-old", learner)
    z = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"]).decode())
    _check_manifest(manifest, learner)
    _, treedef = jax.tree_util.tree_flatten(learner.state)
    ref_leaves = jax.tree_util.tree_leaves(learner.state)
    leaves = [z[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    # restore leaf dtypes exactly (uint32 key arrays; bf16 pi rows were
    # stored as fp32 — the upcast was lossless so this cast is too)
    leaves = [jnp.asarray(l, r.dtype) for l, r in zip(leaves, ref_leaves)]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    if hasattr(learner, "state_spec") and hasattr(learner, "mesh"):
        # ShardedLearner: re-place each leaf on its mesh sharding
        from jax.sharding import NamedSharding

        state = jax.tree_util.tree_map(
            lambda x, spec: jax.device_put(
                x, NamedSharding(learner.mesh, spec)),
            state, learner.state_spec)
    learner.state = state
    _apply_host_state(learner, manifest, bytes(z["sampler_rng"]),
                      bytes(z["pending"]) if "pending" in z else None)
    return learner


# --------------------------------------------------------------------------
# orbax backend: a checkpoint DIRECTORY. The pytree goes through
# orbax/tensorstore (sharding-aware: under jax.distributed each host
# writes only its own shards — the pod-scale path the npz gather-to-one-
# host backend can't serve); the host-side position (manifest, sampler
# RNG pickle, pending batches) rides along as sidecar files. The whole
# directory appears atomically via tmp + rename, mirroring orbax's own
# finalization discipline.

def _quiet_orbax_logging() -> None:
    # orbax logs a dozen absl INFO lines per save; they'd drown the
    # CLI's ppx series
    import logging

    logging.getLogger("absl").setLevel(logging.WARNING)


def _barrier(name: str) -> None:
    """Cross-host sync point; a no-op in single-process runs."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


# pending async orbax saves: path -> finalize closure (waits for the
# background serialization, then writes sidecars and promotes)
_ASYNC_PENDING: dict = {}


def wait_for_async_saves(path: Optional[str] = None) -> None:
    """Finalize async orbax saves: block until the background
    serialization completes, then write sidecars and promote the
    checkpoint directory. With no argument, finalizes all pending
    saves. Registered with atexit on first use, so a normally-exiting
    process never loses an in-flight save; a FAILED finalize stays
    pending (and raises loudly on every retry) rather than letting a
    later load silently read the stale pre-save checkpoint.

    Multi-host caveat: the finalize contains cross-host barriers
    (sync_global_devices has no timeout), so under jax.distributed
    EVERY process must call this explicitly before shutdown — relying
    on atexit is unsafe there: if one process crashes or exits without
    reaching its matching barrier, the remaining processes hang in
    sync_global_devices at interpreter exit. Call
    ``wait_for_async_saves()`` at the end of the training script (the
    CLI does) so a missing peer surfaces as a visible hang in user
    code rather than inside atexit."""
    keys = [path] if path is not None else list(_ASYNC_PENDING)
    for k in keys:
        k = os.path.abspath(k)
        fin = _ASYNC_PENDING.get(k)
        if fin is not None:
            fin()                    # raises on serialization failure
            _ASYNC_PENDING.pop(k, None)


def _save_orbax(path: str, learner, async_save: bool = False) -> None:
    _quiet_orbax_logging()
    import orbax.checkpoint as ocp

    manifest, sampler_rng, pending_blob = _collect_host_state(learner)
    path = os.path.abspath(path)
    # a previous async save to this path must land before we start over
    wait_for_async_saves(path)
    tmp = path + ".orbax-tmp"
    old = path + ".orbax-old"
    # multi-host discipline: the TENSORSTORE save is collective (every
    # process calls it; each writes only its own shards), but all
    # host-side filesystem surgery — tmp/old cleanup, sidecars, the
    # final promote — is process 0's alone, fenced by barriers so no
    # process races another's directory operations
    primary = jax.process_index() == 0
    if primary:
        for d in (tmp, old):
            if os.path.exists(d):
                shutil.rmtree(d)
        os.makedirs(tmp)
    _barrier("mcmc_ammsb_orbax_tmp_ready")
    # orbax/tensorstore refuses zero-size arrays; they carry no data,
    # so persist only the non-empty leaves (the load side rebuilds the
    # empty ones as zeros of the learner's leaf shape/dtype)
    leaves = [l for l in jax.tree_util.tree_leaves(learner.state)
              if l.size > 0]

    def sidecars_and_promote():
        if primary:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "sampler_rng.pkl"), "wb") as f:
                f.write(sampler_rng)
            with open(os.path.join(tmp, "pending.pkl"), "wb") as f:
                f.write(pending_blob)
            # promote: POSIX cannot atomically swap directories, so
            # park the previous checkpoint at .orbax-old first — a
            # crash between the two renames leaves the old checkpoint
            # recoverable there (load_checkpoint falls back to it)
            # instead of lost
            if os.path.exists(path):
                os.rename(path, old)
            os.rename(tmp, path)
            if os.path.exists(old):
                shutil.rmtree(old)
        _barrier("mcmc_ammsb_orbax_done")

    if async_save:
        # AsyncCheckpointer.save blocks only for the device->host copy
        # (training can resume immediately — donated buffers are safe,
        # the data is already on host); tensorstore serialization rides
        # a background thread and the promote is deferred to
        # wait_for_async_saves (auto-invoked by the next save to this
        # path, or by load_checkpoint)
        ckptr = ocp.AsyncCheckpointer(
            ocp.StandardCheckpointHandler())
        ckptr.save(os.path.join(tmp, "state"), args=ocp.args.StandardSave(leaves))

        def finalize(c=ckptr):
            try:
                c.wait_until_finished()
            finally:
                c.close()            # never leak the background thread
            sidecars_and_promote()

        _ASYNC_PENDING[path] = finalize
        if len(_ASYNC_PENDING) == 1:
            import atexit

            atexit.register(wait_for_async_saves)
        return
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.join(tmp, "state"), leaves)
    sidecars_and_promote()


def _load_orbax(path: str, learner):
    _quiet_orbax_logging()
    import orbax.checkpoint as ocp

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _check_manifest(manifest, learner)
    ref_leaves, treedef = jax.tree_util.tree_flatten(learner.state)
    if hasattr(learner, "state_spec") and hasattr(learner, "mesh"):
        # restore each shard directly onto its mesh placement — no
        # gather-to-host round trip
        from jax.sharding import NamedSharding

        abstract = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda x, s: jax.ShapeDtypeStruct(
                x.shape, x.dtype, sharding=NamedSharding(learner.mesh, s)),
            learner.state, learner.state_spec))
    else:
        abstract = [jax.ShapeDtypeStruct(x.shape, x.dtype,
                                         sharding=getattr(x, "sharding",
                                                          None))
                    for x in ref_leaves]
    nonempty = [a for a in abstract if np.prod(a.shape) > 0]
    with ocp.StandardCheckpointer() as ckptr:
        restored = iter(ckptr.restore(os.path.join(path, "state"),
                                      nonempty))
    leaves = [next(restored) if np.prod(a.shape) > 0
              else jnp.zeros(a.shape, a.dtype)
              for a in abstract]
    learner.state = jax.tree_util.tree_unflatten(treedef, leaves)
    with open(os.path.join(path, "sampler_rng.pkl"), "rb") as f:
        sampler_rng = f.read()
    pend_path = os.path.join(path, "pending.pkl")
    pending = None
    if os.path.exists(pend_path):
        with open(pend_path, "rb") as f:
            pending = f.read()
    _apply_host_state(learner, manifest, sampler_rng, pending)
    return learner
