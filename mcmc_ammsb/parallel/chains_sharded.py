"""Multi-chain engine sharded over devices: chain groups per chip.

Independent MCMC chains are embarrassingly parallel across devices:
this engine
runs C = G x C_local flat-layout chains (chains_flat.py) on a 1-D
``('chains',)`` mesh of G devices. Each device owns C_local whole
chains — pi [C*N, K] is row-sharded in contiguous [C_local*N, K]
blocks, so every step's gathers, scatters, and reductions are purely
local: the fused chunk program contains NO collectives at all, and
aggregate throughput scales linearly with G until each chip's own
row-gather ceiling binds.

The reference has no multi-chain or multi-device analog (it is a
single-GPU, single-chain sampler, /root/reference/main.cc:94-96); this
is a beyond-reference capability built on the same per-chain update
semantics as FlatChainLearner. Per-group independence comes from
folding the group index into every RNG key at construction: group g's
sampling/noise/neighbor streams are distinct, and chain c's init seed
is the same global ``init_seed + c`` law the single-device engine uses
— so the SET of chains is statistically identical however many devices
it is spread across.

Checkpoints use the generic checkpoint.py path (state_spec + mesh are
exposed, so load re-places every leaf on its sharding).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_ammsb.chains_flat import (ChainState, _chunk, _chunk_ppx,
                                    _ppx)
from mcmc_ammsb.config import Config, RngBackend
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import init_state
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.utils.timing import StageTimers

CHAIN_AXIS = "chains"


def make_chain_mesh(n_groups: int) -> Mesh:
    """1-D ('chains',) mesh over the first n_groups devices."""
    devices = jax.devices()
    if n_groups > len(devices):
        raise ValueError(f"chain mesh needs {n_groups} devices, "
                         f"only {len(devices)} available")
    return jax.make_mesh((n_groups,), (CHAIN_AXIS,),
                         devices=devices[:n_groups])


def _local_view(state: ChainState) -> ChainState:
    """Per-shard view: squeeze the [1] leading key axis so the body can
    call the single-device chunk/ppx functions unchanged."""
    return state._replace(
        phi_key=state.phi_key[0], beta_key=state.beta_key[0],
        neighbor_key=state.neighbor_key[0],
        sample_key=state.sample_key[0])


def _rewrap(local: ChainState, keys: ChainState) -> ChainState:
    """Put the (unchanged) per-group keys back in [1]-shaped form."""
    return local._replace(
        phi_key=keys.phi_key, beta_key=keys.beta_key,
        neighbor_key=keys.neighbor_key, sample_key=keys.sample_key)


class ShardedChainLearner:
    """C chains spread over a G-device mesh, C/G whole chains each."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 num_chains: int, mesh: Mesh):
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("chain engines support the native RNG "
                             "backend only")
        if cfg.pi_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown pi_dtype {cfg.pi_dtype!r}")
        if cfg.window > 1 and not cfg.shared_neighbors:
            raise ValueError("window > 1 on the chain engines requires "
                             "shared_neighbors (the window body "
                             "operates on the shared-draw layout)")
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too "
                             "small for this graph")
        n_groups = mesh.shape[CHAIN_AXIS]
        if num_chains % n_groups:
            raise ValueError(
                f"num_chains={num_chains} must be divisible by the "
                f"chain mesh size {n_groups} (whole chains per device)")
        cfg = cfg.replace(device_sampling=True)
        self.cfg = cfg
        self.mesh = mesh
        self.num_chains = num_chains
        self.chains_per_group = num_chains // n_groups
        self.training_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v)
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)
        self.adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                          jnp.asarray(graph.cols, jnp.int32))
        self.timers = StageTimers()

        h = len(split.heldout_edges_u)
        # Initialize per GROUP and place each group's block directly on
        # its mesh slice: peak un-sharded memory stays at ONE group's
        # [C_local*N, K] block instead of the whole [C*N, K] concat —
        # the engine exists precisely for chain counts whose full state
        # does not fit a single chip.
        mesh_devs = list(mesh.devices.reshape(-1))
        c_per = num_chains // n_groups
        pi_blocks, phi_blocks, theta_blocks, beta_blocks = [], [], [], []
        base = None
        for g in range(n_groups):
            pis, phis, thetas, betas = [], [], [], []
            for ci in range(g * c_per, (g + 1) * c_per):
                st = init_state(
                    cfg.replace(init_seed=cfg.init_seed + ci), h)
                base = st
                pis.append(st.pi); phis.append(st.phi_sum)
                thetas.append(st.theta); betas.append(st.beta)
            dev = mesh_devs[g]
            pi_blocks.append(
                jax.device_put(jnp.concatenate(pis, axis=0), dev))
            phi_blocks.append(
                jax.device_put(jnp.concatenate(phis, axis=0), dev))
            theta_blocks.append(jax.device_put(jnp.stack(thetas), dev))
            beta_blocks.append(jax.device_put(jnp.stack(betas), dev))
            del pis, phis

        def from_blocks(blocks, spec):
            shape = ((sum(b.shape[0] for b in blocks),)
                     + blocks[0].shape[1:])
            return jax.make_array_from_single_device_arrays(
                shape, NamedSharding(mesh, spec), blocks)

        def group_keys(key):
            return jax.vmap(lambda g: jax.random.fold_in(key, g))(
                jnp.arange(n_groups))

        state = ChainState(
            pi=from_blocks(pi_blocks, P(CHAIN_AXIS, None)),
            phi_sum=from_blocks(phi_blocks, P(CHAIN_AXIS)),
            theta=from_blocks(theta_blocks, P(CHAIN_AXIS)),
            beta=from_blocks(beta_blocks, P(CHAIN_AXIS)),
            step_count=base.step_count,
            beta_count=base.beta_count,
            ppx_per_edge=jnp.zeros((num_chains, h), jnp.float32),
            ppx_count=jnp.asarray(0, jnp.int32),
            phi_key=group_keys(base.phi_key),
            beta_key=group_keys(base.beta_key),
            neighbor_key=group_keys(base.neighbor_key),
            sample_key=group_keys(base.sample_key),
        )
        self.state_spec = ChainState(
            pi=P(CHAIN_AXIS, None), phi_sum=P(CHAIN_AXIS),
            theta=P(CHAIN_AXIS), beta=P(CHAIN_AXIS),
            step_count=P(), beta_count=P(),
            ppx_per_edge=P(CHAIN_AXIS), ppx_count=P(),
            phi_key=P(CHAIN_AXIS), beta_key=P(CHAIN_AXIS),
            neighbor_key=P(CHAIN_AXIS), sample_key=P(CHAIN_AXIS),
        )
        self.state: ChainState = jax.tree.map(
            lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
            state, self.state_spec)

        c_local = self.chains_per_group

        def chunk_body(tset, hset, adj, state, num_steps):
            local = _chunk(cfg, c_local, tset, hset, adj,
                           _local_view(state), num_steps)
            return _rewrap(local, state)

        def make_chunk(num_steps):
            return jax.jit(jax.shard_map(
                partial(chunk_body, num_steps=num_steps), mesh=mesh,
                in_specs=(P(), P(), P(), self.state_spec),
                out_specs=self.state_spec,
                check_vma=False,
            ), donate_argnums=(3,))

        self._chunk_fns: Dict[int, object] = {}
        self._make_chunk = make_chunk

        def ppx_body(hset, eu, ev, state):
            local, neg = _ppx(cfg, c_local, hset, eu, ev,
                              _local_view(state))
            return _rewrap(local, state), neg

        self._ppx_fn = jax.jit(jax.shard_map(
            ppx_body, mesh=mesh,
            in_specs=(P(), P(), P(), self.state_spec),
            out_specs=(self.state_spec, P(CHAIN_AXIS)),
            check_vma=False,
        ), donate_argnums=(3,))

        def chunk_ppx_body(tset, hset, adj, eu, ev, state,
                           num_evals, interval):
            local, neg = _chunk_ppx(cfg, c_local, tset, hset, adj,
                                    eu, ev, _local_view(state),
                                    num_evals, interval)
            return _rewrap(local, state), neg  # [num_evals, c_local]

        def make_chunk_ppx(num_evals, interval):
            return jax.jit(jax.shard_map(
                partial(chunk_ppx_body, num_evals=num_evals,
                        interval=interval), mesh=mesh,
                in_specs=(P(), P(), P(), P(), P(), self.state_spec),
                out_specs=(self.state_spec, P(None, CHAIN_AXIS)),
                check_vma=False,
            ), donate_argnums=(5,))

        self._chunk_ppx_fns: Dict[tuple, object] = {}
        self._make_chunk_ppx = make_chunk_ppx

    # -- API (mirrors FlatChainLearner) ---------------------------------

    def run(self, max_iters: int) -> None:
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            done = 0
            while done < max_iters:
                take = min(spc, max_iters - done)
                with self.timers.stage("device_step"):
                    if take not in self._chunk_fns:
                        self._chunk_fns[take] = self._make_chunk(take)
                    self.state = self._chunk_fns[take](
                        self.training_set, self.heldout_set,
                        self.adjacency, self.state)
                done += take
            int(self.state.step_count)  # fence inside the timer

    def run_with_ppx(self, max_iters: int, interval: int):
        """Fused per-chain eval series across the chain mesh (the
        FlatChainLearner.run_with_ppx contract: ppx is a [C] vector per
        eval, all chain groups advancing in one shard_map program)."""
        from mcmc_ammsb.learner import run_fused_eval_series

        spc = max(1, self.cfg.steps_per_call)

        def dispatch(take):
            key = (take, interval)
            if key not in self._chunk_ppx_fns:
                self._chunk_ppx_fns[key] = self._make_chunk_ppx(
                    take, interval)
            self.state, neg = self._chunk_ppx_fns[key](
                self.training_set, self.heldout_set, self.adjacency,
                self.heldout_u, self.heldout_v, self.state)
            return neg              # [take, C] device; driver blocks

        def tail(t):
            with self.timers.stage("device_step"):
                if t not in self._chunk_fns:
                    self._chunk_fns[t] = self._make_chunk(t)
                self.state = self._chunk_fns[t](
                    self.training_set, self.heldout_set,
                    self.adjacency, self.state)
            int(self.state.step_count)  # fence

        # np.exp in record: bit-exact with heldout_perplexity's numpy exp
        return run_fused_eval_series(
            self.timers, spc, max_iters, interval, dispatch,
            lambda: int(self.state.step_count),
            lambda neg_np, i, step: {"step": step,
                                     "ppx": np.exp(neg_np[i])},
            tail)

    def heldout_perplexity(self) -> np.ndarray:
        """Per-chain held-out perplexity, all C chains."""
        with self.timers.stage("ppx"):
            self.state, neg = self._ppx_fn(
                self.heldout_set, self.heldout_u, self.heldout_v,
                self.state)
            return np.exp(np.asarray(neg))

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """Gelman-Rubin PSRF [K] over beta across ALL chains (the
        global [C, K] beta view gathers off the chain mesh)."""
        from mcmc_ammsb.chains import beta_rhat_series

        return beta_rhat_series(self, draws)

    def print_stats(self, log=print) -> None:
        self.timers.print_table(log)
