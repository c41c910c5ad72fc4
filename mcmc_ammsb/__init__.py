"""Stochastic-gradient MCMC sampler for the assortative
Mixed-Membership Stochastic Blockmodel (a-MMSB).

A ground-up JAX/XLA re-design with the capabilities of the
GPU reference implementation (ielhelw/mcmc-ammsb-gpu): SGRLD updates of
per-node community memberships pi [N, K] and per-community link strengths
theta [K, 2] / beta [K], minibatch + neighbor subsampling, held-out
perplexity evaluation, checkpoint/resume, and multi-chip sharding.

Design stance (a re-design, not a port):
  * one pure functional ``state' = train_step(state, batch)`` under ``jit``;
    many steps fused into a single device dispatch with ``lax.scan``
    (the reference launches 7+ kernels with full queue syncs per step,
    /root/reference/mcmc/learner.cc:214-250).
  * edge membership as vectorized binary search over CSR adjacency
    (branch-free, gather-based) instead of the reference's cuckoo hash
    pointer-chasing (/root/reference/mcmc/cuckoo.cc:28-69); the cuckoo
    layout is kept as an alternative backend for comparison.
  * static shapes everywhere: minibatches padded + masked so a single
    compilation serves every step (the reference sizes its device buffers
    identically, /root/reference/mcmc/sample.cc:129-131).
  * scaling via ``jax.sharding.Mesh ('data','model')``: pi row-sharded
    over 'model' (the generalization of the reference's
    RowPartitionedMatrix, /root/reference/mcmc/partitioned-alloc.h),
    batch work sharded over 'data', gradients combined with ``psum``.
"""

from mcmc_ammsb.config import Config, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, load_snap_edges, synthetic_edges
from mcmc_ammsb.learner import Learner, TrainState, init_state

__version__ = "0.1.0"

__all__ = [
    "Config",
    "SampleStrategy",
    "Graph",
    "Learner",
    "TrainState",
    "init_state",
    "generate_sets",
    "load_snap_edges",
    "synthetic_edges",
]
