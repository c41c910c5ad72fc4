"""Multi-chip execution: device meshes + shard_map training.

The reference is strictly single-GPU (SURVEY.md §2: no MPI/NCCL anywhere);
its capacity-scaling device (RowPartitionedMatrix splitting pi across
allocations, /root/reference/mcmc/partitioned-alloc.h) generalizes here
to sharding pi's row dimension across a 'model' mesh axis, with batch
work data-parallel across a 'data' axis and gradients combined with
psum over the device links.
"""

from mcmc_ammsb.parallel.chains_sharded import (ShardedChainLearner,
                                                make_chain_mesh)
from mcmc_ammsb.parallel.mesh import make_mesh
from mcmc_ammsb.parallel.sharded import ShardedLearner
