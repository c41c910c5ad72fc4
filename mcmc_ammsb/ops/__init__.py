"""Device-side compute: edge membership, neighbor sampling, phi/beta/ppx
updates, and row collectives — the counterparts of the reference's
runtime-compiled GPU kernels (/root/reference/mcmc/{phi,beta,perplexity,
sample,cuckoo}.cc and mcmc/algorithm/*)."""

from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set
from mcmc_ammsb.ops.rowops import row_normalize, row_sums
