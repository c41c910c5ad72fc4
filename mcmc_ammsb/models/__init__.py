"""Model families.

The reference implements exactly one model — the assortative MMSB
(SURVEY.md §0). `models.ammsb.AMMSB` is its formal definition and the
stable surface future families (e.g. the full, non-assortative MMSB
with a [K, K] block matrix) will sit beside.
"""

from mcmc_ammsb.models.ammsb import AMMSB
