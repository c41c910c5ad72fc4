"""Cross-cutting utilities: stage timing/stats and logging."""

from mcmc_ammsb.utils.timing import StageTimers
