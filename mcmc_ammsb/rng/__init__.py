"""Random-number backends.

`native`    — jax.random (threefry counter streams); the default.
`reference` — bit-exact re-implementation of the reference device RNG
              (xorshift128+ core, GSL Ziggurat randn, Marsaglia-Tsang
              gamma, /root/reference/mcmc/random.cl.inc) for
              trajectory-comparable runs. Imported lazily (it carries
              large constant tables).
"""

from mcmc_ammsb.rng import native
