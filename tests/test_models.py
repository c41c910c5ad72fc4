"""Model-family facade tests + CLI arg-parsing checks."""

import jax
import numpy as np
import pytest

from mcmc_ammsb.cli import build_arg_parser, config_from_args
from mcmc_ammsb.config import (Config, EdgeSetBackend, RngBackend,
                               SampleStrategy)
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import DeviceBatch
from mcmc_ammsb.models import AMMSB
from mcmc_ammsb.sampling import MiniBatchSampler


def test_ammsb_surface():
    n, u, v = synthetic_edges(250, 8, seed=51)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=52)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 host_sampler="numpy")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    model = AMMSB(cfg, graph, split)

    state = model.init()
    sampler = MiniBatchSampler(cfg, graph, split)
    step = jax.jit(model.step)
    for _ in range(5):
        state = step(state, DeviceBatch.from_host(sampler.sample()))
    assert int(state.step_count) == 6
    state, res = jax.jit(model.eval)(state)
    assert np.isfinite(float(res.neg_avg_log))
    np.testing.assert_allclose(np.asarray(state.pi).sum(-1), 1.0,
                               atol=1e-5)


def test_cli_arg_parsing():
    args = build_arg_parser().parse_args([
        "--synthetic", "100,4", "-k", "64", "-m", "16", "-n", "8",
        "-a", "0.05", "-b", "512", "-c", "0.33", "-e", "1e-6",
        "-r", "0.02", "-s", "BFLink",
        "--edgeset", "sorted", "--rng", "reference",
        "--steps-per-call", "50", "--device-sampling",
        "--calc-train-ppx", "--phi-seed", "7", "8",
    ])
    cfg = config_from_args(args)
    assert cfg.K == 64 and cfg.mini_batch_size == 16
    assert cfg.num_node_sample == 8
    assert (cfg.a, cfg.b, cfg.c) == (0.05, 512.0, 0.33)
    assert cfg.epsilon == 1e-6 and cfg.heldout_ratio == 0.02
    assert cfg.strategy == SampleStrategy.BF_LINK
    assert cfg.edgeset_backend == EdgeSetBackend.SORTED
    assert cfg.rng_backend == RngBackend.REFERENCE
    assert cfg.steps_per_call == 50 and cfg.device_sampling
    assert cfg.calc_train_ppx and cfg.phi_seed == (7, 8)


@pytest.mark.parametrize("flag", [["--phi-impl", "pallas"],
                                  ["--window-impl", "jnp"]])
def test_removed_kernel_flags_are_rejected(flag, capsys):
    """The phi and window kernel selectors are gone; passing one is an
    error, not a silent no-op."""
    with pytest.raises(SystemExit) as exc:
        build_arg_parser().parse_args(["--synthetic", "100,4"] + flag)
    assert exc.value.code == 2
    assert flag[0] in capsys.readouterr().err
