"""Checkpoints written before the phi and window kernel selectors were
removed still load: their manifests carry ``phi_impl`` and the other
retired selectors, which the loader drops."""

import json

import numpy as np

from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint
from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner


def _learner():
    n, u, v = synthetic_edges(120, 6, seed=17)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=18)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=4, mini_batch_size=6, num_node_sample=4).finalize(
        n, split.total_edges, graph.max_fan_out)
    return Learner(cfg, graph, split, prefetch=False)


def test_manifest_with_retired_kernel_fields_loads(tmp_path):
    path = str(tmp_path / "ck.npz")
    a = _learner()
    a.run(3)
    save_checkpoint(path, a)
    z = dict(np.load(path))
    manifest = json.loads(bytes(z["manifest"]).decode())
    manifest["config"].update(phi_impl="pallas")
    z["manifest"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    np.savez(path, **z)

    b = _learner()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == int(a.state.step_count)
    np.testing.assert_array_equal(np.asarray(b.state.pi),
                                  np.asarray(a.state.pi))
    a.close()
    b.close()
