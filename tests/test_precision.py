"""fp32 math stays fp32 on every backend.

On GPUs XLA may run an f32 dot in TF32 (~11 significant bits) unless
the dot asks for ``Precision.HIGHEST``. That would round the exact
one-hot selects of the window engine and perturb the phi/MMSB
contractions; the CPU cannot show it, so these tests read the traced
programs instead: every ``dot_general`` carries HIGHEST, and the
integer composes of the device samplers contain no float dot at all.
"""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, EdgeSetBackend
from mcmc_ammsb.models import mmsb
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.device_sampling import _compose_rows
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.ops.window import window_steps
from mcmc_ammsb.rng.refblock import _compose_table

HIGHEST = jax.lax.Precision.HIGHEST
B, N_NB, K, E, T, N = 5, 4, 8, 6, 3, 40
CFG = Config(K=K, mini_batch_size=4, num_node_sample=N_NB).finalize(
    N, 30, 5)
f32 = jnp.float32


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub)


def dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]


def _z(*shape, dtype=f32):
    return jnp.zeros(shape, dtype)


def _phi_shared():
    return (lambda *a: phi_ops.phi_update_core(CFG, *a),
            _z(B, K), _z(B), _z(1, N_NB, K), _z(B, N_NB, dtype=bool),
            _z(K), jnp.int32(3), _z(B, K), _z(B, N_NB, dtype=bool))


def _phi_private():
    return (lambda *a: phi_ops.phi_update_core(CFG, *a),
            _z(B, K), _z(B), _z(B, N_NB, K), _z(B, N_NB, dtype=bool),
            _z(K), jnp.int32(3), _z(B, K))


def _window(corrected):
    i32 = jnp.int32
    mcode = _z(T, B + N_NB, 1, dtype=i32) if corrected else None
    return (lambda *a: window_steps(CFG, *a[:6], mcode, *a[6:]),
            _z(K, 2), _z(K), i32(1), i32(1), _z(T, B + N_NB, K),
            _z(T, B), _z(T, B, dtype=i32), _z(T, B, dtype=bool),
            _z(T, E, dtype=bool), _z(T), _z(T, N_NB, dtype=i32),
            _z(T, B, N_NB, dtype=bool), _z(T, B, K), _z(T, K, 2),
            _z(T, E, dtype=bool), _z(T, E, dtype=i32),
            _z(T, E, dtype=i32))


def _mmsb_private():
    return (lambda *a: mmsb._phi_rows_core(CFG, *a),
            _z(B, K), _z(B), _z(K, K), _z(B, N_NB, K),
            _z(B, N_NB, dtype=bool), jnp.int32(3), _z(B, K))


def _mmsb_shared():
    return (lambda *a: mmsb._phi_rows_core_shared(CFG, *a),
            _z(B, K), _z(B), _z(K, K), _z(N_NB, K),
            _z(B, N_NB, dtype=bool), _z(B, N_NB, dtype=bool),
            jnp.int32(3), _z(B, K))


def _mmsb_ppx():
    es = build_edge_set(EdgeSetBackend.CSR, N, np.array([0, 1], np.int32),
                        np.array([1, 2], np.int32))
    state = mmsb.init_mmsb_state(CFG, 2)
    eu = jnp.array([0, 3], jnp.int32)
    ev = jnp.array([1, 4], jnp.int32)
    return (lambda s: mmsb.mmsb_perplexity(CFG, es, eu, ev, s), state)


@pytest.mark.parametrize("case", [
    _phi_shared, _phi_private, lambda: _window(True),
    lambda: _window(False), _mmsb_private, _mmsb_shared, _mmsb_ppx,
], ids=["phi-shared", "phi-private", "window-corrected",
        "window-clean", "mmsb-phi", "mmsb-phi-shared", "mmsb-ppx"])
def test_every_f32_dot_is_highest(case):
    fn, *args = case()
    precs = dot_precisions(fn, *args)
    assert precs, "expected at least one contraction"
    for p in precs:
        assert p == (HIGHEST, HIGHEST) or p == HIGHEST, precs


@pytest.mark.parametrize("fn,args", [
    (lambda v, d: _compose_rows(v, d, 6),
     (_z(2, 4, dtype=jnp.int32), _z(2, 4, dtype=jnp.int32))),
    (_compose_table, (_z(3, 5, dtype=jnp.int32),)),
], ids=["compose-rows", "compose-table"])
def test_integer_composes_have_no_float_dot(fn, args):
    assert dot_precisions(fn, *args) == []


@pytest.mark.parametrize("node_id", [2047, 2049, 317_079, 2**24 - 1])
def test_compose_rows_exact_at_node_ids(node_id):
    """Ordered appends keep node ids exact: TF32 would round ids above
    2048 and f32 ids above 2^24."""
    values = jnp.array([[node_id, node_id - 1, 7, node_id],
                        [1, node_id, node_id - 2, 3]], jnp.int32)
    dst = jnp.array([[2, 0, 9, 3],          # lane 2 dropped (>= width)
                     [4, 1, 0, -1]], jnp.int32)  # lane 3 dropped (< 0)
    got = np.asarray(jax.jit(lambda v, d: _compose_rows(v, d, 5))(
        values, dst))
    want = np.zeros((2, 5), np.int64)
    for s in range(2):
        for lane in range(4):
            if 0 <= int(dst[s, lane]) < 5:
                want[s, int(dst[s, lane])] = int(values[s, lane])
    np.testing.assert_array_equal(got, want)


def test_compose_table_is_pointer_squaring():
    """tab <- tab[tab] per row; entries outside the row compose to 0."""
    tab = np.array([[1, 2, 3, 3, 0], [4, 0, 9, -1, 2]], np.int32)
    want = np.array([[tab[r, t] if 0 <= t < 5 else 0 for t in tab[r]]
                     for r in range(2)])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(_compose_table)(jnp.asarray(tab))), want)
