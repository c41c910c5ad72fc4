"""Reference-parity RNG backend.

Re-implements the reference's device RNG family
(/root/reference/mcmc/random.cl.inc) for trajectory-comparable runs:

  * xorshift128+ 64-bit core — bit-exact, emulated with uint32 pairs
    (JAX runs without 64-bit integers by default); per-stream seed law
    seed_i = base + i (/root/reference/mcmc/random.cc:31-44).
  * uniform / randint with the reference's exact conversion semantics
    (float division by 2^64; modulo range mapping).
  * Gaussian via the 128-layer Ziggurat with GSL's exponential-wedge
    tail (PARAM_R = 3.44428647676). The layer tables are RECOMPUTED
    here from the published construction (Marsaglia & Tsang 2000;
    wedge modification per the GSL notes the reference cites) rather
    than copied — values agree with the construction to float32;
    draw COUNTS and branch structure per lane match the reference
    exactly, so stream positions line up.
  * Gamma via Marsaglia-Tsang acceptance sampling (same algorithm,
    same per-lane draw order).

Every sampler advances only the lanes in ``mask`` — exactly one
xorshift128+ stream per logical GPU thread, consumed in the same order
as the reference kernels (rejection lanes keep drawing, accepted lanes
freeze), so per-stream positions are reproducible under jit/scan.

State layout: seeds are uint32 [S, 4] = (x_hi, x_lo, y_hi, y_lo) of the
reference's ulong2 (x, y).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PARAM_R = 3.44428647676  # right-most ziggurat step (random.cl.inc PARAM_R)

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Ziggurat tables (recomputed, float64 construction at import time)
# ---------------------------------------------------------------------------

def _build_ziggurat_tables():
    """128-layer ziggurat for N(0,1) with exponential-wedge tail.

    Construction: x_127 = R; common box area
    v = R f(R) + tail, tail = integral_R^inf exp(-R(x-R/2)) dx = f(R)/R;
    downward recursion x_{i-1} = finv(f(x_i) + v / x_i).
    Produces ytab (f values), ktab (2^24 x_i/x_{i+1} acceptance
    thresholds) and wtab (2^-24 x_{i+1} scale factors) with the same
    meanings as the reference's tables.
    """
    f = lambda xx: np.exp(-0.5 * xx * xx)
    finv = lambda yy: np.sqrt(-2.0 * np.log(yy))
    r = PARAM_R
    v = r * f(r) + f(r) / r
    x = np.zeros(128, np.float64)
    x[127] = r
    for i in range(127, 0, -1):
        y_next = f(x[i]) + v / x[i]
        x[i - 1] = 0.0 if y_next >= 1.0 else finv(y_next)
    # sanity: construction must close at the top layer
    top = f(x[1]) + v / x[1]
    assert abs(top - 1.0) < 5e-3, top
    ytab = f(x)
    ktab = np.zeros(128, np.uint32)
    wtab = np.zeros(128, np.float64)
    two24 = float(1 << 24)
    for i in range(127):
        ktab[i] = np.uint32(two24 * x[i] / x[i + 1])
        wtab[i] = x[i + 1] / two24
    # tail layer: x = j * (v / f(R)) / 2^24, accepted while x < R
    wtab[127] = v / f(r) / two24
    ktab[127] = np.uint32(two24 * r * f(r) / v)
    return (jnp.asarray(ytab, jnp.float32), jnp.asarray(ktab, jnp.uint32),
            jnp.asarray(wtab, jnp.float32))


_YTAB, _KTAB, _WTAB = _build_ziggurat_tables()


# ---------------------------------------------------------------------------
# 64-bit core, uint32-pair emulation
# ---------------------------------------------------------------------------

def make_seeds(seed_pair: Tuple[int, int], size: int) -> jnp.ndarray:
    """Seed streams: seed_i = (x + i, y + i) (mcmc/random.cc:31-44)."""
    x, y = (np.uint64(seed_pair[0]), np.uint64(seed_pair[1]))
    i = np.arange(size, dtype=np.uint64)
    sx = x + i
    sy = y + i
    out = np.stack([
        (sx >> np.uint64(32)).astype(np.uint32),
        (sx & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (sy >> np.uint64(32)).astype(np.uint32),
        (sy & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    ], axis=-1)
    return jnp.asarray(out)


def _shl(h, l, k: int):
    return (h << _U32(k)) | (l >> _U32(32 - k)), l << _U32(k)


def _shr(h, l, k: int):
    return h >> _U32(k), (l >> _U32(k)) | (h << _U32(32 - k))


def _add(ah, al, bh, bl):
    lo = al + bl
    carry = (lo < al).astype(_U32)
    return ah + bh + carry, lo


def _xorshift128p(seeds):
    """One xorshift128+ step per lane (random.cl.inc:13-25).

    Returns (res_hi, res_lo, new_seeds)."""
    s1h, s1l = seeds[..., 0], seeds[..., 1]   # state.x
    s0h, s0l = seeds[..., 2], seeds[..., 3]   # state.y
    nxh, nxl = s0h, s0l                       # state.x = s0
    th, tl = _shl(s1h, s1l, 23)
    s1h, s1l = s1h ^ th, s1l ^ tl             # s1 ^= s1 << 23
    r17h, r17l = _shr(s1h, s1l, 17)
    r26h, r26l = _shr(s0h, s0l, 26)
    nyh = s1h ^ s0h ^ r17h ^ r26h
    nyl = s1l ^ s0l ^ r17l ^ r26l             # state.y
    rh, rl = _add(nyh, nyl, s0h, s0l)         # return state.y + s0
    new_seeds = jnp.stack([nxh, nxl, nyh, nyl], axis=-1)
    return rh, rl, new_seeds


def _masked(seeds, new_seeds, mask):
    return jnp.where(mask[..., None], new_seeds, seeds)


def rand_u64(seeds, mask=None):
    """Advance masked lanes; returns (hi, lo, seeds')."""
    rh, rl, new_seeds = _xorshift128p(seeds)
    if mask is not None:
        new_seeds = _masked(seeds, new_seeds, mask)
    return rh, rl, new_seeds


def uniform(seeds, mask=None):
    """(float)rand() / 2^64 in fp32 (random.cl.inc:34-35)."""
    rh, rl, seeds = rand_u64(seeds, mask)
    u = (rh.astype(jnp.float32) * jnp.float32(4294967296.0)
         + rl.astype(jnp.float32)) * jnp.float32(2.0 ** -64)
    return u, seeds


def uniform_pos(seeds, mask=None):
    """Nonzero uniform: redraw while exactly 0 (random.cl.inc:310-317)."""
    if mask is None:
        mask = jnp.ones(seeds.shape[:-1], jnp.bool_)
    u, seeds = uniform(seeds, mask)

    def cond(c):
        u, _ = c
        return jnp.any(mask & (u == 0.0))

    def body(c):
        u, s = c
        redraw = mask & (u == 0.0)
        u2, s = uniform(s, redraw)
        return jnp.where(redraw, u2, u), s

    u, seeds = jax.lax.while_loop(cond, body, (u, seeds))
    return u, seeds


def _mod_u64_u32(rh, rl, m: jnp.ndarray):
    """(hi*2^32 + lo) % m for per-lane m < 2^31, in uint32 arithmetic."""
    m = m.astype(_U32)
    # hi % m scaled by 2^32 % m via peasant mulmod, plus lo % m
    pow32 = ((_U32(0xFFFFFFFF) % m) + _U32(1)) % m   # 2^32 mod m
    a = rh % m
    b = pow32
    acc = jnp.zeros_like(a)

    def body(_, carry):
        acc, a, b = carry
        take = (b & _U32(1)).astype(jnp.bool_)
        acc = jnp.where(take, (acc + a) % m, acc)
        a = (a + a) % m
        b = b >> _U32(1)
        return acc, a, b

    acc, _, _ = jax.lax.fori_loop(0, 32, body, (acc, a, b))
    return (acc + rl % m) % m


def randint(seeds, lo: int, hi: int, mask=None):
    """rand() % (hi + 1 - lo) + lo (random.cl.inc:37-49, branch #if 1)."""
    rh, rl, seeds = rand_u64(seeds, mask)
    m = jnp.full(rh.shape, hi + 1 - lo, _U32)
    r = _mod_u64_u32(rh, rl, m).astype(jnp.int32) + lo
    return r, seeds


# ---------------------------------------------------------------------------
# Gaussian (ziggurat) and Gamma (Marsaglia-Tsang), masked rejection loops
# ---------------------------------------------------------------------------

def randn(seeds, mask=None):
    """N(0,1) per masked lane; draw order matches
    gsl_ran_gaussian_ziggurat (random.cl.inc:221-274): one u64 for the
    layer/sign/j; one uniform for wedge or tail; one more for tail."""
    shape = seeds.shape[:-1]
    if mask is None:
        mask = jnp.ones(shape, jnp.bool_)
    done = ~mask
    res = jnp.zeros(shape, jnp.float32)

    def cond(c):
        _, done, _ = c
        return jnp.any(~done)

    def body(c):
        seeds, done, res = c
        active = ~done
        _, kl, seeds = rand_u64(seeds, active)
        i_raw = kl & _U32(0xFF)
        sign = jnp.where((i_raw & _U32(0x80)) > 0, jnp.float32(1.0),
                         jnp.float32(-1.0))
        i = (i_raw & _U32(0x7F)).astype(jnp.int32)
        j = ((kl >> _U32(8)) & _U32(0xFFFFFF))
        x = j.astype(jnp.float32) * _WTAB[i]
        acc1 = j < _KTAB[i]
        need = active & ~acc1
        tail = need & (i == 127)
        u1, seeds = uniform(seeds, need)
        u2, seeds = uniform(seeds, tail)
        # wedge: y = ytab[i+1] + (ytab[i] - ytab[i+1]) * U1
        ip1 = jnp.minimum(i + 1, 127)
        y_wedge = _YTAB[ip1] + (_YTAB[i] - _YTAB[ip1]) * u1
        # tail: x = R - log(1 - U1)/R ; y = exp(-R(x - R/2)) U2
        r = jnp.float32(PARAM_R)
        x_tail = r - jnp.log(1.0 - u1) / r
        y_tail = jnp.exp(-r * (x_tail - 0.5 * r)) * u2
        x = jnp.where(tail, x_tail, x)
        y = jnp.where(tail, y_tail, y_wedge)
        acc2 = need & (y < jnp.exp(-0.5 * x * x))
        newly = (active & acc1) | acc2
        res = jnp.where(newly, sign * x, res)
        return seeds, done | newly, res

    seeds, _, res = jax.lax.while_loop(cond, body, (seeds, done, res))
    return res, seeds


def rand_gamma(seeds, a: float, b: float, mask=None):
    """Gamma(shape=a, scale=b) via Marsaglia-Tsang (random.cl.inc:353-391),
    including the a<1 boosting pre-pass (statically unrolled: a is a
    config constant)."""
    shape = seeds.shape[:-1]
    if mask is None:
        mask = jnp.ones(shape, jnp.bool_)
    f_boost = jnp.ones(shape, jnp.float32)
    aa = float(a)
    while aa < 1.0:
        u, seeds = uniform_pos(seeds, mask)
        f_boost = f_boost * jnp.power(u, jnp.float32(1.0 / aa))
        aa += 1.0

    d = jnp.float32(aa - 1.0 / 3.0)
    c = jnp.float32((1.0 / 3.0) / np.sqrt(aa - 1.0 / 3.0))
    done = ~mask
    res = jnp.zeros(shape, jnp.float32)

    def cond(carry):
        _, done, _ = carry
        return jnp.any(~done)

    def body(carry):
        seeds, done, res = carry
        active = ~done
        x, seeds = randn(seeds, active)
        v = 1.0 + c * x
        ok_v = active & (v > 0)          # v <= 0 -> redraw x next round
        v3 = v * v * v
        u, seeds = uniform_pos(seeds, ok_v)
        sq = x * x
        accept = ok_v & (
            (u < 1.0 - jnp.float32(0.0331) * sq * sq)
            | (jnp.log(u) < 0.5 * sq + d * (1.0 - v3 + jnp.log(v3)))
        )
        res = jnp.where(accept, d * v3, res)
        return seeds, done | accept, res

    seeds, _, res = jax.lax.while_loop(cond, body, (seeds, done, res))
    return f_boost * jnp.float32(b) * res, seeds


# ---------------------------------------------------------------------------
# Reference neighbor sampler (mcmc/sample.cc:13-78): per-lane open-
# addressing dedup hash with the exact draw discipline of
# generate_random_int_kernel — each lane keeps drawing randints
# (redrawing on r == node and on duplicates detected by the hash probe)
# until `num` distinct ids are inserted; the packed output is in HASH-
# SLOT order, not draw order, capacity = 2*num, probe stride
# 1 + (capacity << 1), h1 = (r ^ 553105253) % capacity.
# ---------------------------------------------------------------------------

_NBR_H1_XOR = 553105253


def sample_neighbors_reference(seeds, nodes, num_nodes: int, num: int,
                               mask=None):
    """Draw `num` distinct neighbors != node per lane, reference
    semantics and bit-exact stream consumption. Returns
    (packed [B, num] int32, seeds')."""
    if num >= num_nodes:
        raise ValueError(
            f"cannot draw {num} distinct neighbors != node from a "
            f"{num_nodes}-node graph (the reference kernel would spin "
            "forever here too)")
    b = nodes.shape[0]
    capacity = 2 * num
    sentinel = jnp.int32(num_nodes)
    stride = _U32(1 + (capacity << 1))
    cap = _U32(capacity)
    if mask is None:
        mask = jnp.ones((b,), jnp.bool_)
    lanes = jnp.arange(b, dtype=jnp.int32)
    out0 = jnp.full((b, capacity), sentinel, jnp.int32)

    def insert_one(carry, _):
        seeds, out = carry
        done = ~mask

        def draw_cond(c):
            return jnp.any(~c[3])

        def draw_body(c):
            seeds, out, _, done = c
            active = ~done
            r, seeds = randint(seeds, 0, num_nodes - 1, active)

            # inner do-while: redraw while r == node
            def rcond(rc):
                r2, _ = rc
                return jnp.any(active & (r2 == nodes))

            def rbody(rc):
                r2, s2 = rc
                redraw = active & (r2 == nodes)
                r3, s2 = randint(s2, 0, num_nodes - 1, redraw)
                return jnp.where(redraw, r3, r2), s2

            r, seeds = jax.lax.while_loop(rcond, rbody, (r, seeds))

            # probe until duplicate (redraw) or empty slot (insert)
            l1 = (r.astype(_U32) ^ _U32(_NBR_H1_XOR)) % cap

            def pcond(pc):
                _, _, resolved, _ = pc
                return jnp.any(active & ~resolved)

            def pbody(pc):
                i, out2, resolved, dup = pc
                offset = ((l1 + i.astype(_U32) * stride) % cap
                          ).astype(jnp.int32)
                val = out2[lanes, offset]
                is_dup = active & ~resolved & (val == r)
                can_ins = active & ~resolved & (val == sentinel)
                row = jnp.where(can_ins, lanes, b)
                out2 = out2.at[row, offset].set(r, mode="drop")
                return (i + 1, out2, resolved | is_dup | can_ins,
                        dup | is_dup)

            zero = jnp.zeros((b,), jnp.int32)
            false = jnp.zeros((b,), jnp.bool_)
            _, out, resolved, dup = jax.lax.while_loop(
                pcond, pbody, (zero, out, false, false))
            done = done | (active & ~dup)   # inserted lanes finish
            return seeds, out, r, done

        seeds, out, _, _ = jax.lax.while_loop(
            draw_cond, draw_body,
            (seeds, out, jnp.zeros((b,), jnp.int32), done))
        return (seeds, out), None

    (seeds, out), _ = jax.lax.scan(insert_one, (seeds, out0), None,
                                   length=num)
    # compact: first `num` non-sentinel entries in slot order
    order = jnp.argsort(out == sentinel, axis=1, stable=True)
    packed = jnp.take_along_axis(out, order, axis=1)[:, :num]
    return packed, seeds
