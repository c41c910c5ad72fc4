"""Block decoder for the reference RNG backend.

The reference's stateful draws (ziggurat gaussians
/root/reference/mcmc/random.cl.inc:221-274, rejection randints
sample.cc:13-78) consume a DATA-DEPENDENT number of xorshift128+ words
per draw, which forces rng/reference.py's faithful implementations into
lax.while_loop rejection regions — correct, but every while region is
a host-synchronized loop of small device kernels, and the phi stage
needs K sequential gaussians per lane (phi.cc:114-121): ~256 while
regions per training step.

This module decouples GENERATION from CONSUMPTION.

  1. generate a block of M raw xorshift128+ words per lane with one
     unrolled lax.scan (the recurrence is sequential but each step is a
     handful of uint32 ops; the per-position seed trajectory is kept so
     any prefix position can be restarted from bit-exactly);
  2. DECODE the rejection algorithm's consumption pattern from the raw
     words, fully vectorized over positions: a rejection ROUND's accept
     flag, value and word-consumption are pure functions of the words
     themselves, and the data-dependent chain (draw i+1 starts where
     draw i's accepting round ended) resolves with O(log M)
     pointer-doubling gathers instead of per-draw while loops;
  3. one outer while_loop refills the buffer in the astronomically rare
     case the k draws consume more than M words, restarting generation
     from the exact stream position of the first incomplete round —
     bit-exactness is guaranteed, not probabilistic.

Exact equality against the faithful rng/reference.py implementations is
pinned by tests/test_refblock.py (thousands of lanes x draws x stream
offsets, covering wedge rejections and the exponential tail).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mcmc_ammsb.rng import reference as ref

_U32 = jnp.uint32
_I32 = jnp.int32


def gen_block(seeds: jnp.ndarray, m: int, unroll: int = 16):
    """M sequential xorshift128+ words per lane (all lanes advance).

    Returns (hi [L, M], lo [L, M], seeds_at [L, M+1, 4]) where
    seeds_at[:, p] is the stream state after consuming exactly p words —
    the restart handle for bit-exact refills.
    """

    def step(s, _):
        rh, rl, s2 = ref.rand_u64(s)
        return s2, (rh, rl, s2)

    _, (hi, lo, traj) = jax.lax.scan(
        step, seeds, None, length=m, unroll=min(unroll, m))
    hi = jnp.moveaxis(hi, 0, -1)                      # [L, M]
    lo = jnp.moveaxis(lo, 0, -1)
    seeds_at = jnp.concatenate(
        [seeds[:, None, :], jnp.moveaxis(traj, 0, 1)], axis=1)
    return hi, lo, seeds_at


def _uniform_from_words(hi, lo):
    """The reference's exact u64 -> fp32 conversion (reference.uniform)."""
    return (hi.astype(jnp.float32) * jnp.float32(4294967296.0)
            + lo.astype(jnp.float32)) * jnp.float32(2.0 ** -64)


def _shift1(a, fill):
    return jnp.concatenate([a[:, 1:], jnp.full_like(a[:, :1], fill)], axis=1)


def _decode_randn_rounds(hi, lo, m: int):
    """Vectorized decode of one ziggurat ROUND starting at each position.

    A round reads the layer word at p, and — when the ktab test fails —
    the wedge uniform at p+1 (plus the tail uniform at p+2 on layer
    127). Returns, per position p in [0, m):

      accept [L, m] bool — the round accepts,
      value  [L, m] f32  — the accepted gaussian (garbage if ~accept),
      cons   [L, m] i32  — words the round consumes (1, 2 or 3),
      ok     [L, m] bool — the round is fully decodable inside the
                           buffer (p + cons <= m).

    Float expressions mirror reference.randn term for term so accepted
    values are bit-identical (elementwise f32 ops are deterministic).
    """
    i_raw = lo & _U32(0xFF)
    sign = jnp.where((i_raw & _U32(0x80)) > 0, jnp.float32(1.0),
                     jnp.float32(-1.0))
    i = (i_raw & _U32(0x7F)).astype(_I32)
    j = (lo >> _U32(8)) & _U32(0xFFFFFF)
    x = j.astype(jnp.float32) * ref._WTAB[i]
    acc1 = j < ref._KTAB[i]
    tail = ~acc1 & (i == 127)

    u = _uniform_from_words(hi, lo)
    u1 = _shift1(u, 0.0)
    u2 = _shift1(u1, 0.0)

    ip1 = jnp.minimum(i + 1, 127)
    y_wedge = ref._YTAB[ip1] + (ref._YTAB[i] - ref._YTAB[ip1]) * u1
    r = jnp.float32(ref.PARAM_R)
    x_tail = r - jnp.log(1.0 - u1) / r
    y_tail = jnp.exp(-r * (x_tail - 0.5 * r)) * u2
    x = jnp.where(tail, x_tail, x)
    y = jnp.where(tail, y_tail, y_wedge)
    acc2 = ~acc1 & (y < jnp.exp(-0.5 * x * x))

    accept = acc1 | acc2
    value = sign * x
    cons = jnp.where(acc1, 1, jnp.where(tail, 3, 2)).astype(_I32)
    pos = jnp.arange(m, dtype=_I32)[None, :]
    ok = (pos + cons) <= m
    return accept, value, cons, ok


def _pad_sentinel(a, fill):
    return jnp.concatenate([a, jnp.full_like(a[:, :1], fill)], axis=1)


# Full-table pointer-doubling squaring (tab <- tab[tab]) as a per-row
# integer gather; an entry outside [0, m1) composes to 0. Exact for any
# integer value.
def _compose_table(tab):
    m1 = tab.shape[1]
    ok = (tab >= 0) & (tab < m1)
    return jnp.where(
        ok, jnp.take_along_axis(tab, jnp.where(ok, tab, 0), axis=1), 0)


def randn_block(seeds: jnp.ndarray, k: int,
                mask: Optional[jnp.ndarray] = None,
                pad: Optional[int] = None,
                max_chain_doublings: int = 3
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k sequential N(0,1) draws per masked lane — bit-exact to k
    successive reference.randn calls, without k while regions.

    Returns ([L, k] float32 in draw order, seeds'). Masked-off lanes
    return zeros and their streams do not advance (reference.randn mask
    semantics).

    ``max_chain_doublings``: rejection chains longer than
    2^max_chain_doublings ROUNDS are not resolved in-buffer; the draw
    is treated as incomplete and the refill restarts bit-exactly at the
    unresolved round boundary (every chase intermediate IS a round
    boundary). At the ziggurat's ~1.1% rejection rate a >8-round chain
    has probability ~2e-16 per draw, so the default means the gather-
    heavy chase costs 3 table ops instead of log2(m)+1 (~10) while the
    astronomically rare long chain just pays one more buffer pass.
    """
    lanes = seeds.shape[0]
    if mask is None:
        mask = jnp.ones((lanes,), jnp.bool_)
    if pad is None:
        # expected consumption is k*(1 + ~0.0115 rejections*extra
        # words); pad 16 + k/16 sits ~15 sigma above the mean so
        # refills are negligible while the buffer (whose gathers are
        # element-serialized, ~15 ns/element) stays tight
        pad = 16 + k // 16
    m = k + pad
    doublings = max(1, min(max_chain_doublings,
                           math.ceil(math.log2(m)) + 1))
    ext_rounds = max(1, math.ceil(math.log2(k + 1)))

    res0 = jnp.zeros((lanes, k), jnp.float32)
    filled0 = jnp.where(mask, 0, k).astype(_I32)
    lane_idx = jnp.arange(lanes)

    def cond(c):
        _, filled, _ = c
        return jnp.any(filled < k)

    def body(c):
        seeds, filled, res = c
        with jax.named_scope("rb_gen"):
            hi, lo, seeds_at = gen_block(seeds, m)
        with jax.named_scope("rb_decode"):
            accept, value, cons, ok = _decode_randn_rounds(hi, lo, m)

        # chase[p]: first position in the round chain from p that either
        # accepts or is not fully decodable (sentinel index m) — one
        # pointer-doubled table answers both "which round accepted draw
        # p" and "where must a refill restart".
        with jax.named_scope("rb_chase"):
            p = jnp.broadcast_to(jnp.arange(m, dtype=_I32)[None, :],
                                 (lanes, m))
            step = jnp.where(accept | ~ok, p, p + cons)
            step = _pad_sentinel(step, m)             # step[m] = m
            for _ in range(doublings):
                step = _compose_table(step)
            chase = step                              # [L, m+1]

            accept_f = _pad_sentinel(accept, False)
            ok_f = _pad_sentinel(ok, False)
            cons_f = _pad_sentinel(cons, 0)
            value_f = _pad_sentinel(value, 0.0)

            complete_at = jnp.take_along_axis(
                accept_f & ok_f, chase, axis=1)       # chain ends OK
            # h[p]: start of the NEXT draw after the draw starting at p
            # (sentinel if that draw is incomplete in this buffer)
            nxt = chase + jnp.take_along_axis(cons_f, chase, axis=1)
            h = jnp.where(complete_at, jnp.minimum(nxt, m), m)

        # pos[i] = h^i(0), i in [0, k] (pos[k] = stream position after
        # all k draws), via doubling extension
        with jax.named_scope("rb_ext"):
            pos = jnp.zeros((lanes, 1), _I32)
            htab = h
            for _ in range(ext_rounds):
                ext = jnp.take_along_axis(htab, pos, axis=1)
                pos = jnp.concatenate([pos, ext], axis=1)
                if pos.shape[1] >= k + 1:
                    break
                htab = _compose_table(htab)
            pos = pos[:, :k + 1]

        with jax.named_scope("rb_write"):
            q = jnp.take_along_axis(chase, pos, axis=1)   # [L, k+1]
            complete = jnp.take_along_axis(
                accept_f & ok_f, q[:, :k], axis=1)
            vals = jnp.take_along_axis(value_f, q[:, :k], axis=1)

            n_ok = complete.sum(axis=1).astype(_I32)
            remaining = k - filled
            take = jnp.minimum(n_ok, remaining)

            t = jnp.arange(k, dtype=_I32)[None, :]
            src = jnp.clip(t - filled[:, None], 0, k - 1)
            shifted = jnp.take_along_axis(vals, src, axis=1)
            write = (t >= filled[:, None]) & (t < (filled + take)[:, None])
            res = jnp.where(write, shifted, res)

        # restart handle: lanes that finish stop exactly after their
        # last draw (pos[take]); unfinished lanes restart at the first
        # incomplete ROUND (q[take]) — rounds are redecoded whole, so
        # the refill is bit-exact
        with jax.named_scope("rb_restart"):
            end_done = jnp.take_along_axis(
                pos, take[:, None], axis=1)[:, 0]
            end_part = jnp.take_along_axis(q, take[:, None], axis=1)[:, 0]
            done_now = (filled + take) >= k
            restart = jnp.where(done_now, end_done, end_part)
            seeds = seeds_at[lane_idx, restart]
        return seeds, filled + take, res

    seeds, _, res = jax.lax.while_loop(cond, body, (seeds, filled0, res0))
    return res, seeds


# ---------------------------------------------------------------------------
# Reference neighbor sampler, block-decoded. Each randint consumes
# EXACTLY one word (sample.cc's generate_random_int_kernel draw), so the
# decode needs no chase at all: validity of each draw is a pure function
# of the draw values (r != node and first occurrence), and the hash-slot
# packing is replayed afterwards on the accepted values only.
# ---------------------------------------------------------------------------


def _mod_u64_static(rh, rl, m: int):
    """(hi*2^32 + lo) % m for a STATIC modulus m < 2^31 — the peasant
    mulmod of reference._mod_u64_u32 unrolled over the set bits of the
    trace-time constant 2^32 mod m (bit-identical results)."""
    mm = _U32(m)
    pow32 = ((0xFFFFFFFF % m) + 1) % m                # 2^32 mod m
    a = rh % mm
    acc = jnp.zeros_like(a)
    b = pow32
    while b:
        if b & 1:
            acc = (acc + a) % mm
        a = (a + a) % mm
        b >>= 1
    return (acc + rl % mm) % mm


def sample_neighbors_block(seeds: jnp.ndarray, nodes: jnp.ndarray,
                           num_nodes: int, num: int,
                           mask: Optional[jnp.ndarray] = None,
                           pad: Optional[int] = None
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bit-exact fast twin of reference.sample_neighbors_reference.

    Decode: draw r_p = rand() % num_nodes at every buffer position;
    draw p is ACCEPTED iff r_p != node and r_p differs from every
    earlier draw (the reference's open-addressing probe rejects exactly
    the duplicates — first-occurrence semantics); the stream consumes
    words up to and including the num-th accepted draw. The hash-slot
    output packing is reproduced by replaying the insertion of the
    accepted values into the same table afterwards (a scan over num
    values with a vectorized probe, not a per-draw while loop).
    """
    if num >= num_nodes:
        raise ValueError(
            f"cannot draw {num} distinct neighbors != node from a "
            f"{num_nodes}-node graph (the reference kernel would spin "
            "forever here too)")
    b = nodes.shape[0]
    if mask is None:
        mask = jnp.ones((b,), jnp.bool_)
    if pad is None:
        pad = max(16, num // 2)
    m = num + pad
    lane_idx = jnp.arange(b)

    vals0 = jnp.zeros((b, num), _I32)
    count0 = jnp.where(mask, 0, num).astype(_I32)

    def cond(c):
        _, count, _ = c
        return jnp.any(count < num)

    def body(c):
        seeds, count, vals = c
        hi, lo, seeds_at = gen_block(seeds, m)
        r = _mod_u64_static(hi, lo, num_nodes).astype(_I32)   # [L, m]
        not_node = r != nodes[:, None]
        earlier = (r[:, None, :] == r[:, :, None])            # [L, p, p']
        tri = jnp.tril(jnp.ones((m, m), jnp.bool_), k=-1)     # p' < p
        dup = jnp.any(earlier & tri[None], axis=2)
        # draws equal to a value accepted in an EARLIER buffer are
        # duplicates too (the reference's table persists across refills)
        prev_live = jnp.arange(num, dtype=_I32)[None, :] < count[:, None]
        dup_prev = jnp.any(
            (r[:, :, None] == vals[:, None, :]) & prev_live[:, None, :],
            axis=2)
        valid = not_node & ~dup & ~dup_prev

        # positions of valid draws, in draw order
        order = jnp.argsort(~valid, axis=1, stable=True)      # [L, m]
        n_valid = valid.sum(axis=1).astype(_I32)
        remaining = num - count
        take = jnp.minimum(n_valid, remaining)

        vsel = jnp.take_along_axis(r, order, axis=1)          # [L, m]
        t = jnp.arange(num, dtype=_I32)[None, :]
        src = jnp.clip(t - count[:, None], 0, m - 1)
        shifted = jnp.take_along_axis(vsel, src, axis=1)
        write = (t >= count[:, None]) & (t < (count + take)[:, None])
        vals = jnp.where(write, shifted, vals)

        # stream position: one past the take-th valid draw; if this
        # buffer didn't finish the lane, ALL m words were consumed
        idx = jnp.clip(take - 1, 0, num - 1)
        last_valid_pos = jnp.take_along_axis(
            order, idx[:, None], axis=1)[:, 0]
        consumed = jnp.where(take > 0, last_valid_pos + 1, 0)
        done_now = (count + take) >= num
        consumed = jnp.where(done_now, consumed, m)
        consumed = jnp.where(count >= num, 0, consumed)       # finished lanes
        seeds = seeds_at[lane_idx, consumed]
        return seeds, count + take, vals

    seeds, _, vals = jax.lax.while_loop(cond, body, (seeds, count0, vals0))

    # replay the reference's open-addressing insertion (slot-order
    # packing, sample.cc h1/stride law — reference.py constants)
    capacity = 2 * num
    sentinel = jnp.int32(num_nodes)
    stride = 1 + (capacity << 1)
    probes = jnp.arange(capacity, dtype=_I32)                 # [cap]
    table0 = jnp.full((b, capacity), sentinel, _I32)

    def insert(table, rv):
        l1 = ((rv.astype(_U32) ^ _U32(ref._NBR_H1_XOR))
              % _U32(capacity)).astype(_I32)
        offs = (l1[:, None] + probes[None, :] * stride) % capacity
        empty = jnp.take_along_axis(table, offs, axis=1) == sentinel
        slot_rank = jnp.argmax(empty, axis=1)                 # first empty
        slot = jnp.take_along_axis(
            offs, slot_rank[:, None], axis=1)[:, 0]
        row = jnp.where(mask, lane_idx, b)                    # masked: drop
        table = table.at[row, slot].set(rv, mode="drop")
        return table, None

    table, _ = jax.lax.scan(insert, table0, jnp.moveaxis(vals, 0, 1))
    order = jnp.argsort(table == sentinel, axis=1, stable=True)
    packed = jnp.take_along_axis(table, order, axis=1)[:, :num]
    return packed, seeds
