"""ctypes bindings + lazy build of the native C++ host sampler.

The reference's host side is C++ throughout (graph ETL data.cc,
minibatch samplers sample.cc); this module is its counterpart here:
`csrc/sampler.cpp` compiled on first use with g++ into
`build/libmcmc_sampler.so`, exposed through ctypes (pybind11 is not in
this image). Everything degrades gracefully to the numpy implementations
in sampling.py / data.py when no compiler is available —
``available()`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "csrc", "sampler.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmcmc_sampler.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

STRATEGY_CODES = {
    "NodeLink": 0, "NodeNonLink": 1, "Node": 2,
    "BFLink": 3, "BFNonLink": 4, "BF": 5,
}


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return True
    # build to a temp path + atomic rename: a killed/concurrent build
    # must never leave a truncated .so at the final path
    tmp = _LIB_PATH + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # stale/corrupt artifact: rebuild once from scratch, else
            # degrade to the numpy implementations
            try:
                os.unlink(_LIB_PATH)
            except OSError:
                return None
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
        i64 = ctypes.c_int64
        lib.sample_batches.restype = ctypes.c_int
        lib.sample_batches.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64,          # csr
            ctypes.c_void_p, i64,                           # heldout
            ctypes.c_int, i64, ctypes.c_double, ctypes.c_double,
            i64, i64, i64, ctypes.c_uint64,                 # S, caps, seed
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.snap_parse.restype = i64
        lib.snap_parse.argtypes = [ctypes.c_char_p, i64,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.snap_parse_open.restype = i64
        lib.snap_parse_open.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_void_p)]
        lib.snap_parse_take.restype = None
        lib.snap_parse_take.argtypes = [ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.snap_parse_drop.restype = None
        lib.snap_parse_drop.argtypes = [ctypes.c_void_p]
        lib.chd_build.restype = i64
        lib.chd_build.argtypes = [
            i64, ctypes.c_void_p, ctypes.c_void_p,   # edges
            i64, i64, ctypes.c_uint32,               # M, NB, seed
            ctypes.c_void_p, ctypes.c_void_p,        # out_d, out_slot_of
        ]
        lib.cuckoo_try.restype = ctypes.c_int
        lib.cuckoo_try.argtypes = [
            i64, ctypes.c_void_p,                    # keys
            i64, ctypes.c_uint64,                    # num_bins, seed
            ctypes.c_void_p,                         # out slots
        ]
        lib.ref_theta_init.restype = ctypes.c_int
        lib.ref_theta_init.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
            i64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def sample_batches(
    offsets: np.ndarray, cols: np.ndarray, num_nodes: int,
    heldout_sorted: np.ndarray, strategy: str, mini_batch: int,
    n_f: float, e_f: float, n_batches: int, e_cap: int, b_cap: int,
    seed: int,
):
    """Fill a stack of padded minibatches in one native call.

    Returns (edges_u, edges_v, edge_mask, nodes, node_mask, weights),
    shapes [S, e_cap] / [S, b_cap] / [S], matching
    sampling.MiniBatchSampler.sample_many.
    """
    lib = _load()
    assert lib is not None, "native sampler unavailable"
    offsets = np.ascontiguousarray(offsets, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    heldout_sorted = np.ascontiguousarray(heldout_sorted, np.uint64)
    s = n_batches
    eu = np.empty((s, e_cap), np.int32)
    ev = np.empty((s, e_cap), np.int32)
    em = np.empty((s, e_cap), np.uint8)
    nd = np.empty((s, b_cap), np.int32)
    nm = np.empty((s, b_cap), np.uint8)
    w = np.empty(s, np.float32)
    rc = lib.sample_batches(
        _ptr(offsets), _ptr(cols), num_nodes,
        _ptr(heldout_sorted), len(heldout_sorted),
        STRATEGY_CODES[strategy], mini_batch, float(n_f), float(e_f),
        s, e_cap, b_cap, seed & 0xFFFFFFFFFFFFFFFF,
        _ptr(eu), _ptr(ev), _ptr(em), _ptr(nd), _ptr(nm), _ptr(w),
    )
    if rc != 0:
        reasons = {-1: "unknown strategy", -2: "edge capacity exceeded",
                   -3: "node capacity exceeded",
                   -4: "sampling retry budget exhausted (graph cannot "
                       "supply the requested minibatch)"}
        raise RuntimeError("native sample_batches failed: "
                           f"{reasons.get(rc, f'rc={rc}')}")
    return eu, ev, em.astype(bool), nd, nm.astype(bool), w


def snap_parse(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a SNAP edge list natively; returns canonicalized (u, v)
    int64 arrays (self loops dropped, duplicates retained — renumber +
    dedup happen vectorized in data.renumber_dedup_shuffle).

    Single-pass protocol: the C side reads and parses the file once
    into an owned buffer (snap_parse_open), then snap_parse_take copies
    the pairs out and frees it — at multi-GB edge lists the old
    count-then-fill protocol paid the file I/O and parse twice."""
    lib = _load()
    assert lib is not None, "native parser unavailable"
    reasons = {-1: "cannot read file",
               -3: "malformed line (expected two ints)"}
    handle = ctypes.c_void_p()
    count = lib.snap_parse_open(path.encode(), ctypes.byref(handle))
    if count < 0:
        raise IOError(f"snap_parse({path}) failed: "
                      f"{reasons.get(count, f'rc={count}')}")
    try:
        u = np.empty(count, np.int64)
        v = np.empty(count, np.int64)
    except BaseException:
        lib.snap_parse_drop(handle)
        raise
    lib.snap_parse_take(handle, _ptr(u), _ptr(v))
    return u, v


def chd_build(u: np.ndarray, v: np.ndarray, m_slots: int,
              n_buckets: int, seed: int):
    """Native CHD construction for one seed (same greedy + hashes as the
    numpy path in ops/edgeset.py — identical tables). Returns
    (displacements [NB] i32, slot_of [E] i64) or None when this seed
    fails (caller retries with the next one)."""
    lib = _load()
    assert lib is not None, "native chd_build unavailable"
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    d = np.zeros(n_buckets, np.int32)
    slot_of = np.empty(len(u), np.int64)
    rc = lib.chd_build(len(u), _ptr(u), _ptr(v), m_slots, n_buckets,
                       np.uint32(seed), _ptr(d), _ptr(slot_of))
    if rc == -5:
        return None
    if rc != 0:
        raise IOError(f"chd_build failed: rc={rc}")
    return d, slot_of


def ref_theta_init(eta0: float, eta1: float, seed: int,
                   count: int) -> np.ndarray:
    """The reference's EXACT theta-init bit stream
    (learner.cc:149-153): std::mt19937(seed-truncated-to-32-bit)
    driving libstdc++'s std::gamma_distribution<float>(eta0, eta1),
    ``count`` sequential draws in the interleaved (k,0),(k,1) layout.
    Raises when the native library is unavailable — callers opting
    into bit-stream parity must fail loudly, not silently swap
    distributions (Config.theta_init)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "theta_init='libstdc++' needs the native library "
            "(g++/libstdc++); it is unavailable on this host")
    out = np.empty(count, np.float32)
    rc = lib.ref_theta_init(float(eta0), float(eta1),
                            seed & 0xFFFFFFFFFFFFFFFF, count, _ptr(out))
    if rc != 0:
        raise IOError(f"ref_theta_init failed: rc={rc}")
    return out


def cuckoo_try(keys: np.ndarray, num_bins: int, seed: int):
    """One native cuckoo placement attempt (same walk discipline as the
    numpy fallback in ops/edgeset.py). Returns the filled slots array
    [2, num_bins, 4] uint64 (empty = all-ones) or None when the walk
    fails at this table size (caller grows and retries)."""
    lib = _load()
    assert lib is not None, "native cuckoo_try unavailable"
    keys = np.ascontiguousarray(keys, np.uint64)
    slots = np.empty((2, num_bins, 4), np.uint64)
    rc = lib.cuckoo_try(len(keys), _ptr(keys), num_bins,
                        np.uint64(seed), _ptr(slots))
    if rc == -5:
        return None
    if rc != 0:
        raise IOError(f"cuckoo_try failed: rc={rc}")
    return slots
