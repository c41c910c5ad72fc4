"""Per-stage attribution of the PRODUCTION fused program.

The reference times every kernel launch with device events and prints
true per-stage seconds/% (/root/reference/mcmc/learner.cc:252-299,
mcmc/phi.cc:755-762). Our production step is ONE fused XLA program, so
per-stage truth requires a profiler trace, not host walls: this module
runs a traced production chunk under ``jax.profiler.trace`` and
aggregates the device-plane per-op durations by the ``jax.named_scope``
stage annotations embedded in the step functions (learner.py).

Trace shapes read here (one reduction for both backends):
  * GPU: device planes named ``/device:GPU:<i>``, one thread per CUDA
    stream (``Stream #<id>(Compute)``, ``Stream #<id>(MemcpyD2H)``, ...).
    Each kernel event is named after the HLO instruction that launched
    it with ``.`` and ``-`` turned into ``_`` (``loop_add_fusion.11``
    runs as ``loop_add_fusion_11``); its ``hlo_op`` arg names the
    instruction, or ``command_buffer`` when the kernel ran inside a
    CUDA graph, and its ``tf_op`` arg holds the scope path only outside
    command buffers (``XlaModule:`` inside them).
  * CPU: thunk events on the host plane carry ``hlo_op``.
Each event is mapped to its scope path through, in order: a ``tf_op``
scope path, its ``hlo_op`` instruction name, its kernel name — the
last two through the op_name metadata of the optimized HLO
(``hlo_op_scope_map``). A library kernel inside a command buffer
(cuBLAS gemms, memsets) matches no instruction and takes the stage of
the kernel before it in the same CUDA graph; copies and anything else
unmatched count as "other".

Ops that XLA fused ACROSS stage boundaries are attributed to the stage
of the fusion's representative op — shares are exact for device time,
approximate for stage identity (that is the price of fusion; the
reference pays the dual price of 7+ serialized launches instead).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import re
import tempfile
from typing import Callable, Dict, Iterable, Optional, Tuple

# production stage scopes (annotated in learner.py / parallel/sharded.py)
STAGE_NAMES = (
    "device_sampling",
    "neighbor_draws",
    "membership",
    "noise",
    "edge_lanes",
    "pi_gather",
    "phi_update",
    "pi_scatter",
    "beta_grads",
    "theta_update",
    "ppx",
    # device-sampling sub-scopes (ops/device_sampling.py)
    "ds_link",
    "ds_nonlink",
    "ds_extract_nodes",
    # windowed-engine scopes (ops/window.py, chains_flat.py)
    "window_gather",
    "window_correct",
    "window_dirty",
    "window_body",
    "window_scatter",
)

_HLO_META_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*metadata=\{[^}]*"
    r"op_name=\"([^\"]+)\"", re.M)


def hlo_op_scope_map(hlo_text: str) -> Dict[str, str]:
    """op name -> op_name metadata path, from optimized HLO text; each
    name also appears in the form GPU kernels are named by
    (``.``/``-`` -> ``_``)."""
    out = {}
    for m in _HLO_META_RE.finditer(hlo_text):
        out[m.group(1)] = m.group(2)
        out.setdefault(_kernel_name(m.group(1)), m.group(2))
    return out


def _kernel_name(op: str) -> str:
    return op.replace(".", "_").replace("-", "_")


def _stage_of(path: Optional[str], stages: Iterable[str]) -> str:
    if path:
        for part in reversed(path.split("/")):
            name = part.split(":")[0]
            if name in stages:
                return name
    return "other"


def _leaf_events(evs: list) -> list:
    """Keep only LEAF events of one thread's timeline.

    XLA op timelines nest: a lax.scan compiles to a `while` op whose
    event spans the whole loop while its body ops are emitted as
    children inside that span — summing both double-counts every scan
    body. Events on one thread form a stack by (start, end) nesting;
    anything that contains another event is a container, not a kernel.
    """
    evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
    out = []
    stack = []  # (end_ts, event, is_parent flag index into out/None)
    parents = set()
    for e in evs:
        start, end = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][0] <= start + 1e-9:
            stack.pop()
        if stack:
            parents.add(id(stack[-1][1]))
        stack.append((end, e))
    return [e for e in evs if id(e) not in parents]


def _load_latest_trace(trace_dir: str) -> dict:
    paths = sorted(glob.glob(
        trace_dir + "/**/*.trace.json.gz", recursive=True))
    if not paths:
        raise RuntimeError(f"no trace written under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        return json.load(f)


def _busy_seconds(evs: list) -> float:
    """Union length of the events' [ts, ts+dur] intervals (us -> s)."""
    busy, end = 0.0, float("-inf")
    for e in sorted(evs, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy * 1e-6


def _scope_path(e: dict, op_map: Dict[str, str]) -> Tuple[Optional[str], str]:
    """(scope path or None, attribution source) of one op event."""
    args = e.get("args", {})
    tf_op = args.get("tf_op", "")
    if "/" in tf_op:
        return tf_op, "tf_op"
    for op in (args.get("hlo_op"), e["name"]):
        if op and op != "command_buffer":
            path = op_map.get(op.lstrip("%")) or op_map.get(
                _kernel_name(op.lstrip("%")))
            if path:
                return path, "hlo"
    return None, "none"


def reduce_trace(trace: dict, op_map: Dict[str, str],
                 stages: Iterable[str] = STAGE_NAMES) -> dict:
    """Per-stage device-op seconds from a Chrome-format trace dict;
    ``op_map`` is ``hlo_op_scope_map`` of the traced program.

    Returns {"stages": {stage: seconds}, "total_op_seconds": s,
    "busy_seconds": s_or_None, "source": "tf_op"|"hlo"|"none"}.
    ``busy_seconds`` is the union of the device events' intervals (GPU
    traces; None on CPU) — the device's busy time, which per-op sums
    exceed where streams overlap."""
    events = trace["traceEvents"]
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {p for p, n in pids.items() if "/device:" in n}

    per_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e["pid"] not in dev_pids and (
                "hlo_op" not in e.get("args", {})
                or e["name"].startswith("end:")):
            continue   # host plane: only CPU thunk events are ops
        per_thread[(e["pid"], e.get("tid"))].append(e)

    per_stage = collections.defaultdict(float)
    total = 0.0
    sources = set()
    dev_events = []
    for (pid, _), evs in per_thread.items():
        leaves = _leaf_events(evs)
        if pid in dev_pids:
            dev_events.extend(leaves)
        prev = (None, None)        # (cuda graph id, scope path)
        for e in leaves:
            path, src = _scope_path(e, op_map)
            graph = e.get("args", {}).get("cuda_graph_id")
            if path is None and graph is not None and graph == prev[0]:
                # a library kernel (cuBLAS, memset) inside a command
                # buffer runs between the fusions of the op that
                # launched it: it takes the preceding kernel's stage
                path = prev[1]
            elif path is not None:
                prev = (graph, path)
            sources.add(src)
            dur_s = e["dur"] * 1e-6
            per_stage[_stage_of(path, stages)] += dur_s
            total += dur_s
    source = ("tf_op" if "tf_op" in sources
              else "hlo" if "hlo" in sources else "none")
    return {
        "stages": dict(per_stage),
        "total_op_seconds": total,
        "busy_seconds": _busy_seconds(dev_events) if dev_events else None,
        "source": source,
    }


def profile_trace(
    run: Callable[[], None],
    hlo_text: Optional[str] = None,
    stages: Iterable[str] = STAGE_NAMES,
) -> dict:
    """Trace ``run()`` (it must FENCE its device work with a scalar
    readback) and reduce the trace with ``reduce_trace``; ``hlo_text``
    is the optimized HLO of the traced program."""
    import jax

    with tempfile.TemporaryDirectory(prefix="mcmc_stage_prof_") as d:
        with jax.profiler.trace(d):
            run()
        trace = _load_latest_trace(d)
    return reduce_trace(
        trace, hlo_op_scope_map(hlo_text) if hlo_text else {}, stages)


def traced_stage_profile(run: Callable[[int], None], hlo_text: str,
                         spc: int, iters: Optional[int]) -> dict:
    """The engines' shared ``fused_stage_profile``: compile one chunk
    of ``spc`` steps outside the trace, then trace ``iters`` steps
    (rounded to whole chunks; default max(spc, 200))."""
    iters = iters or max(spc, 200)
    iters = max(spc, (iters // spc) * spc)
    run(spc)
    prof = profile_trace(lambda: run(iters), hlo_text=hlo_text)
    prof["steps"] = iters
    return prof


def print_stage_profile(prof: dict, log=print) -> None:
    """Print a traced stage profile; a trace with no attributable
    device ops is an error, not a table of zeros."""
    if prof["source"] == "none" or prof["total_op_seconds"] <= 0:
        raise RuntimeError(
            "stage profile: the trace has no device op attributable to "
            f"a stage (source={prof['source']!r}, "
            f"total={prof['total_op_seconds']:.3g}s)")
    format_stage_table(prof, prof["steps"], log)


def format_stage_table(prof: dict, steps: int, log=print) -> None:
    """PrintStats-style table (learner.cc:252-299) from a trace profile:
    per-step microseconds and share of device time per stage."""
    total = prof["total_op_seconds"]
    if total <= 0:
        log("stage profile: no device ops captured")
        return
    busy = prof.get("busy_seconds")
    log(f"fused per-step stage profile over {steps} steps "
        f"(device-op time; attribution={prof['source']})")
    for stage, s in sorted(prof["stages"].items(), key=lambda kv: -kv[1]):
        log(f"{stage.upper():16s}: {s / steps * 1e6:9.2f} us/step "
            f"(%{100 * s / total:5.1f})")
    log(f"{'TOTAL OPS':16s}: {total / steps * 1e6:9.2f} us/step")
    if busy:
        log(f"{'DEVICE BUSY':16s}: {busy / steps * 1e6:9.2f} us/step")
