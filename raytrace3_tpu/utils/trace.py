"""Reduce a ``jax.profiler`` trace to device time per named scope.

A pass is traced with ``jax.profiler.start_trace``; every device event in
the resulting ``.xplane.pb`` names the HLO instruction it ran (stat
``hlo_op``).  The compiled module's text maps each instruction to the
``op_name`` metadata JAX recorded, which carries the ``jax.named_scope``
path (``eye_pass``, ``photon_rounds``, ``newton``, ``deposit``).  Device time
is summed per scope; nested scopes count toward each scope they lie in.
"""

from __future__ import annotations

import glob
import os
import re

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def hlo_scopes(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> its op_name metadata (scope path)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def latest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU"):
    """(name, hlo_op, start_ns, duration_ns) of every event on the planes
    whose name starts with ``plane_prefix`` (the GPUs by default)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                yield (e.name, str(stats.get("hlo_op", e.name)),
                       float(e.start_ns), float(e.duration_ns))


def busy_ns(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, float("-inf")
    for s, d in sorted(intervals):
        e = s + d
        if s >= end:
            total += d
        elif e > end:
            total += e - end
        end = max(end, e)
    return total


def scope_times(xplane_path: str, hlo_text: str, scopes,
                plane_prefix: str = "/device:GPU", top: int = 25) -> dict:
    """Device time (ms) per scope, the busiest kernels overall and per
    scope, and the busy and idle share of the traced window (first to last
    device event)."""
    names = hlo_scopes(hlo_text)
    per_scope = {s: 0.0 for s in scopes}
    per_scope_kernel = {s: {} for s in scopes}
    per_kernel: dict[str, float] = {}
    spans = []
    for name, op, start, dur in device_events(xplane_path, plane_prefix):
        spans.append((start, dur))
        path = names.get(op, "")
        key = f"{op} [{name}]" if name != op else op
        for s in scopes:
            if f"/{s}/" in f"/{path}/":
                per_scope[s] += dur
                k = per_scope_kernel[s]
                k[key] = k.get(key, 0.0) + dur
        per_kernel[key] = per_kernel.get(key, 0.0) + dur
    if not spans:
        return {"events": 0}
    window = (max(s + d for s, d in spans) - min(s for s, _ in spans))
    busy = busy_ns(spans)

    def ranked(d):
        return {k: v / 1e6 for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]}

    return {
        "events": len(spans),
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "scope_ms": {s: v / 1e6 for s, v in per_scope.items()},
        "top_kernels_ms": ranked(per_kernel),
        "scope_top_kernels_ms": {s: ranked(k)
                                 for s, k in per_scope_kernel.items()},
    }
