"""Tracing / profiling helpers.

The reference instruments with ad-hoc ``time.time()`` spans and MB/s prints
(/root/reference/ebcc_wrapper/delta_compression.py:385-387,
scripts/scan_cratio/scan_cratio_single_level.py:39-47).  The equivalents
here are (a) wall-clock spans that ``block_until_ready`` their device values
so async dispatch doesn't hide the cost, (b) optional ``jax.profiler`` trace
annotations that show up in TensorBoard/perfetto traces, and (c) the
reduction of a device trace to kernel time per ``jax.named_scope``
(:func:`device_time_by_scope`).
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import time

import jax

from . import logging as elog


class Timer:
    """Accumulating named wall-clock spans with throughput reporting."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, nbytes: int | None = None):
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.spans[name] = self.spans.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if nbytes is not None:
            elog.debug("%s: %.3fs (%.1f MB/s)", name, dt,
                       nbytes / dt / 1e6)

    def report(self) -> dict:
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in self.spans.items()}


@contextlib.contextmanager
def device_span(name: str, *values):
    """Span that waits for ``values`` (device arrays) before stopping the
    clock — the correct way to time jitted work (async dispatch otherwise
    returns immediately)."""
    with jax.profiler.TraceAnnotation(name):
        t0 = time.perf_counter()
        yield
        for v in values:
            jax.block_until_ready(v)
        elog.debug("%s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a jax.profiler trace of the enclosed block (TensorBoard/
    perfetto viewable) — the profiler-integration upgrade over the
    reference's prints."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# device-plane lines the profiler derives from the kernel lines (summaries
# that would count the same kernels twice)
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                  "TensorFlow Ops", "Framework Name Scope", "Source code")
_HLO_LINE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?\bop_name="([^"]*)"')


def innermost_scope(op_name: str, scopes) -> str | None:
    """The scope of ``scopes`` that occurs last in an op_name path."""
    best, pos = None, -1
    for sc in scopes:
        i = op_name.rfind(sc)
        if i > pos:
            best, pos = sc, i
    return best


def hlo_scopes(hlo_text: str, scopes) -> dict:
    """Instruction name -> innermost named scope, from a compiled
    program's HLO text (``compiled.as_text()``).  Each name is also keyed
    with '.' and '-' replaced by '_', the form GPU kernel names take."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if not m:
            continue
        sc = innermost_scope(m.group(2), scopes)
        if sc is not None:
            name = m.group(1)
            out[name] = sc
            out[re.sub(r"[.\-]", "_", name)] = sc
    return out


def _union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_time_by_scope(profile, name_to_scope: dict,
                         window: str | None = None) -> dict:
    """Reduce a ``jax.profiler.ProfileData`` to device time per scope.

    Kernel events are those on ``/device:`` planes (derived summary lines
    excluded).  An event belongs to the scope its name, or its ``hlo_op``
    / ``tf_op`` / ``long_name`` stat, maps to in ``name_to_scope``
    (:func:`hlo_scopes`).  With ``window`` (the name of a host
    ``TraceAnnotation``), only events inside that host span count and the
    busy share is taken over it; otherwise over the first-to-last kernel
    span.  Returns ns totals: ``kernel_ns`` (sum of kernel durations),
    ``busy_ns`` (their union), ``window_ns``, ``by_scope``,
    ``unattributed_ns``, and ``n_events``.
    """
    lo, hi = float("-inf"), float("inf")
    if window is not None:
        spans = [(e.start_ns, e.start_ns + e.duration_ns)
                 for pl in profile.planes if not pl.name.startswith("/device:")
                 for ln in pl.lines for e in ln.events if e.name == window]
        if not spans:
            raise ValueError(f"no host span named {window!r} in the trace")
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    by_scope, intervals = {}, []
    kernel_ns = unattributed = 0.0
    for pl in profile.planes:
        if not pl.name.startswith("/device:"):
            continue
        for ln in pl.lines:
            if ln.name.startswith(_DERIVED_LINES):
                continue
            for e in ln.events:
                a = max(e.start_ns, lo)
                b = min(e.start_ns + e.duration_ns, hi)
                if b <= a:
                    continue
                intervals.append((a, b))
                kernel_ns += b - a
                keys = [e.name] + [str(v) for k, v in e.stats
                                   if k in ("hlo_op", "tf_op", "long_name")]
                sc = next((name_to_scope[k] for k in keys
                           if k in name_to_scope), None)
                if sc is None:
                    unattributed += b - a
                else:
                    by_scope[sc] = by_scope.get(sc, 0.0) + (b - a)
    if window is None and intervals:
        lo = min(a for a, _ in intervals)
        hi = max(b for _, b in intervals)
    return {"kernel_ns": kernel_ns, "busy_ns": _union_ns(intervals),
            "window_ns": max(hi - lo, 0.0) if intervals else 0.0,
            "by_scope": by_scope, "unattributed_ns": unattributed,
            "n_events": len(intervals)}


def load_trace(logdir: str):
    """The newest ``.xplane.pb`` under a ``jax.profiler.trace`` logdir."""
    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return jax.profiler.ProfileData.from_file(max(paths,
                                                  key=os.path.getmtime))
