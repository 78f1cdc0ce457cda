"""Profiler trace of the traced window and what the readers take from it.

The traced run records host and device activity with ``torch.profiler``
over a bounded number of fits, writes the Chrome trace under ``TMPDIR``,
reads it back and deletes it. Device time is the union of the intervals of
kernels, copies and fills, so overlapping streams are counted once; idle
gaps are named by the harness's ``bench.*`` span and the innermost host
operator running at the gap's midpoint.
"""

import json
import re
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW_SPAN = "bench.window"
TOP = 10


@dataclass
class Trace:
    """Device operations (name, start s, end s) and host spans of a window."""

    window: Tuple[float, float]
    device_ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """Union of the device operations' intervals, clipped to the window."""
        return union_intervals(
            [(max(s, self.window[0]), min(e, self.window[1])) for _, s, e in self.device_ops]
        )

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_seconds(self, patterns) -> Optional[float]:
        """Device seconds, inside the window, of the operations whose name
        matches any of the regular expressions ``patterns``; None when none
        ran."""
        w0, w1 = self.window
        hits = [
            min(e, w1) - max(s, w0)
            for name, s, e in self.device_ops
            if any(re.search(p, name) for p in patterns) and e > w0 and s < w1
        ]
        return sum(hits) if hits else None

    def breakdown(self) -> Dict[str, List[List]]:
        """The ten device operations that took most time and the ten host
        activities under which the device idled longest."""
        by_op: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by_op[short_name(name)] = by_op.get(short_name(name), 0.0) + (e - s)
        gaps: Dict[str, float] = {}
        for (s, e), label in zip(self.gaps(), self._gap_labels()):
            gaps[label] = gaps.get(label, 0.0) + (e - s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which no device operation ran."""
        out, at = [], self.window[0]
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def _gap_labels(self) -> List[str]:
        mids = [(s + e) / 2 for s, e in self.gaps()]
        spans = innermost(self.spans, mids)
        ops = innermost(self.host_ops, mids)
        return [
            "/".join(x for x in (sp or "outside spans", op) if x) for sp, op in zip(spans, ops)
        ]


def union_intervals(intervals) -> List[Tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals (empty ones dropped)."""
    merged: List[List[float]] = []
    for s, e in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def innermost(intervals, times) -> List[Optional[str]]:
    """For each time, the name of the latest-starting interval covering it
    (intervals of one thread nest), or None."""
    ordered = sorted(intervals, key=lambda iv: iv[1])
    stack: List[Tuple[str, float, float]] = []
    i = 0
    result: List[Optional[str]] = [None] * len(times)
    for k in sorted(range(len(times)), key=lambda k: times[k]):
        t = times[k]
        while i < len(ordered) and ordered[i][1] <= t:
            stack.append(ordered[i])
            i += 1
        stack = [iv for iv in stack if iv[2] >= t]
        if stack:
            result[k] = max(stack, key=lambda iv: iv[1])[0]
    return result


def short_name(name: str) -> str:
    """A device operation's name without its trailing argument list, at most
    120 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    return name[:120]


@contextmanager
def profiled():
    """Profile host and device activity; yields a holder whose ``trace``
    is the parsed :class:`Trace` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    holder = SimpleNamespace(trace=None)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        with profile(activities=activities) as prof:
            yield holder
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as fh:
            holder.trace = parse_chrome_trace(json.load(fh))


def parse_chrome_trace(doc) -> Trace:
    """:class:`Trace` of a Chrome trace: times in seconds, the window the
    ``bench.window`` span's extent."""
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, spans, host = [], [], []
    window = None
    main_tid = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((ev["name"], s, e))
        elif cat == "user_annotation" and ev["name"].startswith("bench."):
            if ev["name"] == WINDOW_SPAN:
                window, main_tid = (s, e), ev.get("tid")
            else:
                spans.append((ev["name"], s, e, ev.get("tid")))
        elif cat == "cpu_op":
            host.append((ev["name"], s, e, ev.get("tid")))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    on_main = lambda xs: [(n, s, e) for n, s, e, tid in xs if tid == main_tid]
    return Trace(window=window, device_ops=device, spans=on_main(spans), host_ops=on_main(host))
