"""The program layer behind each device operation, host sync and idle gap
of a traced window.

The program marks its layers with ``aggforce.*`` spans
(``aggforce_torch.utils.prof.span``: ``torch.profiler.record_function``
under a profiler), so in the Chrome trace that ``tracing.profiled`` writes
they share one clock with the kernels, copies and CUDA calls.
:func:`parse_layer_trace` reads that trace into a :class:`LayerTrace`: the
fields of ``tracing.parse_chrome_trace``, read by that function unchanged,
and besides

* ``program_spans``: the ``aggforce.*`` spans of the window's thread, as
  (name, start, end);
* ``device_corr`` and ``device_kernel``: each device operation's
  correlation id and whether it is a kernel, parallel to ``device_ops``;
* ``runtime_calls``: the window thread's CUDA runtime and driver calls
  (name, start, end, correlation id): launches, copies, fills and syncs.

A device operation belongs to the innermost program span that covered the
host call that launched it, found by correlation id; one launched outside
every span (the harness's own work) belongs to :data:`OUTSIDE`. So each
layer's numbers are self time: what a child span issued is the child's.

The six layer metrics (``benchmark/metrics/<name>.py``, their entries in
``layer_metrics.json``) read this attribution. One traced run of a cell
with them:

    python3 benchmark/layers.py --workload <cell> --seed <n> [--fits <k>]

runs ``benchmark/run.py --trace 1`` (``--seconds`` the benchmark's
``run_seconds``) in this process with :func:`parse_layer_trace` in place
of the plain parse, ``--fits`` fits in the traced window if given, and the
metrics of ``layer_metrics.json`` that list the cell. It prints run.py's
result line (idle gaps named ``bench.<call>/aggforce.<layer>/<operator>``)
and, on standard error, each layer's device seconds beside the window's
busy time and the three slowest traced calls' time by layer.
"""

import json
import sys
from dataclasses import dataclass, field, fields
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import tracing  # noqa: E402
from benchmark.tracing import DEVICE_CATS, WINDOW_SPAN, innermost, union_intervals  # noqa: E402

PROGRAM_PREFIX = "aggforce."
OUTSIDE = "outside"
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
# host calls that wait for the card
SYNC_CALLS = {
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
}
METRICS_FILE = Path(__file__).resolve().parent / "layer_metrics.json"
# the plain parse, kept apart from ``tracing.parse_chrome_trace``, which
# :func:`main` replaces
plain_parse = tracing.parse_chrome_trace


@dataclass
class LayerTrace(tracing.Trace):
    """A :class:`tracing.Trace` with the program's spans and the links from
    device operations to the host calls that launched them."""

    program_spans: List[Tuple[str, float, float]] = field(default_factory=list)
    device_corr: List[Optional[int]] = field(default_factory=list)
    device_kernel: List[bool] = field(default_factory=list)
    runtime_calls: List[Tuple[str, float, float, Optional[int]]] = field(default_factory=list)

    def layer_names(self) -> List[str]:
        """The program layers with a span in the window."""
        w0, w1 = self.window
        return sorted({n for n, s, e in self.program_spans if e > w0 and s < w1})

    @cached_property
    def device_layers(self) -> List[str]:
        """Each device operation's layer, parallel to ``device_ops``."""
        launched = {c: s for _, s, _, c in self.runtime_calls if c is not None}
        times = [launched.get(c) for c in self.device_corr]
        found = [k for k, t in enumerate(times) if t is not None]
        out = [OUTSIDE] * len(self.device_ops)
        for k, name in zip(found, innermost(self.program_spans, [times[k] for k in found])):
            out[k] = name or OUTSIDE
        return out

    def _layer_ops(self, layer: str):
        """(index, start, end) of the layer's device operations inside the window."""
        w0, w1 = self.window
        return [
            (k, s, e)
            for k, ((_, s, e), lay) in enumerate(zip(self.device_ops, self.device_layers))
            if lay == layer and e > w0 and s < w1
        ]

    def layer_device_seconds(self, layer: str) -> float:
        """Union of the layer's device operations, clipped to the window."""
        w0, w1 = self.window
        ops = [(max(s, w0), min(e, w1)) for _, s, e in self._layer_ops(layer)]
        return sum(e - s for s, e in union_intervals(ops))

    def layer_launches(self, layer: str) -> int:
        """The layer's kernels in the window."""
        return sum(1 for k, _, _ in self._layer_ops(layer) if self.device_kernel[k])

    def layer_syncs(self, layer: str) -> int:
        """Host calls that wait for the card, started in the window inside the layer."""
        w0, w1 = self.window
        starts = [s for name, s, _, _ in self.runtime_calls if name in SYNC_CALLS and w0 <= s < w1]
        return sum(1 for n in innermost(self.program_spans, starts) if (n or OUTSIDE) == layer)

    def layer_host_intervals(self, layer: str) -> List[Tuple[float, float]]:
        """Host time in the window whose innermost program span is ``layer``
        (:data:`OUTSIDE`: no span), as sorted disjoint intervals."""
        w0, w1 = self.window
        cuts = sorted(
            {w0, w1} | {t for _, s, e in self.program_spans for t in (s, e) if w0 < t < w1}
        )
        pieces = list(zip(cuts, cuts[1:]))
        names = innermost(self.program_spans, [(s + e) / 2 for s, e in pieces])
        return union_intervals([p for p, n in zip(pieces, names) if (n or OUTSIDE) == layer])

    def layer_idle_seconds(self, layer: str) -> float:
        """Device-idle time of the window while the host was inside the layer."""
        return overlap_seconds(self.gaps(), self.layer_host_intervals(layer))

    def _gap_labels(self) -> List[str]:
        mids = [(s + e) / 2 for s, e in self.gaps()]
        spans = innermost(self.spans, mids)
        layers = innermost(self.program_spans, mids)
        ops = innermost(self.host_ops, mids)
        return [
            "/".join(x for x in (sp or "outside spans", lay, op) if x)
            for sp, lay, op in zip(spans, layers, ops)
        ]

    def coverage(self) -> Dict[str, float]:
        """Device seconds of each layer and of :data:`OUTSIDE`, with the
        window's ``busy_s``: the layers add up to it unless two layers'
        operations overlapped in time."""
        out = {lay: self.layer_device_seconds(lay) for lay in self.layer_names() + [OUTSIDE]}
        out["busy_s"] = self.busy_s()
        return out

    def slowest_calls(self, k: int = 3) -> List[Dict]:
        """The ``k`` longest ``bench.*`` call spans of the window, each with
        its seconds, the host time it spent in each layer, its three longest
        idle gaps and the CUDA calls the host made during the longest."""
        w0, w1 = self.window
        calls = sorted(
            (sp for sp in self.spans if sp[1] >= w0 and sp[2] <= w1),
            key=lambda sp: sp[1] - sp[2],
        )[:k]
        gaps = list(zip(self.gaps(), self._gap_labels()))
        host = {lay: self.layer_host_intervals(lay) for lay in self.layer_names() + [OUTSIDE]}
        out = []
        for name, s, e in calls:
            inside = sorted(
                ((min(ge, e) - max(gs, s), lab, gs, ge) for (gs, ge), lab in gaps if ge > s and gs < e),
                reverse=True,
            )
            in_gap = sorted(
                (min(ce, inside[0][3]) - max(cs, inside[0][2]), cname)
                for cname, cs, ce, _ in self.runtime_calls
                if inside and ce > inside[0][2] and cs < inside[0][3]
            )
            out.append({
                "span": name, "seconds": e - s,
                "host_s_by_layer": {lay: overlap_seconds(iv, [(s, e)]) for lay, iv in host.items()},
                "longest_idle_gaps": [(d, lab) for d, lab, _, _ in inside[:3]],
                "cuda_calls_in_longest_gap": in_gap[::-1][:3],
            })
        return out


def overlap_seconds(a, b) -> float:
    """Total overlap of two sorted lists of disjoint (start, end) intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def parse_layer_trace(doc) -> LayerTrace:
    """:class:`LayerTrace` of a Chrome trace (see the module's text)."""
    base = plain_parse(doc)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    main_tid = next(
        ev.get("tid") for ev in events
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and ev["name"] == WINDOW_SPAN
    )
    program, corr, kernel, runtime = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            corr.append(args.get("correlation"))
            kernel.append(cat == "kernel")
            continue
        if ev.get("tid") != main_tid:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and ev["name"].startswith(PROGRAM_PREFIX):
            program.append((ev["name"], s, e))
        elif cat in RUNTIME_CATS:
            runtime.append((ev["name"], s, e, args.get("correlation")))
    return LayerTrace(
        **{f.name: getattr(base, f.name) for f in fields(tracing.Trace)},
        program_spans=program, device_corr=corr, device_kernel=kernel, runtime_calls=runtime,
    )


def per_fit(run, layer: str, reading: str, scale: float = 1.0) -> Optional[float]:
    """``scale`` x the :class:`LayerTrace` method ``reading`` of ``layer``
    over the traced fits; None without a layer trace, a device operation
    (the CPU) or a span of the layer in the window."""
    trace = run.trace
    if (
        not isinstance(trace, LayerTrace)
        or not trace.device_ops
        or not run.fit_seconds
        or layer not in trace.layer_names()
    ):
        return None
    return scale * getattr(trace, reading)(layer) / len(run.fit_seconds)


def main(argv=None) -> int:
    import argparse

    from benchmark import harness, run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--fits", type=int, default=None, help="fits in the traced window")
    args = parser.parse_args(argv)
    entries = harness.load_json(METRICS_FILE)
    seen = {}

    def parse(doc):
        seen["trace"] = parse_layer_trace(doc)
        return seen["trace"]

    def load_cell(name, trace):
        cell = base_load_cell(name, trace)
        cell.metrics += [m for m in entries if name in m["workloads"]]
        if args.fits is not None:
            cell.traffic["traced_fits"] = args.fits
        return cell

    base_load_cell = harness.load_cell
    tracing.parse_chrome_trace, harness.load_cell = parse, load_cell
    seconds = harness.load_json(harness.ROOT / "BENCHMARK.json")["run_seconds"]
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(seconds), "--trace", "1"])
    finally:
        tracing.parse_chrome_trace, harness.load_cell = plain_parse, base_load_cell
    if "trace" in seen:
        trace = seen["trace"]
        print("layers: " + json.dumps(trace.coverage()), file=sys.stderr)
        for call in trace.slowest_calls():
            print("slow call: " + json.dumps(call), file=sys.stderr)
    return rc


if __name__ == "__main__":
    # the metrics import this module as benchmark.layers: run that copy
    from benchmark import layers

    sys.exit(layers.main())
