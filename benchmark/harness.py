"""One run of one cell: set-up, the measured window, the traced window, and
the check that decides ``correct``.

Everything that belongs to one configuration, traffic mix, entry, metric or
cell's limits is a file of its own, found by name:

* ``BENCHMARK.json`` (repository root): cells, metrics, ``run_seconds``;
* ``benchmark/configs/<config>.json``: the system, featurizer and fit
  settings (the path named by the configuration's ``file``);
* ``benchmark/traffic/<traffic>.json``: the entry, pool and window sizes,
  the check and how many fits it samples;
* ``benchmark/entries/<entry>.py``: the call into the program;
* ``benchmark/checks/<check>.py``: ``judge``, the numbers the check compares
  for one fit, and ``work``, the fit's Gram flops;
* ``benchmark/metrics/<metric>.py``: ``read(run)``, the metric's value or
  None where the run has nothing to read;
* ``benchmark/limits/<cell>.json``: the limit of each number the check
  compares.

A run is a closed loop: fits run back to back on contiguous windows of a
trajectory pool made on the device from the seed, each with its own
constraint-frame generator; a fit that starts inside the window runs to its
end and counts.

A cell on several chips runs this on every rank (``benchmark/ranks.py``),
each with its own pool from the seed, the same offsets and streams, and a
``Link`` to the others: rank 0 decides when the window ends, and a fit's
time on rank 0 ends once every rank's fit has returned.
"""

import gc
import hashlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import systems

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "aggforce_tpu")

# spawn keys of the per-run random streams (numpy SeedSequence)
_OFFSETS, _FIT, _SAMPLE, _SITES, _WARM = range(5)


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_check(name: str):
    """The check ``benchmark/checks/<name>.py``; a missing file is refused
    at once, by its path."""
    path = BENCH_DIR / "checks" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"check {name!r}: no file {path.relative_to(ROOT)}")
    return load_module(path)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by its names;
    ``check``, the module ``traffic["check"]`` names, is loaded as the cell
    is made."""

    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    metrics: List[Dict]  # the metric entries of BENCHMARK.json this run reports
    chips: int
    check: Any = field(init=False, repr=False)

    def __post_init__(self):
        self.check = load_check(self.traffic["check"])


def load_cell(name: str, trace: bool) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with the metrics a run with
    or without ``trace`` reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if name in m.get("workloads", [name])]
    return Cell(name, config, traffic, limits, metrics, int(w["chips"]))


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    shapes: Dict[str, int]
    frames_per_fit: int
    fit_seconds: List[float] = field(default_factory=list)
    escalated: List[int] = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    trace: Optional[object] = None  # tracing.Trace of the traced window


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stream(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(int(seed), spawn_key=key))


def _entry(traffic: Dict):
    return load_module(BENCH_DIR / "entries" / f"{traffic['entry']}.py")


class Reservoir:
    """A uniform sample of ``k`` fits of the window, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, _stream(seed, _SAMPLE), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Session:
    """A cell's system, pool and entry for one seed, and its fits in order:
    fit ``i`` takes the window at the ``i``-th offset drawn from the seed
    and the constraint-frame generator of ``(seed, i)``.

    With ``link`` (a rank of a cell on several chips) every rank's pool
    must have rank 0's checksum, and the entry's ``prepare`` also gets the
    rank, the world size and the init URL of the program's process group.
    Without ``program`` no entry is prepared (the control alone)."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, link=None, program: bool = True):
        self.cell, self.seed, self.device = cell, seed, device
        self.system = systems.build_system(cell.config)
        self.shapes = systems.shapes(self.system, cell.config)
        self.t_fit = int(cell.traffic["frames_per_fit"])
        self.pool = systems.make_pool(
            self.system, int(cell.traffic["pool_frames"]), seed, device
        )
        self.entry = self.state = None
        if link is not None:
            link.agree("pool", pool_checksum(self.pool))
        if program:
            self.entry = _entry(cell.traffic)
            ranks = () if link is None else (link.rank, link.world, link.init_url)
            self.state = self.entry.prepare(self.system, cell.config, device, *ranks)
        self.offsets = _stream(seed, _OFFSETS)
        self.n_off = int(cell.traffic["pool_frames"]) - self.t_fit + 1

    def warm(self) -> None:
        """One fit on the first ``warm_frames`` frames of the pool."""
        n = int(self.cell.traffic.get("warm_frames", self.t_fit))
        self.entry.fit(self.state, self.pool[0][:n], self.pool[1][:n], _stream(self.seed, _WARM))
        _sync(self.device)

    def fit(self, i: int) -> Dict:
        """Fit ``i``, waited for: the entry's outputs with ``i``, ``offset``."""
        off = int(self.offsets.integers(0, self.n_off))
        c, f = self.pool
        out = self.entry.fit(
            self.state, c[off : off + self.t_fit], f[off : off + self.t_fit],
            _stream(self.seed, _FIT, i),
        )
        _sync(self.device)
        return {"i": i, "offset": off, **out}

    def release(self) -> None:
        """Drop the program's state and cached device memory (the pool stays)."""
        self.entry = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device: torch.device,
    log: Callable[[str], None],
    link=None,
) -> Optional[Dict]:
    """One run; returns the result (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and last ``checks``).

    With ``link`` this is one rank of a cell on several chips: only rank 0
    traces, reads the metrics and returns the result; every rank judges its
    share of the checked sites after the window, and the others post their
    readings and return None. A failed fit there ends the run, since the
    other ranks would wait for it in a collective."""
    from . import tracing

    lead = link is None or link.rank == 0
    ses = Session(cell, seed, device, link)
    ses.warm()
    # what set-up made is never garbage: keep the collector from rescanning it
    gc.collect()
    gc.freeze()
    if link is not None:
        link.barrier("ready")
    run = Run(cell=cell, shapes=ses.shapes, frames_per_fit=ses.t_fit)
    sample = Reservoir(int(cell.traffic["check_fits"]), seed)
    failed = 0
    max_fits = int(cell.traffic["traced_fits"]) if trace else None

    def one_fit(i: int) -> None:
        nonlocal failed
        start = time.perf_counter()
        try:
            item = ses.fit(i)
        except (RuntimeError, ValueError) as err:
            if link is not None:
                raise
            failed += 1
            log(f"fit {i} failed: {err!r}")
            return
        if link is not None:
            link.fit_done(i)
        run.fit_seconds.append(time.perf_counter() - start)
        run.escalated.append(int(item["escalated_sites"]))
        sample.offer(item)

    def more(i: int, t0: float) -> bool:
        go = time.perf_counter() - t0 < seconds and (max_fits is None or i < max_fits)
        return go if link is None else link.go(i, go)

    def window() -> int:
        i = 0
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            run.setup_s = process_age()
            t0 = time.perf_counter()
            while more(i, t0):
                one_fit(i)
                i += 1
            _sync(device)
            run.window_s = time.perf_counter() - t0
        return i

    routes0 = _routes()
    if trace and lead:
        with tracing.profiled() as holder:
            attempted = window()
        run.trace = holder.trace
    else:
        attempted = window()
    log(f"window: {attempted} fits, {run.window_s:.6f} s, set-up {run.setup_s:.6f} s")
    if run.fit_seconds:
        q = np.percentile(run.fit_seconds, [0, 10, 50, 90, 95, 99, 100]) * 1e3
        log("fit ms min/p10/p50/p90/p95/p99/max: " + " ".join(f"{v:.3f}" for v in q))
        slow = sorted(range(len(run.fit_seconds)), key=lambda k: -run.fit_seconds[k])[:5]
        log(
            f"escalated sites in the window: {sum(run.escalated)} "
            f"({sum(1 for e in run.escalated if e)} fits); slowest fits "
            + ", ".join(f"{run.fit_seconds[k] * 1e3:.1f} ms (esc {run.escalated[k]})" for k in slow)
        )
    routes = {k: v - routes0.get(k, 0) for k, v in _routes().items()}
    if routes:
        log(f"linear-fit routes in the window: {json.dumps(routes, sort_keys=True)}")

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    for m in cell.metrics if lead else ():
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    digest = None if link is None else outputs_digest(sample.items)
    ses.release()
    t_check = time.perf_counter()
    share = None if link is None else (link.rank, link.world)
    checks = check_outputs(ses, sample.items, "program", share=share)
    log(f"check: {len(sample.items)} fits in {time.perf_counter() - t_check:.3f} s")
    if link is not None:
        mine = {"peak": int(peak), "digest": digest, "checks": {k: c["value"] for k, c in checks.items()}}
        if not lead:
            link.post(mine)
            return None
        peak, checks = _merge_ranks(cell, mine, link.collect(), log)
    correct = (
        attempted > 0
        and failed == 0
        and bool(checks)
        and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    )
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1 if link is None else link.world,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if trace:
        dev_info["busy_s"] = run.trace.busy_s()
        dev_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def pool_checksum(pool) -> str:
    """Float64 sums of a pool's coordinates and forces, as text."""
    return repr([float(x.sum(dtype=torch.float64)) for x in pool])


def outputs_digest(items: List[Dict]) -> str:
    """A digest of the bytes of the sampled fits' coefficients and mapped
    forces, to compare one rank's outputs with another's exactly."""
    h = hashlib.sha256()
    for item in items:
        h.update(np.ascontiguousarray(np.stack([np.asarray(c) for c in item["coefs"]])).tobytes())
        h.update(item["mapped"].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _merge_ranks(cell: Cell, mine: Dict, others: Dict[int, Dict], log) -> tuple:
    """Rank 0's peak memory and checks from every rank's readings: the
    largest peak, each number's largest reading over the ranks' shares of
    the sites, and ``ranks_disagree``, the ranks whose sampled outputs are
    not byte for byte rank 0's."""
    every = {0: mine, **others}
    log("memory peak by rank: " + ", ".join(f"{r}: {o['peak']}" for r, o in sorted(every.items())))
    worst: Dict[str, float] = {}
    for o in every.values():
        for name, value in o["checks"].items():
            worst[name] = max(worst.get(name, -np.inf), float(value))
    worst["ranks_disagree"] = float(sum(o["digest"] != mine["digest"] for o in others.values()))
    checks = {name: {"value": v, "limit": cell.limits.get(name)} for name, v in worst.items()}
    return max(o["peak"] for o in every.values()), checks


def calibration_readings(
    cell: Cell, seed: int, fits: int, device: torch.device, program: bool, control: bool,
) -> Dict[str, Dict[str, float]]:
    """The check's numbers, largest over ``fits`` fits, of the program's
    outputs and of the control in the program's place."""
    ses = Session(cell, seed, device, program=program)
    out = {}
    if program:
        ses.warm()
        items = [ses.fit(i) for i in range(fits)]
        out["program"] = {k: c["value"] for k, c in check_outputs(ses, items, "program").items()}
    else:
        items = [{"i": i, "offset": int(ses.offsets.integers(0, ses.n_off))} for i in range(fits)]
    if control:
        out["control"] = {
            k: c["value"] for k, c in check_outputs(ses, items, "reference", "tf32").items()
        }
    return out


def _routes() -> Dict[str, int]:
    """The program's counter of linear-fit routes, as this process left it."""
    import sys

    mod = sys.modules.get("aggforce_torch.qp.qplinear")
    return dict(mod.fit_routes) if mod is not None else {}


def fit_inputs(ses: Session, item: Dict, share=None):
    """The frames, constraint frames and checked sites of a sampled fit,
    worked out again from the seed; with ``share`` = (rank, world) only
    every world-th of the checked sites, from the rank-th on."""
    cfg, traffic = ses.cell.config, ses.cell.traffic
    off, t_fit = item["offset"], ses.t_fit
    coords, forces = ses.pool[0][off : off + t_fit], ses.pool[1][off : off + t_fit]
    n_cf = min(int(cfg.get("n_constraint_frames", 0)), t_fit)
    frames = _stream(ses.seed, _FIT, item["i"]).choice(t_fit, size=n_cf, replace=False)
    n_sites = len(ses.system.sites)
    k = int(traffic.get("check_sites", 0))
    sites = (
        sorted(_stream(ses.seed, _SITES, item["i"]).choice(n_sites, size=k, replace=False).tolist())
        if 0 < k < n_sites
        else list(range(n_sites))
    )
    if share is not None:
        sites = sites[share[0] :: share[1]]
    return coords, forces, frames, sites


def check_outputs(
    ses: Session, items: List[Dict], judged: str, precision: str = "float64", share=None
) -> Dict[str, Dict]:
    """Each number compared, the largest over the fits ``items`` (and over
    this rank's ``share`` of the checked sites), beside its limit: of the
    program's outputs (``judged="program"``), or of the reference solved and
    applied in ``precision`` in the program's place (``judged="reference"``;
    the control with ``"tf32"``), as the cell's check judges them."""
    worst: Dict[str, float] = {}
    for item in items:
        for name, value in ses.cell.check.judge(ses, item, judged, precision, share).items():
            worst[name] = max(worst.get(name, -np.inf), value)
    return {
        name: {"value": value, "limit": ses.cell.limits.get(name)} for name, value in worst.items()
    }


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    import sys

    return sorted(
        {m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN_MODULES}
    )
