"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one cell is found by name:
``configs/<config>.json`` (the deployment), ``workloads/<cell>.json`` (the
traffic mix and the limits of its check), ``drivers/<driver>.py`` (the
entry point the traffic drives, named by the workload file) and
``metrics/<metric>.py`` (one reader per metric in ``BENCHMARK.json``).

A run: set-up (import torch, bring up the devices, the driver's set-up
and one warm-up call of the cell's shapes), a window of ``seconds``, then
the check of what the window produced against the plain reference.  With
``trace`` the window runs under the per-layer metrics' hooks (timers that
synchronise the devices, call counters, the program's own counters), then
one more call runs under the profiler for the device's busy time and the
kernels' times.
"""

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names a run may not load: JAX, and the JAX package
#: with the scripts that drive it (compared whole: the port's own name
#: begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "outfit_tpu", "bench", "chip_smoke")


class NoDevice(RuntimeError):
    """The cell needs CUDA devices this machine does not have."""


@dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    trace: bool
    bench: dict
    workload: dict  # the BENCHMARK.json entry
    config: dict  # configs/<config>.json
    traffic: dict  # workloads/<cell>.json
    devices: list
    records: list = field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0
    spans: dict = field(default_factory=dict)  # name -> [seconds]
    counts: dict = field(default_factory=dict)  # name -> calls or counter delta
    calls: dict = field(default_factory=dict)  # name -> [(args, kwargs)] of the profiled call
    profile: dict = field(default_factory=dict)
    state: object = None

    @property
    def window_s(self):
        """From the window's start to the return of the last call started in it."""
        return self.t_end - self.t_start

    def sync(self):
        import torch

        for d in self.devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)


def load_json(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as fh:
        return json.load(fh)


def load_benchmark():
    return load_json(ROOT, "BENCHMARK.json")


def module(kind, name):
    """``<kind>/<name>.py`` of the benchmark's folder (a metric's name may
    hold dots), loaded once."""
    key = f"portbench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(HERE, kind, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def metric_names(bench, cell, section):
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without a ``workloads`` list, and those that
    list it."""
    return [m["name"] for m in bench[section] if cell in m.get("workloads", [cell])]


def resolve(bench, cell):
    """(workload entry, config file, traffic file, driver module) of ``cell``."""
    (wl,) = [w for w in bench["workloads"] if w["name"] == cell]
    (cfg,) = [c for c in bench["configs"] if c["name"] == wl["config"]]
    traffic = load_json(HERE, "workloads", f"{cell}.json")
    return wl, load_json(ROOT, cfg["file"]), traffic, module("drivers", traffic["driver"])


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cuda_devices(chips):
    """The first ``chips`` CUDA devices; raises :class:`NoDevice`."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")
    return [f"cuda:{i}" for i in range(chips)]


# -- hooks ------------------------------------------------------------------


def _owner(path):
    mod, _, attr = path.partition(":")
    owner = importlib.import_module(mod)
    names = attr.split(".")
    for n in names[:-1]:
        owner = getattr(owner, n)
    return owner, names[-1]


def _patch(owner, name, make):
    raw = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
    if isinstance(raw, (classmethod, staticmethod)):
        new = type(raw)(make(raw.__func__))
    else:
        new = make(raw)
    setattr(owner, name, new)
    return owner, name, raw


class Hooks:
    """The hooks the cell's per-layer metrics declare (``HOOKS`` in each
    metric's file): ``("span", "module:attr")`` times each call, the
    devices synchronised before and after, into ``run.spans``;
    ``("mark", "module:attr")`` records each call's wall-clock interval
    without synchronising, to label the profiled call's idle gaps;
    ``("count", "module:attr")`` counts calls into ``run.counts``;
    ``("counter", "module:attr")`` reads a counter of the program (an int,
    or a dict of ints summed) before and after; ``("args", "module:attr")``
    keeps each call's arguments in ``run.calls`` (profiled call only)."""

    def __init__(self, run, specs):
        self.run, self.specs, self.saved, self.before = run, specs, [], {}
        self.marks = []

    def __enter__(self):
        for kind, path in self.specs:
            owner, name = _owner(path)
            if kind == "counter":
                self.before[path] = _counter_value(getattr(owner, name))
                continue
            self.saved.append(_patch(owner, name, lambda fn, kind=kind, path=path: self._wrap(fn, kind, path)))
        return self

    def _wrap(self, fn, kind, path):
        run = self.run

        def wrapper(*a, **k):
            if kind == "count":
                run.counts[path] = run.counts.get(path, 0) + 1
                return fn(*a, **k)
            if kind == "args":
                run.calls.setdefault(path, []).append((a, k))
                return fn(*a, **k)
            if kind == "mark":
                t = time.time_ns()
                try:
                    return fn(*a, **k)
                finally:
                    self.marks.append((path, t, time.time_ns()))
            run.sync()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                run.sync()
                run.spans.setdefault(path, []).append(time.perf_counter() - t)

        return wrapper

    def __exit__(self, *exc):
        for owner, name, raw in reversed(self.saved):
            setattr(owner, name, raw)
        for path, v0 in self.before.items():
            owner, name = _owner(path)
            self.run.counts[path] = _counter_value(getattr(owner, name)) - v0


def _counter_value(v):
    return sum(v.values()) if isinstance(v, dict) else int(v)


def metric_hooks(names):
    specs = []
    for n in names:
        for spec in getattr(module("metrics", n), "HOOKS", ()):
            if tuple(spec) not in specs:
                specs.append(tuple(spec))
    return specs


# -- the profiled call --------------------------------------------------------


def profiled_call(run, driver, specs):
    """One more call under torch.profiler (device activity only: the host
    events of 10^5 launches would take longer to reduce than the call).
    Fills ``run.profile``: busy seconds (mean over the devices used), the
    call's wall, device time by operation, and idle gaps labelled by the
    hooked function the host was in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marks = [("mark", path) for kind, path in specs if kind in ("span", "mark")]
    args = [(k, p) for k, p in specs if k == "args"]
    on_card = any(torch.device(d).type == "cuda" for d in run.devices)
    run.sync()
    with Hooks(run, marks + args) as hooks:
        with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            t_ns = time.time_ns()
            driver.call(run, len(run.records))
            run.sync()
            wall = time.perf_counter() - t
            t1_ns = time.time_ns()
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    by_dev, by_op = {}, {}
    for e in events:
        by_dev.setdefault(e.device_index(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
        by_op[e.name()] = by_op.get(e.name(), 0.0) + e.duration_ns() / 1e9
    busy, gaps = [], {}
    for dev, iv in by_dev.items():
        iv.sort()
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy.append(sum(e - s for s, e in merged) / 1e9)
        edges = [(t_ns, t_ns)] + [tuple(m) for m in merged] + [(t1_ns, t1_ns)]
        for (_, e0), (s1, _) in zip(edges[:-1], edges[1:]):
            if s1 > e0:
                label = _host_label(hooks.marks, (e0 + s1) // 2)
                gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e9
    n_dev = max(1, len(run.devices))
    run.profile = dict(
        busy_s=sum(busy) / n_dev, window_s=wall, ops=by_op,
        device_ops=sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(([k, v / n_dev] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
    )


def _host_label(marks, t):
    """The innermost hooked call running at wall-clock ``t`` (ns)."""
    inner = None
    for path, s, e in marks:
        if s <= t <= e and (inner is None or e - s < inner[2] - inner[1]):
            inner = (path, s, e)
    return inner[0].split(":")[-1] if inner else "host, outside the hooked calls"


# -- one run ------------------------------------------------------------------


def run_cell(cell, seed, seconds, trace, devices=None, process_start=None, traffic_overrides=None, log=None):
    """Run ``cell`` once; returns the result dict (the last line's object)
    and the list of compared numbers.  ``devices`` None: the cell's chips
    as CUDA devices (:class:`NoDevice` without them).  The tests pass
    ``devices=["cpu"]`` and ``traffic_overrides`` to drive a small run on
    the CPU."""
    t_proc = process_start if process_start is not None else time.perf_counter()
    bench = load_benchmark()
    wl, config, traffic, driver = resolve(bench, cell)
    traffic = dict(traffic, **(traffic_overrides or {}))
    import torch

    torch.set_num_threads(4)
    if devices is None:
        devices = cuda_devices(wl["chips"])
    run = Run(cell, seed, seconds, trace, bench, wl, config, traffic, devices)
    e2e = metric_names(bench, cell, "end_to_end")
    layer = metric_names(bench, cell, "per_layer")
    marks = [("import torch", time.perf_counter())]
    for d in devices:
        torch.empty(1, device=d)
    marks.append(("devices", time.perf_counter()))
    run.state = driver.setup(run)
    marks.append(("driver set-up", time.perf_counter()))
    driver.call(run, -1)  # warm-up: every shape the window uses
    run.sync()
    marks.append(("warm-up call", time.perf_counter()))
    setup_s = marks[-1][1] - t_proc
    if log is not None:
        starts = [t_proc] + [m for _, m in marks[:-1]]
        log("set-up: " + ", ".join(f"{name} {m - a:.3f} s" for (name, m), a in zip(marks, starts)))
    specs = metric_hooks(layer) if trace else []
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    with Hooks(run, [s for s in specs if s[0] in ("span", "count", "counter")]):
        run.t_start = time.perf_counter()
        run.records = driver.window(run, run.t_start + seconds)
        run.t_end = run.records[-1]["t1"]
    if log is not None:
        walls = [r["t1"] - r["t0"] for r in run.records]
        log(f"window: {len(walls)} calls in {run.window_s:.3f} s, call walls {' '.join(f'{w:.3f}' for w in walls)}")
    if trace:
        profiled_call(run, driver, specs)
    peak = max([torch.cuda.max_memory_allocated(d) for d in devices if torch.device(d).type == "cuda"] or [0])
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that a run may not load: {found}")
    attempted, failed = driver.tally(run)
    numbers = driver.check(run)
    correct = all(n["ok"] for n in numbers)
    metrics = {}
    for name in layer if trace else e2e:
        value = setup_s if name == "setup_s" else module("metrics", name).read(run)
        if value is not None:
            unit = next(m["unit"] for m in bench["end_to_end"] + bench["per_layer"] if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}
    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
        "count": len(devices),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"], "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in numbers}
    return result, numbers

