"""One run of one cell: set-up, warm-up, the measured window, the check,
the metrics, and the result line.

Everything that belongs to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration's file, its traffic file
(`portbench/traffic/<traffic>.json`, read by `harness.loop`), the driver
that file names (`portbench/drivers/<driver>.py`), and a reader per metric
(`portbench/metrics/<metric>.py`, a `read(run)` that returns a number or
None where it finds nothing to read). A per-layer metric names its cells in
its `workloads` list; an end-to-end metric without one is every cell's.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

from portbench.harness import check, host, loop, readers, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "yaik_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object           # the traffic's driver module
    end_to_end: list         # BENCHMARK.json entries reported with trace 0
    per_layer: list          # ... and with trace 1
    root: str = ROOT         # the checkout the cell's files are in


@dataclasses.dataclass
class Run:
    """What a run hands the metric readers."""
    cell: Cell
    seconds: float
    setup_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    item_pixels: list = dataclasses.field(default_factory=list)
    window_ns: tuple = (0, 0)
    spans: list = dataclasses.field(default_factory=list)
    stages: dict = dataclasses.field(default_factory=dict)
    device_events: list = dataclasses.field(default_factory=list)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    traced: bool = False
    host: dict = dataclasses.field(default_factory=dict)

    @property
    def kind(self) -> str:
        """`decode` or `encode`: what the cell's driver answers."""
        return self.cell.driver.KIND

    @property
    def items_done(self) -> int:
        return sum(len(c.items) for c in self.calls if c.ok)


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']!r} names no "
                             "workloads")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic,
                loop.load_driver(traffic["driver"], root), e2e, layer, root)


def load_reader(metric: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(cell: Cell) -> tuple:
    """(loop.Inputs, the committed streams) of a cell: its driver's own
    `inputs`, or the configuration's committed pool."""
    make = getattr(cell.driver, "inputs", None)
    return make(cell) if make else loop.pool_inputs(cell, cell.driver.KIND)


def per_call(cell: Cell, n: int) -> int:
    k = cell.traffic.get("per_call", 1)
    return n if k == "all" else int(k)


def check_sample(cell: Cell, n: int, seed: int) -> set:
    import numpy as np
    k = cell.traffic.get("check_sample", "all")
    if k == "all" or int(k) >= n:
        return set(range(n))
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    return {int(i) for i in rng.choice(n, int(k), replace=False)}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=None, entry=None) -> tuple:
    """Set up, warm up and measure one run. Returns (the Run, the kept
    answers by pool index, the inputs, the committed streams). `entry`,
    a function of (the program's entry function, the inputs) that returns
    another, replaces the entry point (the controls)."""
    import torch
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    run = Run(cell, seconds, traced=traced)
    t_begin = time.perf_counter()
    inputs, golden = make_inputs(cell)
    t_inputs = time.perf_counter()
    run.item_pixels = inputs.pixels
    fn = cell.driver.entry(inputs, dev, **cell.traffic.get("kwargs", {}))
    if entry is not None:
        fn = entry(fn, inputs)
    k = per_call(cell, inputs.n)
    keep = check_sample(cell, inputs.n, seed)
    # warm-up: every input once, through the same entry and shapes
    warm = loop.Order(inputs.n, seed)
    for _ in range(-(-inputs.n // k)):
        fn(warm.take(k))
    if on_card:
        torch.cuda.synchronize(dev)
    t_warm = time.perf_counter()
    log(f"set-up: {t_begin - t_start:.3f} s to the cell (interpreter, "
        f"import torch), inputs {t_inputs - t_begin:.3f} s, warm-up (CUDA "
        f"context, kernel libraries, every input once) "
        f"{t_warm - t_inputs:.3f} s")
    order = loop.Order(inputs.n, seed)
    if traced:
        trace.install_spans(run.spans)
        wanted = {n for m in cell.per_layer
                  for n in getattr(load_reader(m["name"], cell.root),
                                   "RECORDS", ())}
        trace.record_calls(sorted(wanted), run.kernel_calls)
        from yaik_tpu_torch.utils import profiler
        stage_ctx = profiler.enable()
    run.setup_s = time.perf_counter() - t_start
    h0 = host.snapshot()
    if traced:
        with trace.device_profile(run.device_events, on_card), \
                stage_ctx as prof:
            lo = time.time_ns()
            run.calls, kept, run.window_s = loop.run_window(
                fn, k, order, seconds, keep, log)
            hi = time.time_ns()
        run.window_ns = (lo, hi)
        run.stages = trace.stage_totals(prof)
    else:
        run.calls, kept, run.window_s = loop.run_window(
            fn, k, order, seconds, keep, log)
    run.host = host.delta(h0, host.snapshot())
    return run, kept, inputs, golden


def judge(run: Run, kept: dict, inputs, golden: list) -> tuple:
    """(correct, numbers shown) of a finished window."""
    if run.kind == "decode":
        numbers = check.decode_checks(kept, inputs.streams, inputs.lut)
    else:
        numbers = check.encode_checks(kept, golden)
    return check.verdict(numbers)


def read_metrics(run: Run) -> dict:
    specs = run.cell.per_layer if run.traced else run.cell.end_to_end
    out = {}
    for m in specs:
        reader = load_reader(m["name"], run.cell.root)
        v = reader.read(run)
        if hasattr(reader, "KERNEL"):  # each wrapper call is one launch
            calls = sum(len(run.kernel_calls.get(w, ()))
                        for w in reader.RECORDS)
            events = len(readers.kernels(run, reader.KERNEL))
            if calls != events:     # a lost event or another kernel's
                print(f"portbench: {m['name']}: {calls} wrapper calls but "
                      f"{events} {reader.KERNEL} events in the trace; "
                      "not reported", file=sys.stderr)
                v = None
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the idle time of
    the window summed by the host span it fell in."""
    lo, hi = run.window_ns
    ops: dict = {}
    for name, s, e, _ in run.device_events:
        key = name[:120]
        ops[key] = ops.get(key, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
    idle = trace.idle_by_label([(s, e) for _, s, e, _ in run.device_events],
                               run.spans, lo, hi)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    cell = load_cell(a.workload)
    # kernel caches at fixed paths inside the checkout (the port builds
    # its own libraries into build/yaik_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}. No result.")
        return 2
    run, kept, inputs, golden = run_cell(
        cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start, log=log)
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        log(f"portbench: the process loaded {found}; no result.")
        return 3
    memory_peak = max(torch.cuda.max_memory_allocated(d)
                      for d in range(cell.chips))
    attempted = sum(len(c.items) for c in run.calls)
    failed = attempted - run.items_done
    metrics = read_metrics(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(memory_peak),
              "power": _power_limit()}
    run.host["torch_threads"] = torch.get_num_threads()
    extra = {}
    if run.traced:
        lo, hi = run.window_ns
        busy = trace.union_ns([(s, e) for _, s, e, _ in run.device_events],
                              lo, hi)
        device.update(busy_s=busy / 1e9, window_s=(hi - lo) / 1e9)
        extra["breakdown"] = breakdown(run)
    # the program's state goes before the reference runs
    inputs.lut_bank = inputs.bank3d = None
    torch.cuda.empty_cache()
    correct, shown = judge(run, kept, inputs, golden)
    correct = correct and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device, **extra,
              "host": run.host, "checks": shown}
    for k, v in shown.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0
