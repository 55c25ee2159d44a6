#!/usr/bin/env python3
"""Run one benchmark cell and print the port's own split of it: where its
host time went by the program's spans, and what tracing costs.

    python3 portbench/split.py --workload <cell> --seed <n> --seconds <s> \
        --mode off|program|full

`off` runs the window as `run.py --trace 0` does; `program` the same with
the port's profile recording spans and counters (`profiler.enable()`, no
device trace), so that the end-to-end metrics of the two give the cost of
the program's spans; `full` as `run.py --trace 1`, adding the per-layer
metrics, `program_spans` ({name: [self s, total s, count]}), `counters`,
`idle_by_program_span` (the card's idle seconds by the calling thread's
innermost span) and the benchmark's own `breakdown`. Every mode prints the
end-to-end metrics, `off_ns_per_stage` and `on_ns_per_stage` (one
`profiler.stage` entered and left with no profile and with one, timed in
this process after the window). Prints one JSON line last; no `correct`
check is made. Exits non-zero without a card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from portbench.harness import bench, program  # noqa: E402


def ns_per_stage(on: bool, n: int = 100_000) -> float:
    """ns to enter and leave one `profiler.stage`, with a profile recording
    or with none."""
    from yaik_tpu_torch.utils import profiler
    stage = profiler.stage
    with profiler.enable() if on else contextlib.nullcontext():
        t = time.perf_counter_ns()
        for _ in range(n):
            with stage("x"):
                pass
        return (time.perf_counter_ns() - t) / n


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(prog="portbench/split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("off", "program", "full"),
                    required=True)
    a = ap.parse_args(argv)
    cell = bench.load_cell(a.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(bench.ROOT, "build", sub))
    import torch
    if not torch.cuda.is_available():
        print("portbench/split.py: no CUDA device", file=sys.stderr)
        return 2
    from yaik_tpu_torch.utils import profiler
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    on = profiler.enable() if a.mode == "program" else \
        contextlib.nullcontext()
    with on as prof:
        run, _, _, _ = bench.run_cell(cell, a.seed, a.seconds,
                                      a.mode == "full", "cuda", T_START,
                                      log=log)
    out = {"workload": a.workload, "seed": a.seed, "mode": a.mode,
           "end_to_end": {m["name"]: bench.load_reader(m["name"]).read(run)
                          for m in cell.end_to_end},
           "requests": len(run.calls), "items": run.items_done,
           "device": torch.cuda.get_device_name(0),
           "power": bench._power_limit()}
    if prof is not None:
        out["spans"] = len(prof.events)
    if a.mode == "full":
        out["per_layer"] = {k: v["value"] for k, v in
                            bench.read_metrics(run).items()}
        spans = program.program_spans(run)
        out["program_spans"] = spans
        out["spans"] = sum(v[2] for v in spans.values()) if spans else None
        p = program.profile(run)
        out["counters"] = p.counters if p is not None else None
        out["idle_by_program_span"] = program.idle_by_program_span(run)
        out["breakdown"] = bench.breakdown(run)
        lo, hi = run.window_ns
        out["window_s"] = (hi - lo) / 1e9
    # after the readers: a profile opened here is the last one they keep
    out["off_ns_per_stage"] = ns_per_stage(False)
    out["on_ns_per_stage"] = ns_per_stage(True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
