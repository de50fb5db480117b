"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

The cell is ``benchmark/workloads/<cell>.json``: its configuration
(``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``), the program's entry it drives
(``entries.py``), the control and the limits of its check. Set-up builds the
program's object with seeded weights, makes the inputs and warms every shape
(``setup_s`` runs from the start of this process to the window's start);
the window runs the entry for ``--seconds``; the program is then freed, and
what the timed path produced is compared with the plain reference
(``reference/``). ``--trace 0`` reports the cell's end-to-end metrics of
``BENCHMARK.json``; ``--trace 1`` runs the window under torch.profiler and
reports its per-layer metrics, each read by ``metrics/<name>.py`` (the part
of the name before the first dot). ``--control 1`` also runs the control
(the reference one precision below the configuration's) through the same
comparison and prints its numbers; the benchmark's own runs do not.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the result's
last key. Exits non-zero without a result when there is no card, when a
module of JAX or of the JAX package is loaded, or when the program is not
beside this directory.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "vps_tpu")


def _environment(entry):
    """Fixed cache directories inside the checkout, no JAX through a
    library, and cuBLAS's deterministic workspace for training (it must be
    set before CUDA is first used)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if entry == "train":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name):
    """The workload file with its configuration and traffic in place."""
    cell = load_json("workloads", f"{name}.json")
    cell["name"] = name
    cell["config_file"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_name"] = cell["traffic"]
    cell["traffic"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


def benchmark_metrics(name):
    """(end-to-end metric entries, per-layer metric entries) of the cell
    ``name`` in BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return e2e, layer


def reader(metric):
    """``metrics/<base>.py``'s ``read``, base = the name before its first
    dot."""
    base = metric.split(".")[0]
    path = os.path.join(HERE, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def host():
    """The host's CPU model, its cores, torch's intra-op threads and the
    milliseconds a fixed loop of Python takes on it (the median of five,
    taken after the check): the cells are paced by the host, and runs on
    hosts that differ are not one population."""
    import torch
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), cpu)
    except OSError:
        pass
    loops = []
    for _ in range(5):
        t0, acc = time.perf_counter(), 0
        for i in range(200_000):
            acc += i
        loops.append(time.perf_counter() - t0)
    return {"cpu": cpu, "cores": os.cpu_count(),
            "threads": torch.get_num_threads(),
            "python_loop_ms": sorted(loops)[2] * 1e3}


def percentile(values, q):
    """The q-th percentile of every value, linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(name, cell, w, setup_s):
    """An end-to-end metric from the window: rates over all the work and
    all the time of the window, tails over every unit."""
    per_unit = cell["traffic"].get("images_per_unit", 1)
    return {
        "setup_s": setup_s,
        "frames_per_s": w.units / w.seconds,
        "images_per_s": w.units * per_unit / w.seconds,
        "train_images_per_s": w.units * per_unit / w.seconds,
        "latency_p95_ms": (percentile(w.latencies, 95) * 1e3
                           if w.latencies else math.nan),
    }[name]


def _all_threads():
    """The profiler's setting that records the ops of every thread (the
    video streams' workers): without it only this thread's are kept."""
    import torch
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def _unparsed():
    """While open, the profiler's stop skips building torch's own event
    list (``prof.events()``), which takes minutes for a traced window's
    millions of events; the harness reads the kineto events itself."""
    from unittest import mock

    from torch.autograd import profiler as autograd_profiler
    if not hasattr(autograd_profiler.profile, "_parse_kineto_results"):
        import contextlib
        return contextlib.nullcontext()
    return mock.patch.object(autograd_profiler.profile,
                             "_parse_kineto_results", lambda self, r: [])


class Context:
    """What a per-layer reader gets: the trace, the window, the cell, the
    correlation calls the program recorded in the window and the FLOPs of
    one unit on the reference."""

    def __init__(self, tr, w, cell, calls, flops):
        self.trace, self.window, self.cell = tr, w, cell
        self.calls, self.flops = calls, flops


def run(args, out=sys.stdout, err=sys.stderr, device="cuda", cell=None,
        chips_check=True):
    cell = cell or load_cell(args.workload)
    _environment(cell["entry"])
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if chips_check and (not torch.cuda.is_available()
                        or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=err)
        return 2
    sys.path.insert(0, ROOT)  # the program, beside this directory
    import entries
    import flops as flops_mod
    import trace as trace_mod

    if forbidden_modules():
        print(f"benchmark: loaded at start: {forbidden_modules()}", file=err)
        return 3
    e2e, layer = benchmark_metrics(cell["name"])
    entry = entries.ENTRIES[cell["entry"]](
        cell, cell["config_file"], args.seed, device,
        control=cell["control"] if args.control else None)
    try:
        entry.setup()
        setup_s = time.perf_counter() - T0
        tr = calls = None
        if args.trace:
            correlation = importlib.import_module("vps_torch.ops.correlation")
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with correlation.record_calls() as calls, _unparsed(), \
                    profile(activities=acts,
                            experimental_config=_all_threads()) as prof:
                with record_function(trace_mod.WINDOW):
                    w = entry.window(args.seconds)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
                t_stop = time.perf_counter()
            t_read = time.perf_counter()
            tr = trace_mod.read(prof, cell["stages"])
            del prof
            print(f"trace: profiler stop {t_read - t_stop:.1f}s, read "
                  f"{time.perf_counter() - t_read:.1f}s, "
                  f"{sum(n for _, n in tr.by_name.values())} device ops",
                  file=err)
        else:
            w = entry.window(args.seconds)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
        entry.release()
        t_check = time.perf_counter()
        nums, unit_flops = entry.check(
            counter=flops_mod.Counter if args.trace else None)
        t_check = time.perf_counter() - t_check
    finally:
        entry.close()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {bad}", file=err)
        return 3

    limits = cell["limits"]
    checks = {k: {"value": nums.get(k, math.nan), "limit": v}
              for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    correct = correct and w.units > 0
    metrics = {}
    if args.trace:
        t_read = time.perf_counter()
        ctx = Context(tr, w, cell, calls, unit_flops)
        for m in layer:
            val = reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": end_to_end(m["name"], cell, w,
                                                      setup_s),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = trace_mod.busy_seconds(tr)
        dev["window_s"] = trace_mod.window_seconds(tr)
        result["breakdown"] = {"device_ops": trace_mod.device_ops(tr),
                               "idle_gaps": trace_mod.idle_gaps(tr)}
        print(f"trace: readers and breakdown "
              f"{time.perf_counter() - t_read:.1f}s", file=err)
    reported = {k: v for k, v in nums.items() if k not in limits}
    if reported:
        result["numbers"] = reported
    result["window"] = {"units": w.units, "seconds": w.seconds,
                        "setup_s": setup_s, "check_s": t_check}
    result["host"] = host()
    result["checks"] = checks
    for k, v in reported.items():
        print(f"{k}: {v!r}", file=err)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "vps_torch")):
        print("benchmark: the program (vps_torch) is not beside this "
              "directory", file=sys.stderr)
        return 4
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
