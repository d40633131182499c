"""Run one cell of the benchmark once and print its result line.

    python3 -m mocapbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration (``mocapbench/configs/<config>.json``) and its traffic
mix (``mocapbench/traffic/<traffic>.json``); the mix names its driver
(``mocapbench/drivers/<driver>.py``), and each per-layer metric is read by
``mocapbench/metrics/<metric>.py``.  With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
The run fails, and prints no result, without a CUDA card, when the
profiler lost records in a traced run, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "low_cost_mocap_tpu")


def _args(argv):
    p = argparse.ArgumentParser(prog="mocapbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2) -> int:
    print(f"mocapbench: {msg}", file=sys.stderr)
    return code


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs(root) -> None:
    """Every kernel cache of the run at a fixed place inside the checkout
    (the program builds its own kernels into its package's ``_build/``)."""
    base = root / ".mocapbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def read_metric(root, name: str, run):
    """The per-layer metric ``name`` read by its own reader, or None."""
    path = root / "mocapbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "mocapbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def main(argv=None, device: str | None = None) -> int:
    """``device``: None looks for the CUDA card the cell asks for; a test
    passes "cpu" to drive the rest of a run without one."""
    from mocapbench.common import cell as cell_mod
    from mocapbench.common import trace

    args = _args(argv)
    root = cell_mod.ROOT
    try:
        bench = cell_mod.load_json(root / "BENCHMARK.json")
        wl = next(w for w in bench["workloads"]
                  if w["name"] == args.workload)
        conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    except (OSError, StopIteration, KeyError, ValueError) as e:
        return _fail(f"no cell {args.workload!r} in BENCHMARK.json: {e!r}")
    _cache_dirs(root)
    if args.trace:
        # the port replays CUDA graphs: a profiler session that tears its
        # CUDA tracing down re-creates it lazily at the next span, whose
        # first records it then loses (torch.profiler's own workaround for
        # CUDA graphs)
        os.environ["TEARDOWN_CUPTI"] = "0"
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA card: this benchmark runs only on one")
        if torch.cuda.device_count() < int(wl["chips"]):
            return _fail(f"{torch.cuda.device_count()} CUDA cards, the cell "
                         f"asks for {wl['chips']}")
        device = "cuda"
    cdir = root / "mocapbench"
    config_path = root / conf["file"]
    traffic = cell_mod.load_json(cdir / "traffic" / f"{wl['traffic']}.json")
    cell = cell_mod.Cell(name=wl["name"], config=cell_mod.load_json(
        config_path), config_path=config_path, traffic=traffic,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device)
    driver = importlib.import_module(f"mocapbench.drivers.{traffic['driver']}")
    try:
        run = driver.run(cell)
    except trace.LostRecords as e:
        return _fail(f"the profiler lost records, so no device metric is "
                     f"reported: {e}", 3)

    def mine(m) -> bool:
        return wl["name"] in m.get("workloads", [wl["name"]])

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if mine(m):
                v = read_metric(root, m["name"], run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.metrics, setup_s=run.setup_s)
        for m in bench["end_to_end"]:
            if mine(m) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else device),
           "count": int(wl["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    line = {"attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if args.trace:
        print(f"mocapbench: {len(run.spans)} traced spans, "
              f"{sum(len(ev) for ev in run.spans)} records; the longest "
              f"profiler step {run.stall_s:.3f} s", file=sys.stderr)
        busy = sum(trace.busy_ns(ev) for ev in run.spans) / 1e9
        window = sum(trace.extent(ev)[1] - trace.extent(ev)[0]
                     for ev in run.spans if ev) / 1e9
        dev["busy_s"] = busy
        dev["window_s"] = window
        line["breakdown"] = {"device_ops": trace.top_device_ops(run.spans),
                             "idle_gaps": trace.idle_gaps(run.spans)}

    print("mocapbench: setup_s by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()), file=sys.stderr)
    numbers = run.check()
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    found = forbidden_modules()
    if found:
        return _fail(f"modules loaded that the benchmark forbids: {found}", 4)
    line = {"correct": correct, **line, "checks": checks}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
