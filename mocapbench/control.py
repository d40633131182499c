"""The control of the check that decides ``correct``: the reference held in
the next precision below the configuration's (bfloat16 for float32), put
in the program's place at the cell's own size, on the seeds given.  A
limit is sound only where this run fails it.

    python3 -m mocapbench.control --workload <cell> --seconds <s> \
        --seeds <n>,<n>,...

Prints one JSON line a seed: the numbers beside the mix's limits, and
whether they fail.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def main(argv=None, device: str = "cuda") -> int:
    from mocapbench.common import cell as cell_mod

    p = argparse.ArgumentParser(prog="mocapbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    root = cell_mod.ROOT
    bench = cell_mod.load_json(root / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    traffic = cell_mod.load_json(
        root / "mocapbench" / "traffic" / f"{wl['traffic']}.json")
    driver = importlib.import_module(f"mocapbench.drivers.{traffic['driver']}")
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = cell_mod.Cell(
            name=wl["name"], config=cell_mod.load_json(root / conf["file"]),
            config_path=root / conf["file"], traffic=traffic, seed=seed,
            seconds=args.seconds, trace=False, device=device)
        numbers = driver.control(cell)
        fails = sorted(k for k, v in numbers.items()
                       if not v <= traffic["limits"][k])
        failed_all &= bool(fails)
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "numbers": numbers, "limits": traffic["limits"],
                          "fails": fails}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
