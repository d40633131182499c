"""Tiny cells for the CPU tests: a cell's own files, its mix cut short."""

from mocapbench.common import cell as cell_mod


def tiny(config: str, traffic: str, seconds: float, seed: int = 7,
         **mix) -> cell_mod.Cell:
    """``config`` and ``traffic`` as the benchmark names them, on the CPU,
    with the mix's entries in ``mix`` replaced."""
    path = cell_mod.BENCH_DIR / "configs" / f"{config}.json"
    tr = cell_mod.load_json(cell_mod.BENCH_DIR / "traffic" / f"{traffic}.json")
    tr.update(mix)
    return cell_mod.Cell(name=f"{config}.{traffic}",
                         config=cell_mod.load_json(path), config_path=path,
                         traffic=tr, seed=seed, seconds=seconds, trace=False,
                         device="cpu")


def correct(numbers: dict, limits: dict) -> bool:
    return all(v <= limits[k] for k, v in numbers.items())
