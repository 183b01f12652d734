"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Measures ``metafast_tpu_torch`` (the PyTorch / CUDA package) on the card:
whole ``matrix-builder`` jobs through its launcher, one after another,
on reads generated from the seed.  Prints diagnostic lines, then one JSON
result as the last line of standard output, with the numbers the check
compared as the last lines of standard error.  Exits 1 without a result
when no card (or too few cards) is present, when the package under test
is missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.time()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from portbench.harness import cells, runner

    cell = cells.load(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 1
    try:
        res = runner.run(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                         T_START, log=lambda m: print(m, flush=True))
    except (ImportError, RuntimeError) as e:
        print(f"no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
