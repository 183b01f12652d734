"""The check's control at a cell's own size: the plain reference put in the
program's place, under a 32-bit k-mer key (the next integer type below
the configuration's 2k-bit keys), judged by the same comparison.

    python portbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints, per seed, each compared number beside its limit, and whether the
control came out not correct (it must).  The benchmark's runs never run
this; it sets the upper readings that PERF.md lists beside each limit.
It is the control of the matrix-builder reference (``reference/matrix``).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KEY_BITS = 32


def fold(keys, counts):
    """A narrower key: buckets of ``keys & (2**KEY_BITS - 1)``, each under
    its least full key with the bucket's summed count."""
    import torch

    b = keys & ((1 << KEY_BITS) - 1)
    ub, inv = torch.unique(b, return_inverse=True)
    rep = torch.full((ub.numel(),), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=keys.device)
    rep.scatter_reduce_(0, inv, keys, "amin")
    tot = torch.zeros(ub.numel(), dtype=torch.int64, device=keys.device)
    tot.index_add_(0, inv, counts)
    rep, order = torch.sort(rep)
    return rep, tot[order]


@contextlib.contextmanager
def narrow_keys():
    """The reference's counting under ``KEY_BITS``-bit keys, meanwhile."""
    from portbench.reference import matrix as R

    plain = R.count

    def count(reads, k, device):
        keys, counts = fold(*plain(reads, k, device))
        return keys, counts.clamp(max=R.SATURATE)

    R.count = count
    try:
        yield
    finally:
        R.count = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)

    import torch

    from portbench.gen.community import generate
    from portbench.harness import cells, compare

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cell = cells.load(a.workload)
    tool, params = cell.tool, cell.config["params"]
    all_failed = True
    for seed in a.seeds:
        t0 = time.perf_counter()
        samples = generate(cell.traffic, seed)
        want = tool.expected(samples, params, "cuda", {})
        with narrow_keys():
            ctrl = tool.expected(samples, params, "cuda", {})
        numbers = tool.compare(ctrl, want)
        ok = compare.passed(numbers, tool.LIMITS)
        all_failed &= not ok
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "key_bits": KEY_BITS, "control_correct": ok,
                          "seconds": time.perf_counter() - t0,
                          "numbers": numbers, "limits": tool.LIMITS}),
              flush=True)
        torch.cuda.empty_cache()
    return 0 if all_failed else 2


if __name__ == "__main__":
    sys.exit(main())
