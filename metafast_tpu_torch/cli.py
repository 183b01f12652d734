"""Command line: the default matrix-builder pipeline on one device.

    python -m metafast_tpu_torch.cli -k 31 -i a.fa b.fa c.fa -w wd [--device cuda]

runs ``matrix_pipeline`` with the reference defaults (b=1, l=100,
b1=1000, b2=10000) and writes
``wd/matrices/dist_matrix_<date>_original_order.txt``, as the JAX
package's matrix-builder tool does.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from metafast_tpu.io import textfmt


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="metafast_tpu_torch.cli",
        description="Distance matrix of metagenomic samples (matrix-builder)")
    p.add_argument("-k", type=int, default=31, help="k-mer size (1..31)")
    p.add_argument("-i", "--reads", nargs="+", required=True,
                   help="one FASTA/FASTQ file per sample")
    p.add_argument("-w", "--work-dir", default="workDir",
                   help="output directory")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = p.parse_args(argv)

    from .pipeline.matrix import matrix_pipeline

    res = matrix_pipeline(args.reads, k=args.k, device=args.device)
    out = (Path(args.work_dir) / "matrices" /
           f"dist_matrix_{time.strftime('%Y-%m-%d_%H-%M-%S')}"
           "_original_order.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    textfmt.write_dist_matrix(str(out), res.matrix, res.names)
    print(f"Distance matrix printed to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
