"""ELL SpMV microbenchmark: XLA's gather lowering of ``ELLMatrix.spmv``.

Prints one JSON line with slots/s (padded ELL slots — the streamed
footprint) and effective GB/s (8 B per slot for cols + vals, plus x and y).

Usage: python -m benchmarks.spmv_bench [n_rows] [iters]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from multigrid_prj_tpu.ops.sparse import HostCSR


def banded_csr(n: int, half_band: int = 3, extra: int = 2) -> HostCSR:
    """A banded SPD-ish test matrix: tridiagonal-plus-wings, K = 4 + extra."""
    offs = [0, -1, 1, -half_band * 17] + [half_band * (i + 2) for i in range(extra)]
    rows_l, cols_l, vals_l = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, n - o), dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + o)
        vals_l.append(np.full(r.size, 8.0 if o == 0 else -1.0))
    rows = np.concatenate(rows_l)
    return HostCSR.from_coo(
        rows, np.concatenate(cols_l), np.concatenate(vals_l), (n, n)
    )


def main(argv=None) -> None:
    from bench import ell_spmv_op

    argv = argv if argv is not None else sys.argv[1:]
    n = int(argv[0]) if argv else 1 << 20
    iters = int(argv[1]) if len(argv) > 1 else 50
    dt, nbytes, slots = ell_spmv_op(banded_csr(n), k=iters)
    print(json.dumps({
        "metric": "ell_spmv_xla_slots_per_s", "value": slots / dt,
        "unit": "slots/s", "gb_s": nbytes / dt / 1e9,
        "ms_per_spmv": dt * 1e3,
    }))


if __name__ == "__main__":
    main()
