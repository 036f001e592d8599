"""End-to-end AMG solve wall time.

The reference's headline AMG behavior is the whole ``apply_AMG`` flow
(``AMG/src/AMG.cpp:277-308``): setup + smoothed V-cycles to tolerance.
This harness times the equivalent end to end, with setup reported apart:

* an FD Poisson system (``models/poisson.poisson_fd_csr``) at 512^2 /
  1024^2 (0.26M / 1.05M rows — BASELINE config 3's "large FD system"),
  in plain f32 and ff32 extended precision, and
* a P1 FEM system on a generated structured mesh (``bench_fem``),

with the out-of-the-box solver configuration.

Usage: python -m benchmarks.amg_bench [n_grid ...]   (default: 512 1024)
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _best_of(fn, reps=3):
    import jax

    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out[0])
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_fd(n_grid: int, tol: float = 1e-5, tol_ff: float = 1e-8) -> dict:
    """``tol`` (plain f32 paths) defaults to 1e-5: the f32 residual floor
    at these condition numbers sits near ~1e-6, so 1e-8 would just burn
    maxit; the ff32 refined solve targets ``tol_ff = 1e-8``."""
    import jax
    import jax.numpy as jnp

    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    t0 = time.perf_counter()
    A = poisson_fd_csr(n_grid)
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)

    # host-heap hygiene: setup is host NumPy/C++; a fragmented heap from
    # earlier phases adds noise to the measurement (observed once at 4x)
    import gc

    gc.collect()
    t0 = time.perf_counter()
    # min_coarse=2000: stop coarsening once the level fits a precomputed
    # dense inverse — a deep tail of tiny ELL levels only adds kernel
    # launches and compile size
    solver = AMGSolver(A, num_levels=12, min_coarse=2000)
    t_setup = time.perf_counter() - t0

    rec = {
        "system": f"fd_poisson_{n_grid}x{n_grid}",
        "rows": A.shape[0], "nnz": A.nnz,
        "backend": jax.default_backend(),
        "matrix_build_s": t_build, "setup_s": t_setup,
        "levels": solver.level_sizes,
        "operator_complexity": solver.operator_complexity,
        "smoother": solver.smoother_name,
    }

    def phase(tag, fn, fields):
        try:
            fn()  # compile
            dt, out = _best_of(fn)
            rec[tag + "_ms"] = dt * 1e3
            for name, get in fields.items():
                rec[tag + "_" + name] = get(out)
        except Exception as e:  # one bad phase must not lose the record
            rec[tag + "_error"] = str(e)[:200]

    b_dev = jnp.asarray(b)  # upload once; numpy b re-uploads per call
    phase("solve_f32", lambda: solver.solve(b_dev, tol=tol, maxit=200),
          {"iters": lambda o: o.iterations, "rel": lambda o: o.rel_residual})
    phase("pcg", lambda: solver.solve_pcg(b_dev, tol=tol),
          {"iters": lambda o: o.iterations})
    phase("solve_ff32", lambda: solver.solve_refined(b, tol=tol_ff,
                                                     maxit=300),
          {"iters": lambda o: o.iterations, "rel": lambda o: o.rel_residual})
    return rec


def bench_fem(n: int, tol: float = 1e-10) -> dict:
    """P1 assembly on ``structured_unit_square_mesh(n)`` (n^2 nodes) and
    AMG-PCG in the solver's default precision."""
    import jax

    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.fem import (
        assemble_p1,
        structured_unit_square_mesh,
    )

    t0 = time.perf_counter()
    A, rhs = assemble_p1(structured_unit_square_mesh(n))
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = AMGSolver(A, num_levels=5, rhs=rhs)
    t_setup = time.perf_counter() - t0
    rec = {
        "system": f"fem_p1_{n}x{n}", "rows": A.shape[0], "nnz": A.nnz,
        "backend": jax.default_backend(),
        "assembly_s": t_asm, "setup_s": t_setup,
        "smoother": solver.smoother_name,
    }
    solver.solve_pcg(rhs, tol=tol)  # compile
    dt, out = _best_of(lambda: solver.solve_pcg(rhs, tol=tol))
    rec["pcg_ms"] = dt * 1e3
    rec["pcg_iters"] = out.iterations
    rec["pcg_rel"] = out.rel_residual
    return rec


def main(argv=None) -> None:
    from multigrid_prj_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    sizes = [int(a) for a in argv] or [512, 1024]
    for n in sizes:
        print(json.dumps(bench_fd(n)), flush=True)
    print(json.dumps(bench_fem(81)), flush=True)


if __name__ == "__main__":
    main()
