"""GMG command-line driver — parity with the reference binary.

Reproduces ``GeometricMultigrid/src/main.cpp``: flags ``-n -a -w -ml -test
-smt`` (``src/utilities.cpp:3-132``), the outer loop of 2 pre-smooths + one
sawtooth cycle to ``TOL = 1e-11`` / 1000 iterations (``main.cpp:77-116``),
the ``||``-prefixed timing line the web UI parses (``main.cpp:121-123``),
and the ``MGGS4.txt`` / ``x.mtx`` artifacts (``main.cpp:127-128``).

``-smt 2`` runs multigrid-preconditioned BiCGSTAB (the reference's BiCGSTAB
branch actually ran the Jacobi cycle — a recorded bug, SURVEY.md §7.5 — so
this framework supplies the intended capability instead).

Usage: ``python -m multigrid_prj_tpu.cli.gmg_main -n 385 -ml 4 -test 1``
"""

from __future__ import annotations

import sys
import time

import jax


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from multigrid_prj_tpu.utils.config import parse_gmg_args

    cfg = parse_gmg_args(argv)

    # Numerical parity with the all-double reference needs f64, which the
    # CPU and the GPU both have: "auto" means f64.
    dtype = "float64" if cfg.dtype == "auto" else cfg.dtype
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.ops.krylov import bicgstab
    from multigrid_prj_tpu.ops.stencil import poisson_apply
    from multigrid_prj_tpu.utils.io import save_history, save_vector

    t0 = time.perf_counter()
    tol = cfg.tol if dtype == "float64" else max(cfg.tol, 1e-6)
    solver = GMGSolver(
        shape=(cfg.n, cfg.n),
        length=cfg.width,
        alpha=cfg.alpha,
        num_levels=cfg.levels,
        smoother="jacobi" if cfg.smoother == 1 else "gs",
        cycle=cfg.cycle,
        tol=tol,
        maxit=cfg.maxit,
        pad_align=cfg.pad or None,
    )
    if solver.levels[0].padded_shape is not None:
        print(f"Aligned layout: logical {solver.levels[0].shape} in "
              f"padded {solver.levels[0].padded_shape}")
    b = assemble_rhs(solver.levels[0], cfg.width, test=cfg.test,
                     dtype=jnp.dtype(dtype))
    jax.block_until_ready(b)
    t1 = time.perf_counter()
    print(f"Initialization time: {t1 - t0} seconds")

    t0 = time.perf_counter()
    if cfg.smoother == 2:
        print("BiCGSTAB iters")
        h0 = solver.levels[0].h
        A = lambda x: poisson_apply(x, cfg.alpha, h0)
        M = lambda r: solver.step(jnp.zeros_like(r), r)
        res = bicgstab(A, b, tol=tol, maxit=cfg.maxit, M=M)
        u, hist = res.x, jnp.array([res.rel_residual])
        iters, converged = res.iterations, res.converged
    else:
        print("GS iters" if cfg.smoother == 0 else "Jacobi iters")
        out = solver.solve(b)
        u, hist = out.u, out.history
        iters, converged = out.iterations, out.converged
    jax.block_until_ready(u)
    t1 = time.perf_counter()

    print(f"||Solving elapsed time: {t1 - t0} sec<br>")
    print(f"Tol: {tol}<br>")
    print(f"Max iter: {cfg.maxit}<br>")
    if not converged:
        print(f"Warning: not converged after {iters} iterations "
              f"(final rel. residual {float(hist[-1]):.3e})")

    save_history("MGGS4.txt", jax.device_get(hist))
    save_vector("x.mtx", jax.device_get(u).reshape(-1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
