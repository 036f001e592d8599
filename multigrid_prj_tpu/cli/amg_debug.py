"""AMG debug harness — the standalone diagnostic driver the reference ships
as its second binary (``AMG/debugtest.cpp``, built as ``test`` by
``AMG/CMakeLists.txt:26-27``).

Capability parity, step by step:

* mesh import + P1 assembly (``debugtest.cpp:20-150``);
* an N-level AMG setup exercised MANUALLY with per-level diagnostics:
  strength graph size, C/F split counts, prolongation shape, Galerkin
  coarse-operator size (``debugtest.cpp:155-199`` does this for 2 levels);
* cross-level index composition check — the reference composes component
  masks so deeper levels map to level-0 indices (``debugtest.cpp:167-174``);
  here the equivalent invariant is that the restricted RHS chain
  ``P_l^T ... P_0^T b`` matches restricting in one shot through the
  composed prolongation ``(P_0 P_1 ... P_l)^T b``;
* coarse-system smoothing: ``sweeps`` Jacobi/Chebyshev-free masked GS
  sweeps on the coarsest system with residual printed before/after
  (``debugtest.cpp:229-246`` runs 5000 sweeps and prints both);
* VTU export of the smoothed-then-interpolated solution.

Usage:
  python -m multigrid_prj_tpu.cli.amg_debug -mesh mesh1.msh -levels 2 -sweeps 5000
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="amg_debug", description=__doc__)
    ap.add_argument("-mesh", required=True)
    ap.add_argument("-levels", type=int, default=2,
                    help="levels to set up (reference harness: 2)")
    ap.add_argument("-sweeps", type=int, default=5000,
                    help="coarse GS sweeps (reference: 5000)")
    ap.add_argument("-theta", type=float, default=0.2)
    ap.add_argument("-o", default="debug_output.vtu")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from multigrid_prj_tpu.amg import (
        AMGSolver,
        build_prolongation,
        coarsen_greedy,
        strength_mask,
    )
    from multigrid_prj_tpu.models.fem import assemble_p1, export_vtu, parse_msh
    from multigrid_prj_tpu.ops.sparse import rap

    mesh = parse_msh(args.mesh)
    print(f"Mesh imported! {mesh.n_nodes} nodes, {mesh.n_elements} elements")
    A, rhs = assemble_p1(mesh)
    print(f"Assembled: {A.shape[0]} dofs, {A.nnz} nnz")

    # manual setup loop with diagnostics (debugtest.cpp:155-199)
    mats, Ps, rhss = [A], [], [np.asarray(rhs)]
    cur = A
    for l in range(args.levels - 1):
        s = strength_mask(cur, args.theta)
        labels = coarsen_greedy(cur, args.theta, seed=0)
        nc = int(labels.sum())
        print(f"level {l}: n={cur.shape[0]} nnz={cur.nnz} "
              f"strong={int(s.sum())} coarse={nc} fine={cur.shape[0] - nc}")
        P = build_prolongation(cur, labels, args.theta)
        cur = rap(P, cur)
        Ps.append(P)
        mats.append(cur)
        rhss.append(P.transpose().spmv(rhss[-1]))
        print(f"  -> P {P.shape}, coarse operator n={cur.shape[0]} "
              f"nnz={cur.nnz}")

    # cross-level composition invariant (mask composition analog,
    # debugtest.cpp:167-174): chained P^T restriction == composed one-shot
    if Ps:
        comp = Ps[0]
        for P in Ps[1:]:
            comp = comp.matmul(P)
        one_shot = comp.transpose().spmv(rhss[0])
        err = np.abs(one_shot - rhss[-1]).max()
        denom = max(1.0, np.abs(rhss[-1]).max())
        ok = err / denom < 1e-12
        print(f"cross-level composition check: max diff {err:.3e} "
              f"-> {'PASSED' if ok else 'FAILED'}")
        if not ok:
            return 1

    # coarse smoothing with residual before/after (debugtest.cpp:229-246)
    Ac, bc = mats[-1], rhss[-1]
    solver = AMGSolver(Ac, num_levels=1)
    x = np.zeros(Ac.shape[0])
    r0 = solver.residual_norm(x, bc)
    print(f"coarse residual before: {r0:.6e}")
    import jax.numpy as jnp

    from multigrid_prj_tpu.amg import mc_gs_sweep

    xj = jnp.asarray(x, solver.dtype)
    bj = jnp.asarray(bc, solver.dtype)
    lvl = solver.levels[0]
    sweep = jax.jit(lambda v: mc_gs_sweep(lvl, v, bj))
    for _ in range(args.sweeps):
        xj = sweep(xj)
    r1 = solver.residual_norm(xj, bc)
    print(f"coarse residual after {args.sweeps} GS sweeps: {r1:.6e} "
          f"(reduction {r1 / max(r0, 1e-300):.3e})")

    # interpolate back to the fine level and export (debugtest.cpp epilogue)
    xf = np.asarray(xj, dtype=np.float64)
    for P in reversed(Ps):
        xf = P.spmv(xf)
    export_vtu(args.o, mesh, xf)
    print(f"Debug solution saved in {args.o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
