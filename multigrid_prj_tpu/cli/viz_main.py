"""Visualization CLI — the reference's notebook/pyvista drivers as a command.

Covers ``GeometricMultigrid/test/test.ipynb`` cells 4-6 (solution heatmap +
3D surface from ``x.mtx``, semilog history from ``MGGS4.txt``), ``AMG/start.py``
(FEM field render from a ``.vtu``), and ``gifMaker.py`` (cycle-stage gif via
``--gif``).

Usage:
  python -m multigrid_prj_tpu.cli.viz_main --solution x.mtx --history MGGS4.txt
  python -m multigrid_prj_tpu.cli.viz_main --vtu output.vtu
  python -m multigrid_prj_tpu.cli.viz_main --gif -n 65 -ml 4 -test 0
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="viz_main")
    ap.add_argument("--solution", help="x.mtx vector file (square grid)")
    ap.add_argument("--history", help="MGGS4.txt residual history file")
    ap.add_argument("--vtu", help="output.vtu FEM solution")
    ap.add_argument("--gif", action="store_true",
                    help="run a small GMG solve and animate the cycle stages")
    ap.add_argument("-n", type=int, default=65)
    ap.add_argument("-ml", type=int, default=4)
    ap.add_argument("-test", type=int, default=0)
    ap.add_argument("-w", type=float, default=10.0)
    ap.add_argument("--out", default=".", help="output directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    made = []

    from multigrid_prj_tpu.viz.plots import (
        make_gif,
        plot_convergence,
        plot_fem_solution,
        plot_solution,
        record_cycle_stages,
    )

    if args.solution:
        from multigrid_prj_tpu.utils.io import load_vector

        v = load_vector(args.solution)
        n = int(math.isqrt(v.size))
        if n * n != v.size:
            print(f"Error: {args.solution} has {v.size} values, not a square grid")
            return 1
        made.append(plot_solution(v.reshape(n, n), args.w,
                                  os.path.join(args.out, "solution.png")))

    if args.history:
        from multigrid_prj_tpu.utils.io import load_vector

        made.append(plot_convergence(load_vector(args.history),
                                     os.path.join(args.out, "convergence.png")))

    if args.vtu:
        import xml.etree.ElementTree as ET

        root = ET.parse(args.vtu).getroot()
        pts = np.fromstring(
            root.find(".//Points/DataArray").text.replace("\n", " "), sep=" "
        ).reshape(-1, 3)[:, :2]
        conn = np.fromstring(
            root.find(".//Cells/DataArray[@Name='connectivity']").text
            .replace("\n", " "), sep=" ", dtype=int,
        ).reshape(-1, 3)
        u = np.fromstring(
            root.find(".//PointData/DataArray").text.replace("\n", " "), sep=" "
        )
        made.append(plot_fem_solution(pts, conn, u,
                                      os.path.join(args.out, "fem_solution.png")))

    if args.gif:
        import jax

        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        from multigrid_prj_tpu.gmg import GMGSolver
        from multigrid_prj_tpu.models.poisson import assemble_rhs

        solver = GMGSolver(shape=(args.n, args.n), length=args.w,
                           num_levels=args.ml)
        b = assemble_rhs(solver.levels[0], args.w, test=args.test)
        frames = record_cycle_stages(solver, b, iterations=2)
        made.append(make_gif(frames, os.path.join(args.out, "cycle.gif"),
                             length=args.w))
        made.append(make_gif(frames, os.path.join(args.out, "cycle3d.gif"),
                             length=args.w, three_d=True))

    if not made:
        print("nothing to do: pass --solution/--history/--vtu/--gif")
        return 1
    for p in made:
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
