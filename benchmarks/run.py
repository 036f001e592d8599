"""Benchmark harness for the BASELINE.json configs.

Runs any subset of the five benchmark configurations and emits one JSON
record per config (stdout + optional file).  The reference publishes no
hardware numbers (SURVEY.md §6); the behavioral bars are its convergence
artifacts (rho ~ 0.1/outer-iteration, <= 13 iterations to 1e-11) and the
performance bars come from BASELINE.json.

  python -m benchmarks.run --configs 1,2,3 [--out results.json]

Configs:
  1  2D Poisson 65x65, 4 levels, weighted-Jacobi V-cycle (CPU-runnable)
  2  2D Poisson 1025x1025, RB-GS V- and W-cycles, convergence-factor check
  3  AMG on the imported reference mesh (.msh): setup + RAP + solve
  4  3D Poisson 257^3 (129^3 on CPU), bf16/f32 mixed-precision smoothing
  5  Sharded GMG weak-scaling sweep over the device mesh (1..P devices)
  k  stencil-apply throughput (XLA)

Config 3 reads a gmsh ``.msh`` file given with ``--mesh``; without one it
runs on a generated 81x81-node mesh (the size of the reference's mesh1).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _timeit(fn, *args, reps=3):
    import jax

    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def config1():
    import jax
    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.utils.metrics import SolveMetrics

    f64 = jax.config.jax_enable_x64
    solver = GMGSolver(shape=(65, 65), num_levels=4, smoother="jacobi",
                       omega=0.8, cycle="v", nu=2, pre_sweeps=2,
                       tol=1e-11 if f64 else 1e-6)
    b = assemble_rhs(solver.levels[0], 10.0, test=1,
                     dtype=jnp.float64 if f64 else jnp.float32)
    solver.solve(b)  # compile
    dt, out = _timeit(lambda: solver.solve(b))
    m = SolveMetrics(history=np.asarray(out.history), wall_time_s=dt)
    return {
        "config": 1, "problem": "2D Poisson 65^2, 4 levels, w-Jacobi V(2,2)",
        "iterations": out.iterations, "converged": out.converged,
        "convergence_factor": m.convergence_factor, "wall_time_s": dt,
    }


def config2():
    import jax
    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.utils.metrics import SolveMetrics

    f64 = jax.config.jax_enable_x64
    dtype = jnp.float64 if f64 else jnp.float32
    tol = 1e-11 if f64 else 1e-6
    rec = {"config": 2, "problem": "2D Poisson 1025^2, RB-GS V and W cycles"}
    for cyc in ("v", "w"):
        solver = GMGSolver(shape=(1025, 1025), num_levels=8, smoother="gs",
                           cycle=cyc, nu=2, pre_sweeps=2, tol=tol)
        b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=dtype)
        solver.solve(b)
        dt, out = _timeit(lambda s=solver: s.solve(b))
        m = SolveMetrics(history=np.asarray(out.history), wall_time_s=dt)
        rec[f"{cyc}_iterations"] = out.iterations
        rec[f"{cyc}_convergence_factor"] = m.convergence_factor
        rec[f"{cyc}_wall_time_s"] = dt
        rec[f"{cyc}_converged"] = out.converged
    # the reference's behavioral bar: rho ~ 0.1 per outer iteration
    rec["reference_rho"] = 0.1
    rec["meets_reference_rho"] = rec["v_convergence_factor"] <= 0.12
    return rec


def config3(mesh_path: str | None):
    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.fem import (
        assemble_p1,
        parse_msh,
        structured_unit_square_mesh,
    )

    t0 = time.perf_counter()
    mesh = (parse_msh(mesh_path) if mesh_path
            else structured_unit_square_mesh(81))
    A, rhs = assemble_p1(mesh)
    t_assembly = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = AMGSolver(A, num_levels=5, smoother="chebyshev", rhs=rhs)
    t_setup = time.perf_counter() - t0
    solver.solve_pcg(rhs, tol=1e-10)  # compile
    dt, (x, iters, rel) = _timeit(lambda: solver.solve_pcg(rhs, tol=1e-10))
    return {
        "config": 3,
        "problem": ("AMG on " + (mesh_path.split('/')[-1] if mesh_path
                                 else "generated 81x81 mesh")),
        "dofs": A.shape[0], "nnz": A.nnz,
        "levels": solver.level_sizes,
        "operator_complexity": solver.operator_complexity,
        "assembly_s": t_assembly, "setup_s": t_setup,
        "pcg_iterations": iters, "rel_residual": rel, "solve_s": dt,
    }


def config4():
    import jax
    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import grid_coords
    from multigrid_prj_tpu.ops.stencil import boundary_mask

    n = 65 if jax.default_backend() == "cpu" else 257
    shape = (n, n, n)
    # tol 1e-4: the bf16 defect-correction floor on this problem size
    solver = GMGSolver(shape=shape, length=1.0, alpha=1.0, num_levels=4,
                       cycle="v", nu=2, pre_sweeps=2, tol=1e-4, maxit=60,
                       smoother_dtype=jnp.bfloat16)
    x, y, z = grid_coords(shape, 1.0, dtype=jnp.float32)
    b = jnp.where(boundary_mask(shape), 0.0, jnp.sin(3 * x) * jnp.cos(2 * y) + z)
    solver.solve(b)
    dt, out = _timeit(lambda: solver.solve(b))
    return {
        "config": 4, "problem": f"3D Poisson {n}^3, bf16 smoothing / f32 residual",
        "iterations": out.iterations, "converged": out.converged,
        "final_residual": float(out.history[-1]), "wall_time_s": dt,
        "points": n**3,
    }


def config5():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    devs = jax.devices()
    rec = {"config": 5, "problem": "sharded GMG weak scaling (rows/device fixed)",
           "devices_available": len(devs), "sweep": []}
    rows_per_dev = 256
    for p in (1, 2, 4, 8):
        if p > len(devs):
            break
        n = rows_per_dev * p
        mesh = Mesh(np.array(devs[:p]), ("x",))
        solver = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=4,
                                  nu1=2, nu2=2, maxit=4, tol=0.0)
        b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
        b = jax.device_put(b, solver.sharding)
        u0 = jax.device_put(jnp.zeros_like(b), solver.sharding)
        solver.step(u0, b)  # compile
        dt, _ = _timeit(lambda s=solver, u=u0, bb=b: s.step(u, bb))
        nnz = 5 * n * n
        rec["sweep"].append({
            "devices": p, "n": n, "cycle_s": dt,
            "nnz_per_s_per_device": nnz / dt / p,
        })
    if len(rec["sweep"]) >= 2:
        base = rec["sweep"][0]["nnz_per_s_per_device"]
        rec["weak_scaling_efficiency"] = (
            rec["sweep"][-1]["nnz_per_s_per_device"] / base
        )
    if jax.default_backend() == "cpu":
        rec["note"] = (
            "virtual CPU devices share physical cores: efficiency here "
            "validates the plumbing only, not device scaling"
        )
    return rec


def config_kernels():
    import jax

    from bench import stencil_apply_op

    n = 1024 if jax.default_backend() == "cpu" else 8192
    dt, nbytes = stencil_apply_op(n)
    return {"config": "kernels", "n": n, "xla_apply_gbps": nbytes / dt / 1e9}


RUNNERS = {"1": config1, "2": config2, "4": config4, "5": config5,
           "k": config_kernels}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,3,k")
    ap.add_argument("--mesh", default=None,
                    help="gmsh .msh for config 3 (default: generated mesh)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None,
                    help="force jax platform (cpu) before first use")
    args = ap.parse_args(argv)

    import os

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    plat = args.platform or os.environ.get("JAX_PLATFORMS", "")
    if plat == "cpu":
        # must happen before any backend initialization
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_num_cpu_devices", 8)

    results = []
    for c in args.configs.split(","):
        c = c.strip()
        runner = (lambda: config3(args.mesh)) if c == "3" else RUNNERS.get(c)
        if runner is None:
            print(json.dumps({"config": c, "error": "unknown config"}))
            continue
        try:
            rec = runner()
        except Exception as e:
            rec = {"config": c, "error": f"{type(e).__name__}: {e}"}
        rec["backend"] = jax.default_backend()
        results.append(rec)
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
