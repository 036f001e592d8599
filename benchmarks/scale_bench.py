"""At-scale runs: BASELINE config 5.

Two modes:

* ``--single`` (one GPU): >= 100M-nnz single-device solves —
    - 8193^2 (335M-nnz effective 5-point stencil) ff32 refined GMG solve
      to 1e-7, wall-clock + iterations;
    - 16385^2 (1.3B-nnz) fixed-cycle V(2,2) throughput (per-cycle ms and
      nnz/s; plain-f32 convergence is floored at this kappa, so the
      throughput metric is the honest one).
* ``--sweep`` (8 virtual CPU devices): the weak-scaling plumbing sweep of
  ``benchmarks/run.py`` config5 at a configurable rows-per-device
  (``--rows-per-dev``, default 512 -> n = 4096 at P = 8, 84M nnz).

Prints one JSON object (one key per mode); ``--out PATH`` also writes it.

Usage:
    python -m benchmarks.scale_bench --single
    python -m benchmarks.scale_bench --sweep --rows-per-dev 512
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _fence(x):
    import jax

    jax.block_until_ready(x)


def single_chip() -> dict:
    import jax
    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.ops.transfer import pad_to

    rec = {"mode": "single_chip", "backend": jax.default_backend(),
           "device": str(getattr(jax.devices()[0], "device_kind", "?"))}

    # 8193^2 ff32 refined solve to 1e-7 (335M effective nnz).  inner_cg=4:
    # each refinement step runs 4 iterations of MG-preconditioned CG on the
    # f32 error equation — the plain cycle's f32 rate degrades to
    # ~0.78/cycle at this kappa.
    n = 8193
    solver = GMGSolver(shape=(n, n), length=10.0, alpha=10.0, num_levels=8,
                       cycle="v", nu=2, pre_sweeps=2, tol=1e-7, maxit=200,
                       pad_align=256)
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
    nnz = n * n + 4 * (n - 2) ** 2
    for tag, inner in (("ff32_8193", 4), ("ff32_8193_plain", 0)):
        out = solver.solve_refined(b, inner_cg=inner)  # compile
        t0 = time.perf_counter()
        out = solver.solve_refined(b, inner_cg=inner)
        _fence(out.u)
        dt = time.perf_counter() - t0
        rec[tag] = {
            "nnz": nnz, "iters": int(out.iterations),
            "inner_cg": inner,
            "rel_residual": float(out.history[-1]),
            "converged": bool(out.converged), "wall_s": dt,
        }

    # 16385^2 fixed-cycle throughput (1.3B effective nnz / cycle leg)
    n = 16385
    cycles = 10
    solver = GMGSolver(shape=(n, n), length=10.0, alpha=10.0, num_levels=9,
                       cycle="v", nu=2, pre_sweeps=2, tol=0.0, maxit=cycles,
                       pad_align=256)
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
    lev0 = solver.levels[0]
    bp = pad_to(b, lev0.padded_shape)

    import jax as _jax

    @_jax.jit
    def k_cycles(u, bb, cinv):
        def body(_, uu):
            return solver.step(uu, bb, cinv)

        return _jax.lax.fori_loop(0, cycles, body, u)

    u = k_cycles(jnp.zeros_like(bp), bp, solver._coarse_inv)
    _fence(u)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        u = k_cycles(jnp.zeros_like(bp), bp, solver._coarse_inv)
        _fence(u)
        best = min(best, time.perf_counter() - t0)
    nnz = n * n + 4 * (n - 2) ** 2
    rec["vcycle_16385"] = {
        "nnz": nnz, "cycles": cycles, "wall_s": best,
        "ms_per_cycle": best / cycles * 1e3,
        # one V(2,2) cycle sweeps the fine operator ~6x (2+2 smooths,
        # residual, prolong-correct) — report raw cycle rate, not inflated
        "cycles_nnz_per_s": nnz * cycles / best,
    }

    # full ff32 refined SOLVE at 16385^2 (268M unknowns / 1.34B nnz, ~11 GB
    # live).  try/except: a failure here must not lose the other records.
    try:
        solver2 = GMGSolver(shape=(n, n), length=10.0, alpha=10.0,
                            num_levels=9, cycle="v", nu=2, pre_sweeps=2,
                            tol=1e-7, maxit=100, pad_align=256)
        out = solver2.solve_refined(b)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            out = solver2.solve_refined(b)
            import jax as _j

            _j.block_until_ready(out.u)
            best = min(best, time.perf_counter() - t0)
        rec["ff32_16385"] = {
            "nnz": nnz, "iters": int(out.iterations),
            "rel_residual": float(out.history[-1]),
            "converged": bool(out.converged), "wall_s": best,
        }
    except Exception as e:
        rec["ff32_16385_error"] = str(e)[:200]
    return rec


def _collective_counts(stablehlo_text: str) -> dict:
    """Count collective ops in the LOWERED StableHLO (backend-neutral: the
    CPU backend compiles collectives into custom-call thunks that no longer
    carry these names, so counting must happen pre-compile)."""
    import re

    counts = {}
    for kind in ("collective_permute", "all_gather", "all_reduce",
                 "all_to_all"):
        counts[kind] = len(re.findall(r"stablehlo\." + kind + r"\b",
                                      stablehlo_text))
    return counts


def _step_hlo(solver, u0, bs) -> str:
    return solver._jit_step.lower(u0, bs).as_text()


def _time_step(solver, u0, bs, reps: int = 3) -> float:
    solver.step(u0, bs)  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _fence(solver.step(u0, bs))
        best = min(best, time.perf_counter() - t0)
    return best


def attribution(rows_per_dev: int) -> dict:
    """Attribute the virtual-sweep weak-scaling gap.

    On the 8-virtual-CPU mesh: (a) collective-op counts per V-cycle from
    the compiled HLO, grouped wide-halo schedule vs the per-color-exchange
    baseline; (b) wall time of both; (c) microbenched cost of one halo
    ppermute pair / one psum on this mesh, giving an estimated collective
    share of the cycle.  CPU collectives are emulated through host memcpy
    — the *counts* are the hardware-transferable result, the seconds are
    sandbox-local.
    """
    import jax

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    devs = jax.devices()
    p = len(devs)
    n = rows_per_dev * p
    mesh = Mesh(np.array(devs), ("x",))
    rec = {"mode": "attribution", "devices": p, "n": n}

    variants = {}
    for name, grouped in (("grouped", True), ("per_color", False)):
        solver = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=5,
                                  nu1=2, nu2=2, maxit=2, tol=0.0,
                                  use_grouped=grouped)
        b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
        bs = jax.device_put(b, solver.sharding)
        u0 = jax.device_put(jnp.zeros_like(b), solver.sharding)
        counts = _collective_counts(_step_hlo(solver, u0, bs))
        variants[name] = {
            "collectives_per_cycle": counts,
            "cycle_s": _time_step(solver, u0, bs),
            "num_sharded_levels": solver.num_sharded,
        }
    rec["variants"] = variants
    # the data-driven choice: build once with use_grouped="measure" — the solver A/B-times both schedules on THIS
    # mesh at construction and records the decision
    ms = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=5,
                          nu1=2, nu2=2, maxit=2, tol=0.0,
                          use_grouped="measure")
    rec["measured_schedule"] = ms.schedule_decision

    # microbench: one w=6 halo ppermute pair and one scalar psum
    from multigrid_prj_tpu.parallel.sharded_gmg import (
        _halo_slabs,
        norm2_psum,
    )

    spec = P("x", None)
    sh = NamedSharding(mesh, spec)
    x = jax.device_put(jnp.ones((n, n), jnp.float32), sh)

    def k_exchanges(x, k=32):
        def body(_, v):
            t, bt = _halo_slabs(v, ("x",), 6)
            return v + 1e-9 * (jnp.sum(t) + jnp.sum(bt))

        return jax.lax.fori_loop(0, k, body, x)

    def k_psums(x, k=32):
        def body(_, v):
            return v + 1e-12 * norm2_psum(v[:1, :1], ("x",))

        return jax.lax.fori_loop(0, k, body, x)

    for label, fn in (("halo_pair", k_exchanges), ("psum", k_psums)):
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,),
                                  out_specs=spec))
        _fence(f(x))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _fence(f(x))
            best = min(best, time.perf_counter() - t0)
        rec[label + "_cost_s"] = best / 32
    for name, v in variants.items():
        cp = v["collectives_per_cycle"]["collective_permute"]
        v["est_collective_share"] = min(1.0, (cp / 2)
                                        * rec["halo_pair_cost_s"]
                                        / v["cycle_s"])
    rec["note"] = (
        "grouped cuts collective-permutes 84 -> 28 per V(2,2) cycle; on "
        "this CPU emulation collectives are shared-memory memcpys, so the "
        "seconds say nothing about a device interconnect — the counts do")
    return rec


def sweep(rows_per_dev: int) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    devs = jax.devices()
    rec = {"mode": "virtual_sweep", "rows_per_dev": rows_per_dev,
           "devices": len(devs), "sweep": [],
           "note": ("8 virtual CPU devices on one host: validates sharded "
                    "plumbing and records the collective/compute overhead "
                    "trend, NOT device scaling")}
    for p in (1, 2, 4, 8):
        if p > len(devs):
            break
        n = rows_per_dev * p
        mesh = Mesh(np.array(devs[:p]), ("x",))
        solver = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=5,
                                  nu1=2, nu2=2, maxit=2, tol=0.0)
        b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
        bs = jax.device_put(b, solver.sharding)
        u0 = jax.device_put(jnp.zeros_like(b), solver.sharding)
        best = _time_step(solver, u0, bs)
        nnz = 5 * n * n
        rec["sweep"].append({
            "devices": p, "n": n, "nnz": nnz, "cycle_s": best,
            "nnz_per_s_per_device": nnz / best / p,
        })
        print(json.dumps(rec["sweep"][-1]), flush=True)
    if len(rec["sweep"]) >= 2:
        base = rec["sweep"][0]["nnz_per_s_per_device"]
        rec["weak_scaling_efficiency"] = (
            rec["sweep"][-1]["nnz_per_s_per_device"] / base)
    rec["attribution"] = attribution(rows_per_dev)
    return rec


def main(argv=None) -> None:
    from multigrid_prj_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rows-per-dev", type=int, default=512)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    data = {}
    # single_chip FIRST: sweep() force-switches jax to 8 virtual CPU
    # devices, which would run (or break) the single-device benchmark on
    # the CPU if it came second
    if args.single:
        data["single_chip"] = single_chip()
    if args.sweep:
        data["virtual_sweep"] = sweep(args.rows_per_dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(data, f, indent=2)
    print(json.dumps(data))


if __name__ == "__main__":
    main()
