"""Run the solvers' main paths once on the GPU at full size and check them.

    python chip_smoke.py           # one card: every default phase
    python chip_smoke.py --multi   # four cards: the sharded solvers against
                                   # their one-card answers, nothing else

One process drives everything, CLIs included (called in-process): a JAX
process reserves most of a card's memory, so a second one would fail.
Each phase prints one JSON line with its numbers, its check and the
tolerance it is held to.  The last line, printed only when every phase
passed, is ``{"ok": true, "device": {"platform", "kind", "count"}}``; the
line before it is the card's name and power limit from ``nvidia-smi``.
Without a GPU the script prints no result and exits 2; a failed phase
makes it exit 1.

Reference solutions are float64 solves of the same system (x64 is enabled
for the whole run; every f32 array is created with an explicit dtype) and
residuals are recomputed on the host in NumPy float64, so no check trusts
the residual history of the solve it checks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_prj_tpu.amg import AMGSolver
from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.grids import build_hierarchy
from multigrid_prj_tpu.models.fem import assemble_p1, structured_unit_square_mesh
from multigrid_prj_tpu.models.poisson import assemble_rhs, poisson_fd_csr
from multigrid_prj_tpu.utils.cache import enable_compile_cache

F32, F64 = jnp.float32, jnp.float64


# -- host float64 checks -----------------------------------------------------


def host_stencil_residual(u, b, alpha: float, length: float) -> float:
    """Relative residual ``||b - A u|| / ||b||`` of the Dirichlet Poisson
    stencil (exact layout, any rank), in NumPy float64."""
    u = np.asarray(u, np.float64)
    b = np.asarray(b, np.float64)
    n = u.shape[0]
    c = alpha / (length / (n - 1)) ** 2
    r = b - u  # boundary rows are identity
    core = (slice(1, -1),) * u.ndim
    au = 2.0 * u.ndim * u[core]
    for ax in range(u.ndim):
        for lo, hi in ((0, -2), (2, None)):
            sl = [slice(1, -1)] * u.ndim
            sl[ax] = slice(lo, hi)
            au = au - u[tuple(sl)]
    r[core] = b[core] - c * au
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def stencil_error_bound(b, u_ref, alpha: float, length: float) -> float:
    """Factor turning relative residuals into a relative solution error:
    ``||e|| <= ||A^-1|| ||r||`` with ``||A^-1|| ~ 1/lambda_min`` of the
    interior operator, ``lambda_min = ndim * c * 2 (1 - cos(pi / (n-1)))``.
    Returns ``||b|| / (lambda_min ||u_ref||)``."""
    u_ref = np.asarray(u_ref, np.float64)
    n = u_ref.shape[0]
    c = alpha / (length / (n - 1)) ** 2
    lam = u_ref.ndim * c * 2.0 * (1.0 - math.cos(math.pi / (n - 1)))
    return float(np.linalg.norm(np.asarray(b, np.float64))
                 / (lam * np.linalg.norm(u_ref)))


def rel_diff(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def csr_rel_residual(A, x, b) -> float:
    b = np.asarray(b, np.float64)
    r = b - A.spmv(np.asarray(x, np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _in_tempdir():
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            yield d
        finally:
            os.chdir(cwd)


# -- phases ------------------------------------------------------------------
#
# Each returns a record whose "ok" is the conjunction of its checks.  Sizes
# are parameters so the tests can run every phase at a tiny size on the CPU.


def _ff32_vs_f64(shape, length, alpha, num_levels, b32, tol, **solver_kw):
    """ff32-refined solve of ``b32`` against an f64 solve of the same
    system; shared by the 2D and 3D phases."""
    kw = dict(length=length, alpha=alpha, num_levels=num_levels, cycle="v",
              nu=2, pre_sweeps=2)
    s32 = GMGSolver(shape, tol=tol, maxit=200, **kw, **solver_kw)

    def solve():
        out = s32.solve_refined(b32)
        jax.block_until_ready(out.u)
        return out

    _, t_first = _timed(solve)
    out, t_solve = _timed(solve)
    u_ff, t_fetch = _timed(lambda: np.asarray(out.u))
    b64 = jnp.asarray(b32, F64)
    s64 = GMGSolver(shape, tol=tol / 100, maxit=60, **kw)
    ref, t_ref = _timed(lambda: s64.solve(b64))
    u64 = np.asarray(ref.u)
    b_np = np.asarray(b64)
    res_ff = host_stencil_residual(u_ff, b_np, alpha, length)
    res_64 = host_stencil_residual(u64, b_np, alpha, length)
    amp = stencil_error_bound(b_np, u64, alpha, length)
    diff = rel_diff(u_ff, u64)
    # 2x: the host float64 residual and the solver's float-float one round
    # differently; the float-float floor is ~1e-14 (tests/test_extended.py)
    res_tol = 2.0 * tol
    # ||e|| <= ||A^-1|| ||r||, for both solutions, with a factor 2 for the
    # identity boundary rows that lambda_min leaves out
    diff_tol = 2.0 * amp * (res_tol + res_64)
    return {
        "unknowns": int(np.prod(shape)), "levels": num_levels,
        "iterations": out.iterations,
        "device_rel_residual": float(out.history[-1]),
        "host_rel_residual": res_ff, "host_rel_residual_tol": res_tol,
        "f64_iterations": ref.iterations, "f64_host_rel_residual": res_64,
        "rel_l2_diff_vs_f64": diff, "rel_l2_diff_tol": diff_tol,
        "first_call_s": t_first, "solve_s": t_solve,
        "host_fetch_s": t_fetch, "f64_solve_s": t_ref,
        "ok": bool(res_ff <= res_tol and diff <= diff_tol
                   and np.all(np.isfinite(u_ff))),
    }


def phase_gmg2d(n: int = 8193, num_levels: int = 8, tol: float = 1e-8):
    """2D Poisson, f32 V(2,2) cycles with the direct coarse solve, ff32
    refinement to ``tol``."""
    shape = (n, n)
    lev0 = build_hierarchy(shape, 10.0, num_levels)[0]
    b32 = assemble_rhs(lev0, 10.0, test=1, dtype=F32)
    return _ff32_vs_f64(shape, 10.0, 10.0, num_levels, b32, tol)


def phase_gmg3d(n: int = 257, num_levels: int = 5, tol: float = 1e-8):
    """3D Poisson, bf16 smoothing inside f32 defect correction, ff32
    refinement to ``tol`` (BASELINE config 4)."""
    shape = (n, n, n)
    lev0 = build_hierarchy(shape, 1.0, num_levels)[0]
    b32 = assemble_rhs(
        lev0, 1.0, dtype=F32,
        f=lambda x, y, z: jnp.sin(3.0 * x) * jnp.cos(2.0 * y) + z,
        g=lambda x, y, z: jnp.exp(x) * jnp.exp(-2.0 * y) * z)
    return _ff32_vs_f64(shape, 1.0, 1.0, num_levels, b32, tol,
                        smoother_dtype=jnp.bfloat16)


def phase_gmg_cli(n: int = 513, ml: int = 6, test: int = 1):
    """``gmg_main`` in-process ("auto" precision = f64 on the GPU) against
    the same f64 solve compiled for the CPU.

    ``n``: the CLI keeps the reference's 1e-11 tolerance, which an f64
    solve reaches at 513^2 (13 sawtooth iterations on the CPU); at 1025^2
    its residual floors at 1.26e-11 and it runs all 1000 iterations."""
    from multigrid_prj_tpu.cli import gmg_main
    from multigrid_prj_tpu.utils.io import load_vector

    with _in_tempdir():
        with contextlib.redirect_stdout(sys.stderr):
            rc, t_cli = _timed(lambda: gmg_main.main(
                ["-n", str(n), "-ml", str(ml), "-test", str(test)]))
        x_gpu = load_vector("x.mtx")
        hist = load_vector("MGGS4.txt")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        solver = GMGSolver((n, n), num_levels=ml)
        b = assemble_rhs(solver.levels[0], 10.0, test=test, dtype=F64)
        x_cpu = np.asarray(solver.solve(b).u).reshape(-1)
    diff = float(np.abs(x_gpu - x_cpu).max() / np.abs(x_cpu).max())
    # the same iteration on both devices: the solutions differ by summation
    # order only (2.4e-15 at 1025^2 on an H100 against the CPU)
    tol = 1e-9
    cli_tol = 1e-11
    return {"rc": rc, "iterations": int(hist.size - 1),
            "final_rel_residual": float(hist[-1]), "cli_tol": cli_tol,
            "cli_s": t_cli, "rel_max_diff_vs_cpu": diff, "tol": tol,
            "ok": bool(rc == 0 and hist[-1] <= cli_tol and diff <= tol)}


def phase_amg_fd(n_grid: int = 1024, num_levels: int = 12,
                 min_coarse: int = 2000, seed: int = 0):
    """AMG on the FD Poisson system: f32 V-cycles to 1e-5, f32 PCG to
    1e-5, ff32 refinement to 1e-8; every ``x`` checked on the host."""
    A = poisson_fd_csr(n_grid)
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    solver, t_setup = _timed(lambda: AMGSolver(
        A, num_levels=num_levels, min_coarse=min_coarse, dtype=F32))
    rec = {"rows": A.shape[0], "nnz": A.nnz, "setup_s": t_setup,
           "levels": solver.level_sizes, "smoother": solver.smoother_name}
    ok = True
    # f32 solves: the device residual is evaluated in f32, so the host f64
    # one may sit above it by the f32 rounding of A x (~eps_f32 ||A|| ||x||
    # / ||b||); factor 3 covers it at this size.  ff32: factor 2, as GMG.
    b_dev = jnp.asarray(b, F32)
    for tag, fn, tol, factor in (
            ("vcycle_f32", lambda: solver.solve(b_dev, tol=1e-5, maxit=200),
             1e-5, 3.0),
            ("pcg_f32", lambda: solver.solve_pcg(b_dev, tol=1e-5,
                                                 maxit=200), 1e-5, 3.0),
            ("ff32", lambda: solver.solve_refined(b, tol=1e-8, maxit=300),
             1e-8, 2.0)):
        _, t_first = _timed(fn)
        out, t_solve = _timed(fn)
        res = csr_rel_residual(A, out.x, b)
        good = bool(res <= factor * tol)
        ok &= good
        rec[tag] = {"iterations": out.iterations,
                    "device_rel_residual": out.rel_residual,
                    "host_rel_residual": res, "tol": factor * tol,
                    "first_call_s": t_first, "solve_s": t_solve, "ok": good}
    rec["ok"] = ok
    return rec


def phase_amg_fem(n: int = 1025, n_cli: int = 257, tol: float = 1e-10):
    """P1 FEM on a generated n x n-node mesh with AMG-PCG in f64; then
    ``amg_main`` in-process on a smaller system written as MatrixMarket."""
    from multigrid_prj_tpu.cli import amg_main
    from multigrid_prj_tpu.utils.io import (
        load_vector,
        save_matrix_market,
        save_vector,
    )

    (A, rhs), t_asm = _timed(lambda: assemble_p1(
        structured_unit_square_mesh(n)))
    solver, t_setup = _timed(lambda: AMGSolver(A, num_levels=8,
                                               min_coarse=2000, dtype=F64))
    _, t_first = _timed(lambda: solver.solve_pcg(rhs, tol=tol))
    out, t_solve = _timed(lambda: solver.solve_pcg(rhs, tol=tol))
    res = csr_rel_residual(A, out.x, rhs)
    # f64 throughout: the device and host residuals differ by rounding only
    res_tol = 2.0 * tol
    rec = {"rows": A.shape[0], "nnz": A.nnz, "assembly_s": t_asm,
           "setup_s": t_setup, "levels": solver.level_sizes,
           "pcg_iterations": out.iterations,
           "device_rel_residual": out.rel_residual,
           "host_rel_residual": res, "tol": res_tol,
           "first_call_s": t_first, "solve_s": t_solve}

    Ac, bc = assemble_p1(structured_unit_square_mesh(n_cli))
    with _in_tempdir():
        rows, cols, vals = Ac.to_coo()
        save_matrix_market("A.mtx", rows, cols, vals, Ac.shape)
        save_vector("b.txt", bc)
        with contextlib.redirect_stdout(sys.stderr):
            rc = amg_main.main(["-matrix", "A.mtx", "-rhs", "b.txt",
                                "-tol", str(tol)])
        x_cli = load_vector("x.mtx")
    res_cli = csr_rel_residual(Ac, x_cli, bc)
    rec["cli"] = {"rows": Ac.shape[0], "rc": rc, "host_rel_residual": res_cli,
                  "tol": res_tol}
    rec["ok"] = bool(res <= res_tol and rc == 0 and res_cli <= res_tol)
    return rec


def phase_sharded1(n: int = 2048, num_levels: int = 8, tol: float = 1e-8):
    """``ShardedGMGSolver`` on a one-device mesh against ``GMGSolver``."""
    from multigrid_prj_tpu.parallel.distributed import make_mesh

    return _sharded_vs_single((n, n), make_mesh(1), num_levels, tol)


# The sharded solver needs even grids, whose V(2,2) cycle contracts by only
# ~0.8 per iteration at these sizes (91 iterations to 1e-8 at 2048^2 on an
# H100; ~112 extrapolated at 8192^2).  300 leaves over 2.5x headroom.
SHARDED_MAXIT = 300


def _sharded_vs_single(shape, mesh, num_levels, tol, use_grouped=False):
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    sh, t_build = _timed(lambda: ShardedGMGSolver(
        shape, mesh, num_levels=num_levels, nu1=2, nu2=2, tol=tol,
        maxit=SHARDED_MAXIT, use_grouped=use_grouped))
    single = GMGSolver(shape, num_levels=num_levels, cycle="v", nu=2,
                       pre_sweeps=2, tol=tol, maxit=SHARDED_MAXIT)
    b = assemble_rhs(single.levels[0], 10.0, test=1, dtype=F64)
    _, t_sh_first = _timed(lambda: jax.block_until_ready(sh.solve(b).u))
    out_sh, t_sh = _timed(lambda: sh.solve(b))
    jax.block_until_ready(out_sh.u)
    _, t_1_first = _timed(lambda: jax.block_until_ready(single.solve(b).u))
    out_1, t_1 = _timed(lambda: single.solve(b))
    jax.block_until_ready(out_1.u)
    u_sh, u_1, b_np = (np.asarray(out_sh.u), np.asarray(out_1.u),
                       np.asarray(b))
    res_sh = host_stencil_residual(u_sh, b_np, 10.0, 10.0)
    res_1 = host_stencil_residual(u_1, b_np, 10.0, 10.0)
    diff = rel_diff(u_sh, u_1)
    res_tol = 2.0 * tol  # f64 device vs host residual: rounding only
    # both solutions are within res_tol of the true one in residual, so
    # their difference is bounded through ||A^-1|| (factor 2 as in
    # _ff32_vs_f64)
    diff_tol = 2.0 * stencil_error_bound(b_np, u_1, 10.0, 10.0) * (
        2.0 * res_tol)
    return {"shape": list(shape), "devices": sh.p,
            "sharded_levels": sh.num_sharded,
            "schedule_decision": sh.schedule_decision,
            "sharded_iterations": out_sh.iterations,
            "single_iterations": out_1.iterations,
            "sharded_host_rel_residual": res_sh,
            "single_host_rel_residual": res_1, "tol": res_tol,
            "rel_l2_diff": diff, "rel_l2_diff_tol": diff_tol,
            "sharded_build_s": t_build, "sharded_first_call_s": t_sh_first,
            "sharded_solve_s": t_sh, "single_first_call_s": t_1_first,
            "single_solve_s": t_1,
            "ok": bool(res_sh <= res_tol and res_1 <= res_tol
                       and diff <= diff_tol)}


def phase_ops(n2: int = 8193, n3: int = 257, n_fd: int = 1024,
              n_copy: int = 8192):
    """Wall time of what XLA makes of each hot-path op, median of 5 timed
    calls after a warm-up, against a copy measured in the same run.
    Checks nothing beyond the ops running."""
    import bench

    copy_s, copy_bytes = bench.copy_op(n_copy)
    copy_gbs = copy_bytes / copy_s / 1e9
    rows = {}
    for name, fn in (
            ("apply_2d", lambda: bench.stencil_apply_op(n2)),
            ("rbgs_sweep_2d", lambda: bench.rbgs_sweep_op(n2)),
            ("restrict_fw_2d", lambda: bench.restrict_op(n2)),
            ("prolong_add_2d", lambda: bench.prolong_add_op(n2)),
            ("apply_3d", lambda: bench.stencil3d_op(n3)),
            ("ell_spmv_fd", lambda: bench.ell_spmv_op(
                poisson_fd_csr(n_fd))[:2])):
        dt, nbytes = fn()
        gbs = nbytes / dt / 1e9
        rows[name] = {"ms": dt * 1e3, "gbs": gbs, "share_of_copy":
                      gbs / copy_gbs}
    return {"copy_gbs": copy_gbs, "ops": rows,
            "sizes": {"2d": n2, "3d": n3, "fd_rows": n_fd * n_fd},
            "ok": True}


def phase_multi_gmg(n: int = 8192, num_levels: int = 10, tol: float = 1e-8,
                    devices: int = 4):
    """Four-card sharded GMG (schedule measured on the mesh) against the
    one-card solver."""
    from multigrid_prj_tpu.parallel.distributed import make_mesh

    return _sharded_vs_single((n, n), make_mesh(devices), num_levels, tol,
                              use_grouped="measure")


def phase_multi_amg(n_grid: int = 1024, num_levels: int = 8,
                    min_coarse: int = 2000, tol: float = 1e-8,
                    devices: int = 4, seed: int = 0):
    """Four-card sharded AMG against the one-card AMG with the same
    hierarchy (RCM order, Chebyshev smoothing), both in f64."""
    from multigrid_prj_tpu.parallel.distributed import make_mesh
    from multigrid_prj_tpu.parallel.sharded_amg import ShardedAMGSolver

    A = poisson_fd_csr(n_grid)
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    kw = dict(num_levels=num_levels, min_coarse=min_coarse,
              smoother="chebyshev", dtype=F64)
    sh, t_sh_setup = _timed(lambda: ShardedAMGSolver(
        A, make_mesh(devices), tol=tol, maxit=100, **kw))
    one, t_1_setup = _timed(lambda: AMGSolver(A, reorder="rcm", **kw))
    _, t_sh_first = _timed(lambda: sh.solve(b))
    (x_sh, it_sh, rel_sh), t_sh = _timed(lambda: sh.solve(b))
    _, t_1_first = _timed(lambda: one.solve(b, tol=tol, maxit=100))
    out_1, t_1 = _timed(lambda: one.solve(b, tol=tol, maxit=100))
    res_sh = csr_rel_residual(A, x_sh, b)
    res_1 = csr_rel_residual(A, out_1.x, b)
    diff = rel_diff(x_sh, out_1.x)
    res_tol = 2.0 * tol  # f64 device vs host residual: rounding only
    # same hierarchy and smoother: iterations within one (the padded rows'
    # no-op arithmetic), solutions within kappa_eff * the residuals
    # (kappa of the FD matrix ~ (2 n / pi)^2, times 2)
    diff_tol = 2.0 * (2.0 * n_grid / math.pi) ** 2 * (res_sh + res_1)
    return {"rows": A.shape[0], "devices": sh.p,
            "sharded_levels": sh.num_sharded, "levels": sh.level_sizes,
            "sharded_iterations": it_sh, "single_iterations": out_1.iterations,
            "sharded_host_rel_residual": res_sh,
            "single_host_rel_residual": res_1, "tol": res_tol,
            "rel_l2_diff": diff, "rel_l2_diff_tol": diff_tol,
            "sharded_setup_s": t_sh_setup, "single_setup_s": t_1_setup,
            "sharded_first_call_s": t_sh_first, "sharded_solve_s": t_sh,
            "single_first_call_s": t_1_first, "single_solve_s": t_1,
            "ok": bool(res_sh <= res_tol and res_1 <= res_tol
                       and abs(it_sh - out_1.iterations) <= 1
                       and diff <= diff_tol)}


DEFAULT_PHASES = (
    ("gmg2d", phase_gmg2d),
    ("gmg_cli", phase_gmg_cli),
    ("gmg3d", phase_gmg3d),
    ("amg_fd", phase_amg_fd),
    ("amg_fem", phase_amg_fem),
    ("sharded1", phase_sharded1),
    ("ops", phase_ops),
)
MULTI_PHASES = (
    ("multi_gmg", phase_multi_gmg),
    ("multi_amg", phase_multi_amg),
)


def run_phases(phases) -> bool:
    """Run each phase, print its JSON line; True iff every phase passed."""
    all_ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception as e:  # a phase that raises has failed; say how
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:1000],
                   "traceback": traceback.format_exc()[-3000:]}
        rec = {"phase": name, **rec,
               "phase_wall_s": time.perf_counter() - t0}
        print(json.dumps(rec, default=float), flush=True)
        all_ok &= bool(rec["ok"])
    return all_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {d0.platform!r}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    import bench

    cache_dir = enable_compile_cache()
    card = bench.gpu_info()
    print(json.dumps({"phase": "device", "platform": d0.platform,
                      "kind": d0.device_kind, "count": len(devices),
                      "card": card, "jax": jax.__version__,
                      "compile_cache": cache_dir, "ok": True}), flush=True)
    if args.multi:
        if len(devices) < 4:
            print(f"--multi needs 4 devices, found {len(devices)}",
                  file=sys.stderr)
            return 1
        ok = run_phases(MULTI_PHASES)
    else:
        ok = run_phases(DEFAULT_PHASES)
    print(card, flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
