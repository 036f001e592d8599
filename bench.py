"""Benchmark cells on one GPU: operator throughput, solve wall times and
AMG setup, one JSON line per cell.

Every line names the card (``device_kind``, device count, and the name and
power limit ``nvidia-smi`` reports).  A cell that fails records its error on
its own line; the other cells still run, and the process then exits 1.  The
script refuses to run without a GPU, and refuses a card whose memory
bandwidth is not in :data:`HBM_BW` instead of assuming one.

Times are host wall clock around work that ends in ``block_until_ready``,
after a warm-up call that compiles; each is the median of several repeats.

Cells:
  stencil_apply   dependent chain of 2D 5-point applies at 8192^2 (headline:
                  nnz/s, the reference's nnz accounting ``N + 4*interior``)
  copy            chained saxpy at 8192^2 f32: the copy rate measured in
                  the same run, which the operator rates are judged against
  vcycle_ff32     GMG 1025^2 to 1e-8, f32 V(2,2) cycles + ff32 refinement
  amg_fd          AMG on the 1M-row FD system: setup, f32 solve, PCG, ff32
  amg_fem         AMG-PCG on a P1 system of a generated 81x81-node mesh
                  (the size of the reference's mesh1)
  vcycle3d        257^3, bf16 smoothing + ff32 refinement to 1e-8
  ell_spmv        ELL SpMV on a 1M-row banded matrix
  stencil3d       3D 7-point apply chain at 256^3
  sharded1        sharded V-cycle on a one-device mesh vs the unsharded one
  ell_spmm        ELL SpMM with 4 vectors (A read once per block)
  spmv_16m        ELL SpMV at 16M rows

  python bench.py [--cells stencil_apply,copy,...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Peak device-memory bandwidth (bytes/s) by ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet (H100 SXM: 3.35 TB/s).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_bandwidth(kind: str) -> float:
    """Peak memory bandwidth of a ``device_kind``; unknown kinds raise."""
    try:
        return HBM_BW[kind]
    except KeyError:
        raise ValueError(
            f"no memory bandwidth on record for device kind {kind!r}; "
            "add it to bench.HBM_BW with its source") from None


def gpu_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def time_median(f, *args, reps: int = 5) -> float:
    """Median wall seconds of ``f(*args)`` after one warm-up call."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def chain(op, k: int):
    """jit of ``k`` dependent applications of ``op`` (one dispatch)."""
    return jax.jit(lambda v: jax.lax.fori_loop(0, k, lambda _, w: op(w), v))


def _field(shape, dtype=jnp.float32):
    """A smooth, nonzero test field made on the device."""
    @jax.jit
    def mk():
        i = jax.lax.broadcasted_iota(jnp.float32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.float32, shape, len(shape) - 1)
        return (1e-3 * jnp.sin(0.01 * i) * jnp.cos(0.013 * j)).astype(dtype)

    return mk()


# -- per-op timings (each returns seconds per op and bytes per op) -----------
#
# Bytes are the least traffic the op needs in f32: each operand read once,
# each result written once.  ``GB/s = bytes / seconds`` is then comparable
# with the copy rate.

def copy_op(n: int = 8192, k: int = 50):
    x = jnp.ones((n, n), jnp.float32)
    dt = time_median(chain(lambda v: 1.0000001 * v, k), x) / k
    return dt, 8.0 * n * n


def stencil_apply_op(n: int = 8193, k: int = 20):
    from multigrid_prj_tpu.ops.stencil import poisson_apply

    h = 10.0 / (n - 1)
    dt = time_median(chain(lambda v: poisson_apply(v, 10.0, h), k),
                     _field((n, n))) / k
    return dt, 8.0 * n * n


def rbgs_sweep_op(n: int = 8193, k: int = 10):
    from multigrid_prj_tpu.ops.smoothers import red_black_gauss_seidel

    h = 10.0 / (n - 1)
    b = _field((n, n))
    f = jax.jit(lambda u, bb: jax.lax.fori_loop(
        0, k, lambda _, w: red_black_gauss_seidel(w, bb, 10.0, h), u))
    dt = time_median(f, jnp.zeros_like(b), b) / k
    return dt, 12.0 * n * n  # read u, b; write u


def restrict_op(n: int = 8193, k: int = 10):
    from multigrid_prj_tpu.ops.transfer import restrict_full_weighting

    r = _field((n, n))
    nc = (n + 1) // 2
    # each restriction reads a scalar of the previous one, so the loop body
    # cannot be hoisted out of the loop; the scalar add fuses into the op
    f = jax.jit(lambda v: jax.lax.fori_loop(
        0, k, lambda _, rc: restrict_full_weighting(v + 1e-30 * rc[0, 0]),
        jnp.zeros((nc, nc), jnp.float32)))
    dt = time_median(f, r) / k
    return dt, 4.0 * (n * n + nc * nc)


def prolong_add_op(n: int = 8193, k: int = 10):
    from multigrid_prj_tpu.ops.transfer import prolong

    nc = (n + 1) // 2
    e = _field((nc, nc))
    f = jax.jit(lambda u, ee: jax.lax.fori_loop(
        0, k, lambda _, w: w + prolong(ee + 1e-30 * w[0, 0], (n, n)), u))
    dt = time_median(f, jnp.zeros((n, n), jnp.float32), e) / k
    return dt, 4.0 * (2 * n * n + nc * nc)  # read u, e; write u


def stencil3d_op(n: int = 257, k: int = 20):
    from multigrid_prj_tpu.ops.stencil import poisson_apply

    h = 1.0 / (n - 1)
    dt = time_median(chain(lambda v: poisson_apply(v, 1.0, h), k),
                     _field((n, n, n))) / k
    return dt, 8.0 * n ** 3


def ell_spmv_op(A, k: int = 50):
    from multigrid_prj_tpu.ops.sparse import ELLMatrix

    ell = ELLMatrix.from_host_csr(A, dtype=jnp.float32)
    n = A.shape[0]
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    # the matrix rides as an argument, never as a compile-time constant
    f = jax.jit(lambda m, v: jax.lax.fori_loop(
        0, k, lambda _, w: 0.125 * m.spmv(w), v))
    dt = time_median(f, ell, x) / k
    return dt, 8.0 * ell.nnz_dense + 8.0 * n, ell.nnz_dense


def ell_spmm_op(A, nvec: int = 4, k: int = 20):
    from multigrid_prj_tpu.ops.sparse import ELLMatrix

    ell = ELLMatrix.from_host_csr(A, dtype=jnp.float32)
    n = A.shape[0]
    X = jnp.asarray(np.random.default_rng(0).standard_normal((n, nvec)),
                    jnp.float32)
    f = jax.jit(lambda m, v: jax.lax.fori_loop(
        0, k, lambda _, w: 0.125 * m.spmm(w), v))
    dt = time_median(f, ell, X) / k
    return dt, 8.0 * ell.nnz_dense + 8.0 * n * nvec, ell.nnz_dense * nvec


# -- cells -------------------------------------------------------------------


def cell_stencil_apply(n: int = 8192, k: int = 50):
    dt, _ = stencil_apply_op(n, k)
    nnz = n * n + 4 * (n - 2) ** 2
    bw = device_bandwidth(jax.devices()[0].device_kind)
    roofline = bw / 8.0 * (nnz / (n * n))  # 8 B per point per apply
    return {"metric": "stencil_apply_nnz_per_s", "value": nnz / dt,
            "unit": "nnz/s", "ms_per_apply": dt * 1e3,
            "vs_baseline": (nnz / dt) / (0.8 * roofline)}


def cell_copy(n: int = 8192):
    dt, nbytes = copy_op(n)
    return {"copy_gbs": nbytes / dt / 1e9, "ms": dt * 1e3}


def _timed_solve(fn, reps: int = 3):
    fn()  # compile
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out.u)
        best = min(best, time.perf_counter() - t0)
    return best, out


def cell_vcycle_ff32(n: int = 1025, tol: float = 1e-8):
    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs

    solver = GMGSolver(shape=(n, n), length=10.0, alpha=10.0, num_levels=6,
                       cycle="v", nu=2, pre_sweeps=2, tol=tol, maxit=60)
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
    dt, out = _timed_solve(lambda: solver.solve_refined(b))
    return {"ms": dt * 1e3, "iters": out.iterations,
            "rel_residual": float(out.history[-1])}


def cell_vcycle3d(n: int = 257, tol: float = 1e-8):
    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs

    solver = GMGSolver(shape=(n, n, n), length=1.0, alpha=1.0, num_levels=5,
                       cycle="v", nu=2, pre_sweeps=2, tol=tol, maxit=60,
                       smoother_dtype=jnp.bfloat16)
    b = assemble_rhs(
        solver.levels[0], 1.0, dtype=jnp.float32,
        f=lambda x, y, z: jnp.sin(3.0 * x) * jnp.cos(2.0 * y) + z,
        g=lambda x, y, z: jnp.exp(x) * jnp.exp(-2.0 * y) * z)
    dt, out = _timed_solve(lambda: solver.solve_refined(b))
    return {"ms": dt * 1e3, "iters": out.iterations,
            "rel_residual": float(out.history[-1])}


def cell_amg_fd(n_grid: int = 1024):
    from benchmarks.amg_bench import bench_fd

    return bench_fd(n_grid)


def cell_amg_fem(n: int = 81):
    from benchmarks.amg_bench import bench_fem

    return bench_fem(n)


def cell_ell_spmv(n: int = 1 << 20):
    from benchmarks.spmv_bench import banded_csr

    dt, nbytes, slots = ell_spmv_op(banded_csr(n))
    return {"slots_per_s": slots / dt, "gbs": nbytes / dt / 1e9,
            "ms": dt * 1e3}


def cell_ell_spmm(n: int = 1 << 20, nvec: int = 4):
    from benchmarks.spmv_bench import banded_csr

    dt, nbytes, slots = ell_spmm_op(banded_csr(n), nvec)
    return {"nvec": nvec, "effective_slots_per_s": slots / dt,
            "gbs": nbytes / dt / 1e9, "ms": dt * 1e3}


def cell_spmv_16m(n: int = 16 << 20):
    from benchmarks.spmv_bench import banded_csr

    dt, nbytes, slots = ell_spmv_op(banded_csr(n), k=20)
    return {"rows": n, "slots_per_s": slots / dt, "gbs": nbytes / dt / 1e9,
            "ms": dt * 1e3}


def cell_stencil3d(n: int = 256):
    dt, nbytes = stencil3d_op(n)
    nnz = n ** 3 + 6 * (n - 2) ** 3
    return {"nnz_per_s": nnz / dt, "gbs": nbytes / dt / 1e9,
            "ms": dt * 1e3}


def cell_sharded1(n: int = 2048, k: int = 20):
    """Sharded V-cycle on a one-device mesh against the unsharded one: the
    cost of the shard_map formulation without any communication."""
    from jax.sharding import Mesh

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    sh = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=5, nu1=2,
                          nu2=2, maxit=2, tol=0.0)
    b = assemble_rhs(sh.levels[0], 10.0, test=1, dtype=jnp.float32)
    bs = jax.device_put(b, sh.sharding)
    f_sh = jax.jit(lambda u, bb: jax.lax.fori_loop(
        0, k, lambda _, w: sh._jit_step(w, bb), u))
    un = GMGSolver(shape=(n, n), num_levels=5, cycle="v", nu=2,
                   pre_sweeps=2, tol=0.0, maxit=2)
    f_un = jax.jit(lambda u, bb: jax.lax.fori_loop(
        0, k, lambda _, w: un.step(w, bb), u))
    d_sh = time_median(f_sh, jnp.zeros_like(bs), bs) / k
    d_un = time_median(f_un, jnp.zeros_like(b), b) / k
    return {"sharded_ms": d_sh * 1e3, "unsharded_ms": d_un * 1e3,
            "overhead_ratio": d_sh / d_un}


CELLS = {
    "stencil_apply": cell_stencil_apply,
    "copy": cell_copy,
    "vcycle_ff32": cell_vcycle_ff32,
    "amg_fd": cell_amg_fd,
    "amg_fem": cell_amg_fem,
    "vcycle3d": cell_vcycle3d,
    "ell_spmv": cell_ell_spmv,
    "stencil3d": cell_stencil3d,
    "sharded1": cell_sharded1,
    "ell_spmm": cell_ell_spmm,
    "spmv_16m": cell_spmv_16m,
}


def main(argv=None) -> int:
    from multigrid_prj_tpu.utils.cache import enable_compile_cache

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)
    names = [c.strip() for c in args.cells.split(",") if c.strip()]
    unknown = [c for c in names if c not in CELLS]
    if unknown:
        ap.error(f"unknown cells {unknown}; known: {list(CELLS)}")

    dev = device_record()
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev['platform']!r}",
              file=sys.stderr)
        return 2
    device_bandwidth(dev["kind"])  # refuse an unknown card up front
    enable_compile_cache()
    card = gpu_info()

    failed = []
    for name in names:
        rec = {"cell": name, "device": dev, "card": card}
        t0 = time.perf_counter()
        try:
            rec.update(CELLS[name]())
        except Exception as e:  # a failed cell must not hide the others
            rec["error"] = f"{type(e).__name__}: {e}"[:500]
            failed.append(name)
        rec["cell_wall_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
