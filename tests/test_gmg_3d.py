"""3D Poisson GMG: the stencil/transfer/cycle stack is dimension-generic
(BASELINE.json config 4's 7-point stencil path)."""

import numpy as np
import pytest

import jax.numpy as jnp

from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.models.poisson import grid_coords
from multigrid_prj_tpu.ops.residual import rel_residual_norm
from multigrid_prj_tpu.ops.stencil import boundary_mask
from tests.test_stencil import dense_poisson_3d

N, LEN, ALPHA = 17, 1.0, 2.0


def rhs_3d(shape, length, dtype=jnp.float64):
    x, y, z = grid_coords(shape, length, dtype=dtype)
    g = jnp.exp(x) * jnp.exp(-2.0 * y) * z
    f = jnp.sin(3.0 * x) * jnp.cos(2.0 * y) + z
    return jnp.where(boundary_mask(shape), g, f)


def test_3d_solver_converges_and_matches_dense():
    solver = GMGSolver(shape=(N, N, N), length=LEN, alpha=ALPHA, num_levels=3,
                       cycle="v", nu=2, pre_sweeps=2, tol=1e-10, maxit=50)
    b = rhs_3d((N, N, N), LEN)
    out = solver.solve(b)
    assert out.converged, np.asarray(out.history)[:6]
    assert out.iterations <= 20
    A = dense_poisson_3d(N, ALPHA, solver.levels[0].h)
    want = np.linalg.solve(A, np.asarray(b).reshape(-1))
    got = np.asarray(out.u).reshape(-1)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-8, rel


def test_3d_sawtooth_converges():
    solver = GMGSolver(shape=(N, N, N), length=LEN, alpha=ALPHA, num_levels=3,
                       cycle="sawtooth", tol=1e-10, maxit=60)
    out = solver.solve(rhs_3d((N, N, N), LEN))
    assert out.converged


def test_mixed_precision_smoothing():
    """bf16 smoothing with f32 residuals converges to ~f32 floor."""
    solver = GMGSolver(shape=(33, 33), length=10.0, alpha=10.0, num_levels=3,
                       cycle="v", nu=2, pre_sweeps=2, tol=5e-5, maxit=60,
                       smoother_dtype=jnp.bfloat16)
    from multigrid_prj_tpu.models.poisson import assemble_rhs

    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
    out = solver.solve(b)
    assert out.converged, np.asarray(out.history)[-3:]
    assert float(rel_residual_norm(out.u, b, 10.0, solver.levels[0].h)) < 5e-5


def test_3d_mixed_precision_refined_solve():
    """BASELINE config 4 (CPU-sized pin): 3D 7-point, bf16 smoothing +
    f32 residuals, ff32 outer refinement to 1e-8.  The full-size 257^3
    solve runs on the GPU in ``chip_smoke.py``; this pins the iteration
    count and tolerance at a CI-sized 33^3 so a convergence regression in
    the mixed-precision path fails fast."""
    n = 33
    solver = GMGSolver(shape=(n, n, n), length=1.0, alpha=1.0, num_levels=3,
                       cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=40,
                       smoother_dtype=jnp.bfloat16)
    b = jnp.asarray(rhs_3d((n, n, n), 1.0), jnp.float32)
    out = solver.solve_refined(b)
    assert out.converged, np.asarray(out.history)[-3:]
    assert out.iterations <= 15, out.iterations
    assert float(out.history[-1]) <= 1e-8
