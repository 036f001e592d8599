"""End-to-end GMG convergence tests pinned to the reference's behavior:
relative residual 1 -> ~1e-12 in <= ~13 outer iterations with per-iteration
reduction factor rho ~ 0.1 (``GeometricMultigrid/test/MGGS4.txt``,
SURVEY.md §6)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.models.poisson import assemble_rhs
from tests.test_stencil import dense_poisson_2d

REF_X_MTX = "/root/reference/GeometricMultigrid/test/x.mtx"


def make_problem(n=65, levels=4, alpha=10.0, width=10.0, test=1, **kw):
    solver = GMGSolver(
        shape=(n, n), length=width, alpha=alpha, num_levels=levels, **kw
    )
    b = assemble_rhs(solver.levels[0], width, test=test, dtype=jnp.float64)
    return solver, b


@pytest.mark.parametrize("test", [0, 1, 2])
def test_sawtooth_converges_like_reference(test):
    solver, b = make_problem(test=test)
    out = solver.solve(b)
    assert out.converged
    assert out.iterations <= 15, f"took {out.iterations} iterations"
    # asymptotic reduction factor from the interior of the history; the
    # reference measures rho ~ 0.09-0.10 (MGGS4.txt, BASELINE.md:12) and
    # this solver measures 0.062-0.085 across the three test problems —
    # 0.15 catches any real cycle-quality regression without flaking
    h = np.asarray(out.history)
    rho = (h[-1] / h[1]) ** (1.0 / (len(h) - 2))
    assert rho <= 0.15, f"rho = {rho}"


def test_solution_matches_dense_solve():
    solver, b = make_problem(n=33, levels=3)
    out = solver.solve(b)
    A = dense_poisson_2d(33, 10.0, solver.levels[0].h)
    want = np.linalg.solve(A, np.asarray(b).reshape(-1))
    got = np.asarray(out.u).reshape(-1)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-9, rel


@pytest.mark.parametrize("cycle,smoother", [
    ("v", "gs"), ("w", "gs"), ("v", "jacobi"),
])
def test_standard_cycles_converge(cycle, smoother):
    kw = {"omega": 0.8} if smoother == "jacobi" else {}
    solver, b = make_problem(cycle=cycle, smoother=smoother, nu=2, **kw)
    out = solver.solve(b)
    assert out.converged
    assert out.iterations <= 25


def test_jacobi_sawtooth_converges():
    solver, b = make_problem(smoother="jacobi", omega=0.8)
    out = solver.solve(b)
    assert out.converged


def test_history_starts_at_one():
    """u0 = 0 => first history entry ||b||/||b|| = 1 (reference MGGS4.txt:2)."""
    solver, b = make_problem()
    out = solver.solve(b)
    np.testing.assert_allclose(float(out.history[0]), 1.0, rtol=1e-12)


@pytest.mark.slow
@pytest.mark.skipif(not os.path.exists(REF_X_MTX), reason="reference artifact absent")
def test_matches_reference_solution_artifact():
    """Converge the N=385 test-1 system and compare to the solution vector the
    reference checked in (``GeometricMultigrid/test/x.mtx``).  Both solve the
    same discrete system to 1e-11, so they agree to the artifact's precision."""
    from multigrid_prj_tpu.utils.io import load_vector

    ref = load_vector(REF_X_MTX)
    assert ref.size == 385 * 385
    # The artifact is a test-0 run (g = 0 on the boundary -- the vector's
    # boundary entries are exactly 0; test 1's boundary peaks at e^10) with
    # alpha = 1 (max value 7.3671 = 0.0737 * w^2 / alpha for -alpha*lap(u)=1
    # on [0,10]^2).
    solver, b = make_problem(n=385, levels=4, alpha=1.0, test=0)
    out = solver.solve(b)
    assert out.converged
    got = np.asarray(out.u).reshape(-1)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-5


def test_bicgstab_mg_preconditioned_converges():
    """The -smt 2 CLI path: MG-preconditioned BiCGSTAB (cli/gmg_main.py:79).
    Regression for a hist_cap NameError — every call
    raised before the fix."""
    from multigrid_prj_tpu.ops.krylov import bicgstab
    from multigrid_prj_tpu.ops.stencil import poisson_apply

    solver, b = make_problem(n=65, levels=4)
    h0 = solver.levels[0].h
    A = lambda x: poisson_apply(x, solver.alpha, h0)
    M = lambda r: solver.step(jnp.zeros_like(r), r)
    res = bicgstab(A, b, tol=1e-11, maxit=50, M=M, history=True)
    assert res.converged
    assert res.iterations <= 10
    assert res.history is not None and len(res.history) == res.iterations + 1


def test_direct_coarse_solve_matches_smoothed():
    """coarse="direct" (precomputed dense inverse bottom solve, the default
    for v/w cycles) must converge at least as fast as the 100-sweep coarse
    smoother and reach the same solution."""
    kw = dict(shape=(65, 65), num_levels=4, cycle="v", nu=2, pre_sweeps=2,
              tol=1e-11)
    b = None
    outs = {}
    for mode in ("direct", "smooth"):
        s = GMGSolver(coarse=mode, **kw)
        assert (s._coarse_inv is not None) == (mode == "direct")
        if b is None:
            b = assemble_rhs(s.levels[0], 10.0, test=1, dtype=jnp.float64)
        outs[mode] = s.solve(b)
    assert outs["direct"].converged
    assert outs["direct"].iterations <= outs["smooth"].iterations
    np.testing.assert_allclose(np.asarray(outs["direct"].u),
                               np.asarray(outs["smooth"].u),
                               rtol=1e-8, atol=1e-12)
