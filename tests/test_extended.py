"""Float-float extended precision: EFT building blocks and the refined
solver reaching below the plain-f32 residual floor."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.models.poisson import assemble_rhs
from multigrid_prj_tpu.ops.extended import (
    ff_add,
    ff_from_div,
    ff_poisson_residual,
    two_sum,
)


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


def test_two_sum_exact():
    # values chosen so a + b is inexact in f32
    a, b = _f32(1.0e8), _f32(1.0 + 2 ** -10)
    s, e = two_sum(a, b)
    exact = float(np.float64(float(a)) + np.float64(float(b)))
    assert float(np.float64(float(s)) + np.float64(float(e))) == exact


def test_ff_add_accuracy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32) * 1e6
    y = rng.standard_normal(1000).astype(np.float32) * 1e-3
    hi, lo = ff_add(_f32(x), jnp.zeros(1000, jnp.float32), _f32(y),
                    jnp.zeros(1000, jnp.float32))
    got = np.float64(np.asarray(hi)) + np.float64(np.asarray(lo))
    want = np.float64(x) + np.float64(y)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_ff_residual_beats_f32_floor():
    """The extended residual of a near-exact solution is orders of magnitude
    below what the plain f32 residual reports (which is pure roundoff)."""
    n, alpha = 257, 10.0
    h = 10.0 / (n - 1)
    solver = GMGSolver(shape=(n, n), num_levels=5, cycle="v", nu=2,
                       pre_sweeps=2, tol=1e-9, maxit=40)
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=jnp.float32)
    out = solver.solve_refined(b)
    assert out.converged and float(out.history[-1]) <= 1e-9

    from multigrid_prj_tpu.ops.residual import rel_residual_norm

    plain_floor = float(rel_residual_norm(jnp.asarray(out.u, jnp.float32),
                                          b, alpha, h))
    # the plain f32 residual of the SAME solution reads ~eps*kappa ~ 4e-4
    assert plain_floor > 50 * float(out.history[-1])


def test_refined_matches_f64(monkeypatch):
    n = 129
    s32 = GMGSolver(shape=(n, n), num_levels=4, cycle="v", nu=2, pre_sweeps=2,
                    tol=1e-9, maxit=40)
    b32 = assemble_rhs(s32.levels[0], 10.0, test=1, dtype=jnp.float32)
    r32 = s32.solve_refined(b32)
    assert r32.converged
    s64 = GMGSolver(shape=(n, n), num_levels=4, cycle="v", nu=2, pre_sweeps=2,
                    tol=1e-11, maxit=40)
    b64 = assemble_rhs(s64.levels[0], 10.0, test=1, dtype=jnp.float64)
    r64 = s64.solve(b64)
    d = np.abs(np.float64(np.asarray(r32.u)) - np.asarray(r64.u)).max()
    assert d / np.abs(np.asarray(r64.u)).max() < 1e-5


def test_refined_with_padded_layout():
    n = 129
    s = GMGSolver(shape=(n, n), num_levels=4, cycle="v", nu=2, pre_sweeps=2,
                  tol=1e-9, maxit=40, pad_align=64)
    b = assemble_rhs(s.levels[0], 10.0, test=1, dtype=jnp.float32)
    out = s.solve_refined(b)
    assert out.converged and out.u.shape == (n, n)


def test_refined_inner_cg_converges_fewer_outer_iters():
    """inner_cg=k wraps each refinement step's correction in k iterations of
    MG-preconditioned CG: same solution, at most as many
    outer iterations as the plain refined solve (fewer extended-residual
    evaluations)."""
    n = 257
    s = GMGSolver(shape=(n, n), num_levels=5, cycle="v", nu=2, pre_sweeps=2,
                  tol=1e-9, maxit=40)
    b = assemble_rhs(s.levels[0], 10.0, test=1, dtype=jnp.float32)
    plain = s.solve_refined(b)
    accel = s.solve_refined(b, inner_cg=3)
    assert accel.converged
    assert accel.iterations <= plain.iterations
    d = np.abs(np.asarray(accel.u) - np.asarray(plain.u)).max()
    assert d / np.abs(np.asarray(plain.u)).max() < 1e-6
