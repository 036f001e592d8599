"""Stationary smoothers for the Poisson stencil system.

Capability parity with the reference smoothers:

* ``Gauss_Seidel_iteration`` (``GeometricMultigrid/include/solvers.hpp:24-49``)
  — the reference sweeps lexicographically in place, which is inherently
  sequential.  The data-parallel equivalent is **red-black Gauss-Seidel**: the
  5/7-point stencil is 2-colorable, so each color's update is an independent
  vectorised half-sweep (two fused array passes per sweep).  Smoothing quality
  on Poisson matches or beats lexicographic GS (validated against the
  reference's convergence histories in ``tests/test_gmg_convergence.py``).
* ``Jacobi_iteration`` (``solvers.hpp:53-84``) — the reference's Jacobi is
  unweighted (``omega = 1``); ``omega`` is exposed because damped Jacobi
  (``omega ~ 0.8`` in 2D) is the standard multigrid smoother.

Both smoothers force Dirichlet rows to ``u = b`` exactly as the reference does
(boundary rows are identity with unit diagonal, ``solvers.hpp:37-46``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from multigrid_prj_tpu.ops.stencil import boundary_mask, neighbor_sum

# Sweep counts above this roll up into a lax.fori_loop instead of unrolling,
# keeping trace/compile time bounded for long stationary solves.
_UNROLL_LIMIT = 8


def _run_sweeps(one_sweep, u, sweeps: int):
    if sweeps <= _UNROLL_LIMIT:
        for _ in range(sweeps):
            u = one_sweep(u)
        return u
    return jax.lax.fori_loop(0, sweeps, lambda _, v: one_sweep(v), u)


def jacobi(
    u: jax.Array,
    b: jax.Array,
    alpha: float,
    h: float,
    omega: float = 1.0,
    sweeps: int = 1,
    logical_shape=None,
) -> jax.Array:
    """``sweeps`` damped-Jacobi sweeps on ``A u = b``.

    Interior update: ``u <- (1-omega) u + omega (b/c + sum(neigh)) / (2*ndim)``
    with ``c = alpha/h^2``; boundary rows: ``u <- b``.
    """
    c = alpha / (h * h)
    denom = 2.0 * u.ndim
    bmask = boundary_mask(u.shape, logical_shape)
    b_over_c = b / c

    def one_sweep(u):
        u_new = (b_over_c + neighbor_sum(u)) / denom
        if omega != 1.0:
            u_new = (1.0 - omega) * u + omega * u_new
        return jnp.where(bmask, b, u_new)

    return _run_sweeps(one_sweep, u, sweeps)


def red_black_gauss_seidel(
    u: jax.Array,
    b: jax.Array,
    alpha: float,
    h: float,
    sweeps: int = 1,
    omega: float = 1.0,
    logical_shape=None,
) -> jax.Array:
    """``sweeps`` red-black Gauss-Seidel sweeps on ``A u = b``.

    Each sweep updates the red checkerboard color from the current iterate and
    then the black color from the freshly updated reds — the parallel
    equivalent of the reference's in-place sweep (``solvers.hpp:33-48``).
    ``omega != 1`` gives red-black SOR.
    """
    c = alpha / (h * h)
    denom = 2.0 * u.ndim
    shape = u.shape
    bmask = boundary_mask(shape, logical_shape)
    parity = None
    for ax in range(u.ndim):
        idx = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        parity = idx if parity is None else parity + idx
    parity = parity % 2
    b_over_c = b / c

    def one_sweep(u):
        for color in (0, 1):
            u_new = (b_over_c + neighbor_sum(u)) / denom
            if omega != 1.0:
                u_new = (1.0 - omega) * u + omega * u_new
            upd = (parity == color) & ~bmask
            u = jnp.where(upd, u_new, u)
            u = jnp.where(bmask, b, u)
        return u

    return _run_sweeps(one_sweep, u, sweeps)


def make_smoother(name: str, **kw):
    """Smoother factory: ``f(u, b, alpha, h, sweeps) -> u``.

    Names mirror the reference's ``-smt`` choices
    (``GeometricMultigrid/include/utilities.hpp:9-14``).
    """
    name = name.lower()
    if name in ("gs", "gauss_seidel", "rbgs", "red_black"):
        omega = kw.get("omega", 1.0)

        def f(u, b, alpha, h, sweeps=1, logical_shape=None):
            return red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                          omega=omega,
                                          logical_shape=logical_shape)

        return f
    if name == "jacobi":
        omega = kw.get("omega", 1.0)

        def f(u, b, alpha, h, sweeps=1, logical_shape=None):
            return jacobi(u, b, alpha, h, omega=omega, sweeps=sweeps,
                          logical_shape=logical_shape)

        return f
    raise ValueError(f"unknown smoother {name!r}")
