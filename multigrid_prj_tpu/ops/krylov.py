"""Krylov solvers: BiCGSTAB and CG as ``lax.while_loop`` iterations.

Parity with the reference ``BiCGSTAB``
(``GeometricMultigrid/include/solvers.hpp:86-216``): unpreconditioned
BiCGSTAB with relative tolerance ``1e-11`` and ``maxit = n`` by default,
stopping on breakdown of ``rho`` or ``omega``.  This version is
matrix-free (``A`` is any callable) and adds optional right preconditioning
(``M``), which is how a multigrid cycle becomes a Krylov preconditioner —
the sane replacement for the reference's quirk of running BiCGSTAB in the
smoother slot (and the ``-smt 2`` bug noted in SURVEY.md §7.5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass
class KrylovResult:
    x: jax.Array
    iterations: int
    rel_residual: float
    converged: bool
    # per-iteration relative residual norms ([initial, after it 1, ...]);
    # only populated when the solver was called with history=True
    history: Optional[jax.Array] = None


def _dot(a, b):
    # HIGHEST: a float32 dot may otherwise run in TF32 on GPUs
    return jnp.vdot(a.reshape(-1), b.reshape(-1),
                    precision=jax.lax.Precision.HIGHEST)


def bicgstab(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-11,
    maxit: Optional[int] = None,
    M: Optional[Callable[[jax.Array], jax.Array]] = None,
    history: bool = False,
    hist_cap: Optional[int] = None,
) -> KrylovResult:
    """Preconditioned BiCGSTAB for ``A x = b``; returns :class:`KrylovResult`.

    ``M`` approximates ``A^{-1}`` (identity if omitted — the reference's
    configuration).  All control flow is a single ``lax.while_loop``.
    ``history=True`` records the per-iteration relative residual norms
    inside the loop (the reference's ``MGGS4.txt``-style artifact the web
    chart plots, ``WebInterface/home.php:136-198``).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if maxit is None:
        maxit = b.size
    if M is None:
        M = lambda r: r
    eps = jnp.finfo(b.dtype).tiny * 1e4

    bnorm = jnp.sqrt(_dot(b, b).real)
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
    r0 = b - A(x0)
    rhat = r0
    hist_len = (hist_cap if hist_cap is not None else maxit) + 1
    hist0 = jnp.full((hist_len,) if history else (1,), jnp.nan, b.dtype)
    hist0 = hist0.at[0].set(jnp.sqrt(_dot(r0, r0).real) / bnorm)

    def cond(st):
        _, r, *_, k, ok, _h = st
        rn = jnp.sqrt(_dot(r, r).real)
        return (k < maxit) & (rn > tol * bnorm) & ok

    def body(st):
        x, r, p, v, rho, alpha, omega, k, ok, hist = st
        rho1 = _dot(rhat, r)
        beta = (rho1 / jnp.where(jnp.abs(rho) > eps, rho, eps)) * (
            alpha / jnp.where(jnp.abs(omega) > eps, omega, eps)
        )
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        denom = _dot(rhat, v)
        alpha = rho1 / jnp.where(jnp.abs(denom) > eps, denom, eps)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / jnp.where(jnp.abs(tt) > eps, tt, eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        ok = (jnp.abs(rho1) > eps) & (jnp.abs(omega) > eps)
        if history:
            idx = k + 1 if hist_cap is None else jnp.minimum(k + 1, hist_cap)
            hist = hist.at[idx].set(jnp.sqrt(_dot(r, r).real) / bnorm)
        return x, r, p, v, rho1, alpha, omega, k + 1, ok, hist

    one = jnp.asarray(1.0, dtype=b.dtype)
    state = (
        x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
        one, one, one, jnp.int32(0), jnp.bool_(True), hist0,
    )
    x, r, *_, k, _ok, hist = lax.while_loop(cond, body, state)
    rel = jnp.sqrt(_dot(r, r).real) / bnorm
    k = int(k)
    return KrylovResult(
        x=x,
        iterations=k,
        rel_residual=float(rel),
        converged=bool(rel <= tol),
        history=hist[: k + 1] if history else None,
    )


def cg(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-11,
    maxit: Optional[int] = None,
    M: Optional[Callable[[jax.Array], jax.Array]] = None,
    history: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD ``A`` (framework extension)."""
    if maxit is None:
        maxit = b.size
    x, k, rel, hist = cg_arrays(A, b, x0=x0, tol=tol, maxit=maxit, M=M,
                                history=history)
    k = int(k)
    rel = float(rel)
    return KrylovResult(x=x, iterations=k, rel_residual=rel,
                        converged=bool(rel <= tol),
                        history=hist[: k + 1] if history else None)


def cg_arrays(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-11,
    maxit: int = 100,
    M: Optional[Callable[[jax.Array], jax.Array]] = None,
    history: bool = False,
    hist_cap: Optional[int] = None,
) -> tuple:
    """Jit-friendly CG core: returns ``(x, k, rel, hist)`` as arrays.

    Callers that jit a surrounding function (passing operator data as
    arguments so it is not baked into the executable as constants —
    ``AMGSolver.solve_pcg``) use this; :func:`cg` wraps it into a
    :class:`KrylovResult` on the host.

    ``hist_cap``: static history-buffer length.  When set, ``maxit`` may be
    a TRACED scalar (no recompile per distinct maxit); history writes past
    the cap clamp into the last slot (callers surface this as
    ``history_truncated``).  When None, ``maxit`` must be static and the
    buffer holds every iteration.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if M is None:
        M = lambda r: r
    bnorm = jnp.sqrt(_dot(b, b).real)
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)
    r0 = b - A(x0)
    z0 = M(r0)
    hist_len = (hist_cap if hist_cap is not None else maxit) + 1
    hist0 = jnp.full((hist_len,) if history else (1,), jnp.nan, b.dtype)
    hist0 = hist0.at[0].set(jnp.sqrt(_dot(r0, r0).real) / bnorm)

    def cond(st):
        _, r, *_rest, k, _h = st
        rn = jnp.sqrt(_dot(r, r).real)
        return (k < maxit) & (rn > tol * bnorm)

    def body(st):
        x, r, z, p, rz, k, hist = st
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz1 = _dot(r, z)
        p = z + (rz1 / rz) * p
        if history:
            idx = k + 1 if hist_cap is None else jnp.minimum(k + 1, hist_cap)
            hist = hist.at[idx].set(jnp.sqrt(_dot(r, r).real) / bnorm)
        return x, r, z, p, rz1, k + 1, hist

    state = (x0, r0, z0, z0, _dot(r0, z0), jnp.int32(0), hist0)
    x, r, *_rest, k, hist = lax.while_loop(cond, body, state)
    rel = jnp.sqrt(_dot(r, r).real) / bnorm
    return x, k, rel, hist
