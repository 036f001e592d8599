"""Matrix-free Poisson stencil operator (5-point in 2D, 7-point in 3D).

Capability parity with the reference's ``PoissonMatrix``
(``GeometricMultigrid/include/linear_system.hpp:11-79``):

* boundary rows are Dirichlet identity rows (``linear_system.hpp:24-25``),
* interior diagonal is ``2 * ndim * alpha / h^2`` (``:27-28``),
* interior off-diagonals are ``-alpha / h^2`` for the axis neighbors
  (``:37-38``).

Design: the operator is never materialised.  It is applied as a fused
elementwise pass over the dense ``(n, ..., n)`` grid array built from
shifted zero-padded slices — XLA fuses the shifts, the select against the
boundary mask, and any surrounding axpy into one loop, so one apply
streams ``u`` once from device memory and writes the result once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def boundary_mask(shape: tuple[int, ...], logical_shape=None) -> jax.Array:
    """Boolean mask of Dirichlet boundary nodes (any index 0 or n-1).

    Matches ``SquareDomain::isOnBoundary`` (``domain.cpp:20-23``).

    ``logical_shape``: when the array is a tile-aligned padded buffer, the
    live grid occupies ``[0, logical)`` per axis; indices at or beyond
    ``logical - 1`` are treated as boundary, which pins the entire dead zone
    to identity rows (the aligned-layout invariant: dead values stay at
    ``b``, which is zero there).
    """
    logical = tuple(logical_shape) if logical_shape is not None else shape
    m = None
    for ax, n in enumerate(shape):
        idx = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        edge = (idx == 0) | (idx >= logical[ax] - 1)
        m = edge if m is None else (m | edge)
    return m


def interior_mask(shape: tuple[int, ...]) -> jax.Array:
    return ~boundary_mask(shape)


def _shift_fill_zero(u: jax.Array, axis: int, offset: int) -> jax.Array:
    """``u`` shifted by ``offset`` along ``axis``; vacated entries are zero.

    ``offset=+1`` returns the value of the neighbor at ``index+1``.
    """
    ndim = u.ndim
    sl = [slice(None)] * ndim
    pad = [(0, 0)] * ndim
    if offset == +1:
        sl[axis] = slice(1, None)
        pad[axis] = (0, 1)
    elif offset == -1:
        sl[axis] = slice(None, -1)
        pad[axis] = (1, 0)
    else:
        raise ValueError(f"offset must be +-1, got {offset}")
    return jnp.pad(u[tuple(sl)], pad)


def neighbor_sum(u: jax.Array) -> jax.Array:
    """Sum of the 2*ndim axis neighbors, zero beyond the grid edge.

    Only consumed at interior nodes (boundary rows are identity), so the
    zero-fill at edges is exact.
    """
    total = None
    for ax in range(u.ndim):
        t = _shift_fill_zero(u, ax, +1) + _shift_fill_zero(u, ax, -1)
        total = t if total is None else total + t
    return total


def poisson_diag(ndim: int, alpha: float, h: float) -> float:
    """Interior diagonal ``2 * ndim * alpha / h^2`` (``linear_system.hpp:27-28``)."""
    return 2.0 * ndim * alpha / (h * h)


def poisson_apply(u: jax.Array, alpha: float, h: float,
                  logical_shape=None) -> jax.Array:
    """``y = A u`` for the Dirichlet Poisson operator.

    Boundary rows: ``y = u`` (identity).  Interior:
    ``y = (alpha / h^2) * (2 * ndim * u - sum(neighbors))``.
    """
    c = alpha / (h * h)
    interior = c * (2.0 * u.ndim * u - neighbor_sum(u))
    return jnp.where(boundary_mask(u.shape, logical_shape), u, interior)


def poisson_residual(u: jax.Array, b: jax.Array, alpha: float, h: float,
                     logical_shape=None) -> jax.Array:
    """``r = b - A u`` including boundary rows (``r = b - u`` there).

    Matches the reference ``Residual`` masked computation
    (``solvers.hpp:257-295``).
    """
    return b - poisson_apply(u, alpha, h, logical_shape)


@functools.partial(jax.jit, static_argnames=("alpha", "h"))
def poisson_apply_jit(u: jax.Array, alpha: float, h: float) -> jax.Array:
    return poisson_apply(u, alpha, h)
