"""Grid-transfer operators: restriction and prolongation.

Capability parity with the reference:

* Restriction in the reference is **injection**: every level reads the shared
  full-length residual vector through its index mask
  (``multigrid.hpp:112-114`` smooths ``A_level[j] err = res`` where ``res``
  is the finest residual accessed at the level's masked nodes), i.e.
  ``r_coarse = r_fine[::2, ::2]``.  ``restrict_inject`` reproduces that.
  ``restrict_full_weighting`` is the standard [1/4, 1/2, 1/4]-per-axis
  restriction used by the textbook V/W cycles this framework adds.
* Prolongation (``InterpolationClass::interpolate``,
  ``GeometricMultigrid/src/multigrid.cpp:3-27``): coarse values are shared
  in place (injection on coincident nodes), vertical midpoints are averaged
  (pass 1), then rows are filled horizontally (pass 2) — i.e. bilinear
  interpolation.  ``prolong`` implements exactly that as an axis-by-axis
  linear refinement (bilinear in 2D, trilinear in 3D).

Design: both directions are strided-slice / interleave array ops that XLA
fuses into loops over the grid — no index masks, no scalar loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def restrict_inject(r: jax.Array) -> jax.Array:
    """Injection: sample every other node per axis (the reference's mask read).

    On even axes the high-side coarse edge is a fake boundary (see
    :func:`_fw_axis`); it is zeroed for the same stability reason.
    """
    out = r[(slice(None, None, 2),) * r.ndim]
    for ax, n in enumerate(r.shape):
        if n % 2 == 0:
            sl = [slice(None)] * r.ndim
            sl[ax] = slice(-1, None)
            pad_sl = [slice(None)] * r.ndim
            pad_sl[ax] = slice(None, -1)
            out = jnp.concatenate(
                [out[tuple(pad_sl)], jnp.zeros_like(out[tuple(sl)])], axis=ax
            )
    return out


def _fw_axis(a: jax.Array, axis: int) -> jax.Array:
    """Full-weighting restriction along one axis.

    Odd ``n`` (the 2^k+1 case): coarse interior point ``2i`` gets
    ``0.25 a[2i-1] + 0.5 a[2i] + 0.25 a[2i+1]``; both edge points are
    injected (they sit on the fine Dirichlet boundary).

    Even ``n``: the high-side coarse edge does NOT coincide with a fine
    Dirichlet row — it is a *fake* boundary of the coarse grid.  The coarse
    operator treats its edge rows as identity, so whatever lands there is
    pinned verbatim into the error and re-amplified every cycle (measured:
    divergence at ~1e5x/cycle on a 128^2 4-level V-cycle).  Zeroing the
    fake-edge coarse row keeps the cycle a contraction (the correction just
    has a homogeneous-Dirichlet dent one fine cell inside the domain, which
    post-smoothing repairs).  Odd grids remain the quality path.
    """
    n = a.shape[axis]

    def ax_slice(lo, hi, step=1):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(lo, hi, step)
        return a[tuple(sl)]

    if n % 2 == 0:
        interior = (
            0.25 * ax_slice(1, n - 3, 2)
            + 0.5 * ax_slice(2, n - 2, 2)
            + 0.25 * ax_slice(3, n - 1, 2)
        )
        first = ax_slice(0, 1)
        fake_edge = jnp.zeros_like(first)
        return jnp.concatenate([first, interior, fake_edge], axis=axis)

    interior = (
        0.25 * ax_slice(1, n - 2, 2)
        + 0.5 * ax_slice(2, n - 1, 2)
        + 0.25 * ax_slice(3, n, 2)
    )
    first = ax_slice(0, 1)
    last = ax_slice(n - 1, n)
    return jnp.concatenate([first, interior, last], axis=axis)


def restrict_full_weighting(r: jax.Array) -> jax.Array:
    """Tensor-product full weighting (edge nodes injected)."""
    for ax in range(r.ndim):
        r = _fw_axis(r, ax)
    return r


def _refine_axis(a: jax.Array, axis: int, target: int) -> jax.Array:
    """Linear refinement along ``axis`` from ``n`` to ``target`` nodes.

    ``target = 2n - 1``: even outputs inject, odd outputs average neighbors —
    the reference's two-pass scheme (``multigrid.cpp:4-26``).  ``target = 2n``
    additionally clamps one extra trailing node (general-``n`` support).
    """
    n = a.shape[axis]
    if target == n:
        return a

    def ax_slice(lo, hi):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(lo, hi)
        return a[tuple(sl)]

    if target not in (2 * n - 1, 2 * n):
        raise ValueError(f"cannot refine axis of size {n} to {target}")
    head = ax_slice(0, n - 1)
    mid = 0.5 * (head + ax_slice(1, n))
    # Interleave head/mid -> [a0, m0, a1, m1, ..., a_{n-2}, m_{n-2}]
    stacked = jnp.stack([head, mid], axis=axis + 1)
    new_shape = list(a.shape)
    new_shape[axis] = 2 * (n - 1)
    inter = stacked.reshape(new_shape)
    out = jnp.concatenate([inter, ax_slice(n - 1, n)], axis=axis)
    if target == 2 * n:
        out = jnp.concatenate([out, ax_slice(n - 1, n)], axis=axis)
    return out


def prolong(e: jax.Array, fine_shape: tuple[int, ...]) -> jax.Array:
    """Bilinear/trilinear prolongation of ``e`` to ``fine_shape``."""
    if len(fine_shape) != e.ndim:
        raise ValueError("rank mismatch")
    for ax, target in enumerate(fine_shape):
        e = _refine_axis(e, ax, int(target))
    return e


# ---------------------------------------------------------------------------
# Aligned (padded) layout: logical 2^k+1 grids in tile-aligned buffers.
#
# The live grid occupies [0, n) per axis of a larger physical array whose
# trailing "dead zone" holds zeros and is pinned to identity rows by every
# masked operator (ops/stencil.boundary_mask with logical_shape).  Transfer
# operators below preserve the invariant: the coarse buffer is exactly half
# the fine buffer per axis, coarse dead entries are written as zeros, and
# prolongation emits zeros into the fine dead zone (given zero coarse dead
# entries).  This gives the odd-size convergence quality (true boundary
# alignment at every level) in buffers whose extents suit sharding.
# ---------------------------------------------------------------------------


def _shift_axis(a: jax.Array, axis: int, offset: int) -> jax.Array:
    sl = [slice(None)] * a.ndim
    pad = [(0, 0)] * a.ndim
    if offset == +1:
        sl[axis] = slice(1, None)
        pad[axis] = (0, 1)
    else:
        sl[axis] = slice(None, -1)
        pad[axis] = (1, 0)
    return jnp.pad(a[tuple(sl)], pad)


def restrict_fw_padded(r: jax.Array, logical_shape) -> jax.Array:
    """Full weighting, padded layout: fine physical ``P`` -> coarse ``P/2``.

    Per axis: coarse k <- [1/4, 1/2, 1/4] at fine 2k; edge coarse rows
    (k == 0 and k == nc-1, both on the true Dirichlet boundary for odd
    logical n) are injected; dead rows (k >= nc) zeroed.
    """
    logical = tuple(logical_shape)
    for ax, n in enumerate(logical):
        nc = (n + 1) // 2
        filtered = (
            0.25 * _shift_axis(r, ax, -1) + 0.5 * r + 0.25 * _shift_axis(r, ax, +1)
        )
        sl = [slice(None)] * r.ndim
        sl[ax] = slice(None, None, 2)
        samp_f = filtered[tuple(sl)]
        samp_i = r[tuple(sl)]
        k = jax.lax.broadcasted_iota(jnp.int32, samp_f.shape, ax)
        out = jnp.where((k == 0) | (k == nc - 1), samp_i, samp_f)
        r = jnp.where(k >= nc, 0.0, out)
    return r


def prolong_padded(e: jax.Array) -> jax.Array:
    """Linear prolongation, padded layout: coarse physical ``P`` -> ``2 P``.

    Fine 2k <- coarse k, fine 2k+1 <- average of coarse k, k+1.  Zero coarse
    dead entries produce zeros in the fine dead zone (for odd logical n the
    last live fine row 2(nc-1) lands exactly on coarse nc-1).
    """
    for ax in range(e.ndim):
        nxt = _shift_axis(e, ax, +1)
        mid = 0.5 * (e + nxt)
        stacked = jnp.stack([e, mid], axis=ax + 1)
        new_shape = list(e.shape)
        new_shape[ax] = 2 * e.shape[ax]
        e = stacked.reshape(new_shape)
    return e


def crop_to(a: jax.Array, shape) -> jax.Array:
    """Slice the leading ``shape`` region out of a padded buffer."""
    return a[tuple(slice(0, int(s)) for s in shape)]


def pad_to(a: jax.Array, shape) -> jax.Array:
    """Zero-pad ``a`` up to physical ``shape``."""
    pads = [(0, int(t) - s) for s, t in zip(a.shape, shape)]
    if any(p[1] < 0 for p in pads):
        raise ValueError(f"cannot pad {a.shape} to smaller {tuple(shape)}")
    return jnp.pad(a, pads)
