"""Float-float ("ff32") extended precision for large-grid residuals.

Why: the relative residual a plain-f32 solver can reach is floored at
``eps_f32 * kappa(A) ~ 6e-8 * (N/pi)^2`` — measured 0.38 at 8193^2, 2.6e-5
at 65^2, matching the formula.  Reaching the BASELINE target (1e-8) from
f32 cycles needs the residual evaluated in extended precision.

How: the solution is carried as an unevaluated pair ``u = hi + lo`` and the
residual uses error-free transformations.  The stencil residual is computed
in the *scaled* form

    r = c * ((b/c) - (4 u - sum(neighbors))),   c = alpha / h^2

so every extended-precision operation in the stencil sum is an ADDITION
(Knuth two-sum — exact regardless of FMA contraction); ``4 u`` is exact
(power of two), and the one final multiply by ``c`` happens after the
cancellation is resolved, where a plain rounding error is harmless.
``b/c`` is itself stored as a pair (:func:`ff_from_div`), computed against
``c`` in float64 — with ``c`` rounded to f32 the pair would describe a
different operator, relative ``eps_f32`` away, and that alone floors the
true residual near 1e-8.

The multigrid cycle then solves the error equation entirely in f32, and the
correction is accumulated into the pair — the classic iterative-refinement
split.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_prj_tpu.ops.stencil import boundary_mask


def two_sum(a, b):
    """Knuth exact addition: returns (s, err) with a + b == s + err."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker exact addition, valid when |a| >= |b| (post-normalization)."""
    s = a + b
    err = b - (s - a)
    return s, err


def ff_add(x_hi, x_lo, y_hi, y_lo):
    """Pair + pair -> normalized pair (accurate to ~2 ulps of the pair)."""
    s, e = two_sum(x_hi, y_hi)
    e = e + (x_lo + y_lo)
    return fast_two_sum(s, e)


def ff_sub_accurate(x_hi, x_lo, y_hi, y_lo):
    """Pair - pair with both halves subtracted exactly (two two-sums): the
    rounding is relative to the result, not to the operands — what a
    difference of nearly equal pairs needs."""
    s, e = two_sum(x_hi, -y_hi)
    t, f = two_sum(x_lo, -y_lo)
    s, e = fast_two_sum(s, e + t)
    return fast_two_sum(s, e + f)


def ff_add_f(x_hi, x_lo, y):
    """Pair + float -> normalized pair."""
    s, e = two_sum(x_hi, y)
    e = e + x_lo
    return fast_two_sum(s, e)


def ff_neg(x_hi, x_lo):
    return -x_hi, -x_lo


def split_mask(a):
    """Exact split ``a = hi + lo`` of f32 values into two halves of at most
    12 significant bits each, by masking the low 12 mantissa bits.

    Bit operations cannot be contracted or reassociated by a compiler, so
    the split stays exact where a Veltkamp split (``c = s*a; c - (c - a)``)
    would be broken by a fused multiply-add."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000),
                                      jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """Dekker exact product of f32 arrays: ``a * b == p + err``.  Every
    partial product of the 12-bit halves is exact, so the result holds with
    or without FMA contraction."""
    p = a * b
    ah, al = split_mask(a)
    bh, bl = split_mask(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ff_from_div(b, c: float):
    """f32 pair for ``b / c``, with the scalar ``c`` taken in float64.

    ``c = c_hi + c_lo`` is split on the host; ``b - q * c`` is formed from
    the exact product ``q * c_hi`` (:func:`two_prod`), so the low half is
    accurate to ~eps_f32^2 whatever the compiler contracts."""
    c_hi = float(np.float32(c))
    c_lo = float(np.float32(c - c_hi))
    hi = b / c_hi
    p, e = two_prod(hi, jnp.full_like(hi, c_hi))
    rem = ((b - p) - e) - hi * c_lo
    return hi, rem / c_hi


def _shift2(a, axis, offset):
    sl = [slice(None)] * a.ndim
    pad = [(0, 0)] * a.ndim
    if offset == +1:
        sl[axis] = slice(1, None)
        pad[axis] = (0, 1)
    else:
        sl[axis] = slice(None, -1)
        pad[axis] = (1, 0)
    return jnp.pad(a[tuple(sl)], pad)


def ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, alpha: float, h: float,
                        logical_shape=None):
    """Extended-precision ``r = b - A u`` for the Poisson stencil.

    ``d_hi, d_lo`` = pair for ``b / c`` (precompute with :func:`ff_from_div`).
    Returns an f32 residual whose accuracy is ~``eps_ff * kappa`` instead of
    ``eps_f32 * kappa`` (and better on smooth fields, see below).
    """
    c = alpha / (h * h)
    # acc = sum_k (u - nb_k) = 2*ndim*u - sum(neighbors).  Each difference
    # of neighbouring values of a smooth field is small, so the pair
    # rounding of the sum is relative to |u - nb| ~ h|grad u|, not to |u|.
    acc_hi = acc_lo = None
    for ax in range(u_hi.ndim):
        for off in (+1, -1):
            e_hi, e_lo = ff_sub_accurate(u_hi, u_lo, _shift2(u_hi, ax, off),
                                         _shift2(u_lo, ax, off))
            if acc_hi is None:
                acc_hi, acc_lo = e_hi, e_lo
            else:
                acc_hi, acc_lo = ff_add(acc_hi, acc_lo, e_hi, e_lo)
    # t = d - acc  (the cancellation happens here, in extended precision)
    t_hi, t_lo = ff_add(d_hi, d_lo, -acc_hi, -acc_lo)
    r_interior = c * t_hi + c * t_lo
    # boundary rows: r = b - u
    r_boundary = (b - u_hi) - u_lo
    bm = boundary_mask(u_hi.shape, logical_shape)
    return jnp.where(bm, r_boundary, r_interior)


def ff_accumulate(u_hi, u_lo, e):
    """(u_hi, u_lo) += e, renormalized."""
    return ff_add_f(u_hi, u_lo, e)
