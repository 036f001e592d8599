"""Float-float ("ff32") extended precision for the SPARSE (ELL) path.

Why: a plain-f32 AMG V-cycle stalls at a relative residual
``~eps_f32 * kappa(A)`` — for the FEM matrices this floor sits well above
the reference's 1e-10 tolerances.  ``ops/extended.py``
solves this for the *stencil* path, where the scaled-operator form turns
every extended operation into an addition.  A general sparse matrix has
arbitrary coefficients, so the residual here needs *error-free products*:

    r = b - A x,   A x = sum_k vals[:, k] * x[cols[:, k]]

Each product uses Dekker's two_prod (``ops/extended.py``; its split masks
mantissa bits, so it stays exact under FMA contraction), and the sum is a
cascaded Knuth two_sum chain over the K ELL slots.  The matrix itself is
carried as an unevaluated pair ``vals = hi + lo`` (re-quantized from the
f64 host setup values), and so is the iterate ``x = x_hi + x_lo`` — the
classic iterative-refinement split.

Cost: ~6 flops per nonzero instead of 2 — irrelevant, the op is
HBM-bound and the extended residual streams the same bytes (+ the lo
arrays) once per outer refinement step.

Reference capability: the all-f64 CSR residuals
(``AMG/include/AMG.hpp:397-442``) from f32 arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_prj_tpu.ops.extended import fast_two_sum, two_prod, two_sum
from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ELLPair:
    """ELL matrix carried as an f32 pair ``vals_hi + vals_lo`` (column ids
    shared), re-quantized from the f64 host values at setup."""

    cols: jax.Array  # (n, K) int32
    vals_hi: jax.Array  # (n, K) f32
    vals_lo: jax.Array  # (n, K) f32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_host_csr(csr: HostCSR) -> "ELLPair":
        ell64 = ELLMatrix.from_host_csr(csr, dtype=jnp.float64)
        v64 = np.asarray(ell64.vals, dtype=np.float64)
        hi = v64.astype(np.float32)
        lo = (v64 - hi.astype(np.float64)).astype(np.float32)
        return ELLPair(
            cols=ell64.cols,
            vals_hi=jnp.asarray(hi),
            vals_lo=jnp.asarray(lo),
            shape=ell64.shape,
        )


def ell_residual_ff(A: ELLPair, b_hi, b_lo, x_hi, x_lo):
    """Extended-precision ``r = b - A x`` for an ELL pair matrix.

    All arrays f32; returns the f32 residual with the cancellation resolved
    in ~2^-48 relative precision instead of 2^-24.
    """
    g_hi = jnp.take(x_hi, A.cols, axis=0)  # (n, K)
    g_lo = jnp.take(x_lo, A.cols, axis=0)
    p, e = two_prod(A.vals_hi, g_hi)
    # first-order small terms (their own roundoff is ~eps^2 — negligible)
    e = e + A.vals_hi * g_lo + A.vals_lo * g_hi
    acc_hi, acc_lo = b_hi, b_lo
    for k in range(p.shape[1]):  # cascaded exact accumulation over ELL slots
        s, err = two_sum(acc_hi, -p[:, k])
        err = err + (acc_lo - e[:, k])
        acc_hi, acc_lo = fast_two_sum(s, err)
    return acc_hi + acc_lo


def ff_pair_from_f64(v) -> tuple[jax.Array, jax.Array]:
    """Split a host f64 vector into an f32 (hi, lo) pair on device."""
    v = np.asarray(v, dtype=np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)
