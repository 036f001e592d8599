"""The XLA stencil, smoother, transfer and sparse ops against independent
float64 oracles: explicitly assembled scipy matrices, explicit transfer
matrices and plain Python loops.  The shape grids cover even, 2^k+1,
padded (logical extents inside a larger buffer), non-square and 3D grids."""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from multigrid_prj_tpu.ops import smoothers as sm
from multigrid_prj_tpu.ops import stencil as st
from multigrid_prj_tpu.ops import transfer as tr
from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR, coo_spmv

ALPHA = 10.0

# (physical shape, logical shape or None)
STENCIL_SHAPES = [
    ((64, 64), None),          # even
    ((65, 65), None),          # 2^k + 1
    ((128, 128), (65, 65)),    # pad_align-padded 2^k + 1
    ((48, 80), None),          # non-square
    ((64, 96), (61, 91)),      # padded, non-square
    ((17, 17, 17), None),      # 3D 2^k + 1
    ((16, 12, 20), None),      # 3D even, non-cubic
    ((16, 16, 32), (14, 13, 30)),  # 3D padded
]


def _ids(shapes):
    return ["x".join(map(str, s)) + ("-pad" if l else "") for s, l in shapes]


def _h(shape, logical):
    n = (logical or shape)[0]
    return 10.0 / (n - 1)


def _is_boundary(idx, logical):
    return any(i == 0 or i >= n - 1 for i, n in zip(idx, logical))


def scipy_operator(shape, logical, alpha, h):
    """The masked Poisson operator as an explicit sparse matrix: identity
    rows on the boundary and the dead zone, ``2*ndim*c`` / ``-c`` inside."""
    logical = logical or shape
    c = alpha / (h * h)
    index = np.arange(int(np.prod(shape))).reshape(shape)
    rows, cols, vals = [], [], []
    for idx in itertools.product(*[range(s) for s in shape]):
        r = index[idx]
        if _is_boundary(idx, logical):
            rows.append(r); cols.append(r); vals.append(1.0)
            continue
        rows.append(r); cols.append(r); vals.append(2.0 * len(shape) * c)
        for ax in range(len(shape)):
            for off in (-1, 1):
                nb = list(idx)
                nb[ax] += off
                rows.append(r); cols.append(index[tuple(nb)]); vals.append(-c)
    n = index.size
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("shape,logical", STENCIL_SHAPES,
                         ids=_ids(STENCIL_SHAPES))
def test_apply_matches_scipy(shape, logical):
    h = _h(shape, logical)
    u = _rand(shape, 0)
    got = np.asarray(st.poisson_apply(jnp.asarray(u), ALPHA, h, logical))
    want = (scipy_operator(shape, logical, ALPHA, h) @ u.ravel()).reshape(
        shape)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape,logical", STENCIL_SHAPES,
                         ids=_ids(STENCIL_SHAPES))
def test_residual_matches_scipy(shape, logical):
    h = _h(shape, logical)
    u, b = _rand(shape, 1), _rand(shape, 2)
    got = np.asarray(st.poisson_residual(jnp.asarray(u), jnp.asarray(b),
                                         ALPHA, h, logical))
    A = scipy_operator(shape, logical, ALPHA, h)
    want = (b.ravel() - A @ u.ravel()).reshape(shape)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# -- smoothers against Python loops over the grid points ----------------------

def loop_rbgs(u, b, alpha, h, sweeps, logical=None, omega=1.0):
    """Red-black Gauss-Seidel as an explicit point loop: red points
    (index sum even) first, then black, each from the freshest values."""
    u = u.copy()
    logical = logical or u.shape
    c = alpha / (h * h)
    nd = u.ndim
    for _ in range(sweeps):
        for color in (0, 1):
            for idx in itertools.product(*[range(s) for s in u.shape]):
                if sum(idx) % 2 != color:
                    continue
                if _is_boundary(idx, logical):
                    u[idx] = b[idx]
                    continue
                s = 0.0
                for ax in range(nd):
                    for off in (-1, 1):
                        nb = list(idx)
                        nb[ax] += off
                        s += u[tuple(nb)]
                gs = (b[idx] / c + s) / (2 * nd)
                u[idx] = (1 - omega) * u[idx] + omega * gs
    return u


def loop_jacobi(u, b, alpha, h, sweeps, omega, logical=None):
    logical = logical or u.shape
    c = alpha / (h * h)
    nd = u.ndim
    for _ in range(sweeps):
        new = u.copy()
        for idx in itertools.product(*[range(s) for s in u.shape]):
            if _is_boundary(idx, logical):
                new[idx] = b[idx]
                continue
            s = 0.0
            for ax in range(nd):
                for off in (-1, 1):
                    nb = list(idx)
                    nb[ax] += off
                    s += u[tuple(nb)]
            new[idx] = (1 - omega) * u[idx] + omega * (b[idx] / c + s) / (2 * nd)
        u = new
    return u


SMOOTH_SHAPES = [((17, 17), None), ((12, 20), None), ((32, 32), (17, 17)),
                 ((9, 9, 9), None)]


@pytest.mark.parametrize("sweeps", [1, 2, 4, 5])
@pytest.mark.parametrize("shape,logical", SMOOTH_SHAPES,
                         ids=_ids(SMOOTH_SHAPES))
def test_rbgs_matches_loop(shape, logical, sweeps):
    h = _h(shape, logical)
    u, b = _rand(shape, 3), _rand(shape, 4)
    got = np.asarray(sm.red_black_gauss_seidel(
        jnp.asarray(u), jnp.asarray(b), ALPHA, h, sweeps=sweeps,
        logical_shape=logical))
    want = loop_rbgs(u, b, ALPHA, h, sweeps, logical)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_rbsor_matches_loop():
    shape = (17, 17)
    h = _h(shape, None)
    u, b = _rand(shape, 5), _rand(shape, 6)
    got = np.asarray(sm.red_black_gauss_seidel(
        jnp.asarray(u), jnp.asarray(b), ALPHA, h, sweeps=3, omega=1.3))
    np.testing.assert_allclose(got, loop_rbgs(u, b, ALPHA, h, 3, omega=1.3),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("sweeps", [2, 8, 11])
def test_jacobi_matches_loop(sweeps, omega):
    shape = (17, 17)
    h = _h(shape, None)
    u, b = _rand(shape, 7), _rand(shape, 8)
    got = np.asarray(sm.jacobi(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                               omega=omega, sweeps=sweeps))
    want = loop_jacobi(u, b, ALPHA, h, sweeps, omega)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,logical", [((9, 9, 9), None),
                                           ((16, 16), (13, 11))],
                         ids=["3d", "2d-pad"])
def test_jacobi_matches_loop_3d_and_padded(shape, logical):
    h = _h(shape, logical)
    u, b = _rand(shape, 9), _rand(shape, 10)
    got = np.asarray(sm.jacobi(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                               omega=2.0 / 3.0, sweeps=3,
                               logical_shape=logical))
    want = loop_jacobi(u, b, ALPHA, h, 3, 2.0 / 3.0, logical)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# -- grid transfers against explicit matrices ----------------------------------

def fw_matrix(n):
    """1D full weighting, exact layout (``ops/transfer._fw_axis``)."""
    nc = (n + 1) // 2
    R = np.zeros((nc, n))
    R[0, 0] = 1.0
    if n % 2:
        R[nc - 1, n - 1] = 1.0
    for k in range(1, nc - 1):
        R[k, 2 * k - 1:2 * k + 2] = (0.25, 0.5, 0.25)
    return R


def fw_padded_matrix(p, n):
    """1D full weighting, padded layout: physical ``p`` -> ``p // 2``,
    logical ``n``: edge rows injected, dead rows zero."""
    nc = (n + 1) // 2
    R = np.zeros((p // 2, p))
    for k in range(nc):
        if k in (0, nc - 1):
            R[k, 2 * k] = 1.0
        else:
            R[k, 2 * k - 1:2 * k + 2] = (0.25, 0.5, 0.25)
    return R


def prolong_matrix(n, target):
    """1D linear interpolation ``n`` -> ``target`` (2n-1, or 2n with the
    last node clamped)."""
    P = np.zeros((target, n))
    for i in range(target):
        if i // 2 >= n - 1:
            P[i, n - 1] = 1.0
        elif i % 2 == 0:
            P[i, i // 2] = 1.0
        else:
            P[i, i // 2] = P[i, i // 2 + 1] = 0.5
    return P


def prolong_padded_matrix(p):
    """1D padded prolongation ``p`` -> ``2p`` (zero beyond the buffer)."""
    P = np.zeros((2 * p, p))
    for k in range(p):
        P[2 * k, k] = 1.0
        P[2 * k + 1, k] = 0.5
        if k + 1 < p:
            P[2 * k + 1, k + 1] = 0.5
    return P


def apply_separable(mats, a):
    """Apply one 1D matrix per axis (the tensor-product transfer)."""
    for ax, M in enumerate(mats):
        a = np.moveaxis(np.tensordot(M, a, axes=(1, ax)), 0, ax)
    return a


@pytest.mark.parametrize("shape", [(17, 17), (33, 17), (16, 16), (9, 9, 9)])
def test_restrict_matches_matrix(shape):
    r = _rand(shape, 11)
    got = np.asarray(tr.restrict_full_weighting(jnp.asarray(r)))
    want = apply_separable([fw_matrix(n) for n in shape], r)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("shape,logical", [((64, 512), (61, 509)),
                                           ((128, 256), (127, 255)),
                                           ((64, 64), (33, 33)),
                                           ((16, 16, 32), (9, 13, 17))],
                         ids=["64x512", "128x256", "64-pad33", "3d"])
def test_restrict_padded_matches_matrix(shape, logical):
    r = _rand(shape, 12)
    got = np.asarray(tr.restrict_fw_padded(jnp.asarray(r), logical))
    want = apply_separable(
        [fw_padded_matrix(p, n) for p, n in zip(shape, logical)], r)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("coarse,fine", [((9, 9), (17, 17)),
                                         ((9, 17), (17, 33)),
                                         ((8, 8), (16, 16)),
                                         ((5, 5, 5), (9, 9, 9))])
def test_prolong_matches_matrix(coarse, fine):
    e = _rand(coarse, 13)
    got = np.asarray(tr.prolong(jnp.asarray(e), fine))
    want = apply_separable(
        [prolong_matrix(n, t) for n, t in zip(coarse, fine)], e)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("shape", [(32, 256), (64, 128), (8, 8, 16)])
def test_prolong_padded_matches_matrix(shape):
    e = _rand(shape, 14)
    got = np.asarray(tr.prolong_padded(jnp.asarray(e)))
    want = apply_separable([prolong_padded_matrix(p) for p in shape], e)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


# -- sparse products against scipy --------------------------------------------

def _fd(n):
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    return poisson_fd_csr(n)


def _banded():
    from benchmarks.spmv_bench import banded_csr

    return banded_csr(3000)


def _rcm_fd():
    A = _fd(24)
    return A.permute(A.rcm_permutation())


def _random():
    rng = np.random.default_rng(15)
    n = 700
    rows = rng.integers(0, n, 4000)
    cols = rng.integers(0, n, 4000)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(4000), (n, n))


def _amg_p(transpose):
    from multigrid_prj_tpu.amg import (
        build_prolongation,
        coarsen_pmis,
        smooth_prolongation,
        _estimate_lmax,
    )

    A = _fd(20)
    labels = coarsen_pmis(A, 0.2, seed=1)
    P = smooth_prolongation(A, build_prolongation(A, labels),
                            _estimate_lmax(A),
                            coarse_rows=np.flatnonzero(labels == 1))
    return P.transpose() if transpose else P


MATRICES = {"banded": _banded, "rcm_fd": _rcm_fd, "random": _random,
            "amg_P": lambda: _amg_p(False), "amg_Pt": lambda: _amg_p(True)}


def _scipy(A):
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)


@pytest.mark.parametrize("name", list(MATRICES))
def test_ell_spmv_matches_scipy(name):
    A = MATRICES[name]()
    x = _rand(A.shape[1], 16)
    got = np.asarray(ELLMatrix.from_host_csr(A, dtype=jnp.float64).spmv(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, _scipy(A) @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(MATRICES))
def test_ell_spmm_matches_scipy(name):
    A = MATRICES[name]()
    X = _rand((A.shape[1], 3), 17)
    got = np.asarray(ELLMatrix.from_host_csr(A, dtype=jnp.float64).spmm(
        jnp.asarray(X)))
    np.testing.assert_allclose(got, _scipy(A) @ X, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(MATRICES))
def test_coo_spmv_matches_scipy(name):
    A = MATRICES[name]()
    rows, cols, vals = A.to_coo()
    x = _rand(A.shape[1], 18)
    got = np.asarray(jax.jit(coo_spmv, static_argnums=4)(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(x), A.shape[0]))
    np.testing.assert_allclose(got, _scipy(A) @ x, rtol=1e-12, atol=1e-12)
