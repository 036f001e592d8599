"""AMG setup/solve tests: strength graph, coarsening invariants,
interpolation properties, Galerkin product, and end-to-end convergence on
FD and FEM systems."""

import numpy as np
import pytest

import jax.numpy as jnp

from multigrid_prj_tpu.amg import (
    AMGSolver,
    build_prolongation,
    coarsen_greedy,
    coarsen_pmis,
    mc_gs_sweep,
    strength_mask,
)
from multigrid_prj_tpu.models.fem import assemble_p1, structured_unit_square_mesh
from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR, rap


def fd_poisson(n):
    """Interior-only 5-point FD Poisson on an n x n interior grid."""
    N = n * n
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(n):
            r = i * n + j
            rows.append(r); cols.append(r); vals.append(4.0)
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < n and 0 <= jj < n:
                    rows.append(r); cols.append(ii * n + jj); vals.append(-1.0)
    return HostCSR.from_coo(rows, cols, vals, (N, N))


def test_strength_mask_theta():
    #      row 0: diag 4, offdiag -1 (strong), -0.1 (weak vs max 1)
    A = HostCSR.from_coo(
        [0, 0, 0, 1, 1], [0, 1, 2, 1, 0], [4.0, -1.0, -0.1, 4.0, -1.0], (3, 3)
    )
    s = strength_mask(A, theta=0.2)
    # entries sorted by (row, col): (0,0)F dia, (0,1)T, (0,2) |−0.1| < 0.2*1 F,
    # (1,0)T, (1,1)F
    assert s.tolist() == [False, True, False, True, False]


@pytest.mark.parametrize("coarsen", [coarsen_pmis, coarsen_greedy])
def test_coarsening_invariants(coarsen):
    A = fd_poisson(12)
    labels = coarsen(A, 0.2, seed=3)
    n = A.shape[0]
    assert labels.shape == (n,)
    nc = labels.sum()
    assert 0 < nc < n
    # a sensible coarse fraction for 2D Poisson
    assert 0.15 <= nc / n <= 0.75, nc / n
    # every fine node has at least one strong coarse neighbor
    strong = strength_mask(A, 0.2)
    rows = np.repeat(np.arange(n), A.row_lengths)
    has_c = np.zeros(n, dtype=bool)
    sel = strong & (labels[A.indices] == 1)
    has_c[rows[sel]] = True
    assert has_c[labels == 0].all()


def test_prolongation_rows_sum_to_one():
    A = fd_poisson(10)
    labels = coarsen_pmis(A, 0.2, seed=1)
    P = build_prolongation(A, labels)
    assert P.shape == (A.shape[0], labels.sum())
    row_sums = P.to_dense().sum(axis=1)
    np.testing.assert_allclose(row_sums, 1.0, atol=1e-12)
    # coarse rows are identity rows
    dense = P.to_dense()
    for local, i in enumerate(np.flatnonzero(labels == 1)):
        assert dense[i, local] == 1.0
        assert np.count_nonzero(dense[i]) == 1


def test_galerkin_preserves_spd():
    A = fd_poisson(8)
    labels = coarsen_pmis(A, 0.2, seed=2)
    P = build_prolongation(A, labels)
    Ac = rap(P, A).to_dense()
    np.testing.assert_allclose(Ac, Ac.T, atol=1e-12)
    assert np.linalg.eigvalsh(Ac).min() > 0


def test_mcgs_is_gauss_seidel_per_color():
    """Multicolor GS is a fixed point at the exact solution and reduces the
    error monotonically in the A-norm."""
    A = fd_poisson(6)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(36)
    x_exact = np.linalg.solve(A.to_dense(), b)
    solver = AMGSolver(A, num_levels=1)
    lvl = solver.levels[0]
    xe = jnp.asarray(x_exact)
    np.testing.assert_allclose(
        np.asarray(mc_gs_sweep(lvl, xe, jnp.asarray(b))), x_exact, atol=1e-10
    )
    D = A.to_dense()
    x = jnp.zeros(36, dtype=jnp.float64)
    prev = x_exact @ D @ x_exact
    for _ in range(5):
        x = mc_gs_sweep(lvl, x, jnp.asarray(b))
        e = np.asarray(x) - x_exact
        cur = e @ D @ e
        assert cur < prev
        prev = cur


@pytest.mark.parametrize("coarsening", ["pmis", "greedy"])
def test_amg_solves_fd_poisson(coarsening):
    A = fd_poisson(16)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(A.shape[0])
    solver = AMGSolver(A, num_levels=4, coarsening=coarsening)
    x, iters, rel = solver.solve(b, tol=1e-10, maxit=100)
    assert rel <= 1e-10, rel
    want = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-7, atol=1e-8)


def test_amg_solves_fem_system():
    mesh = structured_unit_square_mesh(17)
    A, rhs = assemble_p1(mesh)
    solver = AMGSolver(A, num_levels=4)
    assert solver.level_sizes[0] == A.shape[0]
    assert len(solver.level_sizes) >= 2
    x, iters, rel = solver.solve(rhs, tol=1e-10, maxit=200)
    assert rel <= 1e-10
    want = np.linalg.solve(A.to_dense(), rhs)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-6, atol=1e-9)


def test_reference_sawtooth_pass_reduces_residual():
    """One reference-style 10/200/10 pass must cut the residual by a large
    factor (the reference prints exactly this after its single pass,
    AMG/src/AMG.cpp:304)."""
    mesh = structured_unit_square_mesh(17)
    A, rhs = assemble_p1(mesh)
    solver = AMGSolver(A, num_levels=3, rhs=rhs)
    x0 = np.zeros(A.shape[0])
    r0 = solver.residual_norm(x0, rhs)
    x1 = solver.reference_sawtooth_pass(x0)
    r1 = solver.residual_norm(x1, rhs)
    # The reference's solution-restriction scheme reduces mostly through its
    # 10/200/10 smoothing (measured ~0.08x here; plain 20 GS sweeps alone
    # reach ~0.06x) — the faithful bar is the measured behavior.
    assert r1 < 0.15 * r0, (r0, r1)


def test_chebyshev_smoother_and_pcg():
    """Chebyshev smoothing + AMG-PCG: the SpMV-only acceleration pair."""
    mesh = structured_unit_square_mesh(17)
    A, rhs = assemble_p1(mesh)
    solver = AMGSolver(A, num_levels=3, smoother="chebyshev")
    assert solver.levels[0].lmax > 0.5  # power-iteration estimate exists
    x, iters, rel = solver.solve(rhs, tol=1e-10, maxit=200)
    assert rel <= 1e-10
    xg, it_pcg, rel_pcg = solver.solve_pcg(rhs, tol=1e-10, maxit=100)
    assert rel_pcg <= 1e-10
    assert it_pcg < iters  # acceleration must actually accelerate
    want = np.linalg.solve(A.to_dense(), rhs)
    np.testing.assert_allclose(np.asarray(xg), want, rtol=1e-6, atol=1e-9)


def test_operator_complexity_reasonable():
    A = fd_poisson(20)
    solver = AMGSolver(A, num_levels=4)
    assert 1.0 < solver.operator_complexity < 3.0


def test_amg_residual_history_and_convergence_factor():
    """Every AMG solve entry point records the per-iteration history, and
    the V-cycle convergence factor regresses the way
    tests/test_gmg_convergence.py pins the GMG cycle (the one structured
    metric the reference keeps, GeometricMultigrid/src/main.cpp:74,87,127)."""
    from multigrid_prj_tpu.utils.metrics import SolveMetrics

    A = fd_poisson(24)
    rng = np.random.default_rng(11)
    b = rng.standard_normal(A.shape[0])

    solver = AMGSolver(A, num_levels=4)
    out = solver.solve(b, tol=1e-10, maxit=100)
    x, iters, rel = out  # 3-tuple unpacking preserved
    assert out.history.shape == (iters + 1,)
    assert out.history[0] == 1.0  # x0 = 0
    np.testing.assert_allclose(out.history[-1], rel, rtol=1e-6)
    assert np.all(np.diff(out.history) < 0)  # monotone V-cycle reduction
    m = SolveMetrics(history=out.history, nnz=A.nnz, cycles=iters)
    # PMIS + direct-interpolation V(1,1): early factors ~0.14 but the tail
    # settles at ~0.60 on 2D FD Poisson (measured; direct interpolation is
    # weak — the reference's formula, AMG.hpp:249-293).  PCG acceleration is
    # the production path.  Regression bar: tail factor must not degrade
    # past 0.75.
    assert m.convergence_factor < 0.75, m.convergence_factor

    pcg = solver.solve_pcg(b, tol=1e-10, maxit=100)
    assert pcg.history.shape == (pcg.iterations + 1,)
    assert pcg.history[-1] <= 1e-10
    # the accelerated path must not lose to plain V-cycles (with F-row-only
    # smoothed P the plain cycle itself reaches rho ~ 0.1, so on small
    # systems both converge in the same handful of iterations)
    assert pcg.iterations <= iters, (pcg.iterations, iters)


def test_amg_refined_history(monkeypatch):
    """solve_refined's history comes from inside the ff32 refinement loop."""
    import jax

    A = fd_poisson(16)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.shape[0])
    solver = AMGSolver(A, num_levels=3, dtype=jnp.float32, reorder="rcm")
    out = solver.solve_refined(b, tol=1e-9, maxit=60)
    assert out.history.shape == (out.iterations + 1,)
    assert out.history[0] == 1.0
    assert out.history[-1] <= 1e-9


def test_two_prod_and_ff_residual_exact():
    """Error-free transforms: two_prod is exact in f32; the ff residual
    matches the f64 residual to ~2^-45 relative."""
    import jax

    from multigrid_prj_tpu.ops.sparse_extended import (
        ELLPair,
        ell_residual_ff,
        ff_pair_from_f64,
        two_prod,
    )

    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal(256), jnp.float32)
    b = jnp.asarray(rng.standard_normal(256), jnp.float32)
    p, e = jax.jit(two_prod)(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_allclose(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact,
        rtol=1e-14,
    )

    # The ff32 payoff is CANCELLATION: near the solution the true residual
    # is ~1e-13 * scale; a plain f32 evaluation is floored at
    # ~eps_f32 * scale (1e-7), the ff evaluation must track the true value.
    A = fd_poisson(12)
    b64 = rng.standard_normal(A.shape[0])
    A2 = ELLPair.from_host_csr(A)
    bh, bl = ff_pair_from_f64(b64)
    # the pair-represented system, solved exactly in f64
    Ad = (np.asarray(A2.vals_hi, np.float64) + np.asarray(A2.vals_lo, np.float64))
    dense = np.zeros(A.shape)
    npr = np.arange(A.shape[0])[:, None].repeat(A2.cols.shape[1], 1)
    np.add.at(dense, (npr, np.asarray(A2.cols)), Ad)
    b_pair = np.asarray(bh, np.float64) + np.asarray(bl, np.float64)
    x64 = np.linalg.solve(dense, b_pair)
    xh, xl = ff_pair_from_f64(x64)
    x_pair = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    r64 = b_pair - dense @ x_pair  # tiny: ~eps_f64 * kappa * scale
    r_ff = np.asarray(ell_residual_ff(A2, bh, bl, xh, xl), np.float64)
    r_f32 = np.asarray(
        jnp.asarray(b_pair, jnp.float32)
        - ELLMatrix.from_host_csr(A, dtype=jnp.float32).spmv(
            jnp.asarray(x_pair, jnp.float32)
        ),
        np.float64,
    )
    scale = np.linalg.norm(b_pair)
    assert np.linalg.norm(r_ff - r64) / scale < 1e-11  # ff tracks the truth
    assert np.linalg.norm(r_f32 - r64) / scale > 1e-8  # plain f32 cannot


def test_amg_f32_refined_beats_plain_floor():
    """On an f32 hierarchy, solve() stalls at the eps_f32*kappa floor while
    solve_refined() (ff32 outer residuals) reaches 1e-9 — the sparse analog
    of the GMG ff32 path (the documented f32 floor)."""
    A = fd_poisson(48)  # kappa ~ (48/pi)^2 ~ 2.4e2 -> f32 floor ~ 3e-5
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    solver = AMGSolver(A, num_levels=4, dtype=jnp.float32)
    _, _, rel_plain = solver.solve(b, tol=1e-9, maxit=60)
    assert rel_plain > 1e-8  # plain f32 cannot get there
    x, iters, rel = solver.solve_refined(b, tol=1e-9, maxit=60)
    assert rel <= 1e-9, rel
    assert iters < 60
    # true residual in f64 confirms the device-side estimate
    r = b - A.spmv(np.asarray(x, np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 5e-9


def test_amg_rejects_f64_without_x64():
    import jax

    A = fd_poisson(6)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="x64"):
            AMGSolver(A, num_levels=2, dtype=jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Convergence-factor regression: smoothed-P V-cycles must
# hold rho <~ 0.2 on the 512^2 FD system and the reference's own mesh1 FEM
# system — the AMG analog of test_gmg_convergence's rho <= 0.15 pin.
# Measured (seeded, deterministic): fd512/chebyshev 0.113, mesh1/chebyshev
# 0.083, mesh1/mcgs 0.177.
# ---------------------------------------------------------------------------


def _solve_rho(A, b, smoother, **kw):
    from multigrid_prj_tpu.utils.metrics import SolveMetrics

    solver = AMGSolver(A, smoother=smoother, **kw)
    out = solver.solve(b, tol=1e-10, maxit=60)
    assert out.rel_residual <= 1e-10
    m = SolveMetrics(history=out.history, nnz=A.nnz, cycles=out.iterations)
    return out.iterations, m.convergence_factor


def test_amg_convergence_factor_fd512():
    """512^2 FD Poisson (262k rows), Chebyshev smoothing."""
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    A = poisson_fd_csr(512)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    iters, rho = _solve_rho(A, b, "chebyshev", num_levels=8, min_coarse=200)
    assert iters <= 14, iters
    assert rho <= 0.2, rho


@pytest.mark.parametrize("smoother,rho_bar", [("chebyshev", 0.15),
                                              ("mcgs", 0.22)])
def test_amg_convergence_factor_mesh1(smoother, rho_bar):
    """The reference's own FEM system (mesh1.msh, 6561 nodes,
    AMG/src/main.cpp:21-23)."""
    import os

    path = "/root/reference/AMG/mesh/mesh1.msh"
    if not os.path.exists(path):
        pytest.skip("reference mesh not available")
    from multigrid_prj_tpu.models.fem import assemble_p1, parse_msh

    A, rhs = assemble_p1(parse_msh(path))
    iters, rho = _solve_rho(A, rhs, smoother, num_levels=5)
    assert iters <= 14, iters
    assert rho <= rho_bar, rho
