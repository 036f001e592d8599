"""Aligned padded layout: logical 2^k+1 grids in padded buffers must be
bit-identical to the exact layout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.grids import build_hierarchy
from multigrid_prj_tpu.models.poisson import assemble_rhs
from multigrid_prj_tpu.ops.transfer import (
    crop_to,
    pad_to,
    prolong,
    prolong_padded,
    restrict_full_weighting,
    restrict_fw_padded,
)


def test_hierarchy_padding_metadata():
    levels = build_hierarchy((65, 65), 10.0, 4, pad_align=128)
    assert [l.padded_shape[0] for l in levels] == [128, 64, 32, 16]
    assert [l.shape[0] for l in levels] == [65, 33, 17, 9]
    # without pad_align nothing is padded
    levels = build_hierarchy((65, 65), 10.0, 4)
    assert all(l.padded_shape is None for l in levels)
    # padding stops when headroom runs out
    levels = build_hierarchy((127, 127), 10.0, 5, pad_align=128)
    assert levels[0].padded_shape == (128, 128)
    assert levels[1].padded_shape is None  # 64 < 64 + 1


def test_padded_transfer_matches_exact():
    rng = np.random.default_rng(0)
    n, P = 17, 32
    r = rng.standard_normal((n, n))
    r[0, :] = r[-1, :] = r[:, 0] = r[:, -1] = 0.0
    rp = np.zeros((P, P))
    rp[:n, :n] = r
    rc_pad = np.asarray(restrict_fw_padded(jnp.asarray(rp), (n, n)))
    rc_exact = np.asarray(restrict_full_weighting(jnp.asarray(r)))
    nc = (n + 1) // 2
    np.testing.assert_allclose(rc_pad[:nc, :nc], rc_exact, atol=1e-14)
    assert np.all(rc_pad[nc:, :] == 0) and np.all(rc_pad[:, nc:] == 0)

    e = rng.standard_normal((nc, nc))
    ep = np.zeros((P // 2, P // 2))
    ep[:nc, :nc] = e
    ef_pad = np.asarray(prolong_padded(jnp.asarray(ep)))
    ef_exact = np.asarray(prolong(jnp.asarray(e), (n, n)))
    np.testing.assert_allclose(ef_pad[:n, :n], ef_exact, atol=1e-14)


@pytest.mark.parametrize("cycle", ["v", "sawtooth"])
def test_padded_solve_bit_identical(cycle):
    # coarse="smooth": the layout-equivalence claim needs both solvers to run
    # the same coarse iteration — the "direct" dense inverse is built on each
    # layout's own buffer, whose f64 rounding differs across layouts.
    kw = dict(shape=(65, 65), num_levels=4, cycle=cycle, nu=2, pre_sweeps=2,
              tol=1e-11, coarse="smooth")
    exact = GMGSolver(**kw)
    padded = GMGSolver(pad_align=128, **kw)
    b = assemble_rhs(exact.levels[0], 10.0, test=1, dtype=jnp.float64)
    oe, op = exact.solve(b), padded.solve(b)
    assert oe.iterations == op.iterations
    # identical up to reduction-order ulps (padded norms sum extra zeros)
    np.testing.assert_allclose(np.asarray(oe.history), np.asarray(op.history),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(oe.u), np.asarray(op.u), rtol=1e-12,
                               atol=1e-14)
