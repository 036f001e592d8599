"""multigrid_prj_tpu — a JAX multigrid sparse linear-algebra framework.

Built from scratch in JAX/XLA with the capabilities of the reference
C++ project ``Stefo01/multigrid_prj`` (see SURVEY.md): geometric multigrid on
matrix-free 2D/3D Poisson stencils, classical algebraic multigrid (strength
graph, coarsening, direct interpolation, Galerkin RAP), Jacobi / red-black
Gauss-Seidel / BiCGSTAB smoothers, P1 finite-element assembly from gmsh
``.msh`` meshes, ``.mtx``/VTU I/O and convergence monitoring — redesigned
for accelerators: fused stencil sweeps and sharded block-row partitioning
over a ``jax.sharding.Mesh`` with halo-exchange collectives.
"""

__version__ = "0.1.0"

from multigrid_prj_tpu.grids import GridLevel, build_hierarchy
from multigrid_prj_tpu.gmg import GMGSolver, sawtooth_cycle, v_cycle

__all__ = [
    "GridLevel",
    "build_hierarchy",
    "GMGSolver",
    "sawtooth_cycle",
    "v_cycle",
    "__version__",
]
