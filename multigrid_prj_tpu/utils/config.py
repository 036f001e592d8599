"""Typed configuration + reference-compatible CLI parsing.

Parity with ``Utils::Initialization_for_N``
(``GeometricMultigrid/src/utilities.cpp:3-132``): flags ``-n -a -w -ml -test
-smt --help`` with defaults ``N=200, alpha=10.0, width=10.0, level=2,
test=1, smoother=GS`` (``utilities.hpp:16-21``), smoother codes ``0 = GS,
1 = Jacobi, 2 = BiCGSTAB`` (``utilities.hpp:9-14``), and out-of-range
smoother codes falling back to the default (``utilities.cpp:76-78``).
"""

from __future__ import annotations

import dataclasses
import sys

SMOOTHER_NAMES = {0: "gs", 1: "jacobi", 2: "bicgstab"}

HELP_TEXT = """Usage: python -m multigrid_prj_tpu.cli.gmg_main [OPTIONS]

Options:
  -n, insert number of spaces
  -a, specifies differential constant
  -w, insert the Width of the rectangle domain
  -ml, insert multigrid level
  -test, insert type of function in input to test it
  -smt, you can choose your favourite smoother (0 GS, 1 Jacobi, 2 BiCGSTAB)
  --help, Display this help message
"""


@dataclasses.dataclass
class GMGConfig:
    """GMG driver configuration (defaults: ``utilities.hpp:16-21``)."""

    n: int = 200
    alpha: float = 10.0
    width: float = 10.0
    levels: int = 2
    test: int = 1
    smoother: int = 0  # 0 GS, 1 Jacobi, 2 BiCGSTAB

    # Framework extensions (not in the reference CLI):
    cycle: str = "sawtooth"
    tol: float = 1e-11
    maxit: int = 1000
    dtype: str = "auto"  # auto: f64 (the reference is all-double)
    pad: int = 0  # tile-aligned padded layout (e.g. 256); 0 = exact layout

    @property
    def smoother_name(self) -> str:
        return SMOOTHER_NAMES.get(self.smoother, "gs")


def _fail(msg: str) -> None:
    print(msg)
    sys.exit(1)


def parse_gmg_args(argv: list[str]) -> GMGConfig:
    """Parse the reference's flag set; unknown tokens are ignored like the
    reference's scan loop (``utilities.cpp:28-130``)."""
    cfg = GMGConfig()
    if not argv:
        print(f"Inserted by default N = {cfg.n}")
        print(f"Inserted by default alpha = {cfg.alpha}")
        print(f"Inserted by default width = {cfg.width}")
        print(f"Inserted by default multigrid level = {cfg.levels}")
        print(f"Inserted by default test number {cfg.test}")
        print(f"Inserted by default Smooter number {cfg.smoother}")
        return cfg
    i = 0
    while i < len(argv):
        tok = argv[i]
        has_next = i + 1 < len(argv)

        def _int(flag):
            try:
                return int(argv[i + 1])
            except (ValueError, IndexError):
                _fail(f"Error: Please, insert a number after {flag}")

        def _float(flag):
            try:
                return float(argv[i + 1])
            except (ValueError, IndexError):
                _fail(f"Error: Please, insert a double after {flag}")

        if tok == "--help":
            print(HELP_TEXT)
            sys.exit(1)
        elif tok == "-n" and has_next:
            cfg.n = _int("-n")
            print(f"Inserted N = {cfg.n}")
            if cfg.n <= 0:
                _fail("Error: Please, insert a valid N value")
            i += 2
        elif tok == "-a" and has_next:
            cfg.alpha = _float("-a")
            print(f"Inserted alpha = {cfg.alpha}")
            i += 2
        elif tok == "-w" and has_next:
            cfg.width = _float("-w")
            print(f"Inserted width = {cfg.width}")
            if cfg.width <= 0:
                _fail("Error: Please, insert a valid width")
            i += 2
        elif tok == "-ml" and has_next:
            cfg.levels = _int("-ml")
            print(f"Inserted level = {cfg.levels}")
            if cfg.levels <= 0:
                _fail("Error: Please, insert a valid level")
            i += 2
        elif tok == "-test" and has_next:
            cfg.test = _int("-test")
            print(f"Inserted test number = {cfg.test}")
            if cfg.test < 0:
                _fail("Error: Please, insert a valid test number")
            i += 2
        elif tok == "-smt" and has_next:
            cfg.smoother = _int("-smt")
            print(f"Inserted Smoother number = {cfg.smoother}")
            if cfg.smoother not in SMOOTHER_NAMES:
                cfg.smoother = 0
            i += 2
        elif tok == "-cycle" and has_next:
            cfg.cycle = argv[i + 1]
            i += 2
        elif tok == "-tol" and has_next:
            cfg.tol = _float("-tol")
            i += 2
        elif tok == "-pad" and has_next:
            cfg.pad = _int("-pad")
            i += 2
        elif tok == "-n" or tok in ("-a", "-w", "-ml", "-test", "-smt"):
            _fail("Error: Please, insert something")
        else:
            i += 1
    return cfg
