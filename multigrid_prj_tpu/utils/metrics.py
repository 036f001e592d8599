"""Structured metrics, timers, and profiling hooks.

The reference's observability is ``std::cout`` prose plus one structured
artifact — the residual-history vector written to ``MGGS4.txt``
(``GeometricMultigrid/src/main.cpp:74,87,127``) and wall-clock timers around
init/solve (``main.cpp:25,64-67,118-121``).  This module keeps that artifact
(via ``utils.io.save_history``) and adds what a production solver needs:
per-iteration records (residual, reduction factor), per-phase timings with
completion fences, throughput accounting (nnz/s, GB/s), and JSON/CSV export.

``trace`` wraps ``jax.profiler`` for device timeline capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Optional

import jax
import numpy as np


def fence(x) -> None:
    """Completion fence: wait until every array in ``x`` is computed."""
    jax.block_until_ready(x)


@dataclasses.dataclass
class PhaseTimer:
    """Named wall-clock phases (the reference's init/solve split)."""

    phases: dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, result_to_fence: Any = None):
        t0 = time.perf_counter()
        yield
        if result_to_fence is not None:
            fence(result_to_fence)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.6f} seconds" for k, v in self.phases.items())


@dataclasses.dataclass
class SolveMetrics:
    """Per-solve record: history + derived convergence data + throughput."""

    history: np.ndarray
    wall_time_s: float = 0.0
    nnz: int = 0
    cycles: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def iterations(self) -> int:
        return max(len(self.history) - 1, 0)

    @property
    def reduction_factors(self) -> np.ndarray:
        h = self.history
        return h[1:] / np.where(h[:-1] == 0, 1.0, h[:-1])

    @property
    def convergence_factor(self) -> float:
        """Geometric mean reduction per iteration (tail-weighted)."""
        f = self.reduction_factors
        if f.size == 0:
            return 0.0
        tail = f[len(f) // 2:]
        return float(np.exp(np.mean(np.log(np.maximum(tail, 1e-300)))))

    @property
    def nnz_per_s(self) -> float:
        if self.wall_time_s <= 0:
            return 0.0
        return self.nnz * self.cycles / self.wall_time_s

    def to_dict(self) -> dict:
        return {
            "iterations": self.iterations,
            "final_residual": float(self.history[-1]) if len(self.history) else None,
            "convergence_factor": self.convergence_factor,
            "wall_time_s": self.wall_time_s,
            "nnz": self.nnz,
            "cycles": self.cycles,
            "nnz_per_s": self.nnz_per_s,
            "history": [float(x) for x in self.history],
            **self.extra,
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    def write_csv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("iteration,residual,reduction\n")
            h = self.history
            for k, r in enumerate(h):
                red = "" if k == 0 else f"{h[k] / h[k - 1]:.6e}"
                fh.write(f"{k},{r:.17e},{red}\n")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``jax.profiler`` trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
