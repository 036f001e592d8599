"""A/B benchmark: halo-exchange/compute overlap in the sharded RB-GS sweep.

Times the SAME sharded red-black Gauss-Seidel sweep chain with the
interior/edge split (``overlap=True`` — the ppermute rides under the
interior update, SURVEY.md §7.4.4) vs the exchange-then-compute reference
schedule (``overlap=False`` — every element of the neighbor sum
data-depends on the collective).  Both produce bitwise-identical results
(asserted here and in ``tests/test_sharded_gmg.py``).

Differential timing (chain of K vs K+D sweeps, subtract) cancels the
dispatch latency.  Optional ``--trace DIR`` captures a ``jax.profiler``
trace of a short chain of each variant for scheduler-level evidence.

On a single-device mesh the ppermute is degenerate — the A/B is only
meaningful on >= 2 devices (several GPUs, or the virtual 8-device CPU
mesh, which validates the schedule shapes but not interconnect timing;
the JSON notes which).

    python -m benchmarks.overlap_ab [--n 4096] [--trace DIR]
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m benchmarks.overlap_ab --n 1024
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--few", type=int, default=25)
    ap.add_argument("--delta", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="directory for jax.profiler traces (one per variant)")
    ap.add_argument("--platform", default=None,
                    help="force jax platform before first use (cpu spawns 8 "
                         "virtual devices); env JAX_PLATFORMS may be "
                         "overridden by site customization, this is not")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu":
            jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multigrid_prj_tpu.parallel.sharded_gmg import AXIS, rbgs_local

    devs = jax.devices()
    p = len(devs)
    n = args.n - args.n % (2 * p)  # divisible shards
    mesh = Mesh(np.array(devs), (AXIS,))
    spec = P(AXIS, None)
    sharding = NamedSharding(mesh, spec)
    gshape = (n, n)
    alpha, h = 10.0, 10.0 / (n - 1)

    def chain(sweeps: int, overlap: bool):
        def local(u, b):
            return rbgs_local(u, b, alpha, h, gshape, (AXIS,),
                              sweeps=sweeps, overlap=overlap)

        return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=spec))

    rng = np.random.default_rng(0)
    u = jax.device_put(jnp.asarray(rng.standard_normal(gshape), jnp.float32),
                       sharding)
    b = jax.device_put(jnp.asarray(rng.standard_normal(gshape), jnp.float32),
                       sharding)

    def fence(x):
        jax.block_until_ready(x)

    # bitwise equivalence of the two schedules
    y_ov = chain(2, True)(u, b)
    y_no = chain(2, False)(u, b)
    assert np.array_equal(np.asarray(y_ov), np.asarray(y_no)), \
        "overlap schedule changed the numbers"

    rec = {"bench": "overlap_ab", "devices": p, "n": n,
           "backend": jax.default_backend(),
           "bitwise_equal": True}

    results = {}
    for tag, ov in (("overlap", True), ("no_overlap", False)):
        few = chain(args.few, ov)
        many = chain(args.few + args.delta, ov)
        fence(few(u, b))
        fence(many(u, b))
        diffs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fence(few(u, b))
            t1 = time.perf_counter()
            fence(many(u, b))
            t2 = time.perf_counter()
            diffs.append((t2 - t1) - (t1 - t0))
        diffs.sort()
        per_sweep = diffs[len(diffs) // 2] / args.delta
        results[tag] = per_sweep
        rec[f"{tag}_us_per_sweep"] = per_sweep * 1e6
        if args.trace:
            with jax.profiler.trace(f"{args.trace}/{tag}"):
                fence(few(u, b))

    rec["speedup_overlap"] = results["no_overlap"] / results["overlap"]
    if p == 1:
        rec["note"] = ("single-device mesh: ppermute degenerate, A/B not "
                       "meaningful — run on several devices")
    elif jax.default_backend() == "cpu":
        rec["note"] = ("virtual CPU devices: validates schedule shapes, "
                       "not interconnect overlap timing")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
