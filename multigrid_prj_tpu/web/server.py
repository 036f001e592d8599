"""Web front-end: parameter form + solver runner + convergence chart.

Capability parity with the reference's ``WebInterface/`` (PHP):

* parameter form for ``N, a, width, level, test, smoother``
  (``home.php:60-100``) — the test-function dropdown is populated from the
  registry in ``models/poisson.py`` (the reference *scrapes the C++ source*
  between ``// FFF`` / ``// END`` markers, ``FuncHandle.php:19-26``; here the
  registry is introspected directly);
* run button executes the GMG solver (the reference shells out to the
  compiled binary, ``home.php:103``; here the solver runs in-process);
* timing line and iteration count in the response (``home.php:106-121``);
* residual-history chart (the reference fetches ``MGGS4.txt`` into Chart.js,
  ``home.php:136-198``; here a dependency-free canvas chart — this sandbox
  has no CDN egress);
* download links for ``x.mtx`` and ``MGGS4.txt`` (``home.php:123-129``).

Run: ``python -m multigrid_prj_tpu.web.server --port 8765 [--workdir DIR]``
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# One solve at a time: ThreadingHTTPServer handles each POST on its own
# thread, and two concurrent solves would interleave writes to MGGS4.txt /
# x.mtx (and contend for the one accelerator).  The reference has the same
# serialization implicitly — PHP shells out to one binary at a time per
# request, writing the same files (``home.php:103,127-128``).
_SOLVE_LOCK = threading.Lock()

PAGE = """<!DOCTYPE html>
<html><head><title>multigrid_prj_tpu</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 760px; }}
fieldset {{ border: 1px solid #999; border-radius: 6px; margin-bottom: 1rem; }}
label {{ display: inline-block; width: 14rem; margin: .25rem 0; }}
#out {{ white-space: pre-line; background: #f5f5f5; padding: .6rem; border-radius: 6px; }}
canvas {{ border: 1px solid #ccc; margin-top: 1rem; }}
</style></head>
<body>
<h2>JAX multigrid — geometric solver</h2>
<form id="f">
<fieldset><legend>Parameters</legend>
<label>Coarse-grid nodes per side (N)</label><input name="n" value="9"><br>
<small>finest grid = N upscaled by 2N&minus;1 per level, as the reference UI</small><br>
<label>Diffusion constant (a)</label><input name="a" value="10.0"><br>
<label>Domain width (w)</label><input name="w" value="10.0"><br>
<label>Multigrid levels (ml)</label><input name="ml" value="4"><br>
<label>Test functions</label><select name="test">{options}</select><br>
<label>Smoother</label>
<select name="smt"><option value="0">Gauss-Seidel (red-black)</option>
<option value="1">Jacobi</option><option value="2">BiCGSTAB + MG</option></select><br>
<label>Cycle</label>
<select name="cycle"><option>sawtooth</option><option>v</option><option>w</option></select>
</fieldset>
<button type="submit">Solve</button>
</form>
<p id="out"></p>
<p><a href="/MGGS4.txt" download>Download residual history</a> &middot;
   <a href="/x.mtx" download>Download solution</a></p>
<canvas id="chart" width="720" height="360"></canvas>
<script>
const f = document.getElementById('f'), out = document.getElementById('out');
f.addEventListener('submit', async (e) => {{
  e.preventDefault();
  out.textContent = 'solving...';
  const r = await fetch('/run', {{method: 'POST',
    body: new URLSearchParams(new FormData(f))}});
  const j = await r.json();
  if (j.error) {{ out.textContent = 'Error: ' + j.error; return; }}
  out.textContent = `Converged: ${{j.converged}}  Iterations: ${{j.iterations}}` +
    `  Final rel. residual: ${{j.final_residual.toExponential(3)}}` +
    `\\n||Solving elapsed time: ${{j.solve_time.toFixed(3)}} sec`;
  drawChart(j.history);
}});
function drawChart(h) {{
  const c = document.getElementById('chart'), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  const logs = h.map(v => Math.log10(Math.max(v, 1e-300)));
  const ymax = Math.max(...logs), ymin = Math.min(...logs);
  const L = 50, B = 30, W = c.width - L - 10, H = c.height - B - 10;
  const X = i => L + W * i / Math.max(h.length - 1, 1);
  const Y = v => 10 + H * (ymax - v) / Math.max(ymax - ymin, 1e-9);
  g.strokeStyle = '#888'; g.strokeRect(L, 10, W, H);
  g.fillStyle = '#000'; g.font = '12px sans-serif';
  for (let d = Math.ceil(ymin); d <= ymax; d += 2) {{
    g.fillText('1e' + d, 4, Y(d) + 4);
    g.strokeStyle = '#eee'; g.beginPath();
    g.moveTo(L, Y(d)); g.lineTo(L + W, Y(d)); g.stroke();
  }}
  g.strokeStyle = '#0b62d6'; g.lineWidth = 2; g.beginPath();
  logs.forEach((v, i) => i ? g.lineTo(X(i), Y(v)) : g.moveTo(X(i), Y(v)));
  g.stroke();
  g.fillText('iteration', L + W / 2 - 20, c.height - 8);
}}
fetch('/MGGS4.txt').then(r => r.ok ? r.text() : null).then(t => {{
  if (!t) return;
  const vals = t.trim().split('\\n').slice(1).map(Number);
  if (vals.length > 1) drawChart(vals);
}});
</script></body></html>
"""


def _test_options() -> str:
    from multigrid_prj_tpu.models.poisson import TEST_FUNCTIONS

    opts = []
    for i, (f, g) in sorted(TEST_FUNCTIONS.items()):
        fsrc = inspect.getsource(f).strip().split("return")[-1].strip()
        opts.append(f'<option value="{i}">test {i}: f = {fsrc[:60]}</option>')
    return "\n".join(opts)


class Handler(BaseHTTPRequestHandler):
    workdir = "."

    def _send(self, code: int, body: bytes, ctype: str = "text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            page = PAGE.format(options=_test_options())
            self._send(200, page.encode())
        elif self.path in ("/MGGS4.txt", "/x.mtx"):
            p = os.path.join(self.workdir, self.path.lstrip("/"))
            if os.path.exists(p):
                with open(p, "rb") as fh:
                    self._send(200, fh.read(), "text/plain")
            else:
                self._send(404, b"not found", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/run":
            self._send(404, b"not found", "text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        form = dict(urllib.parse.parse_qsl(self.rfile.read(length).decode()))
        try:
            with _SOLVE_LOCK:
                result = run_solver(form, self.workdir)
            self._send(200, json.dumps(result).encode(), "application/json")
        except Exception as e:  # surface solver errors to the page
            self._send(200, json.dumps({"error": str(e)}).encode(),
                       "application/json")

    def log_message(self, fmt, *args):
        pass  # quiet


def run_solver(form: dict, workdir: str) -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.utils.io import save_history, save_vector

    n = int(form.get("n", 65))
    a = float(form.get("a", 10.0))
    w = float(form.get("w", 10.0))
    ml = int(form.get("ml", 4))
    test = int(form.get("test", 1))
    smt = int(form.get("smt", 0))
    cycle = form.get("cycle", "sawtooth")
    # The reference's form takes the COARSEST grid size and upscales it per
    # level: N <- N * 2 - 1, (ml - 1) times (``WebInterface/home.php:93-98``),
    # so the entered grid nests exactly in the multigrid hierarchy.
    for _ in range(ml - 1):
        n = n * 2 - 1
    if not (3 <= n <= 4097):
        raise ValueError(f"finest N = {n} out of range [3, 4097] "
                         "(N is upscaled by 2N-1 per level, as the reference)")
    if ml < 1:
        raise ValueError("levels must be >= 1")

    dtype = jnp.float64
    tol = 1e-11
    solver = GMGSolver(
        shape=(n, n), length=w, alpha=a, num_levels=ml,
        smoother="jacobi" if smt == 1 else "gs", cycle=cycle, tol=tol,
    )
    b = assemble_rhs(solver.levels[0], w, test=test, dtype=dtype)
    t0 = time.perf_counter()
    if smt == 2:
        from multigrid_prj_tpu.ops.krylov import bicgstab
        from multigrid_prj_tpu.ops.stencil import poisson_apply

        h0 = solver.levels[0].h
        res = bicgstab(
            lambda x: poisson_apply(x, a, h0), b, tol=tol, maxit=200,
            M=lambda r: solver.step(jnp.zeros_like(r), r), history=True,
        )
        u = res.x
        hist = np.asarray(res.history)  # per-iteration, from inside the loop
        iters, converged = res.iterations, bool(res.converged)
    else:
        out = solver.solve(b)
        u, hist = out.u, np.asarray(out.history)
        iters, converged = out.iterations, bool(out.converged)
    dt = time.perf_counter() - t0
    save_history(os.path.join(workdir, "MGGS4.txt"), hist)
    save_vector(os.path.join(workdir, "x.mtx"), np.asarray(u).reshape(-1))
    return {
        "iterations": iters,
        "converged": converged,
        "final_residual": float(hist[-1]),
        "solve_time": dt,
        "history": [float(x) for x in hist],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--workdir", default=".")
    args = ap.parse_args(argv)
    Handler.workdir = args.workdir
    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"serving on http://{args.host}:{args.port}")
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
