"""What the jitted reference scan computes on XLA:CPU, beside what PyTorch
computes on the CPU: the characterisation behind scan/obstacle.py's flush
rules. Prints one JSON line.

    JAX_PLATFORMS=cpu python tools/probe_scan_flush.py [--pairs N]

  - atan2: jax.jit(jnp.arctan2) against torch.atan2 and the port's
    _atan2_xla (glibc's atan2f under denormals-are-zero and
    flush-to-zero), on every pair of the operand classes (+-0,
    subnormals, the least normal, tiny and unit normals, +-inf, NaN,
    seeded subnormals) and on N seeded pairs of normal floats;
  - products, sums and comparisons on the class grid: the jitted result
    against IEEE's and against the port's ftz;
  - the range: the reference's range_min of one-point sets against the
    separately rounded sqrt(x*x + y*y), sqrt(fma(x, x, y*y)) and
    sqrt(fma(y, y, x*x)); and torch's CPU float32 sqrt against numpy's
    (correctly rounded) on N seeded floats;
  - the angle extrema: the reference's angle_min and angle_max of two
    points whose angles are +-0 or subnormal, against the port's.

Runs on the CPU only, at small sizes (about 20 s).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import scan_classes  # noqa: E402
from jackal_tpu.scan import obstacle as jobs  # noqa: E402
from jackal_tpu_torch.ops.convert import ftz  # noqa: E402
from jackal_tpu_torch.scan import obstacle as obs  # noqa: E402


def differ(a, b) -> int:
    """Elements whose float32 bits differ (any NaN equal to any NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both = np.isnan(a) & np.isnan(b)
    return int(((a.view(np.int32) != b.view(np.int32)) & ~both).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=200000)
    n = ap.parse_args(argv).pairs
    out = {}
    c = scan_classes()
    y, x = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    Y, X = torch.from_numpy(y), torch.from_numpy(x)
    ref = np.asarray(jax.jit(jnp.arctan2)(y, x))
    out["atan2_class_pairs"] = {
        "pairs": int(y.size), "torch_differs": differ(torch.atan2(Y, X), ref),
        "port_differs": differ(obs._atan2_xla(Y, X), ref)}
    rng = np.random.default_rng(0)
    ys = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(
        np.float32)
    xs = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(
        np.float32)
    ref = np.asarray(jax.jit(jnp.arctan2)(ys, xs))
    Ys, Xs = torch.from_numpy(ys), torch.from_numpy(xs)
    out["atan2_normal_pairs"] = {
        "pairs": n, "torch_differs": differ(torch.atan2(Ys, Xs), ref),
        "port_differs": differ(obs._atan2_xla(Ys, Xs), ref)}
    for name, f in (("product", lambda a, b: a * b),
                    ("sum", lambda a, b: a + b)):
        ref = np.asarray(jax.jit(f)(x, y))
        out[name] = {"ieee_differs": differ(f(X, Y), ref),
                     "port_differs": differ(ftz(f(ftz(X), ftz(Y))), ref)}
    ref = np.asarray(jax.jit(lambda a, b: a < b)(x, y))
    out["less"] = {"ieee_differs": int(((X < Y).numpy() != ref).sum()),
                   "port_differs": int(((ftz(X) < ftz(Y)).numpy()
                                        != ref).sum())}
    f32, f64 = np.float32, np.float64
    m = 1000
    px = rng.uniform(-3, 6, m).astype(f32)
    py = rng.uniform(-5, 5, m).astype(f32)
    got = np.array([float(jobs.obstacle_scan_from_points(
        jnp.asarray([[a, b, 0.5]], jnp.float32), jnp.ones(1, bool)).range_min)
        for a, b in zip(px, py)], f32)
    sep = np.sqrt((px * px + py * py).astype(f32))
    fxx = np.sqrt((px.astype(f64) * px + (py * py).astype(f64)).astype(f32))
    fyy = np.sqrt((py.astype(f64) * py + (px * px).astype(f64)).astype(f32))
    out["range_one_point_sets"] = {
        "sets": m, "separate_differs": differ(sep, got),
        "fma_x_x_yy_differs": differ(fxx, got),
        "fma_y_y_xx_differs": differ(fyy, got)}
    v = np.abs(rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
               ).astype(f32)
    out["cpu_sqrt"] = {"floats": n, "torch_differs_from_numpy": differ(
        torch.sqrt(torch.from_numpy(v)), np.sqrt(v))}
    ties = [f32(0.0), f32(-0.0), f32(1e-40), f32(-1e-40)]
    wrong = 0
    for a in ties:
        for b in ties:
            pts = np.array([[1.0, a, 0.5], [1.0, b, 0.5]], f32)
            want = jobs.obstacle_scan_from_points(jnp.asarray(pts),
                                                  jnp.ones(2, bool))
            have = obs.obstacle_scan_from_points(torch.from_numpy(pts),
                                                 torch.ones(2, dtype=bool))
            wrong += differ([have.angle_min, have.angle_max],
                            [want.angle_min, want.angle_max])
    out["angle_extrema_of_zero_and_subnormal_pairs"] = {
        "pairs": len(ties) ** 2, "port_differs": wrong}
    print(json.dumps({"scan_flush_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
