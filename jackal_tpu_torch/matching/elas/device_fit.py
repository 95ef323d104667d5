"""ELAS plane fit on the device in float64, bit-equal to the C++ engine.

computeDisparityPlanes (elas.cpp:507-577) fits d = a*u + b*v + c per
Delaunay triangle with a full-pivot 3x3 Gauss-Jordan in float64
(matrix.cpp:414-502; the port's C++ twin: native/prior_engine.cpp solve3).
The card has native float64, so the solve runs in torch.float64 with the
reference's operations in the reference's order, vectorized over the
triangles:

  per k in 0..2:
    full pivot over the trailing submatrix, strict-> first-wins scan order
    (the first maximal |A[i][j]| in i-major order);
    fail if the pivot's magnitude < 1e-20;
    row swap (A, b) and column swap (A, column index);
    A[k][:] /= piv; b[k] /= piv
    rows i != k: f = A[i][k]; A[i][:] -= f*A[k][:]; b[i] -= f*b[k]
  unscramble: out[idx[k]] = b[k]; singular -> (0, 0, 0)

Each multiply, subtract and divide is its own eager op, so none is fused
into an FMA; float64 division is correctly rounded on the CPU and the card.
The outputs are the float64 results cast to float32, like the C++ engine's.
"""
from __future__ import annotations

import torch

from ...device import DeviceLike, resolve_device

_EPS = 1e-20        # singularity gate (matrix.cpp)


def _swap(idx3: torch.Tensor, k: int, p: torch.Tensor) -> torch.Tensor:
    """[T, 3] permutation exchanging positions k and p[t]."""
    p = p[:, None]
    return torch.where(idx3 == k, p, torch.where(idx3 == p, k, idx3))


def _gj_solve3(A: torch.Tensor, b: torch.Tensor):
    """A [T, 3, 3] float64, b [T, 3] float64 -> (x [T, 3] float64,
    ok [T] bool)."""
    T = A.shape[0]
    dev = A.device
    idx3 = torch.arange(3, device=dev).expand(T, 3)
    colidx = idx3
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    for k in range(3):
        elig = torch.zeros(3, 3, dtype=torch.bool, device=dev)
        elig[k:, k:] = True
        mag = torch.where(elig, A.abs(), -1.0).reshape(T, 9)
        best = mag.max(dim=1).values
        # the first maximal entry in i-major order: argmax returns the
        # first index of the maximum
        sel = (mag == best[:, None]).to(torch.uint8).argmax(dim=1)
        pr, pc = sel // 3, sel % 3
        ok = ok & (best >= _EPS)

        permr = _swap(idx3, k, pr)
        A = torch.gather(A, 1, permr[:, :, None].expand(T, 3, 3))
        b = torch.gather(b, 1, permr)
        permc = _swap(idx3, k, pc)
        A = torch.gather(A, 2, permc[:, None, :].expand(T, 3, 3))
        colidx = torch.gather(colidx, 1, permc)

        piv = A[:, k, k]
        Ak = A[:, k] / piv[:, None]
        bk = b[:, k] / piv
        rows, brows = [], []
        for i in range(3):
            if i == k:
                rows.append(Ak)
                brows.append(bk)
            else:
                f = A[:, i, k]
                rows.append(A[:, i] - f[:, None] * Ak)
                brows.append(b[:, i] - f * bk)
        A = torch.stack(rows, dim=1)
        b = torch.stack(brows, dim=1)

    out = torch.zeros_like(b).scatter(1, colidx, b)     # out[idx[k]] = b[k]
    return torch.where(ok[:, None], out, 0.0), ok


def _fit_planes_impl(support: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """support [N, 3] int32 (u, v, d), tri [T, 3] int32 -> [T, 6] float32
    (t1a, t1b, t1c, t2a, t2b, t2c), equal to fit_planes_native bit for
    bit."""
    t = tri.long()
    u, v, d = (support[:, i][t].to(torch.float64) for i in range(3))
    one = torch.ones_like(u)
    outs = []
    for right in (False, True):
        A = torch.stack([u - d if right else u, v, one], dim=-1)
        x, _ = _gj_solve3(A, d)
        outs.append(x.to(torch.float32))
    return torch.cat(outs, dim=-1)


def fit_planes_device(support, tri, device: DeviceLike = None) -> torch.Tensor:
    """Plane fit of ``tri`` over ``support`` on ``device`` (the card unless
    ``device="cpu"``): [T, 6] float32."""
    dev = resolve_device(device)
    return _fit_planes_impl(torch.as_tensor(support).to(dev, torch.int32),
                            torch.as_tensor(tri).to(dev, torch.int32))
