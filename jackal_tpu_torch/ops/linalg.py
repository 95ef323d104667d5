"""The dense linear algebra of the reference's Matrix class, batched in
PyTorch.

The reference vendors libviso2's double-precision Matrix (matrix.h:49-131);
ELAS uses it only through 3x3 solves (plane fitting, elas.cpp:507-577).
This is its solve / lu / svd surface as batched tensor ops:

  - gauss_jordan_solve: Gauss-Jordan elimination with full pivoting and
    the reference's singularity contract (matrix.cpp:414-502): where it
    returns false (a |pivot| < 1e-20), a per-system ``ok`` flag is False
    and that system's outputs are zeros;
  - lu: Doolittle factorization with implicit-scaling partial pivoting and
    the zero-pivot substitution TINY = 1e-20 (matrix.cpp:511-574);
  - svd: A = U diag(w) V^T, the output convention of Matrix::svd
    (matrix.cpp:576-821), by torch.linalg.svd; signs and the order of
    equal singular values are those of the LAPACK build.

Each takes its dtype from the input: float64 in, float64 out (an integer
input computes in float64, the reference's double). Each runs on
``device``: a tensor stays on its own device unless one is named, a numpy
array goes to the card unless ``device="cpu"``. The systems of a
batch ([..., M, M]) are eliminated together, one pivot step at a time.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, as_input


def _float(x, device: DeviceLike) -> torch.Tensor:
    t = as_input(x, device)
    return t if t.is_floating_point() else t.to(torch.float64)


def _swap_rows(X: torch.Tensor, n: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> None:
    """In place: swap rows a[k] and b[k] of X[k] for every system k."""
    ra, rb = X[n, a].clone(), X[n, b].clone()
    X[n, a] = rb
    X[n, b] = ra


def gauss_jordan_solve(A, B, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve A X = B by Gauss-Jordan elimination with full pivoting.

    A: [..., M, M], B: [..., M, K]. Returns (A_inv, X, ok): the inverse the
    reference leaves in A, the solution it leaves in B, and ok = False
    where a |pivot| < 1e-20 was met (both outputs zero there)."""
    A = _float(A, device)
    B = _float(B, A.device)
    batch, M, K = A.shape[:-2], A.shape[-1], B.shape[-1]
    A = A.reshape(-1, M, M).clone()
    B = B.reshape(-1, M, K).clone()
    N, dev = A.shape[0], A.device
    n = torch.arange(N, device=dev)
    ar = torch.arange(M, device=dev)
    ipiv = torch.zeros((N, M), dtype=torch.int64, device=dev)
    indxr = torch.zeros((N, M), dtype=torch.int64, device=dev)
    indxc = torch.zeros((N, M), dtype=torch.int64, device=dev)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    for i in range(M):
        # the largest |A| over rows and columns not yet pivoted (first in
        # row-major order on ties)
        free = (ipiv == 0)
        cand = free[:, :, None] & free[:, None, :]
        flat = torch.where(cand, A.abs(), -1.0).reshape(N, -1).argmax(1)
        irow, icol = flat // M, flat % M
        ipiv[n, icol] += 1
        _swap_rows(A, n, irow, icol)
        _swap_rows(B, n, irow, icol)
        indxr[:, i], indxc[:, i] = irow, icol
        piv = A[n, icol, icol]
        small = piv.abs() < 1e-20
        ok &= ~small
        pivinv = torch.where(small, 0.0, 1.0 / piv)
        A[n, icol, icol] = 1.0
        A[n, icol] *= pivinv[:, None]
        B[n, icol] *= pivinv[:, None]
        # eliminate column icol from every other row
        dum = A[n, :, icol].clone()
        dum[n, icol] = 0.0
        A[n, :, icol] = torch.where(ar[None] == icol[:, None], A[n, :, icol],
                                    0.0)
        A = A - dum[:, :, None] * A[n, icol][:, None, :]
        B = B - dum[:, :, None] * B[n, icol][:, None, :]
    # undo the column swaps in reverse order (matrix.cpp:494-500)
    for i in range(M - 1, -1, -1):
        r, c = indxr[:, i], indxc[:, i]
        cr, cc = A[n, :, r].clone(), A[n, :, c].clone()
        A[n, :, r] = cc
        A[n, :, c] = cr
    A = torch.where(ok[:, None, None], A, 0.0)
    B = torch.where(ok[:, None, None], B, 0.0)
    return (A.reshape(*batch, M, M), B.reshape(*batch, M, K),
            ok.reshape(batch))


def lu(A, device: DeviceLike = None
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Doolittle LU with implicit-scaling partial pivoting (matrix.cpp:
    511-574), Crout's column order. Returns (LU, idx, d, ok): the packed
    factors, the row interchange of each step (int32), the permutation's
    sign d in {-1, +1}, and ok = False where a row of zeros made A
    singular. A zero pivot becomes TINY = 1e-20, as in the reference."""
    A = _float(A, device)
    batch, M = A.shape[:-2], A.shape[-1]
    A = A.reshape(-1, M, M).clone()
    N, dev, dt = A.shape[0], A.device, A.dtype
    n = torch.arange(N, device=dev)
    ar = torch.arange(M, device=dev)
    rowmax = A.abs().amax(2)
    vv_ok = rowmax > 0.0
    ok = vv_ok.all(1)
    vv = 1.0 / torch.where(vv_ok, rowmax, 1.0)
    idx = torch.zeros((N, M), dtype=torch.int32, device=dev)
    d = torch.ones(N, dtype=dt, device=dev)
    for j in range(M):
        # column j of the factors, row by row in order (each row reads
        # the rows above it as updated)
        for i in range(M):
            s = torch.where(ar < min(i, j), A[:, i] * A[:, :, j], 0.0)
            A[:, i, j] = A[:, i, j] - s.sum(1)
        merit = torch.where(ar[None] >= j, vv * A[:, :, j].abs(), -1.0)
        imax = merit.argmax(1)
        _swap_rows(A, n, torch.full_like(imax, j), imax)
        vv[n, imax] = vv[:, j]
        d = torch.where(imax != j, -d, d)
        idx[:, j] = imax.to(torch.int32)
        piv = torch.where(A[:, j, j] == 0.0, 1e-20, A[:, j, j])
        A[:, j, j] = piv
        below = ar[None] > j
        A[:, :, j] = A[:, :, j] * torch.where(below, 1.0 / piv[:, None], 1.0)
    return (A.reshape(*batch, M, M), idx.reshape(*batch, M),
            d.reshape(batch), ok.reshape(batch))


def svd(A, device: DeviceLike = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, w, V) with A = U @ diag(w) @ V^T, w descending (the reference
    leaves its values unsorted; for distinct values descending is the
    order a caller sorting by magnitude gets)."""
    U, s, Vh = torch.linalg.svd(_float(A, device), full_matrices=False)
    return U, s, Vh.transpose(-1, -2)
