"""The port's L2 surface on the CPU == jackal_tpu's: the remaining
filter.cpp kernels bit for bit (and equal to the compiled reference's
goldens on their defined region), the Matrix linalg surface in float64.

linalg: the port computes in the input's float64. It is held against
jackal_tpu.ops.linalg run under jax.enable_x64(True) (float64) on the
same systems. lu is bit-equal. gauss_jordan_solve has equal ok flags and
values within rtol 1e-12, atol 1e-12: the reference's jitted elimination
step is not bit-equal to the port's eager one (over 4096 random 3x3
systems up to 5.5e-10 apart at values near 1e5), as XLA:CPU may contract
its multiply and subtract into an FMA where each eager op rounds. In
float32, against the reference package's default dtype, rtol and atol
1e-5 on the seeded systems. svd is held by its reconstruction and
its singular values (signs and the order of equal values are the LAPACK
build's), as the reference's tests/test_filters_linalg.py holds it.
"""
import numpy as np
import pytest
import torch
import jax

from jackal_tpu.ops import filters as jf
from jackal_tpu.ops import linalg as jl
from jackal_tpu_torch.ops import filters as pf
from jackal_tpu_torch.ops import linalg as pl

FIX = "tests/fixtures"
RTOL = ATOL = 1e-12


@pytest.fixture(scope="module")
def golden():
    return np.load(f"{FIX}/filters_golden.npz")


def _defined_mask(H, W):
    m = np.zeros(H * W, bool)
    m[2:H * W - 20] = True          # flat head unwritten / tail reads OOB
    m = m.reshape(H, W)
    m[:2] = m[H - 2:] = False       # column passes write rows [2, H-2)
    return m


def _images():
    rng = np.random.default_rng(5)
    return {"golden": np.load(f"{FIX}/filters_golden.npz")["img"],
            "random_37x53": rng.integers(0, 256, (37, 53)).astype(np.uint8),
            "flat_white": np.full((9, 12), 255, np.uint8),
            "photo_crop": np.load(f"{FIX}/elas_golden_photo.npz")["left"][
                100:196, 200:360]}


@pytest.mark.parametrize("name", sorted(_images()))
def test_filters_bit_equal_jax(name):
    img = _images()[name]
    ii = pf.integral_image(img, "cpu")
    assert ii.dtype == torch.int32
    np.testing.assert_array_equal(ii.numpy(),
                                  np.asarray(jf.integral_image(img)))
    du, dv = pf.sobel5x5(img, "cpu")
    jdu, jdv = jf.sobel5x5(img)
    assert du.dtype == dv.dtype == torch.uint8
    np.testing.assert_array_equal(du.numpy(), np.asarray(jdu))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jdv))
    cb = pf.checkerboard5x5(img, "cpu")
    assert cb.dtype == torch.int16
    np.testing.assert_array_equal(cb.numpy(),
                                  np.asarray(jf.checkerboard5x5(img)))
    bl = pf.blob5x5(img, "cpu")
    assert bl.dtype == torch.int16
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jf.blob5x5(img)))


def test_filters_equal_reference_goldens(golden):
    img = golden["img"]
    H, W = img.shape
    np.testing.assert_array_equal(pf.integral_image(img, "cpu").numpy(),
                                  golden["ii"])
    m = _defined_mask(H, W)
    du, dv = (x.numpy() for x in pf.sobel5x5(torch.from_numpy(img)))
    np.testing.assert_array_equal(du[m], golden["du"][m])
    np.testing.assert_array_equal(dv[m], golden["dv"][m])
    np.testing.assert_array_equal(pf.checkerboard5x5(img, "cpu").numpy()[m],
                                  golden["cb"][m])
    mb = np.zeros(H * W, bool)
    mb[3 + 3 * W:H * W - 2 - 2 * W] = True
    mb = mb.reshape(H, W)
    np.testing.assert_array_equal(pf.blob5x5(img, "cpu").numpy()[mb],
                                  golden["bl"][mb])


def test_host_arrays_go_to_the_card(monkeypatch):
    """A numpy input runs on the card unless device="cpu" (without one,
    resolve_device's error); a tensor stays on its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _images()["random_37x53"]
    A, B = _systems()
    for call in (lambda: pf.integral_image(img), lambda: pf.sobel5x5(img),
                 lambda: pf.checkerboard5x5(img), lambda: pf.blob5x5(img),
                 lambda: pl.gauss_jordan_solve(A, B), lambda: pl.lu(A),
                 lambda: pl.svd(A)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    t = torch.from_numpy(img)
    assert torch.equal(pf.blob5x5(t), pf.blob5x5(img, "cpu"))
    assert pl.lu(torch.from_numpy(A))[0].device == torch.device("cpu")


def _systems():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 3, 3))
    A[5] = 0.0                                        # all zero
    A[6] = np.outer([1.0, 2.0, 3.0], [1.0, 0.0, 1.0])  # rank 1
    A[7] = np.eye(3)
    A[8] = [[0.0, 2.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 3.0]]  # swaps
    A[9] = [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]  # ties
    return A, rng.standard_normal((64, 3, 2))


def test_gauss_jordan_equal_jax_x64():
    A, B = _systems()
    Ai, X, ok = pl.gauss_jordan_solve(A, B, "cpu")
    assert Ai.dtype == X.dtype == torch.float64 and ok.dtype == torch.bool
    with jax.enable_x64(True):
        jAi, jX, jok = (np.asarray(x) for x in jl.gauss_jordan_solve(A, B))
    assert jAi.dtype == np.float64
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert not ok[5] and not ok[6] and ok[7] and ok[8]
    np.testing.assert_allclose(Ai.numpy(), jAi, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(X.numpy(), jX, rtol=RTOL, atol=ATOL)
    good = ok.numpy()
    np.testing.assert_allclose(X.numpy()[good],
                               np.linalg.solve(A[good], B[good]),
                               rtol=1e-9, atol=1e-9)
    assert (X.numpy()[~good] == 0).all() and (Ai.numpy()[~good] == 0).all()


def test_gauss_jordan_batch_shapes_and_float32():
    A, B = _systems()
    Ai, X, ok = pl.gauss_jordan_solve(A.reshape(8, 8, 3, 3),
                                      B.reshape(8, 8, 3, 2), "cpu")
    assert Ai.shape == (8, 8, 3, 3) and X.shape == (8, 8, 3, 2)
    assert ok.shape == (8, 8)
    Ai1, X1, ok1 = pl.gauss_jordan_solve(A, B, "cpu")
    assert torch.equal(Ai.reshape(64, 3, 3), Ai1)
    assert torch.equal(X.reshape(64, 3, 2), X1)
    # float32 in, float32 out, against the reference package's default
    A32, B32 = A.astype(np.float32), B.astype(np.float32)
    Ai, X, ok = pl.gauss_jordan_solve(A32, B32, "cpu")
    assert X.dtype == torch.float32
    jAi, jX, jok = (np.asarray(x) for x in jl.gauss_jordan_solve(A32, B32))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(X.numpy(), jX, rtol=1e-5, atol=1e-5)


def test_lu_equal_jax_x64_and_reconstructs():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((16, 4, 4))
    A[3] = 0.0
    A[3, 1] = [1.0, 2.0, 3.0, 4.0]                  # rows of zeros
    A[4, :, 0] = 0.0                                  # a zero pivot
    LU, idx, d, ok = pl.lu(A, "cpu")
    assert LU.dtype == torch.float64 and idx.dtype == torch.int32
    with jax.enable_x64(True):
        jLU, jidx, jd, jok = (np.asarray(x) for x in jl.lu(A))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(LU.numpy(), jLU)
    assert not ok[3] and ok[0]
    LUn, idxn = LU.numpy(), idx.numpy()
    for b in (0, 1, 2, 5):
        L = np.tril(LUn[b], -1) + np.eye(4)
        U = np.triu(LUn[b])
        PA = A[b].copy()
        for j in range(4):              # replay the recorded row swaps
            PA[[j, idxn[b, j]]] = PA[[idxn[b, j], j]]
        np.testing.assert_allclose(L @ U, PA, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(float(d[b]) * np.prod(np.diag(LUn[b])),
                                   np.linalg.det(A[b]), rtol=1e-10)


@pytest.mark.parametrize("shape", [(5, 4), (3, 6), (7, 3, 3)])
def test_svd_convention(shape):
    A = np.random.default_rng(2).standard_normal(shape)
    U, w, V = pl.svd(A, "cpu")
    assert w.dtype == torch.float64
    Un, wn, Vn = U.numpy(), w.numpy(), V.numpy()
    np.testing.assert_allclose(Un @ (wn[..., :, None] * np.swapaxes(
        Vn, -1, -2)), A, rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        _, jw, _ = jl.svd(A)
    np.testing.assert_allclose(wn, np.asarray(jw), rtol=1e-12, atol=1e-12)
    assert (np.diff(wn, axis=-1) <= 0).all()
