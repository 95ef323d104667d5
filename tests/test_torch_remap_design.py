"""A numpy model of kernel N's two paths against the rectify warp's plain
version, on the CPU.

Kernel N (jackal_tpu_torch/csrc/remap_kernel.cu) gives a block a 64 x 16
output tile. It reduces the tile's source box from the maps alone (the
least and largest tap x0, y0, plus one), widens it to 16-byte columns,
and where it fits 2048 bytes (and the frame's width is a multiple of 16)
copies each frame's window into shared memory, zeros outside the frame,
and reads the four taps there; elsewhere it gathers them from the frame.
The model does the same window arithmetic in numpy; both paths must give
remap_bilinear_plain's bytes, so an off-by-one in the window shows here
before the card runs.
"""
import numpy as np
import pytest
import torch

from jackal_tpu_torch.geometry.remap import remap_bilinear_plain

TILE_W, TILE_H, STAGE_BYTES = 64, 16, 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixed15(m):
    """__float2int_rn(2^15 * m): round half to even, saturate, NaN -> 0."""
    r = np.rint(m.astype(np.float32) * np.float32(32768.0)).astype(np.float64)
    r = np.nan_to_num(r, nan=0.0, posinf=2.0 ** 31 - 1, neginf=-2.0 ** 31)
    return np.clip(r, -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)


def _lerp15(v00, v01, v10, v11, fx, fy):
    h0 = (v00 * (32768 - fx) + v01 * fx + 16384) >> 15
    h1 = (v10 * (32768 - fx) + v11 * fx + 16384) >> 15
    return (h0 * (32768 - fy) + h1 * fy + 16384) >> 15


def kernel_n_model(img, mapx, mapy):
    """Kernel N on uint8 frames [F, H, W] in numpy: (out [F, Ho, Wo],
    staged tiles, global tiles)."""
    F, H, W = img.shape
    Ho, Wo = mapx.shape
    sx, sy = _fixed15(mapx), _fixed15(mapy)
    x0, y0, fx, fy = sx >> 15, sy >> 15, sx & 0x7fff, sy & 0x7fff
    frames = img.astype(np.int64)
    out = np.zeros((F, Ho, Wo), np.int64)
    staged = 0
    for ty in range(0, Ho, TILE_H):
        for tx in range(0, Wo, TILE_W):
            sl = (slice(ty, ty + TILE_H), slice(tx, tx + TILE_W))
            X, Y, FX, FY = x0[sl], y0[sl], fx[sl], fy[sl]
            wx0 = int(X.min()) & ~15
            wy0 = int(Y.min())
            cols = (int(X.max()) + 2 - wx0 + 15) & ~15
            rows = int(Y.max()) + 2 - wy0
            if W % 16 == 0 and cols * rows <= STAGE_BYTES:
                staged += 1
                # the window, zeros outside the frame (whole 16-byte chunks
                # lie inside or outside a row at W % 16 == 0)
                win = np.zeros((F, rows, cols), np.int64)
                ys = np.arange(wy0, wy0 + rows)
                xs = np.arange(wx0, wx0 + cols)
                iy, ix = (ys >= 0) & (ys < H), (xs >= 0) & (xs < W)
                win[:, np.flatnonzero(iy)[:, None], np.flatnonzero(ix)] = \
                    frames[:, ys[iy][:, None], xs[ix]]
                flat = win.reshape(F, -1)
                off = (Y - wy0) * cols + (X - wx0)
                taps = [flat[:, off], flat[:, off + 1], flat[:, off + cols],
                        flat[:, off + cols + 1]]
            else:
                def tap(yy, xx):
                    ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
                    v = frames[:, np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
                    return np.where(ok, v, 0)
                taps = [tap(Y, X), tap(Y, X + 1), tap(Y + 1, X),
                        tap(Y + 1, X + 1)]
            out[(slice(None),) + sl] = _lerp15(*taps, FX, FY)
    tiles = -(-Ho // TILE_H) * -(-Wo // TILE_W)
    return out.astype(np.uint8), staged, tiles - staged


@pytest.mark.parametrize("case", range(9))
def test_remap_model_on_the_kernel_edge_cases(case):
    """chip_smoke.REMAP_EDGE_CASES, as the card holds kernel N on them:
    the model of both paths equals remap_bilinear_plain on each view; the
    smooth maps' tiles stage (beside global tiles in one launch's case),
    the scattered and special ones do not."""
    from chip_smoke import REMAP_EDGE_CASES, remap_edge_case

    assert len(REMAP_EDGE_CASES) == 9
    left, lmap, right, rmap = remap_edge_case(REMAP_EDGE_CASES[case], "cpu")
    staged = glob = 0
    for img, (mx, my) in ((left, lmap), (right, rmap)):
        want = remap_bilinear_plain(img, mx, my)
        frames = img.reshape(-1, *img.shape[-2:]).numpy()
        got, s, g = kernel_n_model(frames, mx.numpy(), my.numpy())
        assert np.array_equal(got.reshape(want.shape), want.numpy())
        staged, glob = staged + s, glob + g
    if case == 6:
        assert staged > 0 and glob > 0, (staged, glob)
    elif case >= 7:
        assert glob == 0, (staged, glob)
    elif case in (0, 1, 2, 3, 5):      # scattered maps or W % 16 != 0
        assert staged == 0, (staged, glob)


def test_remap_model_on_the_nodes_maps():
    """The per-frame node's rectification maps (640x360 raw to 640x480):
    every tile stages, and the model equals the plain version on a seeded
    raw pair."""
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pp = PipelineParams(im_width=640, im_height=480, crop_im_width=640,
                        crop_im_height=480)
    pipe = make_pipeline(engine="elas", params=pp, device="cpu")
    rng = np.random.default_rng(19)
    for mx, my in (pipe.lmap, pipe.rmap):
        raw = rng.integers(0, 256, (1, 360, 640)).astype(np.uint8)
        got, staged, glob = kernel_n_model(raw, mx.numpy(), my.numpy())
        assert (staged, glob) == (300, 0)
        want = remap_bilinear_plain(torch.from_numpy(raw), mx, my)
        assert np.array_equal(got, want.numpy())
