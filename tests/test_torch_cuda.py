"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and nvcc; without one each skips (they are
decided inside a fixture, never at import). Run them on the card with
    python -m pytest tests/test_torch_cuda.py -q
chip_smoke.py runs the same checks at the node's full size.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import dense as dm
from jackal_tpu_torch.matching.elas import support as sm
from jackal_tpu_torch.ops.descriptor import create_descriptor

pytestmark = pytest.mark.cuda
FIX = "tests/fixtures"


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,H,W,disp_max,disp_min", [
    (2, 60, 160, 47, 0), (1, 43, 101, 30, 4), (1, 120, 333, 255, 0),
    (1, 480, 640, 255, 0),      # the node's shape
    (8, 480, 640, 255, 0),      # the batched node's
    (1, 40, 2112, 511, 0),      # D = 512 on a wide frame
    (1, 60, 200, 255, 0),       # W < D
    (1, 60, 320, 255, 250)])    # disp_min near D
def test_support_kernel_equals_plain(dev, B, H, W, disp_max, disp_min):
    rng = np.random.default_rng(W)
    l = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    r = np.roll(l, -9, axis=2)    # right(u - 9) = left(u)
    d1 = create_descriptor(torch.from_numpy(l).to(dev))
    d2 = create_descriptor(torch.from_numpy(r).to(dev))
    step = sm.effective_stepsize(ElasParams())
    ncv = -(-H // step)
    n0 = sm.launches
    got = sm.grid_row_keys(d1, d2, step, disp_min, disp_max + 1)
    want = sm.support_keys_plain(sm.grid_row_blocks(d1, step, ncv),
                                 sm.grid_row_blocks(d2, step, ncv),
                                 disp_min, disp_max + 1)
    assert sm.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    p = ElasParams(disp_max=disp_max, disp_min=disp_min)
    cpu = sm.support_candidates(d1.cpu(), d2.cpu(), p)
    assert torch.equal(sm.support_candidates(d1, d2, p).cpu(), cpu)


@pytest.mark.parametrize("case", range(8))
def test_support_kernel_edges(dev, case):
    """chip_smoke.SUPPORT_EDGE_CASES: the node's and the batched node's
    shapes, D = 512 at W = 2112 and 4096 (fewer d a chunk), W < D,
    disp_min near D, an odd width, constant descriptors (every cost
    ties)."""
    from chip_smoke import SUPPORT_EDGE_CASES, support_edge_case

    assert len(SUPPORT_EDGE_CASES) == 8
    name = SUPPORT_EDGE_CASES[case]
    d1, d2, disp_min, D = support_edge_case(name, dev)
    step = sm.effective_stepsize(ElasParams())
    ncv = -(-d1.shape[1] // step)
    n0 = sm.launches
    got = sm.grid_row_keys(d1, d2, step, disp_min, D)
    assert sm.launches == n0 + 1
    want = sm.support_keys_plain(sm.grid_row_blocks(d1, step, ncv),
                                 sm.grid_row_blocks(d2, step, ncv),
                                 disp_min, D)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if name.startswith("constant"):     # all ties: the lowest two d win
        assert bool((want[0][:, :, 300:400] == 0).all())
        assert bool((want[1][:, :, 300:400] == 1).all())


def test_support_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(sm, "support_keys_plain", refuse)
    monkeypatch.setattr(sm, "grid_row_blocks", refuse)
    d = torch.full((1, 20, 40, 16), 9, dtype=torch.uint8, device=dev)
    keys = sm.grid_row_keys(d, d.clone(), 5, 0, 20)
    assert keys.is_cuda and keys.shape == (4, 1, 3, 40)
    assert int(keys[0][0, 0, 20]) == 0 and int(keys[1][0, 0, 20]) == 1


def test_support_kernel_refuses_what_it_does_not_take(dev):
    d = torch.zeros((1, 20, 40, 16), dtype=torch.uint8, device=dev)
    for lo, hi in ((0, 513), (20, 20), (30, 20), (-1, 10)):
        with pytest.raises(ValueError, match="disp_min"):
            sm.grid_row_keys(d, d, 5, lo, hi)
    with pytest.raises(ValueError, match="^desc2:"):
        sm.grid_row_keys(d, d.to(torch.int32), 5, 0, 20)
    with pytest.raises(ValueError, match="^desc1:"):
        sm.grid_row_keys(d[..., :8].contiguous(), d, 5, 0, 20)
    wide = torch.zeros((1, 10, 60000, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="W = 60000"):
        sm.grid_row_keys(wide, wide, 5, 0, 20)


def _front_held(left, right, p, dev):
    """Kernel R's pair entry, kernel A from the descriptors' rows, A with
    Q's tests as its epilogue (support_candidates) and Q alone against
    their plain versions (torch.equal), with one launch of R, one call of
    A with its epilogue and none of Q on the nodes' route; returns the
    card's grid."""
    from jackal_tpu_torch.ops import descriptor as dmod

    lt, rt = (torch.from_numpy(x).to(dev) for x in (left, right))
    H = left.shape[1]
    r0, q0, f0 = dmod.launches, sm.epilogue_launches, sm.fused_launches
    desc = dmod.create_descriptor_pair(lt, rt, p.subsampling)
    assert torch.equal(desc, dmod.create_descriptor_plain(
        torch.stack([lt, rt]), p.subsampling))
    d1, d2 = desc[0], desc[1]
    step = sm.effective_stepsize(p)
    ncv = -(-H // step)
    a0 = sm.launches
    grid = sm.support_candidates(d1, d2, p)
    assert (dmod.launches, sm.fused_launches, sm.epilogue_launches) == (
        r0 + 1, f0 + (ncv > 1), q0)
    assert sm.launches == a0 + (ncv > 1)
    keys = sm.grid_row_keys(d1, d2, step, p.disp_min, p.disp_num)
    want = sm.support_keys_plain(sm.grid_row_blocks(d1, step, ncv),
                                 sm.grid_row_blocks(d2, step, ncv),
                                 p.disp_min, p.disp_num)
    for g, w in zip(keys, want):
        assert torch.equal(g, w)
    plain = sm.support_epilogue_plain(keys, d1, d2, p)
    assert torch.equal(grid, plain)
    assert torch.equal(sm.support_epilogue(keys, d1, d2, p), plain)
    assert sm.epilogue_launches == q0 + 1
    return grid


@pytest.mark.parametrize("case", range(19))
def test_front_kernels_equal_plain(dev, case):
    """chip_smoke.FRONT_EDGE_CASES (tests/test_torch_front_kernels.py holds
    the plain versions against the JAX package on them): odd W, grid rows
    past the image, half resolution at even and odd H, disp_min > 0,
    W < D, B = 3, constant frames, candidate step 1; R's strip and band
    edges (W % 16 of 1, 3, 15, H ending mid-band, frames off 16-byte rows,
    half resolution off and on), the last key row at step 1 and 2, and
    A's epilogue at R = 1 reading its keys back from the out array."""
    from chip_smoke import FRONT_EDGE_CASES, front_edge_images

    assert len(FRONT_EDGE_CASES) == 19
    left, right, kw = front_edge_images(list(FRONT_EDGE_CASES)[case])
    p = ElasParams(**kw)
    grid = _front_held(left, right, p, dev)
    want = sm.support_candidates(
        create_descriptor(torch.from_numpy(left), p.subsampling),
        create_descriptor(torch.from_numpy(right), p.subsampling), p)
    assert torch.equal(grid.cpu(), want)


@pytest.mark.parametrize("case", range(8))
def test_front_kernels_on_the_support_edge_shapes(dev, case):
    """chip_smoke.SUPPORT_EDGE_CASES' frames: the nodes' shapes, D = 512
    at W = 2112 and 4096, W < D, disp_min near D, an odd width, constant
    frames."""
    from chip_smoke import SUPPORT_EDGE_CASES, support_edge_images

    left, right, lo, hi = support_edge_images(SUPPORT_EDGE_CASES[case])
    _front_held(left, right, ElasParams(disp_min=lo, disp_max=hi - 1), dev)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("case", range(10))
def test_descriptor_pair_at_strip_and_band_edges(dev, case, half):
    """Kernel R's pair entry on chip_smoke.DESCRIPTOR_EDGE_SHAPES (W < 16,
    W % 16 of 1, 3, 15, H under a band, frames too small for a valid
    pixel), each view a tensor of its own; and through create_descriptor
    on their concatenation."""
    from chip_smoke import DESCRIPTOR_EDGE_SHAPES
    from jackal_tpu_torch.ops import descriptor as dmod

    assert len(DESCRIPTOR_EDGE_SHAPES) == 10
    shape = DESCRIPTOR_EDGE_SHAPES[case]
    rng = np.random.default_rng(sum(shape))
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(
        np.uint8)) for _ in range(2))
    n0 = dmod.launches
    got = dmod.create_descriptor_pair(left.to(dev), right.to(dev), half)
    assert dmod.launches == n0 + 1
    want = dmod.create_descriptor_plain(torch.stack([left, right]), half)
    assert torch.equal(got.cpu(), want)
    both = dmod.create_descriptor(torch.cat([left, right]).to(dev), half)
    assert torch.equal(both.cpu(), want.reshape(both.shape))


@pytest.mark.parametrize("frames", [1, 8, 16])
def test_descriptor_pair_at_the_nodes_sizes(dev, frames):
    """At 640x480, 1, 8 and 16 pairs, as the nodes call it; views that are
    not contiguous are copied first."""
    from jackal_tpu_torch.ops import descriptor as dmod

    rng = np.random.default_rng(frames)
    left, right = (torch.from_numpy(rng.integers(
        0, 256, (frames, 480, 640)).astype(np.uint8)).to(dev)
        for _ in range(2))
    want = dmod.create_descriptor_plain(torch.stack([left, right]))
    assert torch.equal(dmod.create_descriptor_pair(left, right), want)
    wide = torch.cat([left, right], dim=2)            # [F, 480, 1280]
    got = dmod.create_descriptor_pair(wide[..., :640], wide[..., 640:])
    assert torch.equal(got, want)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("shape", [(480, 640), (3, 37, 79)])
def test_descriptor_pair_of_one_tensor(dev, shape, half):
    """Both views one tensor (elas_match(t, t) on a CUDA tensor passes the
    same one twice): both halves of the output are its descriptor, none
    left unwritten."""
    from jackal_tpu_torch.ops import descriptor as dmod

    x = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)).to(dev)
    n0 = dmod.launches
    got = dmod.create_descriptor_pair(x, x, half)
    assert dmod.launches == n0 + 1
    want = dmod.create_descriptor_plain(torch.stack([x, x]), half)
    assert torch.equal(got, want)


def test_elas_match_of_one_tensor_for_both_views(dev):
    """elas_match(t, t) with t on the card, whose two views reach kernel R
    as one tensor, equals the CPU's elas_match of the same frame twice."""
    from jackal_tpu_torch.matching.elas.pipeline import elas_match

    g = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
    t = torch.from_numpy(g["left"]).to(dev)
    D1, D2 = elas_match(t, t, ElasParams(), device=dev)
    C1, C2 = elas_match(g["left"], g["left"], ElasParams(), device="cpu")
    assert torch.equal(D1.cpu(), C1) and torch.equal(D2.cpu(), C2)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("shape", [(2, 37, 61), (1, 8, 9), (1, 6, 40),
                                   (1, 17, 70)])
def test_descriptor_kernel_at_tile_edges(dev, shape, half):
    """Kernel R on frames too small for a valid pixel (H < 7) and on 8 x 32
    tiles cut by the image's edge."""
    from jackal_tpu_torch.ops import descriptor as dmod

    img = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8))
    n0 = dmod.launches
    got = dmod.create_descriptor(img.to(dev), half)
    assert dmod.launches == n0 + 1
    assert torch.equal(got.cpu(), dmod.create_descriptor_plain(img, half))


@pytest.mark.parametrize("thr", [0.85, 0.95, 0.1])
def test_support_epilogue_at_the_ratio_edge(dev, thr):
    """Kernel Q on seeded keys whose second cost sits where f32(k1 >> 9)
    and f32(thr) * f32(k2 >> 9) meet (the f32 product rounded once), dead
    keys, dL pointing at any column and low textures; thr at both presets
    and far from them."""
    rng = np.random.default_rng(int(thr * 100))
    B, H, W = 2, 61, 101
    p = ElasParams(disp_max=40, support_threshold=thr, lr_threshold=10)
    nv = -(-H // 5) - 1
    c1 = rng.integers(0, 3000, (2, B, nv, W))   # c1 / thr < 32768
    c2 = np.rint(c1 / np.float32(thr)).astype(np.int64) + rng.integers(
        -1, 3, c1.shape)
    d = rng.integers(0, 41, (2, B, nv, W))
    k1 = c1 * 512 + d
    k2 = np.clip(c2, 0, 32767) * 512 + (d + 1) % 41
    k1[rng.random(k1.shape) < 0.1] = 1 << 24
    keys = torch.from_numpy(
        np.stack([k1[0], k2[0], k1[1], k2[1]]).astype(np.int32))
    desc = torch.from_numpy(
        rng.integers(120, 137, (2, B, H, W, 16)).astype(np.uint8))
    want = sm.support_epilogue_plain(keys, desc[0], desc[1], p)
    n0 = sm.epilogue_launches
    got = sm.support_epilogue(keys.to(dev), desc[0].to(dev),
                              desc[1].to(dev), p)
    assert sm.epilogue_launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    assert (want > 0).sum() > 10 and (want[:, 1:, 1:] == -1).sum() > 10


def test_front_kernels_never_run_the_plain_versions(dev, monkeypatch):
    """On the card create_descriptor, support_candidates and the
    per-frame elas_match reach no plain version of R, A or Q."""
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.ops import descriptor as dmod

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((dmod, "create_descriptor_plain"),
                      (sm, "support_keys_plain"), (sm, "grid_row_blocks"),
                      (sm, "support_epilogue_plain")):
        monkeypatch.setattr(mod, name, refuse)
    z = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
    r0, q0, f0 = dmod.launches, sm.epilogue_launches, sm.fused_launches
    D1, D2 = elas_match(z["left"], z["right"], ElasParams(), device=dev)
    assert torch.equal(D1.cpu(), torch.from_numpy(z["D1"]))
    assert torch.equal(D2.cpu(), torch.from_numpy(z["D2"]))
    assert (dmod.launches, sm.fused_launches, sm.epilogue_launches) == (
        r0 + 1, f0 + 1, q0)


def test_front_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.ops import descriptor as dmod

    img = torch.zeros((2, 30, 40), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        dmod.create_descriptor(img.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        dmod.create_descriptor(img.transpose(1, 2))
    with pytest.raises(ValueError, match="uint8"):
        dmod.create_descriptor(img[0, 0])       # one row: no [H, W]
    with pytest.raises(ValueError, match="differ in shape"):
        dmod.create_descriptor_pair(img[:1], img)
    with pytest.raises(ValueError, match="right: expected a contiguous "
                                         "uint8"):
        dmod.create_descriptor_pair(img, img.to(torch.int32))
    with pytest.raises(ValueError, match="right is on cpu"):
        dmod.create_descriptor_pair(img, img.cpu())
    p = ElasParams(disp_max=20)
    d = dmod.create_descriptor(img)
    d1, d2 = d[:1], d[1:]
    keys = sm.grid_row_keys(d1, d2, 5, 0, 21)
    assert keys.shape == (4, 1, 5, 40)
    with pytest.raises(ValueError, match="^desc2:"):
        sm.grid_row_keys(d1, d2.to(torch.int32), 5, 0, 21)
    with pytest.raises(ValueError, match="grid step"):
        sm.grid_row_keys(d1, d2, 0, 0, 21)
    with pytest.raises(ValueError, match="disp_min"):
        sm.grid_row_keys(d1, d2, 5, 0, 513)
    with pytest.raises(ValueError, match="^keys:"):
        sm.support_epilogue(keys[:, :, :4].contiguous(), d1, d2, p)
    with pytest.raises(ValueError, match="^keys:"):
        sm.support_epilogue(keys.to(torch.int64), d1, d2, p)
    with pytest.raises(ValueError, match="^desc1:"):
        sm.support_epilogue(keys, d1[..., :8].contiguous(), d2, p)
    with pytest.raises(ValueError, match="^desc2:"):
        sm.support_epilogue(keys, d1, d2.cpu(), p)


def test_front_kernels_raise_on_a_failed_launch(dev, monkeypatch):
    """A launch that returns an error raises RuntimeError; nothing falls
    back to a plain version."""
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops import descriptor as dmod

    img = torch.zeros((2, 30, 40), dtype=torch.uint8, device=dev)
    d = dmod.create_descriptor(img)
    d1, d2 = d[:1], d[1:]
    p = ElasParams(disp_max=20)
    keys = sm.grid_row_keys(d1, d2, 5, 0, 21)   # caches A's plan

    class Refused:
        argtypes = restype = None

        def __call__(self, *args):
            return 1                               # cudaErrorInvalidValue

    monkeypatch.setattr(cuda_lib, "load", lambda name: type(
        "Lib", (), {"__getattr__": lambda self, n: Refused()})())

    def refuse(*a, **k):
        raise AssertionError("a failed launch fell back to a plain version")

    for mod, name in ((dmod, "create_descriptor_plain"),
                      (sm, "support_keys_plain"),
                      (sm, "support_epilogue_plain")):
        monkeypatch.setattr(mod, name, refuse)
    r0, a0, q0 = dmod.launches, sm.launches, sm.epilogue_launches
    f0 = sm.fused_launches
    with pytest.raises(RuntimeError, match="elas_descriptor"):
        dmod.create_descriptor(img)
    with pytest.raises(RuntimeError, match="elas_descriptor"):
        dmod.create_descriptor_pair(img, img)
    with pytest.raises(RuntimeError, match="support_keys"):
        sm.grid_row_keys(d1, d2, 5, 0, 21)
    with pytest.raises(RuntimeError, match="support_keys"):
        sm.support_candidates(d1, d2, p)
    with pytest.raises(RuntimeError, match="support_epilogue"):
        sm.support_epilogue(keys, d1, d2, p)
    assert (dmod.launches, sm.launches, sm.epilogue_launches,
            sm.fused_launches) == (r0, a0, q0, f0)


def _dense_inputs(rng, B, H, W, p, dev, covered=0.9):
    """Seeded descriptors of a pair shifted 7 columns and each view's random
    prior maps (d_plane, plane_valid, covered, grid words) on the card."""
    gs = p.grid_size
    l = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    d1 = create_descriptor(torch.from_numpy(l).to(dev))
    d2 = create_descriptor(torch.from_numpy(np.roll(l, 7, axis=2)).to(dev))
    maps = [[torch.from_numpy(a).to(dev) for a in (
        rng.integers(-3, p.disp_num + 4, (B, H, W)).astype(np.int32),
        rng.random((B, H, W)) < 0.7, rng.random((B, H, W)) < covered,
        dm.pack_grid(rng.random((B, -(-H // gs), -(-W // gs), p.disp_num))
                     < 0.1))] for _ in range(2)]
    return d1, d2, maps


@pytest.mark.parametrize("right_image", [False, True])
@pytest.mark.parametrize("B,H,W,preset,D,gs", [
    (1, 40, 128, "robotics", 256, 20), (2, 33, 75, "middlebury", 256, 20),
    (1, 480, 640, "robotics", 256, 20),     # the node's shape
    (8, 48, 200, "robotics", 256, 20),      # B = 8, W % 32 != 0
    (1, 45, 333, "robotics", 64, 20),       # windows across word edges
    (2, 37, 130, "middlebury", 100, 20),    # D % 32 != 0
    (1, 21, 1500, "robotics", 256, 20),     # two strips of columns
    (2, 30, 150, "robotics", 8, 20),        # one candidate word (D < 32)
    (1, 41, 200, "middlebury", 32, 20),     # one candidate word
    (1, 36, 170, "robotics", 96, 7),        # three words, cells of 7
    (2, 25, 90, "robotics", 32, 1),         # cells of one pixel
    (1, 23, 140, "middlebury", 64, 1)])
def test_dense_kernel_equals_plain(dev, B, H, W, preset, D, gs, right_image):
    """Kernel B: both views from one launch (dense_match_pair) and one view
    (dense_match) against the plain version, with int32 and int16
    d_plane."""
    rng = np.random.default_rng(H * W + D)
    p = dataclasses.replace(getattr(ElasParams, preset)(), disp_max=D - 1,
                            grid_size=gs)
    d1, d2, (m1, m2) = _dense_inputs(rng, B, H, W, p, dev)
    n0 = dm.launches
    got = dm.dense_match(d1, d2, *(m2 if right_image else m1), p,
                         right_image)
    assert dm.launches == n0 + 1
    want = dm.dense_match_plain(d1, d2, *(m2 if right_image else m1), p,
                                right_image)
    assert torch.equal(got, want)
    pair = dm.dense_match_pair(d1, d2, m1, m2, p)
    assert dm.launches == n0 + 2
    assert torch.equal(pair[1 if right_image else 0], want)
    short = [[m[0].to(torch.int16)] + m[1:] for m in (m1, m2)]
    pair16 = dm.dense_match_pair(d1, d2, *short, p)
    assert torch.equal(pair16[1 if right_image else 0], want)
    assert (want >= 0).float().mean() > 0.3


@pytest.mark.parametrize("sradius,D", [(8.0, 256), (9.0, 256), (9.0, 64),
                                       (70.0, 64)])
def test_dense_kernel_past_radius_7(dev, sradius, D):
    """Kernel B past its unrolled radii (2 to 7): the radius at run time,
    P from a table on the card (70 at D = 64: a window wider than D, the
    table min(r + 1, D) long), both views and each alone, int32 and int16
    d_plane."""
    rng = np.random.default_rng(int(sradius) * D)
    p = dataclasses.replace(ElasParams(), disp_max=D - 1, sradius=sradius)
    assert p.plane_radius == int(sradius)
    d1, d2, (m1, m2) = _dense_inputs(rng, 2, 45, 333, p, dev)
    want = dm.dense_match_pair_plain(d1, d2, m1, m2, p)
    for got in (dm.dense_match_pair(d1, d2, m1, m2, p),
                (dm.dense_match(d1, d2, *m1, p, False),
                 dm.dense_match(d1, d2, *m2, p, True)),
                dm.dense_match_pair(d1, d2, *[[m[0].to(torch.int16)] + m[1:]
                                              for m in (m1, m2)], p)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (want[0] >= 0).float().mean() > 0.3


def test_dense_kernel_every_pixel_unmatched(dev):
    """No pixel covered: every output is -10 in both views; the warps still
    run their ballots with empty candidate sets."""
    p = ElasParams()
    d1, d2, maps = _dense_inputs(np.random.default_rng(3), 2, 40, 150, p,
                                 dev, covered=0.0)
    for out in dm.dense_match_pair(d1, d2, *maps, p):
        assert bool((out == -10).all())


def test_dense_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(dm, "dense_match_plain", refuse)
    monkeypatch.setattr(dm, "dense_match_pair_plain", refuse)
    p = ElasParams()
    d1, d2, maps = _dense_inputs(np.random.default_rng(4), 1, 20, 64, p, dev)
    D1, D2 = dm.dense_match_pair(d1, d2, *maps, p)
    assert D1.is_cuda and D2.shape == (1, 20, 64)
    with pytest.raises(ValueError, match="D <= 256"):
        dm.dense_match_pair(d1, d2, *maps, ElasParams(disp_max=256))


def _lr_counts():
    from jackal_tpu_torch.matching.elas import post

    return dm.launches, dm.lr_launches, post.launches["elas_lr"]


def _hold_lr(d1, d2, m1, m2, p, smax, fused):
    """dense_match_pair_lr on the card == dense_match_pair_plain then
    left_right_consistency_check_plain (torch.equal and int32 bits), with
    its launches: one of kernel B with the L/R epilogue and none of H
    where ``fused``, else one of B alone and one of H."""
    n0 = _lr_counts()
    got = dm.dense_match_pair_lr(d1, d2, m1, m2, p, smax)
    n1 = _lr_counts()
    want = dm.dense_match_pair_lr_plain(d1, d2, m1, m2, p, smax)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert tuple(b - a for a, b in zip(n0, n1)) == ((1, 1, 0) if fused
                                                    else (1, 0, 1))
    return want


@pytest.mark.parametrize("smax", [0, 7, -1])
@pytest.mark.parametrize("B", [1, 8])
def test_dense_lr_kernel_on_the_golden_pairs(dev, B, smax):
    """Kernel B with the L/R check as its epilogue (one launch, H none) on
    the golden 640x480 pairs with their native priors (B = 8: the two
    pairs alternated, the batched node's shape), at sweep bounds 0, 7 and
    disp_max."""
    from chip_smoke import GOLDEN, prior_inputs

    p = ElasParams()
    per_pair = []
    for fix in GOLDEN:
        g = np.load(f"{FIX}/{fix}.npz")
        desc = create_descriptor(torch.from_numpy(
            np.stack([g["left"], g["right"]])).to(dev))
        d1, d2 = desc[0:1], desc[1:2]
        per_pair.append((d1, d2, prior_inputs(d1, d2, p, dev)))
    pick = [per_pair[b % 2] for b in range(B)]
    d1 = torch.cat([x[0] for x in pick]).contiguous()
    d2 = torch.cat([x[1] for x in pick]).contiguous()
    m1, m2 = ([torch.cat([x[2][v][i] for x in pick]) for i in range(4)]
              for v in (0, 1))
    want = _hold_lr(d1, d2, m1, m2, p, smax, True)
    assert (want[0] >= 0).float().mean() > 0.1


@pytest.mark.parametrize("W,sub,fused", [
    (640, False, True), (1024, False, True),   # one block a row
    (1025, False, False),                      # two strips: B, then H
    (333, True, False)])                       # subsampling: B, then H
@pytest.mark.parametrize("smax", [0, 7, -1])
def test_dense_lr_kernel_random_priors(dev, W, sub, fused, smax):
    """dense_match_pair_lr on random priors, both d_plane widths: fused
    where one block owns the whole row and the maps are not subsampled,
    else kernel B alone and then kernel H (the L/R check of the
    subsampled warp d/2 on these full maps)."""
    rng = np.random.default_rng(W + smax)
    p = dataclasses.replace(ElasParams(), subsampling=sub)
    assert dm.lr_fused(W, p) == fused
    d1, d2, (m1, m2) = _dense_inputs(rng, 2, 37, W, p, dev)
    _hold_lr(d1, d2, m1, m2, p, smax, fused)
    short = [[m[0].to(torch.int16)] + m[1:] for m in (m1, m2)]
    _hold_lr(d1, d2, *short, p, smax, fused)


def test_dense_lr_kernel_never_runs_the_plain_versions(dev, monkeypatch):
    from jackal_tpu_torch.matching.elas import post

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((dm, "dense_match_plain"),
                      (dm, "dense_match_pair_plain"),
                      (dm, "dense_match_pair_lr_plain"),
                      (post, "left_right_consistency_check_plain")):
        monkeypatch.setattr(mod, name, refuse)
    p = ElasParams()
    d1, d2, maps = _dense_inputs(np.random.default_rng(5), 1, 20, 64, p, dev)
    D1, D2 = dm.dense_match_pair_lr(d1, d2, *maps, p)
    assert D1.is_cuda and D2.shape == (1, 20, 64)
    with pytest.raises(ValueError, match="D <= 256"):
        dm.dense_match_pair_lr(d1, d2, *maps, ElasParams(disp_max=256))


@pytest.mark.parametrize("fix", ["s320_flat", "s320_boxes", "s320_mb"])
def test_elas_on_the_card_equals_libelas(dev, fix):
    from jackal_tpu_torch.matching.elas.pipeline import elas_match

    g = np.load(f"{FIX}/elas_golden_{fix}.npz")
    p = (ElasParams.middlebury() if str(g["preset"]).upper() == "MIDDLEBURY"
         else ElasParams())
    D1, D2 = elas_match(g["left"], g["right"], p, device=dev)
    assert torch.equal(D1.cpu(), torch.from_numpy(g["D1"]))
    assert torch.equal(D2.cpu(), torch.from_numpy(g["D2"]))


def test_node_on_the_card_equals_cpu(dev):
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    gpu = make_pipeline(engine="elas", device=dev)
    cpu = make_pipeline(engine="elas", device="cpu")
    left, right = synthetic_raw_pair(cpu, 3, 10.0, 0.1)
    a, b = gpu.process_frame(left, right), cpu.process_frame(left, right)
    np.testing.assert_array_equal(a.dmap, b.dmap)
    np.testing.assert_allclose(a.scan.scan.cpu().numpy(),
                               b.scan.scan.numpy(), rtol=1e-5)
    assert dataclasses.is_dataclass(a.scan)


@pytest.mark.parametrize("CH,T,W,H,Ts", [
    (2, 40, 150, 37, 16), (1, 25, 333, 70, 200), (3, 300, 640, 480, 48)])
def test_raster_kernel_equals_plain(dev, CH, T, W, H, Ts):
    from chip_smoke import raster_overflow_case
    from jackal_tpu_torch.matching.elas import device_prior as dp

    # random triangles and three whose planes overflow int32, listed first
    # in every third tile; both sides (two such draws) in one launch
    sides = [raster_overflow_case(np.random.default_rng(W + k), CH, T, W, H,
                                  Ts) for k in range(2)]
    tables, sels = zip(*sides)
    n0 = dp.launches
    got = dp.raster_maps([t.to(dev) for t in tables],
                         [x.to(dev) for x in sels], T, W, H)
    assert dp.launches == n0 + 1
    want = dp.raster_maps_plain(tables, sels, T, W, H)
    for g, w in zip(got, want):
        assert g.shape == (2 * CH, H, W) and torch.equal(g.cpu(), w)
    for g, w in zip(got, dp.decode_win(dp.raster_plain(
            tables[0].to(dev), sels[0].to(dev), T, W, H))):
        assert torch.equal(g[:CH], w)
    dpl = got[0][:CH].cpu()
    C = -(-W // dp._RASTER_CTILE)
    v, u = np.mgrid[0:H, 0:W]
    tile = (v // dp._RASTER_SLAB) * C + u // dp._RASTER_CTILE
    want_dp = np.array([511, -512, 0])[tile % 3]
    np.testing.assert_array_equal(dpl[..., 1:].numpy(),
                                  np.broadcast_to(want_dp[:, 1:],
                                                  (CH, H, W - 1)))


@pytest.mark.parametrize("case", range(4))
def test_raster_kernel_edges(dev, case):
    """chip_smoke.RASTER_EDGE_CASES: Ts = 300 (three rounds of the
    kernel's 128 slots), a triangle over every pixel, tiles of pad slots
    only, 8 frames at 640x480."""
    from chip_smoke import RASTER_EDGE_CASES, raster_edge_case
    from jackal_tpu_torch.matching.elas import device_prior as dp

    assert len(RASTER_EDGE_CASES) == 4
    table, sel, T, W, H = raster_edge_case(RASTER_EDGE_CASES[case])
    for sides in ((table,), (table, table)):
        sels = (sel,) * len(sides)
        n0 = dp.launches
        got = dp.raster_maps([t.to(dev) for t in sides],
                             [x.to(dev) for x in sels], T, W, H)
        assert dp.launches == n0 + 1
        want = dp.raster_maps_plain(sides, sels, T, W, H)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    covered = want[2]
    if case == 1:           # the whole-image triangle covers every pixel
        assert bool(covered.all())
    if case == 2:           # the pad-only tiles stay uncovered
        C = -(-W // dp._RASTER_CTILE)
        v, u = np.mgrid[0:H, 0:W]
        tile = (v // dp._RASTER_SLAB) * C + u // dp._RASTER_CTILE
        dead = torch.from_numpy((tile % 2 == 0) | (tile % 4 == 1))
        assert not bool(covered[:, dead].any())


def test_raster_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    from chip_smoke import raster_overflow_case
    from jackal_tpu_torch.matching.elas import device_prior as dp

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    for name in ("raster_plain", "raster_maps_plain", "decode_win",
                 "_slab_products_impl", "_slab_raster_impl"):
        monkeypatch.setattr(dp, name, refuse)
    table, sel = raster_overflow_case(np.random.default_rng(1), 1, 30, 200,
                                      40, 8)
    maps = dp.raster_maps((table.to(dev),) * 2, (sel.to(dev),) * 2, 30, 200,
                          40)
    assert all(m.is_cuda and m.shape == (2, 40, 200) for m in maps)


def test_raster_kernel_refuses_what_it_does_not_take(dev):
    from chip_smoke import raster_overflow_case
    from jackal_tpu_torch.matching.elas import device_prior as dp

    table, sel = raster_overflow_case(np.random.default_rng(2), 1, 30, 200,
                                      40, 8)
    table, sel = table.to(dev), sel.to(dev)
    with pytest.raises(ValueError, match="table"):
        dp.raster_maps((table.long(),), (sel,), 30, 200, 40)
    with pytest.raises(ValueError, match="sel"):
        dp.raster_maps((table,), (sel.cpu(),), 30, 200, 40)
    with pytest.raises(ValueError, match="tiles"):
        dp.raster_maps((table,), (sel,), 30, 400, 40)
    with pytest.raises(ValueError, match="sides"):
        dp.raster_maps((table,) * 3, (sel,) * 3, 30, 200, 40)


def test_fit_and_slopes_on_the_card_equal_native(dev):
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas.device_fit import fit_planes_device
    from jackal_tpu_torch.matching.elas.native_prior import fit_planes_native

    rng = np.random.default_rng(3)
    n = 600
    sp = np.stack([rng.integers(0, 640, n), rng.integers(0, 480, n),
                   rng.integers(0, 256, n)], -1).astype(np.int32)
    tri = rng.integers(0, n, (6000, 3)).astype(np.int32)
    got = fit_planes_device(sp, tri, device=dev).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  fit_planes_native(sp, tri).view(np.int32))
    flags = torch.from_numpy(rng.random(len(tri)) < 0.5)
    cpu = dp._tri_coeffs_impl(torch.from_numpy(sp), torch.from_numpy(tri),
                              flags)
    card = dp._tri_coeffs_impl(torch.from_numpy(sp).to(dev),
                               torch.from_numpy(tri).to(dev), flags.to(dev))
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_batch_on_the_card_equals_per_frame(dev):
    from jackal_tpu_torch.matching.elas.pipeline import (
        elas_match, elas_match_batch_device)

    g = np.load(f"{FIX}/elas_golden_s320_boxes.npz")
    lb = np.stack([g["left"], g["left"][:, ::-1], np.full_like(g["left"], 9)])
    rb = np.stack([g["right"], g["right"][:, ::-1],
                   np.full_like(g["right"], 9)])
    lb, rb = np.ascontiguousarray(lb), np.ascontiguousarray(rb)
    D1, D2 = elas_match_batch_device(lb, rb, chunk=3, device=dev)
    for b in range(3):
        s1, s2 = elas_match(lb[b], rb[b], device=dev)
        assert torch.equal(D1[b], s1) and torch.equal(D2[b], s2)
    assert torch.equal(D1[0].cpu(), torch.from_numpy(g["D1"]))


@pytest.mark.parametrize("N,H,W", [
    (2, 37, 61), (4, 480, 640), (1, 5, 333),
    (2, 9, 13), (1, 6, 18), (3, 11, 31),        # W % 4 = 1, 2, 3
    (1, 1, 1), (2, 2, 3), (1, 3, 5), (1, 5, 2), (2, 3, 8), (1, 2, 12),
    (8, 960, 1280)])                            # BASELINE config 3's
def test_census_kernel_equals_plain(dev, N, H, W):
    from jackal_tpu_torch.ops import sgm_kernel as sk

    img = torch.from_numpy(np.random.default_rng(W * H).integers(
        0, 256, (N, H, W)).astype(np.uint8)).to(dev)
    n0 = sk.launches["census"]
    got = sk.census5x5_batch(img)
    assert sk.launches["census"] == n0 + 1
    assert torch.equal(got, sk.census5x5_batch_plain(img))
    # ties and extremes: equal bytes are not darker, 0 and 255 edges
    flat = torch.full((N, H, W), 128, dtype=torch.uint8, device=dev)
    flat[..., ::3] = 0
    flat[..., 1::5] = 255
    assert torch.equal(sk.census5x5_batch(flat),
                       sk.census5x5_batch_plain(flat))


@pytest.mark.parametrize("B,H,W,D,num_paths", [
    (2, 23, 150, 16, 8), (1, 40, 96, 48, 8), (1, 16, 128, 24, 4),
    (1, 31, 70, 2, 8), (1, 20, 300, 256, 8), (1, 120, 160, 128, 8)])
def test_path_and_wta_kernels_equal_plain(dev, B, H, W, D, num_paths):
    """Odd H, W % 32 != 0, D not a power of two, D > W/2, D at both ends
    of the kernels' range, 4 paths; the 12000 cells of d > u make the
    _CARRY_BIG clamp bind."""
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.matching import sgm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    rng = np.random.default_rng(H * W + D)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    codes = sgm.census5x5(torch.from_numpy(np.stack([left, np.roll(
        left, 5, axis=2)])).to(dev))
    cost = sgm.census_cost_volume_hdw(codes[0], codes[1], D)
    p = SGMParams(disp_num=D, num_paths=num_paths)
    n0 = dict(sk.launches)
    S = sk.aggregate_paths_bhdw(cost, p)
    want = sk.aggregate_paths_bhdw_plain(cost, p)
    assert torch.equal(S, want)
    if D > 2:
        assert (want == 28000).any()
    maps = sk.sgm_wta_maps(S)
    assert torch.equal(maps, sk.sgm_wta_maps_plain(S))
    assert sk.launches["sgm_paths"] == n0["sgm_paths"] + 1
    assert sk.launches["sgm_wta"] == n0["sgm_wta"] + 1


@pytest.mark.parametrize("B,H,W,D,num_paths", [
    (1, 3, 5, 24, 8),        # lines shorter than the ring of 8 steps
    (2, 7, 31, 64, 8),       # H and W under 32, B > 1
    (1, 40, 6, 100, 8),      # D past a 64-pair of lanes, W < 8
    (1, 33, 97, 192, 4),     # six values a lane, 4 paths
    (3, 12, 65, 63, 8)])     # odd D, padded to 64
def test_path_kernel_edge_shapes(dev, B, H, W, D, num_paths):
    """The redesigned path kernel at the shapes its design makes awkward,
    with the plain version's penalties and with penalties past the 16-bit
    lanes (its 32-bit path)."""
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.matching import sgm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    rng = np.random.default_rng(B * H * W + D)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    codes = sgm.census5x5(torch.from_numpy(np.stack([left, np.roll(
        left, 3, axis=2)])).to(dev))
    cost = sgm.census_cost_volume_hdw(codes[0], codes[1], D)
    for p1, p2 in ((10, 120), (4767, 4767), (7000, 4767)):
        p = SGMParams(disp_num=D, num_paths=num_paths, p1=p1, p2=p2)
        n0 = sk.launches["sgm_paths"]
        got = sk.aggregate_paths_bhdw(cost, p)
        assert sk.launches["sgm_paths"] == n0 + 1
        assert torch.equal(got, sk.aggregate_paths_bhdw_plain(cost, p))


def test_path_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.ops import sgm_kernel as sk

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(sk, "aggregate_paths_bhdw_plain", refuse)
    monkeypatch.setattr(sk, "aggregate_paths", refuse)
    cost = torch.zeros((1, 20, 16, 40), dtype=torch.int16, device=dev)
    S = sk.aggregate_paths_bhdw(cost, SGMParams(disp_num=16))
    assert S.is_cuda and S.shape == (1, 20, 16, 40)
    assert int(S.max()) == 0


@pytest.mark.parametrize("case", range(8))
def test_wta_kernel_edges(dev, case):
    """chip_smoke.WTA_EDGE_CASES: constant volumes (every d ties) at D = 2,
    3 and 64, tie-heavy volumes, a single column (the right view's 12000
    wins), D = 256 at W = 1280 (dynamic shared memory), B = 4 at
    1280x960."""
    from chip_smoke import WTA_EDGE_CASES, wta_edge_volume
    from jackal_tpu_torch.ops import sgm_kernel as sk

    assert len(WTA_EDGE_CASES) == 8
    name = WTA_EDGE_CASES[case]
    S = wta_edge_volume(name, dev)
    n0 = sk.launches["sgm_wta"]
    got = sk.sgm_wta_maps(S)
    assert sk.launches["sgm_wta"] == n0 + 1
    want = sk.sgm_wta_maps_plain(S)
    assert torch.equal(got, want)
    D = S.shape[2]
    if name.startswith("constant"):
        assert bool((want[:, :, 0] == 15000).all())
        assert bool((want[:, :, 1] == 0).all())
        assert bool((want[:, :, 2] == (15000 if D > 2 else 30000)).all())
        assert bool((want[:, :, 5, -1] == 12000).all())
    if name.startswith("one column"):
        assert bool((want[:, :, 5] == torch.minimum(
            S[:, :, 0, :], torch.tensor(12000, device=dev))).all())


def test_wta_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    from jackal_tpu_torch.ops import sgm_kernel as sk

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    for name in ("sgm_wta_maps_plain", "wta_maps", "right_view_volume"):
        monkeypatch.setattr(sk, name, refuse)
    S = torch.full((1, 20, 16, 40), 7, dtype=torch.int16, device=dev)
    maps = sk.sgm_wta_maps(S)
    assert maps.is_cuda and maps.shape == (1, 20, 10, 40)
    assert int(maps[:, :, 0].max()) == 7


@pytest.mark.parametrize("D", [256, 257, 320, 512, 1024])
def test_bm_and_sgm_card_past_d256_equal_cpu(dev, D, monkeypatch):
    """The card takes every D the CPU takes: BM's kernel and sgm_match on
    the card equal the CPU's plain engines (which equal the reference at
    D = 320, 512 and 1024: tests/test_torch_bm.py, test_torch_sgm.py), and
    E and F alone equal their plain twins, at D = 256 (the register and
    slab kernels) and past it (their D > 256 paths), on seeded 1 x 12 x W
    strips, W = D + 76. No plain twin runs on a CUDA tensor."""
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import sgm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import sgm_kernel as sk

    W = max(360, D + 76)
    left = np.random.default_rng(D).integers(0, 256, (1, 12, W)).astype(
        np.uint8)
    lb, rb = torch.from_numpy(left), torch.from_numpy(np.roll(left, -40, 2))
    rs = np.roll(left, 40, axis=2)
    bp, sp = BMParams(disp_num=D), SGMParams(disp_num=D)
    want_bm = bk.bm_match_fused(lb, rb, bp)
    want_sgm = sgm.sgm_match(left[0], rs[0], sp, device="cpu")
    codes = sgm.census5x5(torch.from_numpy(np.concatenate([left, rs])))
    cost = sgm.census_cost_volume_hdw(codes[:1], codes[1:], D)
    want_S = sk.aggregate_paths_bhdw(cost, sp)
    want_maps = sk.sgm_wta_maps(want_S)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain twin")

    for mod, names in ((bk, ("bm_match_fused_plain",)),
                       (sk, ("aggregate_paths_bhdw_plain", "aggregate_paths",
                             "sgm_wta_maps_plain", "wta_maps"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    n0 = dict(sk.launches)
    got = bk.bm_match_fused(lb.to(dev), rb.to(dev), bp)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want_bm))
    got = sgm.sgm_match(left[0], rs[0], sp, device=dev)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want_sgm))
    S = sk.aggregate_paths_bhdw(cost.to(dev), sp)
    assert torch.equal(S.cpu(), want_S)
    assert torch.equal(sk.sgm_wta_maps(S).cpu(), want_maps)
    assert sk.launches["sgm_paths"] == n0["sgm_paths"] + 2
    assert sk.launches["sgm_wta"] == n0["sgm_wta"] + 2


def test_sgm_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.ops import sgm_kernel as sk

    for D in (0, 1):
        vol = torch.zeros((1, 4, D, 8), dtype=torch.int16, device=dev)
        with pytest.raises(ValueError, match="D = "):
            sk.aggregate_paths_bhdw(vol, SGMParams(disp_num=D))
        with pytest.raises(ValueError, match="D = "):
            sk.sgm_wta_maps(vol)
    vol = torch.zeros((1, 4, 8, 8), dtype=torch.int16, device=dev)
    for kw in ({"p1": -1}, {"p2": -1}, {"p2": 1 << 31}):
        with pytest.raises(ValueError, match="P1, P2"):
            sk.aggregate_paths_bhdw(vol, SGMParams(disp_num=8, **kw))
    with pytest.raises(ValueError, match="int16"):
        sk.sgm_wta_maps(vol.to(torch.int32))


@pytest.mark.parametrize("p1,p2", [(6000, 100000), (40000, 5000),
                                   (0, (1 << 31) - 1 - 28000)])
def test_path_kernel_takes_large_penalties(dev, p1, p2):
    """Penalties far above the int16 range: the recurrence runs in int32
    and only the stored values are clamped, on the card as on the CPU."""
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.matching import sgm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    left = np.random.default_rng(p1).integers(0, 256, (2, 29, 90)).astype(
        np.uint8)
    codes = sgm.census5x5(torch.from_numpy(np.stack([left, np.roll(
        left, 4, axis=2)])).to(dev))
    cost = sgm.census_cost_volume_hdw(codes[0], codes[1], 24)
    p = SGMParams(disp_num=24, p1=p1, p2=p2)
    assert torch.equal(sk.aggregate_paths_bhdw(cost, p),
                       sk.aggregate_paths_bhdw_plain(cost, p))


@pytest.mark.parametrize("kw", [{}, {"true_right": True},
                                {"num_paths": 4, "disp_num": 48}])
def test_sgm_on_the_card_equals_cpu(dev, kw):
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.matching.sgm import sgm_match_batch

    g = np.load(f"{FIX}/elas_golden_s320_boxes.npz")
    lb = np.stack([g["left"], g["left"][::-1]])
    rb = np.stack([g["right"], g["right"][::-1]])
    p = dataclasses.replace(SGMParams(), **kw)
    got = sgm_match_batch(lb, rb, p, device=dev)
    want = sgm_match_batch(lb, rb, p, device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_sgm_node_on_the_card_equals_cpu(dev):
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    gpu, cpu = make_pipeline(device=dev), make_pipeline(device="cpu")
    left, right = synthetic_raw_pair(cpu, 2, 9.0, 0.05)
    a, b = gpu.process_frame(left, right), cpu.process_frame(left, right)
    np.testing.assert_array_equal(a.dmap, b.dmap)
    np.testing.assert_allclose(a.scan.scan.cpu().numpy(),
                               b.scan.scan.numpy(), rtol=1e-5)


@pytest.mark.parametrize("B,H,W,D,window,shift", [
    (3, 37, 333, 33, 9, 7),          # odd D, W % 32 != 0, B = 3, odd H
    (1, 50, 130, 64, 5, 60),         # D about W / 2
    (2, 21, 1280, 128, 9, 40),       # the widest frames of a config
    (1, 9, 2000, 16, 3, 3),          # near the kernel's widest
    (1, 16, 300, 256, 9, 100),       # bench_bm256's D
    (1, 12, 90, 2, 1, 1)])           # the smallest D and window
def test_bm_kernel_equals_plain(dev, B, H, W, D, window, shift):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    rng = np.random.default_rng(W + D)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    lt = torch.from_numpy(left).to(dev)
    rt = torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev)
    p = BMParams(disp_num=D, window=window)
    n0 = bk.launches["bm"]
    got = bk.bm_match_fused(lt, rt, p)
    assert bk.launches["bm"] == n0 + 1
    want = bk.bm_match_fused_plain(lt, rt, p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] >= 0).float().mean() > 0.2


@pytest.mark.parametrize("D", [64, 256])
def test_bm_kernel_on_the_golden_pair(dev, D):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    gold = [np.load(f"{FIX}/elas_golden_{f}.npz")
            for f in ("s640_boxes", "photo")]
    lt = torch.from_numpy(np.stack([g["left"] for g in gold])).to(dev)
    rt = torch.from_numpy(np.stack([g["right"] for g in gold])).to(dev)
    p = BMParams(disp_num=D)
    for g, w in zip(bk.bm_match_fused(lt, rt, p),
                    bk.bm_match_fused_plain(lt, rt, p)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,H,W,D,window,shift", [
    (1, 30, 200, 64, 9, 9),          # W not a multiple of the 64-column strip
    (2, 17, 150, 100, 7, 30),        # D past the strip's width
    (1, 5, 20, 16, 5, 2),            # H and W under 32, W under a strip
    (1, 70, 333, 200, 3, 50),        # D > W / 2, rows past a 64-row chunk
    (1, 3, 64, 8, 7, 1)])            # fewer rows than the window
def test_bm_kernel_edge_shapes(dev, B, H, W, D, window, shift):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    rng = np.random.default_rng(H * W + D)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    lt = torch.from_numpy(left).to(dev)
    rt = torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev)
    p = BMParams(disp_num=D, window=window)
    for g, w in zip(bk.bm_match_fused(lt, rt, p),
                    bk.bm_match_fused_plain(lt, rt, p)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,H,W,D,window,shift", [
    (32, 161, 333, 101, 3, 40),      # odd D past the strip, W % 64 != 0,
    (32, 161, 333, 101, 21, 17),     # H % 64 != 0; small and large windows
    (32, 330, 333, 33, 9, 7),        # odd D under the strip
    (32, 330, 333, 33, 1, 3)])
def test_bm_kernel_wide_strip_edge_shapes(dev, B, H, W, D, window, shift):
    """Batches large enough that G takes its 64-column strip, at the edges
    that strip has; its 32-column twin (G' "full32") agrees."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    rng = np.random.default_rng(H * W + D + window)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    lt = torch.from_numpy(left).to(dev)
    rt = torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev)
    p = BMParams(disp_num=D, window=window)
    assert bk.strip_width((B, H, W), p) == 64
    want = bk.bm_match_fused_plain(lt, rt, p)
    for got in (bk.bm_match_fused(lt, rt, p),
                bk.bm_match_diag(lt, rt, p, "full32")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_bm_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(bk, "bm_match_fused_plain", refuse)
    img = torch.zeros((1, 20, 64), dtype=torch.uint8, device=dev)
    dl, dr = bk.bm_match_fused(img, img, BMParams(disp_num=16))
    assert dl.is_cuda and dl.shape == (1, 20, 64)


def test_bm_kernel_refuses_what_it_does_not_take(dev):
    """G refuses D < 2, even windows, windows past 2901 (r > 1450, where the
    reference's int32 box sums wrap) and what is not a uint8 batch; G'
    refuses what G's strip cannot hold. Window 257 and window 255 on
    300x640 are no longer refused: test_bm_kernel_takes_every_window."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    img = torch.zeros((1, 20, 64), dtype=torch.uint8, device=dev)
    for D in (0, 1):
        with pytest.raises(ValueError, match="D = "):
            bk.bm_match_fused(img, img, BMParams(disp_num=D))
    for window in (8, 2903):
        with pytest.raises(ValueError, match="window"):
            bk.bm_match_fused(img, img, BMParams(window=window))
    # a strip of columns holds any width: only D and the window bound the
    # shared memory
    wide = torch.zeros((1, 4, 4096), dtype=torch.uint8, device=dev)
    assert bk.bm_match_fused(wide, wide, BMParams())[0].shape == (1, 4, 4096)
    tall = torch.zeros((1, 300, 640), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        bk.bm_match_diag(tall, tall, BMParams(window=255), "full")
    with pytest.raises(ValueError, match="uint8"):
        bk.bm_match_fused(img.to(torch.int32), img, BMParams())


@pytest.mark.parametrize("B,H,W,D,window,shift", [
    (1, 300, 640, 64, 255, 9),       # past the strip's shared memory
    (1, 96, 320, 256, 75, 40),       # and at D = 256
    (2, 40, 300, 64, 227, 5),        # just past it, r <= 127
    (1, 50, 330, 64, 257, 7),        # r = 128: past the strip's 16 bits
    (1, 30, 200, 16, 2901, 3)])      # r = 1450, the widest
def test_bm_kernel_takes_every_window(dev, B, H, W, D, window, shift):
    """Windows G's strip cannot hold go to its path without shared memory
    and equal the plain twin."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    rng = np.random.default_rng(H * W + window)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    lt = torch.from_numpy(left).to(dev)
    rt = torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev)
    p = BMParams(disp_num=D, window=window)
    assert bk.strip_width((B, H, W), p) == 0
    assert bk._shape_fn("bm_kernel", "bm_smem_bytes")(
        B, H, W, D, window // 2) == 0
    for g, w in zip(bk.bm_match_fused(lt, rt, p),
                    bk.bm_match_fused_plain(lt, rt, p)):
        assert torch.equal(g, w)


def test_bm_kernel_costs_past_the_invalid_cost(dev):
    """Window 257 on chip_smoke.binary_pair, whose real costs pass 1 << 24
    (tests/test_torch_bm.py holds the plain twin against the reference
    there): G equals its plain twin."""
    from chip_smoke import binary_pair
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    lt, rt = (torch.from_numpy(x).to(dev)[None] for x in binary_pair())
    p = BMParams(disp_num=64, window=257, uniqueness=1.0, lr_threshold=1000)
    want = bk.bm_match_fused_plain(lt, rt, p)
    for g, w in zip(bk.bm_match_fused(lt, rt, p), want):
        assert torch.equal(g, w)
    assert (want[0] >= 0).float().mean() > 0.1


def test_bm_diag_modes_run(dev):
    """G', the per-part timing: "full" and "full32" are G itself; the
    other modes run."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    left = np.random.default_rng(1).integers(0, 256, (2, 40, 200)).astype(
        np.uint8)
    lt = torch.from_numpy(left).to(dev)
    rt = torch.from_numpy(np.roll(left, -5, axis=2)).to(dev)
    p = BMParams(disp_num=32)
    want = bk.bm_match_fused(lt, rt, p)
    for mode in bk.DIAG_MODES:
        got = bk.bm_match_diag(lt, rt, p, mode)
        torch.cuda.synchronize()
        if mode in ("full", "full32"):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[0].shape == (2, 40, 200)


@pytest.mark.parametrize("engine", ["bm", "sgm"])
def test_gen_pcl_node_on_the_card_equals_cpu(dev, engine):
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    pp = PipelineParams(gen_pcl=True)
    gpu = make_pipeline(engine=engine, device=dev, params=pp)
    cpu = make_pipeline(engine=engine, device="cpu", params=pp)
    pairs = [synthetic_raw_pair(cpu, s, 9.0 + 3 * s, 0.05) for s in range(2)]
    col = np.random.default_rng(2).integers(0, 256, (2, 360, 640, 3)).astype(
        np.uint8)
    lb, rb = (np.stack([p[i] for p in pairs]) for i in range(2))
    a = gpu.process_batch_fused_pcl(lb, rb, col)
    b = cpu.process_batch_fused_pcl(lb, rb, col)
    assert torch.equal(a[0].cpu(), b[0])
    assert torch.equal(a[1][1].cpu(), b[1][1])
    assert torch.equal(a[1][2].cpu(), b[1][2])
    v = b[1][2].numpy()
    np.testing.assert_allclose(a[1][0].cpu().numpy()[v], b[1][0].numpy()[v],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[2].scan.cpu().numpy(), b[2].scan.numpy(),
                               rtol=1e-5)


# ---- the multi-device paths and the L2 surface on the card ------------

def _mesh_pairs(B):
    g = np.load(f"{FIX}/elas_golden_s320_flat.npz")
    return (np.stack([np.roll(g["left"], 5 * b, axis=0) for b in range(B)]),
            np.stack([np.roll(g["right"], 5 * b, axis=0) for b in range(B)]))


@pytest.mark.parametrize("disp", [1, 2, 4])
def test_tp_bm_on_a_card_mesh_equals_bm_match(dev, disp):
    """bm_match_tp on [cuda:0] * 4 (4 / disp data rows) == the port's
    single-device bm_match on the card and on the CPU."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.matching.bm import bm_match
    from jackal_tpu_torch.parallel.mesh import bm_match_tp, gather, make_mesh

    B = 4 // disp
    lb, rb = _mesh_pairs(B)
    p = BMParams(disp_num=32)
    mesh = make_mesh(4, disp_parallel=disp, devices=[dev] * 4)
    dl, dr = (gather(x) for x in bm_match_tp(mesh, p)(lb, rb))
    assert dl.device == dev
    for b in range(B):
        sl, sr = bm_match(torch.from_numpy(lb[b]).to(dev),
                          torch.from_numpy(rb[b]).to(dev), p)
        assert torch.equal(dl[b], sl) and torch.equal(dr[b], sr)
        cl, cr = bm_match(lb[b], rb[b], p)
        assert torch.equal(dl[b].cpu(), cl) and torch.equal(dr[b].cpu(), cr)


@pytest.mark.parametrize("engine", ["bm", "sgm"])
def test_dp_step_on_a_card_mesh_equals_unsharded(dev, engine):
    """dp_sharded_step on [cuda:0] * 4 == process_batch_fused on the whole
    batch (kernels G or D, E, F under both), maps and every scan field."""
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import sgm_kernel as sk
    from jackal_tpu_torch.parallel.mesh import (dp_sharded_step, gather,
                                                make_mesh)
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    pipe = make_pipeline(engine=engine, device=dev)
    ps = [synthetic_raw_pair(pipe, s, 6 + 2 * s) for s in range(4)]
    lb, rb = (np.stack([p[i] for p in ps]) for i in (0, 1))
    mesh = make_mesh(4, devices=[dev] * 4)
    n0 = bk.launches["bm"] + sk.launches["sgm_paths"]
    dmaps, scans, closest = dp_sharded_step(pipe, mesh)(lb, rb)
    assert bk.launches["bm"] + sk.launches["sgm_paths"] == n0 + 4
    wd, ws = pipe.process_batch_fused(lb, rb)
    assert torch.equal(gather(dmaps), wd)
    got = gather(scans)
    for f in ("scan", "angle_min", "angle_max", "range_min", "range_max"):
        assert torch.equal(getattr(got, f), getattr(ws, f)), f
    assert torch.equal(closest, ws.scan.min())


def test_filters_and_linalg_on_the_card_equal_cpu(dev):
    from jackal_tpu_torch.ops import filters as pf
    from jackal_tpu_torch.ops import linalg as pl

    img = np.load(f"{FIX}/elas_golden_photo.npz")["left"]
    for fn in (pf.integral_image, pf.sobel5x5, pf.checkerboard5x5,
               pf.blob5x5):
        got, want = (x if isinstance(x, tuple) else (x,)
                     for x in (fn(img, dev), fn(img, "cpu")))
        for g, w in zip(got, want):
            assert g.device == dev and torch.equal(g.cpu(), w)
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((256, 3, 3)), rng.standard_normal((256, 3, 2))
    for g, w in zip(pl.gauss_jordan_solve(torch.from_numpy(A).to(dev),
                                          torch.from_numpy(B).to(dev)),
                    pl.gauss_jordan_solve(A, B, "cpu")):
        assert torch.equal(g.cpu(), w)


def _hold_equal(kernel, name, got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", range(18))
def test_postprocess_kernels_edges(dev, case):
    """chip_smoke.POST_EDGE_CASES: kernels H-K against their plain versions
    (torch.equal and int32 bits) at W % 4 != 0, H and W under 9, all
    invalid and all valid maps, values on the abs-mask's steps with both
    zeros, MIDDLEBURY's long gaps, subsampled maps, B = 8 at 640x480, and
    the edges of I's and J's 32 x 32 tiles and of I's two designs."""
    from chip_smoke import (POST_EDGE_CASES, post_edge_case,
                            post_kernels_hold)
    from jackal_tpu_torch.matching.elas import post

    assert len(POST_EDGE_CASES) == 18
    name = POST_EDGE_CASES[case]
    D1, D2, p = post_edge_case(name, dev)
    n0, d0 = dict(post.launches), dict(post.device_launches)
    for smax in (-1, 32):
        post_kernels_hold(D1, D2, p, _hold_equal, name, smax)
    # per hold: H once, I twice (the case's params, then MIDDLEBURY's), J
    # twice (8 and 4 taps), K once, each of I, J, K again with its sinks
    # (out and the u8 epilogue), and the u8 map alone once
    assert {k: post.launches[k] - n0[k] for k in n0} == {
        "elas_lr": 2, "elas_gap": 8, "elas_mean": 8, "elas_median": 4,
        "elas_speckle": 0, "elas_u8": 2}
    # kernel launches: I's tile design once, its scan design twice
    tile = post.gap_width_eff(p) <= post.GAP_TILE_MAX and not p.add_corners
    assert {k: post.device_launches[k] - d0[k] for k in d0} == {
        "elas_lr": 2, "elas_gap": 4 * ((1 if tile else 2) + 2),
        "elas_mean": 8, "elas_median": 4, "elas_speckle": 0, "elas_u8": 2}


@pytest.mark.parametrize("fix", ["elas_golden_s640_boxes", "elas_golden_photo"])
def test_postprocess_kernels_on_the_golden_maps(dev, fix):
    """H-K on the 640x480 maps of both golden fixtures, ROBOTICS and
    MIDDLEBURY, and post_tail / postprocess_batch on the card against the
    CPU's plain chain."""
    from chip_smoke import post_kernels_hold
    from jackal_tpu_torch.matching.elas import post

    g = np.load(f"{FIX}/{fix}.npz")
    D1, D2 = (torch.from_numpy(g[k]).to(dev) for k in ("D1", "D2"))
    for p in (ElasParams(), ElasParams.middlebury()):
        post_kernels_hold(D1, D2, p, _hold_equal, fix)
        for got, want in ((post.post_tail(D1, D2, p),
                           post.post_tail(D1.cpu(), D2.cpu(), p)),
                          (post.postprocess_batch(D1[None], D2[None], p),
                           post.postprocess_batch(D1[None].cpu(),
                                                  D2[None].cpu(), p))):
            for a, b in zip(got, want):
                assert torch.equal(a.cpu().view(torch.int32),
                                   b.view(torch.int32))


@pytest.mark.parametrize("case", [*range(18), "elas_golden_s640_boxes",
                                  "elas_golden_photo", "NaN and signed zeros"])
def test_median_kernel_is_one_launch(dev, case):
    """Kernel K, one tiled launch a call, against median_filter_plain
    (int32 bits) on chip_smoke.POST_EDGE_CASES (maps smaller than its
    halo, one row, one column, B = 8 at 640x480), both views of the golden
    640x480 maps and a map with NaN, -0.0 and +0.0 taps."""
    from chip_smoke import POST_EDGE_CASES, post_edge_case
    from jackal_tpu_torch.matching.elas import post

    if isinstance(case, int):
        X = torch.stack(post_edge_case(POST_EDGE_CASES[case], dev)[:2])
    elif case.startswith("elas_golden"):
        g = np.load(f"{FIX}/{case}.npz")
        X = torch.from_numpy(np.stack([g["D1"], g["D2"]])).to(dev)
    else:
        rng = np.random.default_rng(7)
        D = rng.integers(0, 6, (2, 45, 77)).astype(np.float32)
        for v, share in ((np.nan, 0.02), (-0.0, 0.2), (0.0, 0.2),
                         (-10.0, 0.1)):
            D[rng.random(D.shape) < share] = v
        X = torch.from_numpy(D).to(dev)
    n0, d0 = post.launches["elas_median"], post.device_launches["elas_median"]
    got = post.median_filter(X)
    assert post.launches["elas_median"] == n0 + 1
    assert post.device_launches["elas_median"] == d0 + 1
    want = post.median_filter_plain(X)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_postprocess_kernels_never_run_the_plain_twins(dev, monkeypatch):
    from jackal_tpu_torch.matching.elas import post

    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for name in ("left_right_consistency_check_plain",
                 "gap_interpolation_plain", "adaptive_mean_plain",
                 "adaptive_mean_sub_plain", "median_filter_plain",
                 "remove_small_segments_plain",
                 "remove_small_segments_batch_plain"):
        monkeypatch.setattr(post, name, refuse)
    rng = np.random.default_rng(3)
    D1, D2 = (torch.from_numpy(rng.integers(-1, 40, (2, 30, 50))
                               .astype(np.float32)).to(dev) for _ in range(2))
    for p in (ElasParams(), ElasParams.middlebury(),
              dataclasses.replace(ElasParams(), subsampling=True)):
        post.postprocess_batch(D1, D2, p)
        post.postprocess_batch(D1[:1], D2[:1], p)


def test_postprocess_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.matching.elas import post

    D = torch.zeros((4, 5), device=dev)
    with pytest.raises(ValueError, match="float32"):
        post.gap_interpolation(D.double())
    with pytest.raises(ValueError, match="float32"):
        post.median_filter(torch.zeros((0, 5), device=dev))
    with pytest.raises(ValueError, match="L/R check"):
        post.left_right_consistency_check(D, torch.zeros((4, 6), device=dev))


def test_weighted_mean_division_equals_ieee_division(dev):
    """Kernel J's division (div_even, through the elas_div_even entry
    point) against torch's float32 '/' on the card, for every even divisor
    in [2, 32]: every subnormal, every power of two with the float one ulp
    either side, the largest float, +0, +inf and 4M seeded random positive
    floats. A negative or NaN dividend comes back as it is (the kernel
    stores no negative mean)."""
    import ctypes

    from jackal_tpu_torch.ops import cuda_lib

    fn = cuda_lib.load("elas_post_kernel").elas_div_even
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def div_even(x, d):
        out = torch.empty_like(x)
        cuda_lib.launch(fn, "elas_div_even", x, x.data_ptr(), out.data_ptr(),
                        x.numel(), d)
        return out

    pow2 = torch.arange(1, 255, dtype=torch.int32) << 23
    rng = np.random.default_rng(0)
    bits = torch.cat([
        torch.arange(1, 1 << 23, dtype=torch.int32),      # subnormals
        pow2 - 1, pow2, pow2 + 1,
        torch.tensor([0, 0x7F7FFFFF, 0x7F800000], dtype=torch.int32),
        torch.from_numpy(rng.integers(1, 0x7F800000, 4_000_000,
                                      dtype=np.int32))])
    x = bits.view(torch.float32).to(dev)
    for d in range(2, 33, 2):
        want = x / torch.full_like(x, float(d))
        assert torch.equal(div_even(x, d).view(torch.int32),
                           want.view(torch.int32)), d
    neg = torch.tensor([-0.0, -1e-45, -1.5, -10.0, float("nan"),
                        -float("inf")], device=dev)
    for d in (2, 6, 32):
        assert torch.equal(div_even(neg, d).view(torch.int32),
                           neg.view(torch.int32)), d


@pytest.mark.parametrize("case", range(23))
def test_speckle_kernel_edges(dev, case):
    """chip_smoke.SPECKLE_EDGE_CASES: kernel L against its plain versions,
    maps (int32 bits) and labels (_connected_component_labels), on smooth
    and random fields, a serpentine spiral across tiles, all valid, all
    invalid, a checkerboard and stripes (more runs a row than the plain
    version's compact slots: its sort branch), one row, one column, H and
    W not multiples of the tile, t = 0 and t = 0.1 on non-integer
    disparities, speckle_size 0, 1 and past H * W, subsampling's
    speckle_size_eff, NaN with -0.0 and +0.0, B = 8 at 640x480, both
    views stacked, one component over every tile of 640x480, the spiral
    over 15 x 15 tiles, B = 16 at 640x480 (more tiles than the grid's
    blocks keep in shared memory: their labels spill), 1 x 4000 and
    3000 x 1 frames; one call and one cooperative kernel launch a
    call."""
    from chip_smoke import (SPECKLE_EDGE_CASES, SPECKLE_LAUNCHES,
                            speckle_edge_case, speckle_hold)
    from jackal_tpu_torch.matching.elas import post

    assert len(SPECKLE_EDGE_CASES) == 23 and SPECKLE_LAUNCHES == 1
    name = SPECKLE_EDGE_CASES[case]
    D, p = speckle_edge_case(name, dev)
    n0 = post.launches["elas_speckle"]
    d0 = post.device_launches["elas_speckle"]
    speckle_hold(D, p, _hold_equal, name)
    assert post.launches["elas_speckle"] == n0 + 2
    assert post.device_launches["elas_speckle"] == d0 + 2
    if name.startswith("B = 16"):
        grid, spill = post.speckle_plan(dev, 16, 480, 640)
        assert 16 * 15 * 20 > grid and spill > 0, (grid, spill)
    if name.startswith("checkerboard"):
        lbl = post._connected_component_labels(D, p.speckle_sim_threshold)
        _, _, nruns = post._runs_along_rows(
            lbl.reshape(-1, D.shape[-1]), (D >= 0).reshape(-1, D.shape[-1]))
        assert int(nruns) > post._RUN_CAP


def test_speckle_kernel_reads_nothing_back(dev):
    """Kernel L on the batched node's shape under
    torch.cuda.set_sync_debug_mode("error"): no host read in the call (the
    plain version reads its fixed-point flag and run count back)."""
    from chip_smoke import speckle_edge_case
    from jackal_tpu_torch.matching.elas import post

    D, p = speckle_edge_case("B = 8 at 640x480", dev)
    post.remove_small_segments_batch(D, p)
    torch.cuda.synchronize()
    d0 = post.device_launches["elas_speckle"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = post.remove_small_segments_batch(D, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert post.device_launches["elas_speckle"] == d0 + 1
    want = post.remove_small_segments_batch_plain(D, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_speckle_kernel_refuses_what_it_does_not_take(dev):
    from jackal_tpu_torch.matching.elas import post

    with pytest.raises(ValueError, match="float32"):
        post.remove_small_segments(torch.zeros((4, 5), device=dev).double())
    with pytest.raises(ValueError, match="float32"):
        post.remove_small_segments(torch.zeros((0, 5), device=dev))


@pytest.mark.parametrize("fix", ["elas_golden_s640_boxes", "elas_golden_photo"])
def test_elas_match_speckle_route_on_the_card(dev, fix):
    """The per-frame elas_match on the card equals the CPU's (and libelas
    at the preset's threshold of 1) on both golden pairs. Below a
    threshold of 10 it runs kernel L once a frame and never the BFS; at 12
    it runs the BFS and L not at all (pipeline._speckle)."""
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import post

    g = np.load(f"{FIX}/{fix}.npz")
    preset = {"ROBOTICS": ElasParams.robotics,
              "MIDDLEBURY": ElasParams.middlebury}[str(g["preset"]).upper()]
    for t, route in ((1.0, "elas_speckle"), (12.0, "bfs")):
        p = dataclasses.replace(preset(), speckle_sim_threshold=t)
        r0, n0 = dict(ep.speckle_routes), post.launches["elas_speckle"]
        D1, D2 = ep.elas_match(g["left"], g["right"], p, device=dev)
        torch.cuda.synchronize()
        grew = {k: ep.speckle_routes[k] - r0[k] for k in r0}
        assert grew == {"elas_speckle": int(route == "elas_speckle"),
                        "bfs": int(route == "bfs")}, (t, grew)
        assert post.launches["elas_speckle"] - n0 == int(route ==
                                                         "elas_speckle")
        C1, C2 = ep.elas_match(g["left"], g["right"], p, device="cpu")
        assert torch.equal(D1.cpu(), C1) and torch.equal(D2.cpu(), C2), t
        if t == 1.0:
            assert torch.equal(D1.cpu(), torch.from_numpy(g["D1"]))
            assert torch.equal(D2.cpu(), torch.from_numpy(g["D2"]))


@pytest.mark.parametrize("case", range(9))
def test_remap_kernel_equals_plain(dev, case):
    """chip_smoke.REMAP_EDGE_CASES: kernel N against remap_bilinear_plain
    (torch.equal) on NaN, +-70000, +-2e9 and +-inf coordinates, rounding
    ties of 2^-16, odd sizes with maps larger than the frame, B x colour,
    maps smaller than the frame, the pair call (one launch; two where the
    views' shapes differ), smooth maps whose tiles N stages in shared
    memory next to tiles it gathers from global memory in the same
    launch, staged tiles at odd map sizes, and F = 96 frames."""
    from chip_smoke import REMAP_EDGE_CASES, remap_edge_case, remap_hold

    assert len(REMAP_EDGE_CASES) == 9
    name = REMAP_EDGE_CASES[case]
    paths = remap_hold(*remap_edge_case(name, dev), _hold_equal, name)
    if case == 6:                       # both paths in one launch
        assert paths["staged"] > 0 and paths["global"] > 0, paths
    if case >= 7:
        assert paths["staged"] > 0 and paths["global"] == 0, paths


def test_remap_kernel_saturates_as_xla_converts(dev):
    """The repair's input on the card: NaN reads coordinate 0, +-70000 and
    2e9 saturate, as the CPU's plain version and the reference do."""
    from jackal_tpu_torch.geometry import remap

    img = np.random.default_rng(0).integers(0, 256, (8, 10)).astype(np.uint8)
    mx = np.array([[0.5, 70000, -70000, np.nan, 3.25, 2e9]], np.float32)
    my = np.array([[0.5, 1, 1, 1, np.nan, 1]], np.float32)
    args = [torch.from_numpy(a) for a in (img, mx, my)]
    got = remap.remap_bilinear(*(a.to(dev) for a in args))
    want = remap.remap_bilinear_plain(*args)
    assert torch.equal(got.cpu(), want)
    assert int(got[0, 3]) == int(img[1, 0])


def test_rectify_is_one_launch_and_equals_cpu(dev):
    """The node's rectify (_rectify_crop): one launch of kernel N for both
    views, equal to the CPU pipeline's on a raw pair and a batch of 3."""
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.geometry import remap
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pp = PipelineParams(im_width=640, im_height=480, crop_im_width=640,
                        crop_im_height=480)
    card = make_pipeline(params=pp, device=dev)
    cpu = make_pipeline(params=pp, device="cpu")
    rng = np.random.default_rng(4)
    for shape in ((360, 640), (3, 360, 640)):
        l, r = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
                for _ in range(2))
        n0 = remap.launches["remap"]
        got = card._rectify_crop(l.to(dev), r.to(dev))
        assert remap.launches["remap"] == n0 + 1
        for a, b in zip(got, cpu._rectify_crop(l, r)):
            assert torch.equal(a.cpu(), b)


def test_rectify_colour_call_is_one_launch_and_equals_plain(dev):
    """BASELINE config 5's colour call (_rectify_crop_color): 32 colour
    frames of 3 channels, F = 96 frames of one launch of kernel N on the
    left maps, equal to the plain version; every output tile staged."""
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.geometry import remap
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pp = PipelineParams(calib_im_size=(640, 360), gen_pcl=True,
                        im_width=640, im_height=480, crop_im_width=640,
                        crop_im_height=480)
    cfg5 = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=pp, device=dev)
    col = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (32, 480, 640, 3)).astype(np.uint8)).to(dev)
    n0 = remap.launches["remap"]
    got = cfg5._rectify_crop_color(col)
    assert remap.launches["remap"] == n0 + 1
    colc = col.movedim(-1, -3).contiguous()
    want = remap.remap_bilinear_plain(colc, *cfg5.lmap)
    assert torch.equal(got, want.movedim(-3, -1))
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    assert torch.equal(remap._remap_cuda([(colc, *cfg5.lmap)], cnt)[0], want)
    assert int(cnt[0]) == 10 * 30 and int(cnt[1]) == 0, cnt


# ---- kernels P1-P3: the scan and the cloud ---------------------------------

def _scan_calib(dev):
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine="elas", device=dev)
    return pipe, (pipe.Q32, pipe.XR32, pipe.XT32)


@pytest.mark.parametrize("case", range(16))
def test_scan_kernels_equal_plain(dev, case):
    """chip_smoke.SCAN_EDGE_CASES: kernels P1, P2, P3 and the fused cloud
    and scan against their plain versions (NaN masks equal, torch.equal
    otherwise; rgb bits and the valid mask torch.equal; the fused scan
    also against P3 on P2's cloud) on NaN and +-inf points, points a few
    ulps either side of every bin edge at three fields of view, points on
    y = -x (bin 90), points on the ground threshold, an empty and an
    all-ground set, seeded maps at B = 1, 8 and 32 with and without
    colour, a width that is no multiple of 32, crop offsets, a cache that
    accepts d = 0, and the flush cases (every pair of operand classes, the
    ground gate at a zero threshold, maps whose reprojection flushes); one
    launch a call."""
    from chip_smoke import SCAN_EDGE_CASES, scan_edge_case, scan_hold

    assert len(SCAN_EDGE_CASES) == 16
    _, calib = _scan_calib(dev)
    name = SCAN_EDGE_CASES[case]
    out = scan_hold(scan_edge_case(name, dev), calib, _hold_equal, name)
    if case == 0:
        assert bool(torch.isnan(out.scan[3, 0]))
    if case == 6:
        want = torch.tensor([400.0, -400.0, 1e9, -500.0], device=dev)
        got = torch.stack([out.angle_min, out.angle_max, out.range_min,
                           out.range_max], -1)
        assert torch.equal(got[:2], want.expand(2, 4))
        assert bool((out.scan[:2] == 1e9).all())


def test_scan_kernels_read_nothing_back(dev):
    """The node's scan stage (P1) and the gen-pcl tail (the fused cloud and
    scan) at the node's shape under torch.cuda.set_sync_debug_mode
    ("error")."""
    from chip_smoke import scan_counts
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.scan import obstacle as obs

    pp = PipelineParams(gen_pcl=True, im_width=640, im_height=480,
                        crop_im_width=640, crop_im_height=480)
    pipe = make_pipeline(engine="bm", params=pp, device=dev)
    dm = torch.from_numpy(np.random.default_rng(2).integers(
        0, 90, (2, 480, 640)).astype(np.uint8)).to(dev)
    pipe._scan_stage(dm)
    pipe._cloud_scan(dm)
    torch.cuda.synchronize()
    n0 = scan_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scan = pipe._scan_stage(dm)
        cloud, pscan = pipe._cloud_scan(dm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: v - n0[k] for k, v in scan_counts().items()} == {
        "scan": 1, "cloud": 0, "scan_points": 0, "cloud_scan": 1}
    want = obs.obstacle_scan_from_disparity_plain(
        dm, pipe.valid_disp, pipe.Q32, pipe.XR32, pipe.XT32, pipe.sp)
    assert torch.equal(scan.scan, want.scan)
    assert pscan.scan.shape == (2, 90)


def test_scan_launches_on_the_nodes(dev):
    """P1 once a frame or a batch on a node without gen_pcl, never P2, P3
    or the fused cloud and scan; with gen_pcl the fused kernel once a frame
    or a batch, never P1, P2 or P3; each node's scan equal to the CPU's
    within PERF.md's scan tolerance."""
    from chip_smoke import scan_counts
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
    from jackal_tpu_torch.scan import obstacle as obs

    for gen_pcl in (False, True):
        pp = PipelineParams(gen_pcl=gen_pcl)
        card = make_pipeline(engine="bm", device=dev, params=pp)
        cpu = make_pipeline(engine="bm", device="cpu", params=pp)
        pairs = [synthetic_raw_pair(cpu, s, 9.0 + 3 * s, 0.05)
                 for s in range(2)]
        lb, rb = (np.stack([p[i] for p in pairs]) for i in range(2))
        want = (0, 0, 0, 1) if gen_pcl else (1, 0, 0, 0)
        n0 = scan_counts()
        fr = card.process_frame(*pairs[0])
        assert tuple(v - n0[k] for k, v in scan_counts().items()) == want
        n0 = scan_counts()
        out = card.process_batch_pcl(lb, rb) if gen_pcl \
            else card.process_batch(lb, rb)
        assert tuple(v - n0[k] for k, v in scan_counts().items()) == want
        ref = cpu.process_frame(*pairs[0])
        np.testing.assert_allclose(fr.scan.scan.cpu().numpy(),
                                   ref.scan.scan.numpy(), rtol=1e-5)
        assert out[-1].scan.shape == (2, 90)


def test_scan_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.config import ScanParams
    from jackal_tpu_torch.scan import obstacle as obs

    pipe, calib = _scan_calib(dev)
    H, W = pipe.valid_disp.shape[:2]
    dm = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="valid range cache"):
        obs.obstacle_scan_from_disparity(dm, pipe.valid_disp[:-1], *calib)
    with pytest.raises(ValueError, match="uint8"):
        obs.obstacle_scan_from_disparity(dm.float(), pipe.valid_disp,
                                         *calib)
    with pytest.raises(ValueError, match="bins"):
        obs.obstacle_scan_from_disparity(dm, pipe.valid_disp, *calib,
                                         ScanParams(bin_size=5000))
    with pytest.raises(ValueError, match="colour"):
        obs.point_cloud_from_disparity(dm, torch.zeros(
            (H, W, 4), dtype=torch.uint8, device=dev), *calib)
    with pytest.raises(ValueError, match="mask"):
        obs.obstacle_scan_from_points(torch.zeros((5, 3), device=dev),
                                      torch.ones(4, dtype=torch.bool,
                                                 device=dev))


def test_scan_scratch_stays_zero(dev):
    """The scan kernels' cached scratch (one a device, stream, set count
    and bin count) is zero after every call: P1, P3 and the fused kernel in
    turn at B = 1, 3 and 8, at 90, 45 and 4096 bins, on the current stream
    and on a side stream; after a call refused before its launch; and after
    a launch that fails, whose scratch the wrapper drops."""
    from chip_smoke import scratch_zero
    from jackal_tpu_torch.config import GroundPlaneParams, ScanParams
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.scan import obstacle as obs

    pipe, calib = _scan_calib(dev)
    H, W = pipe.valid_disp.shape[:2]
    rng = np.random.default_rng(31)
    maps = torch.from_numpy(rng.integers(0, 90, (8, H, W)).astype(
        np.uint8)).to(dev)
    gp = GroundPlaneParams()
    side = torch.cuda.Stream(dev)
    for stream in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(stream):
            for B in (1, 3, 8):
                for bins in (90, 45, 4096):
                    sp = ScanParams(bin_size=bins)
                    m = maps[:B]
                    got = obs.obstacle_scan_from_disparity(
                        m, pipe.valid_disp, *calib, sp)
                    want = obs.obstacle_scan_from_disparity_plain(
                        m, pipe.valid_disp, *calib, sp)
                    assert torch.equal(got.scan, want.scan)
                    cloud, fs = obs.cloud_and_scan_from_disparity(
                        m, None, *calib, sp, gp)
                    p3 = obs.obstacle_scan_from_points(cloud[0], cloud[2],
                                                       sp, gp)
                    assert torch.equal(fs.scan, p3.scan)
        stream.synchronize()
        scratch_zero()
    keys = {k[1] for k in obs._scratch}
    assert len(keys) == 2
    with pytest.raises(ValueError, match="bins"):
        obs.obstacle_scan_from_disparity(maps, pipe.valid_disp, *calib,
                                         ScanParams(bin_size=5000))
    scratch_zero()

    real = cuda_lib.launch

    def fails(fn, kernel, t, *args):
        real(fn, kernel, t, *args)
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch")

    key = (0, torch.cuda.current_stream(dev).cuda_stream, 1, 90)
    assert key in obs._scratch
    cuda_lib.launch = fails
    try:
        with pytest.raises(RuntimeError, match="failed to launch"):
            obs.obstacle_scan_from_disparity(maps[:1], pipe.valid_disp,
                                             *calib)
    finally:
        cuda_lib.launch = real
    assert key not in obs._scratch
    got = obs.obstacle_scan_from_disparity(maps[:1], pipe.valid_disp, *calib)
    want = obs.obstacle_scan_from_disparity_plain(maps[:1], pipe.valid_disp,
                                                  *calib)
    assert torch.equal(got.scan, want.scan)
    scratch_zero()


def _one_kernel_a_call(label: str, fn, kernel: str, calls: int = 5) -> list:
    """The names of the device activities (kernels, copies, fills) that
    torch.profiler records over ``calls`` calls of fn(), traced again up to
    3 windows where it records none. Raises unless every one is the kernel
    named ``kernel`` (no fill, memset or copy beside it), at most one a
    call (the profiler may leave a launch unrecorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
        print(f"WARNING: torch.profiler recorded no device activity in "
              f"window {window + 1} of 3 ({label}); traced again")
    else:
        raise RuntimeError("torch.profiler recorded no device activity")
    if len(names) > calls or any(kernel not in n for n in names):
        raise AssertionError(f"{label}: {calls} calls ran {names}, not one "
                             f"{kernel} each")
    return names


def test_scan_kernels_are_one_kernel_a_call(dev):
    """Under torch.profiler a call of P1, of P3 and of the fused cloud and
    scan is one kernel, with no fill or memset (the scratch is kept and set
    back to zero by the kernel)."""
    from jackal_tpu_torch.scan import obstacle as obs

    pipe, calib = _scan_calib(dev)
    H, W = pipe.valid_disp.shape[:2]
    dm = torch.from_numpy(np.random.default_rng(32).integers(
        0, 90, (2, H, W)).astype(np.uint8)).to(dev)
    cloud = obs.point_cloud_from_disparity(dm, None, *calib)
    calls = {
        "scan_from_disparity_kernel": lambda: obs.obstacle_scan_from_disparity(
            dm, pipe.valid_disp, *calib),
        "scan_from_points_kernel": lambda: obs.obstacle_scan_from_points(
            cloud[0], cloud[2]),
        "cloud_scan_kernel": lambda: obs.cloud_and_scan_from_disparity(
            dm, None, *calib)}
    for name, fn in calls.items():
        fn()
        assert _one_kernel_a_call(name, fn, name)


def test_gen_pcl_paths_launch_the_fused_kernel_once(dev):
    """Every gen-pcl path launches the fused cloud and scan once a frame or
    a batch and P1, P2 and P3 never: process_frame, process_batch_fused_pcl
    (BM), process_batch_pcl (ELAS, batched) and StreamingRunner's ELAS
    loop; the fused scan equals P2 then P3 on the same maps."""
    from chip_smoke import scan_counts, scan_same
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.runner import StreamingRunner
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
    from jackal_tpu_torch.scan import obstacle as obs

    fields = ("scan", "angle_min", "angle_max", "range_min", "range_max")
    pp = PipelineParams(gen_pcl=True)
    for engine in ("bm", "elas"):
        card = make_pipeline(engine=engine, device=dev, params=pp)
        cpu = make_pipeline(engine=engine, device="cpu", params=pp)
        pairs = [synthetic_raw_pair(cpu, s, 9.0 + 3 * s, 0.05)
                 for s in range(2)]
        lb, rb = (np.stack([p[i] for p in pairs]) for i in range(2))
        runs = {"process_frame": lambda: card.process_frame(*pairs[0]),
                "process_batch_pcl": lambda: card.process_batch_pcl(lb, rb)}
        if engine == "bm":
            runs["process_batch_fused_pcl"] = \
                lambda: card.process_batch_fused_pcl(lb, rb)
        else:
            runs["StreamingRunner"] = lambda: StreamingRunner(
                card, TopicBus(), batch_size=2).run(iter(pairs * 2))
        for name, fn in runs.items():
            n0 = scan_counts()
            out = fn()
            torch.cuda.synchronize()
            grew = {k: v - n0[k] for k, v in scan_counts().items()}
            want = 2 if name == "StreamingRunner" else 1
            assert grew == {"scan": 0, "cloud": 0, "scan_points": 0,
                            "cloud_scan": want}, (engine, name, grew)
            if name == "process_batch_pcl":
                dmaps, cloud, scans = out
                p2 = obs.point_cloud_from_disparity(
                    dmaps, None, card.Q32, card.XR32, card.XT32, card.sp,
                    card.p.crop_offset_x, card.p.crop_offset_y)
                p3 = obs.obstacle_scan_from_points(p2[0], p2[2], card.sp,
                                                   card.gp)
                scan_same("cloud_scan", f"{engine} {name}",
                          [cloud[0]] + [getattr(scans, f) for f in fields],
                          [p2[0]] + [getattr(p3, f) for f in fields],
                          _hold_equal)


# ---- kernels M1 and M2: the batched prior's table and grids --------------

def _prior_on_card(dev, wires, W, H, p):
    """M1 and M2 on a chunk wire on the card, one launch for both, against
    their plain versions on the card and _chunk_coeffs on the CPU."""
    from chip_smoke import prior_chunk
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep

    flat, CH, Np, Tp, Ts, SC = prior_chunk(wires, W, H)
    card = torch.from_numpy(flat).to(dev)
    gs = p.grid_size
    grid = (gs, -(-H // gs), -(-W // gs), p.disp_num)
    n0 = dict(dp.prior_launches)
    table, sels, words = dp.coeff_grid(card, CH, Np, Tp, SC, Ts, *grid)
    assert dp.prior_launches == {"coeff_grid": n0["coeff_grid"] + 1}
    ptable, psels = dp.coeff_table_plain(card, CH, Np, Tp, SC, Ts)
    pwords = dp.grid_words_plain(card, CH, Np, *grid)
    assert torch.equal(table, ptable)
    assert all(torch.equal(a, b) for a, b in zip(sels, psels))
    assert torch.equal(words, pwords)
    cpu = ep._chunk_coeffs(torch.from_numpy(flat), CH, Np, Tp, Ts, W, H, p)
    got = ep._chunk_coeffs(card, CH, Np, Tp, Ts, W, H, p)
    for g, c in zip(got, cpu):
        assert all(torch.equal(x.cpu(), y) for x, y in zip(g, c))
    return table, words


@pytest.mark.parametrize("case", range(8))
def test_prior_kernels_edges(dev, case):
    """chip_smoke.PRIOR_EDGE_CASES: degenerate and tied triangles, d > u,
    pad rows, D = 100, grids of 3 x 2 cells and of 2 rows (no interior
    cell), 2112 cells a grid row at grid_size 1, the batched node's chunk
    size (CH 8, Np 1536, Tp 3072)."""
    from chip_smoke import PRIOR_EDGE_CASES, prior_edge_case

    assert len(PRIOR_EDGE_CASES) == 8
    name = PRIOR_EDGE_CASES[case]
    wires, _, W, H, p = prior_edge_case(name)
    table, words = _prior_on_card(dev, wires, W, H, p)
    assert bool(words.any()) == (name not in ("3 x 2 grid cells",
                                              "2 rows of grid cells"))
    if name.startswith("the batched node"):
        assert table.shape == (2 * 8 * 3072, 16)
        assert bool((words < 0).any())          # bit 31 of a word


@pytest.mark.parametrize("chunk,disp_max", [(1, 255), (2, 255), (2, 99)])
def test_prior_kernels_on_the_st320_chunk(dev, chunk, disp_max):
    from chip_smoke import prior_wire

    z = np.load(f"{FIX}/elas_stages_st320.npz")
    sp = z["support"].astype(np.int32)
    H, W = z["left"].shape
    wires = [prior_wire(s, W, H) for s in (sp, sp[::2])[:chunk]]
    _prior_on_card(dev, wires, W, H, ElasParams(disp_max=disp_max))


def test_chunk_coeffs_is_two_kernels(dev, monkeypatch):
    """One _chunk_coeffs call on a CUDA wire: M1 and M2 in one launch, and
    no ATen op on the card but allocations and views; the plain versions
    are never reached."""
    from chip_smoke import aten_ops_of_a_call, prior_chunk, prior_edge_case
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep

    def refuse(*a, **k):
        raise AssertionError("a CUDA wire reached a plain twin")

    for name in ("coeff_table_plain", "grid_words_plain"):
        monkeypatch.setattr(dp, name, refuse)
    wires, _, W, H, p = prior_edge_case("seeded, pad rows")
    flat, CH, Np, Tp, Ts, _ = prior_chunk(wires, W, H)
    card = torch.from_numpy(flat).to(dev)
    n0 = dict(dp.prior_launches)
    ops = aten_ops_of_a_call(
        lambda: ep._chunk_coeffs(card, CH, Np, Tp, Ts, W, H, p))
    torch.cuda.synchronize()
    assert dp.prior_launches == {"coeff_grid": n0["coeff_grid"] + 1}
    assert [n for n, ok in ops if not ok] == []


def test_prior_kernels_refuse_what_they_do_not_take(dev):
    from chip_smoke import prior_chunk, prior_edge_case
    from jackal_tpu_torch.matching.elas import device_prior as dp

    wires, _, W, H, p = prior_edge_case("d > u")
    flat, CH, Np, Tp, Ts, SC = prior_chunk(wires, W, H)
    card = torch.from_numpy(flat).to(dev)
    grid = (20, 24, 32, 256)
    with pytest.raises(ValueError, match="coeff_grid"):
        dp.coeff_grid(card[:-8], CH, Np, Tp, SC, Ts, *grid)
    with pytest.raises(ValueError, match="coeff_grid"):
        dp.coeff_grid(card.long(), CH, Np, Tp, SC, Ts, *grid)
    with pytest.raises(ValueError, match="coeff_grid"):
        dp.coeff_grid(card[:10], CH, Np, Tp, SC, Ts, *grid)
    with pytest.raises(ValueError, match="coeff_grid"):
        dp.coeff_grid(card, CH, Np, Tp, SC, Ts, 0, 24, 32, 256)


# ---- kernels O1, O2 and S: the SGM and BM tails ---------------------------

def _tail_held(dev, name):
    """O1, O2 or S on a TAIL_EDGE_CASES case on the card against its plain
    version on the card (torch.equal), one launch a call; returns the
    kernel's outputs."""
    from chip_smoke import tail_edge_case
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    kind, *args = tail_edge_case(name)
    if kind == "cost":
        cl, cr = (torch.from_numpy(a).to(dev) for a in args[:2])
        D = args[2]
        n0 = sk.launches["sgm_cost"]
        got = sk.sgm_cost_volume(cl, cr, D, True)
        assert torch.equal(sk.sgm_cost_volume(cl, cr, D), got[0])
        assert sk.launches["sgm_cost"] == n0 + 2
        want = sk.sgm_cost_volume_plain(cl, cr, D, True)
    elif kind == "epilogue":
        m, mr, D, kw = args
        m = torch.from_numpy(m).to(dev)
        mr = None if mr is None else torch.from_numpy(mr).to(dev)
        p = SGMParams(**kw)
        n0 = sk.launches["sgm_epilogue"]
        got = sk.sgm_epilogue(m, mr, D, p, u8=True)
        assert all(torch.equal(a, b) for a, b in zip(
            sk.sgm_epilogue(m, mr, D, p), got[:2]))
        assert sk.launches["sgm_epilogue"] == n0 + 2
        want = sk.sgm_epilogue_plain(m, mr, D, p, u8=True)
    else:
        left, dL, kw = (torch.from_numpy(args[0]).to(dev),
                        torch.from_numpy(args[1]).to(dev), args[2])
        p = BMParams(**kw)
        n0 = bm.launches["bm_gate"]
        got = (bm.bm_texture_gate(left, dL, p), bm.bm_gate_u8(left, dL, p))
        assert bm.launches["bm_gate"] == n0 + 2
        want = (bm.bm_texture_gate_plain(left, dL, p),
                bm.bm_gate_u8_plain(left, dL, p))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("case", range(18))
def test_tail_kernels_edges(dev, case):
    """chip_smoke.TAIL_EDGE_CASES: O1 at D = 2, 3, 64, 257 and D > W, W no
    multiple of 8, codes with bit 23 set; O2 on crafted maps (halves at even
    and odd best_d, best_d at 0 and D - 1, den <= 0, the 30000 sentinels,
    dL = -1, true_right maps, uniqueness factors that are no float32); S at
    windows 1, 9, 255 (rows from device memory), 257 and 2901, threshold 0,
    a flat frame, B = 3 at an odd width."""
    from chip_smoke import TAIL_EDGE_CASES

    assert len(TAIL_EDGE_CASES) == 18
    _tail_held(dev, TAIL_EDGE_CASES[case])


@pytest.mark.parametrize("D,true_right", [(64, False), (64, True),
                                          (128, False)])
def test_tail_kernels_on_the_golden_pair(dev, D, true_right):
    """O1 and O2 (both views, with and without true_right) and census
    kernel D's pair entry against their plain versions on the 640x480
    golden pair; S on BM's maps of the same pair."""
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import sgm_kernel as sk

    g = [np.load(f"{FIX}/elas_golden_{f}.npz") for f in ("s640_boxes",
                                                         "photo")]
    left = torch.from_numpy(np.stack([x["left"] for x in g])).to(dev)
    right = torch.from_numpy(np.stack([x["right"] for x in g])).to(dev)
    codes = sk.census5x5_pair(left, right)
    assert torch.equal(codes, sk.census5x5_batch(torch.cat([left, right])))
    p = SGMParams(disp_num=D, true_right=true_right)
    costs = sk.sgm_cost_volume(codes[:2], codes[2:], D, True)
    want = sk.sgm_cost_volume_plain(codes[:2], codes[2:], D, True)
    assert all(torch.equal(a, b) for a, b in zip(costs, want))
    maps = [sk.sgm_wta_maps(sk.aggregate_paths_bhdw(c, p)) for c in costs]
    mr = maps[1] if true_right else None
    got = sk.sgm_epilogue(maps[0], mr, D, p, u8=True)
    want = sk.sgm_epilogue_plain(maps[0], mr, D, p, u8=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bp = BMParams(disp_num=D)
    dL = bk.bm_match_fused(left, right, bp)[0]
    assert torch.equal(bm.bm_gate_u8(left, dL, bp),
                       bm.bm_gate_u8_plain(left, dL, bp))
    assert torch.equal(bm.bm_texture_gate(left, dL, bp),
                       bm.bm_texture_gate_plain(left, dL, bp))


def test_tail_kernels_never_run_the_plain_versions(dev, monkeypatch):
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, names in ((sk, ("sgm_cost_volume_plain",
                             "census_cost_volume_hdw", "shift_by_d",
                             "sgm_epilogue_plain", "_wta_from_maps",
                             "_lr_tail", "dmap_u8", "census5x5_batch_plain")),
                       (bm, ("bm_texture_gate_plain", "bm_gate_u8_plain",
                             "_box_filter", "dmap_u8"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    img = torch.full((1, 20, 40), 9, dtype=torch.uint8, device=dev)
    codes = sk.census5x5_pair(img, img)
    cost, cost_r = sk.sgm_cost_volume(codes[:1], codes[1:], 16, True)
    assert int(cost[0, 0, 3, 3]) == 0 and int(cost[0, 0, 3, 2]) == 12000
    assert int(cost_r[0, 0, 3, 36]) == 0 and int(cost_r[0, 0, 3, 37]) == 12000
    maps = torch.zeros((1, 20, 10, 40), dtype=torch.int16, device=dev)
    maps[:, :, 2] = maps[:, :, 7] = 100
    dl, dr, u8 = sk.sgm_epilogue(maps, None, 16, SGMParams(disp_num=16), True)
    assert bool((dl == 0).all()) and bool((u8 == 0).all())
    p = BMParams(texture_threshold=0)
    dL = torch.full((1, 20, 40), 3.5, device=dev)
    assert bool((bm.bm_gate_u8(img, dL, p) == 4).all())
    assert bool((bm.bm_texture_gate(img, dL, p) == 3.5).all())


def test_tail_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import sgm_kernel as sk

    codes = torch.zeros((1, 8, 24), dtype=torch.int32, device=dev)
    for bad in (codes.to(torch.int16), codes[:, :4], codes.cpu()):
        with pytest.raises(ValueError, match="codes_r"):
            sk.sgm_cost_volume(codes, bad, 8)
    with pytest.raises(ValueError, match="D = "):
        sk.sgm_cost_volume(codes, codes, 1)
    maps = torch.zeros((1, 8, 10, 24), dtype=torch.int16, device=dev)
    p = SGMParams(disp_num=8)
    with pytest.raises(ValueError, match="maps"):
        sk.sgm_epilogue(maps[:, :, :9], None, 8, p)
    with pytest.raises(ValueError, match="maps"):
        sk.sgm_epilogue(maps.to(torch.int32), None, 8, p)
    with pytest.raises(ValueError, match="maps_right"):
        sk.sgm_epilogue(maps, maps.cpu(), 8, p)
    img = torch.zeros((1, 8, 24), dtype=torch.uint8, device=dev)
    dL = torch.zeros((1, 8, 24), device=dev)
    for left, d in ((img.float(), dL), (img[:, :4], dL), (img.cpu(), dL),
                    (img, dL.double()), (img.numpy(force=True), dL)):
        with pytest.raises(ValueError, match="kernel S"):
            bm.bm_gate_u8(left, d, BMParams())
    with pytest.raises(ValueError, match="window"):
        bm.bm_texture_gate(img, dL, BMParams(window=2903))


@pytest.mark.parametrize("engine", ["sgm", "bm"])
def test_tail_nodes_on_the_card_equal_cpu(dev, engine):
    """The SGM and BM nodes' batched step on the card equals the CPU's,
    with O1 and F with O2 folded in (O2 never), or G with S's gate folded
    in (S never), launched once a batch, and one call of the engine
    dispatching no eager op on the card."""
    from chip_smoke import aten_ops_of_a_call
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import sgm_kernel as sk
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    gpu = make_pipeline(engine=engine, device=dev)
    cpu = make_pipeline(engine=engine, device="cpu")
    pairs = [synthetic_raw_pair(cpu, s, 8.0 + 5 * s, 0.03 * s)
             for s in range(3)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    n0, g0, b0 = dict(sk.launches), bm.launches["bm_gate"], bk.launches["bm"]
    got, _ = gpu.process_batch_fused(lb, rb)
    want, _ = cpu.process_batch_fused(lb, rb)
    assert torch.equal(got.cpu(), want)
    if engine == "sgm":
        # F's launch carries O2's epilogue: O2 never runs
        assert sk.launches["sgm_cost"] == n0["sgm_cost"] + 1
        assert sk.launches["sgm_wta"] == n0["sgm_wta"] + 1
        assert sk.launches["sgm_epilogue"] == n0["sgm_epilogue"]
    else:
        # G applies the texture gate and writes the u8 map: S never runs
        assert bm.launches["bm_gate"] == g0
        assert bk.launches["bm"] == b0 + 1
    L, R = gpu._rectify_crop(torch.from_numpy(lb).to(dev),
                             torch.from_numpy(rb).to(dev))
    ops = aten_ops_of_a_call(lambda: gpu._match_batch(L, R))
    assert [n for n, ok in ops if not ok] == []


@pytest.mark.parametrize("W", [640, 642])
def test_gate_kernel_on_a_frame_at_an_odd_address(dev, W):
    """S stages the frame in 4-byte words only where W % 4 == 0 and the
    frame's address allows it; a frame one byte into its buffer takes the
    byte loads, with the same result."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.matching import bm

    rng = np.random.default_rng(W)
    buf = torch.from_numpy(rng.integers(0, 256, 2 * 40 * W + 1).astype(
        np.uint8)).to(dev)
    left = buf[1:].view(2, 40, W)
    assert left.data_ptr() % 4 == 1
    dL = torch.from_numpy(rng.integers(-1, 60, (2, 40, W)).astype(
        np.float32) + 0.5).to(dev)
    p = BMParams(texture_threshold=40)
    for aligned in (left, left.clone()):
        assert torch.equal(bm.bm_gate_u8(aligned, dL, p),
                           bm.bm_gate_u8_plain(aligned, dL, p))
        assert torch.equal(bm.bm_texture_gate(aligned, dL, p),
                           bm.bm_texture_gate_plain(aligned, dL, p))


# ---- kernel G with S's texture gate and u8 map folded in ------------------

def _gated_held(left, right, p):
    """G with the gate (ops/bm_kernel.bm_match_gated) against its plain
    twin on the card, torch.equal on the gated map, dR and the u8 map; one
    launch of G, and of S none where G's strip takes the shape, one past
    it."""
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import bm_kernel as bk

    wide = bk.strip_width(tuple(left.shape), p) == 0
    n0, s0 = bk.launches["bm"], bm.launches["bm_gate"]
    got = bk.bm_match_gated(left, right, p)
    assert bk.launches["bm"] == n0 + 1
    assert bm.launches["bm_gate"] == s0 + int(wide)
    want = bk.bm_match_gated_plain(left, right, p)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)
    return got, wide


@pytest.mark.parametrize("case", range(9))
def test_gated_bm_edges(dev, case):
    """chip_smoke.GATE_FOLD_CASES: window 1 at W = 65 (a 64-column strip's
    tail), texture equal to the threshold (a ramp; a constant frame at
    threshold 0), flat areas, D = 256 (the strip) against D = 257 (G's
    path without shared memory, then S), windows 225 (the strip) and 227
    (past its shared memory, then S) at D = 64."""
    from chip_smoke import GATE_FOLD_CASES, gate_fold_case
    from jackal_tpu_torch.config import BMParams

    assert len(GATE_FOLD_CASES) == 9
    name = GATE_FOLD_CASES[case]
    left, right, kw = gate_fold_case(name)
    (dl, _, u8), wide = _gated_held(torch.from_numpy(left).to(dev),
                                    torch.from_numpy(right).to(dev),
                                    BMParams(**kw))
    assert wide == ("G then S" in name)
    if "constant" not in name:
        assert bool((u8 > 0).any()) and bool((dl == -1).any())


@pytest.mark.parametrize("preset", ["node", "config 5", "bench_bm256"])
def test_gated_bm_at_the_presets(dev, preset):
    """G with the gate at the BM node's shape (B = 1), BASELINE config 5's
    (B = 32, D = 64) and bench_bm256's (B = 16, D = 256) on the golden
    frames, alternated; each on G's strip (S never)."""
    from jackal_tpu_torch.config import BMParams

    B, D = {"node": (1, 64), "config 5": (32, 64),
            "bench_bm256": (16, 256)}[preset]
    g = [np.load(f"{FIX}/elas_golden_{f}.npz") for f in ("s640_boxes",
                                                         "photo")]
    left, right = (torch.from_numpy(np.stack([g[i % 2][k] for i in range(B)]))
                   .to(dev) for k in ("left", "right"))
    (dl, _, u8), wide = _gated_held(left, right, BMParams(disp_num=D))
    assert not wide and u8.shape == (B, 480, 640)
    assert 0.3 < float((u8 > 0).float().mean()) < 1.0
    torch.cuda.empty_cache()


def test_gated_bm_on_cropped_views_and_an_odd_address(dev):
    """A batch that is a cropped view of a larger one (not contiguous) and
    frames one byte into their buffer: the wrapper copies or reads them as
    they lie, with the same maps as the plain twin."""
    from jackal_tpu_torch.config import BMParams

    rng = np.random.default_rng(77)
    big = rng.integers(0, 256, (2, 50, 210)).astype(np.uint8)
    left = torch.from_numpy(big).to(dev)[:, 5:45, 3:203]
    right = torch.from_numpy(np.roll(big, -4, axis=2)).to(dev)[:, 5:45,
                                                             3:203]
    assert not left.is_contiguous()
    p = BMParams(disp_num=32, texture_threshold=60)
    _gated_held(left, right, p)
    buf = torch.from_numpy(rng.integers(0, 256, 2 * 40 * 200 + 1).astype(
        np.uint8)).to(dev)
    _gated_held(buf[1:].view(2, 40, 200), left.contiguous(), p)


def test_gated_bm_refuses_what_it_does_not_take(dev):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    img = torch.zeros((1, 8, 24), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="texture_threshold"):
        bk.bm_match_gated(img, img, BMParams(texture_threshold=2 ** 28))
    with pytest.raises(ValueError, match="window"):
        bk.bm_match_gated(img, img, BMParams(window=8))
    with pytest.raises(ValueError, match="uint8"):
        bk.bm_match_gated(img.float(), img, BMParams())


# ---- kernel F with O2 folded in, and M1 two lanes a row -------------------

def _hold_equal(kernel, name, got, want):
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("case", ["node", "config 3", "node, true_right",
                                  *range(9)])
def test_fold_kernel_equals_its_twin(dev, case):
    """F with O2 folded in (sgm_wta_epilogue) against its plain twin at the
    SGM node's shape (the golden pair, B = 1, D = 64), config 3's (B = 4,
    1280x960, seeded) and chip_smoke.FOLD_CASES (W = 300 across tiles,
    W % 8 != 0, W < D, D = 2, ties with half-way offsets; F then O2 at
    D = 96, 200, 256 and 320), its launches pinned to its route; true_right
    F twice, then O2."""
    from chip_smoke import (FOLD_CASES, CONFIG3, fold_held, fold_inputs,
                            fold_volume)
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.ops import sgm_kernel as sk

    assert len(FOLD_CASES) == 9
    S_right = None
    if isinstance(case, int):
        name = list(FOLD_CASES)[case]
        kind, a, b, D = fold_inputs(name)
        p = SGMParams(disp_num=D)
        S = torch.from_numpy(a).to(dev) if kind == "volume" else fold_volume(
            torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), p)
        want = "F then O2" if "(F then O2" in name else "fold"
    elif case == "config 3":
        rng = np.random.default_rng(3)
        frame = rng.integers(0, 256, (CONFIG3[0], CONFIG3[1], CONFIG3[2] + 9))
        frame = torch.from_numpy(frame.astype(np.uint8)).to(dev)
        p = SGMParams()
        S = fold_volume(frame[:, :, 9:].contiguous(),
                        frame[:, :, :-9].contiguous(), p)
        want = "fold"
    else:
        g = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
        left, right = (torch.from_numpy(g[k][None]).to(dev)
                       for k in ("left", "right"))
        tr = case == "node, true_right"
        p = dataclasses.replace(SGMParams(), true_right=tr)
        S = fold_volume(left, right, p, tr)
        if tr:
            S, S_right = S
        want = "F then O2" if tr else "fold"
    assert fold_held(_hold_equal, str(case), S, p, S_right) == want
    torch.cuda.empty_cache()


def test_fold_launcher_refuses_past_its_shared_memory(dev):
    """The fold's launcher refuses a slab with its halo past the card's
    227 KB a block (D = 184 at the 256-column tile) and D past 256; no
    route sends it such a D."""
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.ops import sgm_kernel as sk

    for D in (184, 257):
        S = torch.zeros((1, 2, D, 16), dtype=torch.int16, device=dev)
        assert sk.sgm_tail_route(tuple(S.shape), False) == "F then O2"
        with pytest.raises(RuntimeError, match="sgm_wta_epilogue"):
            sk._fold_cuda(S, SGMParams(disp_num=D), False)


def test_fold_kernel_never_runs_the_plain_twin(dev, monkeypatch):
    from jackal_tpu_torch.config import SGMParams
    from jackal_tpu_torch.ops import sgm_kernel as sk

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("sgm_wta_epilogue_plain", "sgm_wta_maps_plain",
                 "sgm_epilogue_plain", "sgm_epilogue", "sgm_wta_maps",
                 "wta_maps", "_wta_from_maps", "_lr_tail", "dmap_u8"):
        monkeypatch.setattr(sk, name, refuse)
    S = torch.full((1, 20, 16, 40), 7, dtype=torch.int16, device=dev)
    S[:, :, 3] = 2
    dl, dr, u8 = sk.sgm_wta_epilogue(S, SGMParams(disp_num=16), True)
    assert bool((dl[:, :, 3:37] == 3).all()) and bool((u8[:, :, 3:37] == 3)
                                                      .all())
    with pytest.raises(ValueError, match="S"):
        sk.sgm_wta_epilogue(S.to(torch.int32), SGMParams(disp_num=16))


def test_fold_and_m1_contract_only_inside_divisions(dev):
    """F with O2 folded in and M1 (two lanes a row, with M2's blocks) have
    the FFMA and DFMA counts of their -fmad=false builds: the FMAs inside
    IEEE division and nothing contracted."""
    from chip_smoke import sass_by_function
    from jackal_tpu_torch.ops import cuda_lib

    for lib, name, ops in (("sgm_wta_kernel", "sgm_wta_epilogue_kernel",
                            ("FFMA",)),
                           ("prior_kernel", "coeff_grid_kernel",
                            ("FFMA", "DFMA"))):
        for lb in (lib, f"{lib}_nofmad"):
            cuda_lib.load(lb)
        for op in ops:
            got, ref = (sass_by_function(cuda_lib.library(lb).path, op,
                                         (name,))
                        for lb in (lib, f"{lib}_nofmad"))
            assert got == ref and set(got) == {name}, (lib, op, got, ref)


def _m1_parts(card, CH, Np, Tp, SC, Ts, grid):
    from chip_smoke import prior_parts_call
    from jackal_tpu_torch.matching.elas import device_prior as dp

    ptable, psels = dp.coeff_table_plain(card, CH, Np, Tp, SC, Ts)
    table, sels, _ = prior_parts_call(card, CH, Np, Tp, SC, Ts, *grid, 1)
    assert torch.equal(table, ptable)
    assert all(torch.equal(a, b) for a, b in zip(sels, psels))
    words = prior_parts_call(card, CH, Np, Tp, SC, Ts, *grid, 2)[2]
    assert torch.equal(words, dp.grid_words_plain(card, CH, Np, *grid))


@pytest.mark.parametrize("case", ["golden B = 8", *range(8)])
def test_m1_two_lanes_a_row_equals_plain(dev, case):
    """M1 (two lanes a table row, the tile lists by 16-byte loads) in
    coeff_grid's one launch, and its blocks and M2's each alone (the build
    variant prior_kernel_parts), against the plain versions on the golden
    chunk of 8 frames and chip_smoke.PRIOR_EDGE_CASES (singular and tied
    triangles, d > u, pad rows, the batched node's chunk)."""
    from chip_smoke import (PRIOR_EDGE_CASES, batch_chunks, prior_chunk,
                            prior_edge_case)
    from jackal_tpu_torch.matching.elas import device_prior as dp

    if case == "golden B = 8":
        g = [np.load(f"{FIX}/elas_golden_{f}.npz") for f in ("s640_boxes",
                                                             "photo")]
        lb = np.stack([g[i % 2]["left"] for i in range(8)])
        rb = np.stack([g[i % 2]["right"] for i in range(8)])
        p = ElasParams()
        flat, Np, Tp, Ts, fr = next(iter(batch_chunks(p, lb, rb, 8, dev)))
        W, H, CH = 640, 480, len(fr)
        card = flat.to(dev)
        SC = -(-H // 16) * -(-W // 128)
    else:
        wires, _, W, H, p = prior_edge_case(PRIOR_EDGE_CASES[case])
        flat, CH, Np, Tp, Ts, SC = prior_chunk(wires, W, H)
        card = torch.from_numpy(flat).to(dev)
    gs = p.grid_size
    grid = (gs, -(-H // gs), -(-W // gs), p.disp_num)
    table, sels, words = dp.coeff_grid(card, CH, Np, Tp, SC, Ts, *grid)
    ptable, psels = dp.coeff_table_plain(card, CH, Np, Tp, SC, Ts)
    assert torch.equal(table, ptable)
    assert all(torch.equal(a, b) for a, b in zip(sels, psels))
    assert torch.equal(words, dp.grid_words_plain(card, CH, Np, *grid))
    _m1_parts(card, CH, Np, Tp, SC, Ts, grid)


def test_m1_tile_lists_at_an_unaligned_offset(dev):
    """A wire whose tile lists do not start 16-byte aligned (an odd support
    count Np * 3 * CH): M1 widens them entry by entry, as the plain version
    does."""
    from chip_smoke import prior_edge_case
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep

    wires, _, W, H, p = prior_edge_case("seeded, pad rows")
    _, Tp, Ts = ep._chunk_pads(wires)
    SC = -(-H // 16) * -(-W // 128)
    for Np in (41, 43):
        flat = ep._flatten_chunk_wire_np(wires, Np, Tp, Ts)
        card = torch.from_numpy(flat).to(dev)
        CH = len(wires)
        grid = (p.grid_size, -(-H // p.grid_size), -(-W // p.grid_size),
                p.disp_num)
        table, sels, _ = dp.coeff_grid(card, CH, Np, Tp, SC, Ts, *grid)
        ptable, psels = dp.coeff_table_plain(card, CH, Np, Tp, SC, Ts)
        assert torch.equal(table, ptable)
        assert all(torch.equal(a, b) for a, b in zip(sels, psels))


def _rounding_maps(dev, seed=0, B=2, H=70, W=90):
    """Maps with what a u8 map must round and clip: x.5 of both parities,
    -0.5, 0.49, -1, -10, runs of them past ROBOTICS' gap width, and values
    past 255."""
    rng = np.random.default_rng(seed)
    D = rng.integers(0, 60, (B, H, W)).astype(np.float32)
    D[..., ::5] += 0.5
    D[:, ::7, :] = rng.choice([255.5, 256.0, 300.25, 1e6, 254.5],
                              (B, 1, W))
    D[rng.random(D.shape) < 0.15] = -1.0
    D[rng.random(D.shape) < 0.05] = -10.0
    D[:, 3, 3:9] = [0.5, 1.5, 2.5, -0.5, -0.4, 0.49]
    D[:, 20:30, 10:30] = -1.0
    D[:, 35:40, 40:60] = -10.0
    return torch.from_numpy(D).to(dev)


@pytest.mark.parametrize("views", [1, 2])
def test_u8_epilogue_of_i_j_k_equals_dmap_u8(dev, views):
    """Each of I (tile design: ROBOTICS; scan design: MIDDLEBURY), J (8 and
    4 taps) and K with its sinks: the float frames written into the given
    tensors == the call without sinks, and the first view's u8 map ==
    dmap_u8 of its float output, on maps with x.5, -1, -10 and values past
    255; with the filters off the tail leaves those values in place."""
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.ops.convert import dmap_u8

    X = _rounding_maps(dev, views)
    n0 = X.shape[0] // views
    for name, fn in (
            ("I tile", lambda Y, **k: post.gap_interpolation(
                Y, ElasParams(), **k)),
            ("I scan", lambda Y, **k: post.gap_interpolation(
                Y, ElasParams.middlebury(), **k)),
            ("J 8 taps", post.adaptive_mean),
            ("J 4 taps", post.adaptive_mean_sub),
            ("K", post.median_filter)):
        want = fn(X)
        out = tuple(torch.full_like(X[:n0], 3.0) for _ in range(views)) \
            if views == 2 else None
        U = torch.empty(X[:n0].shape, dtype=torch.uint8, device=dev)
        got = fn(X, out=out, u8=U)
        got = torch.cat(got) if out is not None else got
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name
        assert torch.equal(U, dmap_u8(want[:n0])), name
    p = dataclasses.replace(ElasParams(), filter_adaptive_mean=False,
                            filter_median=False)
    U = torch.empty(X[0].shape, dtype=torch.uint8, device=dev)
    F1, _ = post.post_tail(X[0], X[-1], p, u8=U)
    f = F1.cpu().numpy()
    assert ((f % 1) == 0.5).any() and (f > 255).any() and (f == -10).any()
    assert torch.equal(U, dmap_u8(F1))
    V = torch.empty_like(U)
    assert post.u8_map(X[0], V) is V and torch.equal(V, dmap_u8(X[0]))


def test_dense_pair_writes_one_tensor(dev):
    """Kernel B's two views: [0] and [1] of one tensor (the tail takes
    them as one, no stack), equal to each view's launch alone and to the
    given output rows."""
    from chip_smoke import prior_inputs
    from jackal_tpu_torch.matching.elas import post

    g = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
    desc = create_descriptor(torch.from_numpy(np.stack([g["left"],
                                                        g["right"]])).to(dev))
    d1, d2 = desc[0:1], desc[1:2]
    p = ElasParams()
    views = prior_inputs(d1, d2, p, dev)
    D1, D2 = dm.dense_match_pair(d1, d2, *views, p)
    X = post._pair(D1, D2)
    assert X.data_ptr() == D1.data_ptr() and X.shape == (2, *D1.shape)
    assert torch.equal(D1, dm.dense_match(d1, d2, *views[0], p, False))
    assert torch.equal(D2, dm.dense_match(d1, d2, *views[1], p, True))
    L1, L2 = dm.dense_match_pair_lr(d1, d2, *views, p)
    assert post._pair(L1, L2).data_ptr() == L1.data_ptr()
    rows = torch.zeros((2, 3, *D1.shape[1:]), device=dev)
    R1, R2 = dm.dense_match_pair_lr(d1, d2, *views, p,
                                    out=(rows[0, 1:2], rows[1, 2:3]))
    assert torch.equal(R1, L1) and torch.equal(R2, L2)
    assert torch.equal(rows[0, 1], L1[0]) and torch.equal(rows[1, 2], L2[0])
    assert not rows[0, 0].any() and not rows[1, 1].any()


def test_elas_chunk_tail_dispatches_no_eager_op(dev):
    """One batched chunk's tail with the node's u8 sink (kernels M1+M2, C
    for both sides, B with its L/R epilogue, L, I, J writing the u8 map):
    no ATen op that launches work on the card, C launched once, the u8
    map == dmap_u8 of the public path's D1."""
    from chip_smoke import aten_ops_of_a_call
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.ops.convert import dmap_u8

    g = [np.load(f"{FIX}/elas_golden_{f}.npz") for f in ("s640_boxes",
                                                         "photo")]
    L = torch.from_numpy(np.stack([x["left"] for x in g])).to(dev)
    R = torch.from_numpy(np.stack([x["right"] for x in g])).to(dev)
    p = ElasParams()
    d1, d2, dcan = ep._front(L, R, p)
    dcan = dcan.cpu().numpy()
    wires = [ep._prior_tri_job(dcan[b], p, 640, 480) for b in range(2)]
    Np, Tp, Ts = ep._chunk_pads(wires)
    lad = ep._lr_ladder(wires, p)
    flat = torch.from_numpy(ep._flatten_chunk_wire(wires, Np, Tp,
                                                   Ts)).to(dev)
    U = torch.empty((2, 480, 640), dtype=torch.uint8, device=dev)
    args = (flat, d1, d2, 2, Np, Tp, Ts, 640, 480, ep._node_params(p, True),
            lad, None, U)
    ep._chunk_tail(*args)
    n0 = dp.launches
    ops = aten_ops_of_a_call(lambda: ep._chunk_tail(*args))
    assert dp.launches == n0 + 1
    assert [n for n, ok in ops if not ok] == []
    D1, _ = ep.elas_match_batch_device(L, R, p, chunk=2, device=dev)
    assert torch.equal(U, dmap_u8(D1))
    for b, x in enumerate(g):
        assert torch.equal(D1[b].cpu(), torch.from_numpy(x["D1"]))


@pytest.mark.parametrize("preset", ["robotics", "middlebury"])
def test_node_u8_routes_on_the_card_equal_the_cpu(dev, preset):
    """The node's u8 routes (per frame, batched, streamed) on the card ==
    on the CPU, on the stage fixture and its 8-pixel shift."""
    from jackal_tpu_torch.matching.elas import pipeline as ep

    p = getattr(ElasParams, preset)()
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    lb = np.stack([z["left"], np.roll(z["left"], 8, 1)])
    rb = np.stack([z["right"], np.roll(z["right"], 8, 1)])
    for b in range(2):
        got = ep._elas_match_u8(lb[b], rb[b], p, device=dev)
        assert got.is_cuda and torch.equal(
            got.cpu(), ep._elas_match_u8(lb[b], rb[b], p, device="cpu"))
    want = ep._elas_match_batch_u8(lb, rb, p, chunk=1, device="cpu")
    assert torch.equal(ep._elas_match_batch_u8(lb, rb, p, chunk=1,
                                               device=dev).cpu(), want)
    got = next(ep._elas_stream_u8(iter([(lb, rb)]), p, chunk=2,
                                  device=dev))
    assert torch.equal(got.cpu(), want)
    flat = np.full((40, 64), 128, np.uint8)
    assert not ep._elas_match_u8(flat, flat, p, device=dev).any()


def test_elas_options_on_the_card_equal_the_cpu(dev):
    """elas_match with use_native=False and with return_debug=True, and
    post.postprocess, on one 640x480 golden frame: card == CPU, every
    field; the C++ route's D1 with the debug item == libelas's."""
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import post

    g = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
    p = ElasParams()
    for use_native, debug in ((False, False), (None, True), (False, True)):
        got = ep.elas_match(g["left"], g["right"], p, return_debug=debug,
                            use_native=use_native, device=dev)
        want = ep.elas_match(g["left"], g["right"], p, return_debug=debug,
                             use_native=use_native, device="cpu")
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.cpu(), b)
        if debug:
            assert torch.equal(got[2].dense_D1.cpu(), want[2].dense_D1)
            assert torch.equal(got[2].dense_D2.cpu(), want[2].dense_D2)
            np.testing.assert_array_equal(got[2].support, want[2].support)
        if use_native is None:
            np.testing.assert_array_equal(got[0].cpu().numpy(), g["D1"])
    dbg = got[2]
    for q in (p, ElasParams.middlebury()):
        for a, b in zip(post.postprocess(dbg.dense_D1, dbg.dense_D2, q),
                        post.postprocess(dbg.dense_D1.cpu(),
                                         dbg.dense_D2.cpu(), q)):
            assert torch.equal(a.cpu(), b)


# ---- TP BM's kernels T1, T2 and the exact scan's kernel V ----------------

def _tp_hold(dev, left, right, p, data, disp):
    """T1's partials and T2's maps against their plain twins on the card,
    bm_match_tp against the eager TP path on the card and, where the ranks
    divide D, bm_match frame by frame; T1 once a rank, T2 and S once a row
    of 'data', no ATen op that launches work on the card."""
    from chip_smoke import aten_ops_of_a_call
    from jackal_tpu_torch.matching import bm as bm_mod
    from jackal_tpu_torch.matching.bm import bm_match
    from jackal_tpu_torch.ops import bm_tp_kernel as tpk
    from jackal_tpu_torch.parallel import mesh as pmesh

    D, r = p.disp_num, p.window // 2
    Dl = D // disp
    L, R = (torch.from_numpy(x).to(dev) for x in (left, right))
    Bs = L.shape[0] // data
    parts = tpk.rank_partials(L[:Bs], R[:Bs], D, r, [dev] * disp)
    for k in range(disp):
        assert torch.equal(parts[k], tpk.tp_partials_plain(
            L[:Bs], R[:Bs], k * Dl, Dl, D, r))
    for a, b in zip(tpk.tp_combine(parts, D, Dl, p),
                    tpk.tp_combine_plain(parts, D, Dl, p)):
        assert torch.equal(a, b)
    mesh = pmesh.make_mesh(data * disp, disp_parallel=disp,
                           devices=[dev] * (data * disp))
    n0 = dict(tpk.launches)
    s0 = bm_mod.launches["bm_gate"]
    ops = aten_ops_of_a_call(lambda: pmesh.bm_match_tp(mesh, p)(L, R))
    dl, dr = (pmesh.gather(x) for x in pmesh.bm_match_tp(mesh, p)(L, R))
    torch.cuda.synchronize()
    assert [n for n, ok in ops if not ok] == []
    assert tpk.launches == {"bm_tp_partials": n0["bm_tp_partials"]
                            + 2 * data * disp,
                            "bm_tp_combine": n0["bm_tp_combine"] + 2 * data}
    assert bm_mod.launches["bm_gate"] == s0 + 2 * data
    el, er = (pmesh.gather(x) for x in pmesh.bm_match_tp_plain(mesh, p)(L, R))
    assert torch.equal(dl, el) and torch.equal(dr, er)
    if D % disp == 0:
        for b in range(L.shape[0]):
            sl, sr = bm_match(L[b], R[b], p)
            assert torch.equal(dl[b], sl) and torch.equal(dr[b], sr)
    return dl, dr


@pytest.mark.parametrize("case", range(5))
def test_tp_kernels_at_the_phase_11b_shapes(dev, case):
    """chip_smoke.TP_CARD_CASES at 640x480: D = 64 on 2 x 2 and 1 x 4,
    D = 256 on 1 x 8, D = 30 on 1 x 4, window 227 on 1 x 4."""
    from chip_smoke import TP_CARD_CASES, tp_pair
    from jackal_tpu_torch.config import BMParams

    D, data, disp, B, win = TP_CARD_CASES[case]
    left, right, uniq = tp_pair("seeded", B, 480, 640, D, disp,
                                band=max(4, 2 * win))
    dl, dr = _tp_hold(dev, left, right,
                      BMParams(disp_num=D, window=win, uniqueness=uniq),
                      data, disp)
    assert float((dl >= 0).float().mean()) > 0.1


@pytest.mark.parametrize("kind", range(3))
@pytest.mark.parametrize("D,disp", [(16, 2), (16, 4), (30, 4)])
def test_tp_kernels_on_the_cpu_tests_pairs(dev, kind, D, disp):
    """tests/test_torch_tp_partials.py's pairs (48x96, B = 2 on 2 data
    rows): the kernels against the twins that file holds to the JAX
    package."""
    from chip_smoke import TP_PAIR_KINDS, tp_pair
    from jackal_tpu_torch.config import BMParams

    left, right, uniq = tp_pair(TP_PAIR_KINDS[kind], 2, 48, 96, D, disp)
    _tp_hold(dev, left, right, BMParams(disp_num=D, uniqueness=uniq), 2,
             disp)


def test_tp_kernels_refuse_what_they_do_not_take(dev):
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_tp_kernel as tpk
    from jackal_tpu_torch.parallel import mesh as pmesh

    L = torch.zeros((1, 8, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        tpk.tp_partials(L.float(), L.float(), 0, 4, 8, 1)
    with pytest.raises(ValueError):
        tpk.tp_partials(L, L, 6, 4, 8, 1)          # past D
    with pytest.raises(ValueError):
        tpk.tp_combine(torch.zeros((3, 2, tpk.NF, 1, 8, 16), dtype=torch.int32,
                                   device=dev), 8, 4, BMParams(disp_num=8))
    mesh = pmesh.make_mesh(4, disp_parallel=4, devices=[dev] * 4)
    with pytest.raises(ValueError):                   # 2 over 4 ranks: Dl 0
        pmesh.bm_match_tp(mesh, BMParams(disp_num=2))(L, L)


def _exact_scan_hold(dev, case):
    """Kernel V against the CPU path, every field (assert_array_equal),
    once a call; the ATen ops that launch work a call: the map's and the
    range's uploads (the read's output lies on the host, and the result's
    torch.tensor on the card dispatches no ATen op)."""
    from chip_smoke import aten_ops_of_a_call
    from jackal_tpu_torch.scan import exact_scan as es

    dmap, valid, Q, XR, XT, ox, oy = case
    want = es.obstacle_scan_from_disparity_exact(dmap, valid, Q, XR, XT, ox,
                                                 oy, device="cpu")
    n0 = es.launches["exact_scan"]
    got = []
    ops = aten_ops_of_a_call(lambda: got.append(
        es.obstacle_scan_from_disparity_exact(dmap, valid, Q, XR, XT, ox,
                                              oy, device=dev)))
    assert es.launches["exact_scan"] == n0 + 1
    assert len([n for n, ok in ops if not ok]) == 2, ops
    for f in ("scan", "angle_min", "angle_max", "range_min", "range_max"):
        a = getattr(got[0], f)
        assert a.is_cuda and a.dtype == torch.float64
        np.testing.assert_array_equal(a.cpu().numpy(),
                                      getattr(want, f).numpy())
    return got[0]


@pytest.mark.parametrize("case", range(4))
def test_exact_scan_kernel_edges(dev, case):
    """chip_smoke.EXACT_SCAN_EDGE_CASES (tests/test_torch_exact_scan_edges.py
    holds the CPU path to the JAX package on them)."""
    from chip_smoke import EXACT_SCAN_EDGE_CASES, exact_scan_edge_case

    _exact_scan_hold(dev, exact_scan_edge_case(EXACT_SCAN_EDGE_CASES[case]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_scan_kernel_node_maps(dev, seed):
    """640x480 maps of the node's shape on the default calibration's cache,
    seeded d in 0..96 (many accepted pixels, every bin)."""
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine="bm", device="cpu", params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480))
    rng = np.random.default_rng(seed)
    H, W = pipe.valid_disp.shape[:2]
    dmap = rng.integers(0, 97, (H, W)).astype(np.uint8)
    res = _exact_scan_hold(dev, (dmap, pipe.valid_disp.numpy(), pipe.rect.Q,
                                 pipe.calib.XR, pipe.calib.XT,
                                 pipe.p.crop_offset_x, pipe.p.crop_offset_y))
    assert int((res.scan < 1e9 - 1).sum()) > 10
