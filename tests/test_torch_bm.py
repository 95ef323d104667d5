"""The port's BM engine on the CPU == jackal_tpu's, bit for bit.

Each plain function against the reference package on seeded inputs: the
box filter, the texture gate, bm_finalize, and bm_match at D = 16, 33, 64,
128 and 256 on awkward shapes, a 96x320 golden crop and the full 640x480
boxes scene, and at the windows past kernel G's strip (257, where real
costs pass the invalid cost 1 << 24, and 75 at D = 256). Kernel G's plain
twin against the Pallas kernel in interpret
mode (as tests/test_pallas_kernels.py runs it): bit for bit at D = 16 and
33, where the Pallas kernel's invalid cost _big(D) is bm_match's 1 << 24;
at D = 64 (2^24 - 1) and D = 128 (2^23 - 1) the Pallas kernel departs
from bm_match where that sentinel enters the parabola, and the port keeps
bm_match's value. Then the slice: the BM node's process_frame,
process_batch_fused and StreamingRunner against the reference's.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jackal_tpu.config import BMParams as JaxBMParams
from jackal_tpu.matching import bm as jbm
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu_torch.config import BMParams
from jackal_tpu_torch.io_bus.bus import TopicBus
from jackal_tpu_torch.matching import bm
from jackal_tpu_torch.ops import bm_kernel as bk
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_SCAN,
                                              StreamingRunner)
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
from jackal_tpu_torch.scan.obstacle import format_laser_scan_ranges

SCAN_RTOL = 1e-5
FIX = "tests/fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _params(D, window=9):
    return (JaxBMParams(disp_num=D, window=window),
            BMParams(disp_num=D, window=window))


def _pair(rng, B, H, W, shift):
    """A seeded pair whose right image is the left one moved ``shift``
    columns to the left: disparity ``shift`` everywhere."""
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    return left, np.roll(left, -shift, axis=2)


@pytest.mark.parametrize("H,W,r", [(7, 13, 1), (23, 61, 4), (5, 40, 7),
                                   (1, 9, 2)])
def test_box_filter_equals_jax(H, W, r):
    x = np.random.default_rng(H * W).integers(0, 600, (2, H, W)).astype(
        np.int32)
    want = np.asarray(jbm._box_filter(jnp.asarray(x), r))
    got = bm._box_filter(torch.from_numpy(x), r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W,D,window", [(19, 37, 16, 9), (30, 101, 33, 5),
                                          (8, 70, 24, 3)])
def test_gate_and_finalize_equal_jax(H, W, D, window):
    rng = np.random.default_rng(W)
    jp, tp = _params(D, window)
    left = rng.integers(0, 256, (H, W)).astype(np.uint8)
    left[:, : W // 3] = left[:, :1]        # a textureless band the gate drops
    dL = rng.uniform(-1, D, (H, W)).astype(np.float32)
    dR = np.where(rng.random((H, W)) < 0.9, np.roll(dL, -3, 1), -1.0
                  ).astype(np.float32)
    want = np.asarray(jbm.bm_texture_gate(jnp.asarray(left), jnp.asarray(dL),
                                          jp))
    got = bm.bm_texture_gate(torch.from_numpy(left), torch.from_numpy(dL), tp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).mean() > 0.1 and (want >= 0).mean() > 0.2
    wl, wr = jbm.bm_finalize(jnp.asarray(left), jnp.asarray(dL),
                             jnp.asarray(dR), jp)
    gl, gr = bm.bm_finalize(torch.from_numpy(left), torch.from_numpy(dL),
                            torch.from_numpy(dR), tp)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


@pytest.mark.parametrize("B,H,W,D,window,shift", [
    (2, 23, 97, 16, 9, 5),          # odd H, W % 32 != 0, a batch of two
    (1, 30, 150, 33, 7, 11),        # odd D
    (1, 20, 140, 64, 9, 40),        # the headline's D
    (1, 12, 300, 128, 5, 70),
    (1, 9, 333, 256, 9, 100),       # bench_bm256's D
])
def test_bm_match_equals_jax(B, H, W, D, window, shift):
    rng = np.random.default_rng(H * W + D)
    left, right = _pair(rng, B, H, W, shift)
    jp, tp = _params(D, window)
    dl, dr = bm.bm_match_batch(torch.from_numpy(left),
                               torch.from_numpy(right), tp)
    assert dl.shape == (B, H, W) and dl.dtype == torch.float32
    for b in range(B):
        wl, wr = jbm.bm_match(jnp.asarray(left[b]), jnp.asarray(right[b]), jp)
        np.testing.assert_array_equal(dl[b].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(dr[b].numpy(), np.asarray(wr))
    assert (dl >= 0).float().mean() > 0.3
    # the fused twin, gated, is bm_match: the gate and the L/R check only
    # write -1, so their order does not matter
    fl, fr = bk.bm_match_fused(torch.from_numpy(left),
                               torch.from_numpy(right), tp)
    assert torch.equal(bm.bm_texture_gate(torch.from_numpy(left), fl, tp), dl)
    assert torch.equal(fr, dr)


def test_bm_match_past_the_card_limit_equals_jax():
    """D = 320, past G's strip kernel (ops/bm_kernel.STRIP_MAX_D): the
    port's plain engine and kernel G's plain twin compute the reference's
    function there; the card's D > 256 path equals them
    (tests/test_torch_cuda.py::test_bm_and_sgm_card_past_d256_equal_cpu)."""
    _past_the_strip(320, 360)


@pytest.mark.parametrize("D,W", [(512, 560), (1024, 1100)])
def test_bm_match_at_large_d_equals_jax(D, W):
    """D = 512 and 1024 on narrow strips (W >= D + 40)."""
    _past_the_strip(D, W)


def _past_the_strip(D, W):
    rng = np.random.default_rng(D)
    left, right = _pair(rng, 1, 12, W, 40)
    jp, tp = _params(D)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    dl, dr = bm.bm_match(lt, rt, tp)
    wl, wr = jbm.bm_match(jnp.asarray(left[0]), jnp.asarray(right[0]), jp)
    np.testing.assert_array_equal(dl[0].numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr[0].numpy(), np.asarray(wr))
    assert (np.abs(np.asarray(wl) - 40) < 1).mean() > 0.5
    fl, fr = bk.bm_match_fused(lt, rt, tp)
    assert torch.equal(bm.bm_texture_gate(lt, fl, tp), dl)
    assert torch.equal(fr, dr)


@pytest.mark.parametrize("case", ["binary pair, window 257",
                                  "golden crop, D = 256, window 75"])
def test_bm_match_wide_windows_equal_jax(case):
    """Windows past kernel G's strip, which the card takes on its path
    without shared memory: 257 (r = 128 > 127), where real costs pass the
    invalid cost 1 << 24 and bm_match compares them as int32 against it
    (an invalid d wins, cm and cp are clamped to it; uniqueness 1 and a
    loose L/R threshold keep the pixels where the clamp moves the parabola
    in the output: 3 of them differ without it), and 75 at D = 256, past
    the strip's shared memory. The port's bm_match and G's plain twin
    equal the reference's."""
    if case.startswith("binary"):
        from chip_smoke import binary_pair

        left, right = binary_pair()
        kw = dict(disp_num=64, window=257, uniqueness=1.0, lr_threshold=1000)
        ad = np.abs(left.astype(np.int32) - right.astype(np.int32))
        assert int(bm._box_filter(torch.from_numpy(ad), 128).max()) > 1 << 24
    else:
        g = np.load(f"{FIX}/elas_golden_s640_boxes.npz")
        crop = (slice(200, 296), slice(160, 480))
        left, right = (np.ascontiguousarray(g[k][crop])
                       for k in ("left", "right"))
        kw = dict(disp_num=256, window=75)
    jp, tp = JaxBMParams(**kw), BMParams(**kw)
    wl, wr = jbm.bm_match(jnp.asarray(left), jnp.asarray(right), jp)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    dl, dr = bm.bm_match(lt, rt, tp)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(wr))
    assert (np.asarray(wl) >= 0).mean() > 0.1
    fl, fr = bk.bm_match_fused(lt[None], rt[None], tp)
    assert torch.equal(bm.bm_texture_gate(lt, fl[0], tp), dl)
    assert torch.equal(fr[0], dr)


@pytest.mark.parametrize("fix,crop,D", [
    ("elas_golden_s640_boxes", (slice(200, 296), slice(160, 480)), 256),
    ("elas_golden_photo", (slice(0, 96), slice(0, 320)), 64),
    ("elas_golden_s640_boxes", (slice(None), slice(None)), 64),
])
def test_golden_scenes_equal_jax(fix, crop, D):
    g = np.load(f"{FIX}/{fix}.npz")
    left = np.ascontiguousarray(g["left"][crop])
    right = np.ascontiguousarray(g["right"][crop])
    jp, tp = _params(D)
    wl, wr = jbm.bm_match(jnp.asarray(left), jnp.asarray(right), jp)
    dl, dr = bm.bm_match(left, right, tp)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(wr))
    assert (np.asarray(wl) >= 0).mean() > 0.1


@pytest.mark.parametrize("B,H,W,D,shift", [(2, 19, 150, 16, 5),
                                           (1, 21, 130, 33, 7)])
def test_fused_twin_equals_pallas(interpret_pallas, B, H, W, D, shift):
    """Where the Pallas kernel's sentinel is 1 << 24 (D <= 64 is not
    enough: _big(64) = 2^24 - 1), the plain twin of G equals it bit for
    bit, the left map gated as the pipeline gates it."""
    from jackal_tpu.ops.pallas.bm_kernel import _big, bm_match_pallas

    assert _big(D) == bm._BIG
    rng = np.random.default_rng(D)
    left, right = _pair(rng, B, H, W, shift)
    jp, tp = _params(D)
    pl_, pr = bm_match_pallas(jnp.asarray(left), jnp.asarray(right), jp)
    pl_ = np.asarray(jbm.bm_texture_gate(jnp.asarray(left), pl_, jp))
    gl, gr = bk.bm_match_fused_plain(torch.from_numpy(left),
                                     torch.from_numpy(right), tp)
    gl = bm.bm_texture_gate(torch.from_numpy(left), gl, tp)
    np.testing.assert_array_equal(gl.numpy(), pl_)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(pr))
    assert (pl_ >= 0).mean() > 0.5


@pytest.mark.parametrize("seed,H,W,D,window,shift,n_right,n_left", [
    (10, 24, 200, 64, 9, 9, 3, 0), (133, 8, 140, 128, 3, 1, 8, 3)])
def test_pallas_sentinel_differs_from_bm_match(interpret_pallas, seed, H, W,
                                               D, window, shift, n_right,
                                               n_left):
    """The reference package's own difference: at D = 64 the Pallas kernel
    marks invalid costs 2^24 - 1 and at D = 128 2^23 - 1 (_big(D)), where
    bm_match uses 1 << 24. Where best_d +- 1 is an invalid disparity (the
    right view's last columns, the left view's first) that sentinel enters
    the parabola. On these seeded pairs, at D = 64: 3 right-view values
    differ (the first [0, 1, 190]: 8.50019 in bm_match, 8.500191 in Pallas)
    and no left one; seeds 0-4, 7, 9 and 11 of the same shape give no
    difference at all. At D = 128: 8 right-view values in column 138 (the
    first [0, 0, 138]: 0.50002885 against 0.5000578) and 3 left-view ones
    in column 1. The port equals bm_match everywhere."""
    from jackal_tpu.ops.pallas.bm_kernel import _big, bm_match_pallas

    assert _big(D) < bm._BIG
    rng = np.random.default_rng(seed)
    left, right = _pair(rng, 1, H, W, shift)
    jp, tp = _params(D, window)
    pl_, pr = (np.asarray(x) for x in bm_match_pallas(
        jnp.asarray(left), jnp.asarray(right), jp, tile_h=8))
    gl, gr = (x.numpy() for x in bk.bm_match_fused_plain(
        torch.from_numpy(left), torch.from_numpy(right), tp))
    # the port's right view is bm_match's, and so is its gated left view
    ml, mr = jbm.bm_match(jnp.asarray(left[0]), jnp.asarray(right[0]), jp)
    np.testing.assert_array_equal(gr[0], np.asarray(mr))
    np.testing.assert_array_equal(
        bm.bm_texture_gate(torch.from_numpy(left[0]),
                           torch.from_numpy(gl[0]), tp).numpy(),
        np.asarray(ml))
    right_diff = np.argwhere(gr != pr)
    left_diff = np.argwhere(gl != pl_)
    assert len(right_diff) == n_right and len(left_diff) == n_left
    assert (right_diff[:, 2] >= W - D).all()        # only near the right edge
    assert (left_diff[:, 2] < D).all()              # and the left one
    assert np.abs(gr - pr).max() < 1e-3 and np.abs(gl - pl_).max() < 1e-3


@pytest.fixture(scope="module")
def nodes():
    port = make_pipeline(engine="bm", device="cpu")
    pairs = [synthetic_raw_pair(port, 0, 12, 0.0),
             synthetic_raw_pair(port, 1, 6, 0.15)]
    return port, jax_make_pipeline(engine="bm"), pairs


def _scans_close(got, want_scan):
    ws, gs = np.asarray(want_scan), got.numpy()
    filled = ws < 1e9 - 1
    assert filled.sum() >= 10
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)


@pytest.mark.parametrize("k", [0, 1])
def test_process_frame_matches_jax(nodes, k):
    port, ref, pairs = nodes
    assert port.engine == "bm"
    want = ref.process_frame(*pairs[k])
    got = port.process_frame(*pairs[k])
    assert got.dmap.dtype == np.uint8 and got.dmap.shape == (180, 320)
    np.testing.assert_array_equal(got.dmap, want.dmap)
    assert (want.dmap > 0).mean() > 0.4
    _scans_close(got.scan.scan, want.scan.scan)
    for key in ("angle_min", "angle_max", "range_min", "range_max"):
        np.testing.assert_allclose(float(getattr(got.scan, key)),
                                   float(getattr(want.scan, key)),
                                   rtol=SCAN_RTOL)


def test_process_batch_fused_matches_jax(nodes):
    port, ref, pairs = nodes
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    dmaps, scans = port.process_batch_fused(lb, rb)
    assert dmaps.dtype == torch.uint8 and dmaps.shape == (2, 180, 320)
    wd, ws = ref.process_batch_fused(jnp.asarray(lb), jnp.asarray(rb))
    np.testing.assert_array_equal(dmaps.numpy(), np.asarray(wd))
    for b in range(2):
        _scans_close(scans.scan[b], np.asarray(ws.scan)[b])
    d2, s2 = port.process_batch(lb, rb)
    assert torch.equal(d2, dmaps) and torch.equal(s2.scan, scans.scan)
    d3, s3, (dmap_t, scan_t) = port.process_batch_fused(lb, rb, timing=True)
    assert torch.equal(d3, dmaps) and dmap_t > 0 and scan_t > 0


def test_streaming_runner_publishes_process_frame(nodes):
    port, _, pairs = nodes
    frames = [port.process_frame(*p) for p in pairs]
    bus = TopicBus()
    depth, scan_msgs = [], []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    bus.subscribe(TOPIC_SCAN, scan_msgs.append)
    runner = StreamingRunner(port, bus, batch_size=2, stage_sample_every=2)
    order = [1, 0, 0]
    assert runner.run(iter([pairs[k] for k in order])) == 3
    assert [m.header.seq for m in depth] == [0, 1, 2]
    for i, k in enumerate(order):
        np.testing.assert_array_equal(depth[i].data, frames[k].dmap)
        np.testing.assert_array_equal(
            scan_msgs[i].ranges, format_laser_scan_ranges(frames[k].scan.scan))
