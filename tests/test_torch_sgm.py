"""The port's SGM engine on the CPU == jackal_tpu's, bit for bit.

Each plain function against the reference package on seeded inputs:
census, cost volume, path aggregation (8 and 4 paths, with cells where the
_CARRY_BIG clamp binds), the WTA maps, the row lookup of the L/R check,
and sgm_match / sgm_match_batch end to end, on awkward shapes and on the
two 640x480 golden scenes. The Pallas kernels D, E and F run in interpret
mode, as tests/test_pallas_kernels.py runs them. Then the slice: the SGM
node's process_frame (u8 map bit for bit, the scan within the relative
1e-5 of tests/test_torch_pipeline.py), process_batch_fused,
StreamingRunner, and the entry point against the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jackal_tpu.config import SGMParams as JaxSGMParams
from jackal_tpu.matching import sgm as jsgm
from jackal_tpu.ops.shifts import shifted_row_lookup as jax_lookup
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu.scan.obstacle import format_laser_scan_ranges as jax_ranges
from jackal_tpu_torch.config import SGMParams
from jackal_tpu_torch.io_bus.bus import TopicBus
from jackal_tpu_torch.matching import sgm
from jackal_tpu_torch.ops import sgm_kernel as sk
from jackal_tpu_torch.ops.shifts import shifted_row_lookup
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_SCAN,
                                              StreamingRunner)
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
from jackal_tpu_torch.scan.obstacle import format_laser_scan_ranges

SCAN_RTOL = 1e-5


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


def _pair(rng, B, H, W, shift=5):
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    return left, np.roll(left, shift, axis=2)


def _params(D, **kw):
    return (dataclasses.replace(JaxSGMParams(disp_num=D), **kw),
            dataclasses.replace(SGMParams(disp_num=D), **kw))


@pytest.mark.parametrize("B,H,W", [(2, 37, 61), (1, 128, 128), (3, 130, 257),
                                   (1, 5, 640)])
def test_census_equals_jax(interpret_pallas, B, H, W):
    from jackal_tpu.ops.pallas.sgm_kernel import census5x5_pallas

    img = np.random.default_rng(7 + W).integers(0, 256, (B, H, W)).astype(
        np.uint8)
    want = np.asarray(jax.vmap(jsgm.census5x5)(jnp.asarray(img)))
    np.testing.assert_array_equal(
        np.asarray(census5x5_pallas(jnp.asarray(img))), want)
    got = sk.census5x5_batch(torch.from_numpy(img))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sgm.census5x5(torch.from_numpy(img[0]))
                                  .numpy(), want[0])


@pytest.mark.parametrize("B,H,W", [
    (2, 9, 13), (1, 6, 18), (3, 11, 31)] + [    # W % 4 = 1, 2, 3
    (1, h, w) for h in (1, 2, 3, 5) for w in (1, 2, 3, 5)])
def test_census_odd_shapes_equal_jax(B, H, W):
    """Kernel D's plain twin at the widths its 4-pixel words make awkward
    and at frames smaller than the 5x5 window, against jackal_tpu's
    census5x5 (the Pallas kernel's own reference)."""
    img = np.random.default_rng(H * 10 + W).integers(
        0, 256, (B, H, W)).astype(np.uint8)
    img[0, 0, 0] = img[0, -1, -1]       # a tie with the far corner
    want = np.asarray(jax.vmap(jsgm.census5x5)(jnp.asarray(img)))
    np.testing.assert_array_equal(
        sk.census5x5_batch(torch.from_numpy(img)).numpy(), want)


@pytest.mark.parametrize("H,W,D", [(23, 150, 16), (12, 40, 24), (9, 61, 48)])
def test_cost_volume_equals_jax(H, W, D):
    rng = np.random.default_rng(H * W)
    left, right = _pair(rng, 1, H, W)
    cl, cr = (np.asarray(jsgm.census5x5(jnp.asarray(x[0])))
              for x in (left, right))
    tl, tr = torch.from_numpy(cl), torch.from_numpy(cr)
    want = np.asarray(jsgm.census_cost_volume(jnp.asarray(cl),
                                              jnp.asarray(cr), D))
    got = sgm.census_cost_volume(tl, tr, D)
    assert got.dtype == torch.int16 and got.shape == (D, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sgm.census_cost_volume_hdw(tl, tr, D).numpy(),
        np.asarray(jsgm.census_cost_volume_hdw(jnp.asarray(cl),
                                               jnp.asarray(cr), D)))
    # the popcount of the full 24-bit range, beyond what census gives
    x = torch.from_numpy(rng.integers(0, 1 << 24, 4096).astype(np.int32))
    np.testing.assert_array_equal(
        sgm._popcount(x).numpy(),
        np.asarray(jsgm._popcount(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("num_paths", [8, 4])
@pytest.mark.parametrize("H,W,D", [(17, 61, 16), (20, 40, 24)])
def test_aggregate_paths_equals_jax(num_paths, H, W, D):
    """D > W/2 at (20, 40, 24): most cells carry the 12000 sentinel, and
    the 8-path sums there pass _CARRY_BIG, so every clamp binds."""
    rng = np.random.default_rng(num_paths * H)
    jp, tp = _params(D, num_paths=num_paths)
    cost = rng.integers(0, 25, (D, H, W)).astype(np.int16)
    cost = np.where(np.arange(D)[:, None, None] > np.arange(W), 12000,
                    cost).astype(np.int16)
    want = np.asarray(jsgm.aggregate_paths(jnp.asarray(cost), jp))
    got = sgm.aggregate_paths(torch.from_numpy(cost), tp)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 28000).sum() > 0 and (want < 1000).sum() > 0
    # the kernel's [B, H, D, W] twin on a batch of two
    batch = np.stack([cost, cost[:, ::-1]]).transpose(0, 2, 1, 3)
    got_b = sk.aggregate_paths_bhdw(torch.from_numpy(batch.copy()), tp)
    np.testing.assert_array_equal(got_b[0].numpy(), want.transpose(1, 0, 2))


def test_aggregate_paths_penalty_range():
    """Up to the largest penalties the reference's int16 recurrence takes
    without wrapping (_CARRY_BIG + P = 2^15 - 1) the port equals it; above
    them the reference wraps below 0 and the port, in int32, stays in
    [0, _CARRY_BIG]."""
    rng = np.random.default_rng(12)
    D, H, W = 16, 13, 45
    cost = rng.integers(0, 25, (D, H, W)).astype(np.int16)
    cost = np.where(np.arange(D)[:, None, None] > np.arange(W), 12000,
                    cost).astype(np.int16)
    edge = (1 << 15) - 1 - sgm._CARRY_BIG
    jp, tp = _params(D, p1=edge, p2=edge)
    want = np.asarray(jsgm.aggregate_paths(jnp.asarray(cost), jp))
    got = sgm.aggregate_paths(torch.from_numpy(cost), tp)
    np.testing.assert_array_equal(got.numpy(), want)
    jp, tp = _params(D, p1=6000, p2=100000)
    assert (np.asarray(jsgm.aggregate_paths(jnp.asarray(cost), jp)) < 0).any()
    got = sgm.aggregate_paths(torch.from_numpy(cost), tp)
    assert int(got.min()) >= 0 and int(got.max()) == sgm._CARRY_BIG


def test_penalties_past_int16_equal_pallas(interpret_pallas):
    """Past the jnp engine's int16 line (P1 = 6000, P2 = 100000, the input
    of test_aggregate_paths_penalty_range) the reference's two engines
    part: the Pallas kernel E runs the recurrence in int32 and clamps on
    store, as the port's engine and kernel E's plain twin do, and they
    equal it bit for bit."""
    from jackal_tpu.ops.pallas.sgm_kernel import aggregate_paths_pallas_bhdw

    rng = np.random.default_rng(12)
    D, H, W = 16, 13, 45
    cost = rng.integers(0, 25, (D, H, W)).astype(np.int16)
    cost = np.where(np.arange(D)[:, None, None] > np.arange(W), 12000,
                    cost).astype(np.int16)
    jp, tp = _params(D, p1=6000, p2=100000)
    bhdw = np.ascontiguousarray(cost.transpose(1, 0, 2)[None])
    want = np.asarray(aggregate_paths_pallas_bhdw(jnp.asarray(bhdw), jp,
                                                  hdw_layout=True))
    got = sgm.aggregate_paths(torch.from_numpy(cost), tp)
    np.testing.assert_array_equal(got.numpy(), want[0].transpose(1, 0, 2))
    twin = sk.aggregate_paths_bhdw(torch.from_numpy(bhdw), tp)
    np.testing.assert_array_equal(twin.numpy(), want)
    assert (np.asarray(jsgm.aggregate_paths(jnp.asarray(cost), jp))
            != want[0].transpose(1, 0, 2)).any()


@pytest.mark.parametrize("case", ["aggregated", "ties", "D2"])
def test_kernel_twins_equal_pallas(interpret_pallas, case):
    """Kernels E and F in interpret mode == the plain twins, at a tiny
    shape with odd H; the right view reads 12000 past the border. F also
    on a tie-heavy volume (values of {0, 9000, 18000} and a constant row:
    the first d wins) and at D = 2 (no d is left for the second best)."""
    from jackal_tpu.ops.pallas.sgm_kernel import (
        aggregate_paths_pallas_bhdw, sgm_wta_maps_pallas)

    rng = np.random.default_rng(1)
    if case == "aggregated":
        B, H, W, D = 1, 9, 40, 8
        left, right = _pair(rng, B, H, W, 3)
        jp, tp = _params(D)
        cl = jax.vmap(jsgm.census5x5)(jnp.asarray(left))
        cr = jax.vmap(jsgm.census5x5)(jnp.asarray(right))
        cost = jax.vmap(lambda a, b: jsgm.census_cost_volume_hdw(a, b, D))(
            cl, cr)
        S = aggregate_paths_pallas_bhdw(cost, jp, hdw_layout=True)
        got_S = sk.aggregate_paths_bhdw(torch.from_numpy(np.asarray(cost)),
                                        tp)
        np.testing.assert_array_equal(got_S.numpy(), np.asarray(S))
    else:
        B, H, W, D = (2, 7, 45, 16) if case == "ties" else (1, 5, 33, 2)
        S_np = (rng.integers(0, 3, (B, H, D, W)) * 9000).astype(np.int16)
        S_np[:, 2] = 18000 if case == "ties" else rng.integers(
            0, 28001, (B, D, W))
        S, got_S = jnp.asarray(S_np), torch.from_numpy(S_np)
    maps = np.asarray(sgm_wta_maps_pallas(S))
    got = sk.sgm_wta_maps(got_S)
    assert got.dtype == torch.int16 and got.shape == (B, H, 10, W)
    np.testing.assert_array_equal(got.numpy(), maps)
    if case == "aggregated":
        # last column: only d = 0 lies inside, so the second best and the
        # cost at d = 1 are the sentinel
        assert (maps[:, :, 7:10:2, -1] == 12000).all()
    elif case == "ties":
        # the constant row: best_d 0, the second best the value
        assert (maps[:, 2, 1] == 0).all() and (maps[:, 2, 2] == 18000).all()
    else:
        # D = 2: best_d +- 1 covers both d, nothing is left
        assert (maps[:, :, 2] == 30000).all()


@pytest.mark.parametrize("true_right", [False, True])
def test_finalize_equals_jax(true_right):
    rng = np.random.default_rng(3)
    D, H, W = 16, 11, 50
    jp, tp = _params(D, true_right=true_right)
    S = rng.integers(0, 400, (D, H, W)).astype(np.int16)
    S[rng.random(S.shape) < 0.05] = 28000
    S[:, 2, 7] = S[:, 2, 7].min()            # a tie: the first d wins
    SR = rng.integers(0, 400, (D, H, W)).astype(np.int16) \
        if true_right else None
    want = jsgm._finalize(jnp.asarray(S), jp,
                          None if SR is None else jnp.asarray(SR))
    got = sgm._finalize(torch.from_numpy(S), tp,
                        None if SR is None else torch.from_numpy(SR))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sign", [-1, 1])
def test_shifted_row_lookup_equals_jax(sign):
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((3, 7, 33)).astype(np.float32)
    s = rng.integers(0, 10, (3, 7, 33)).astype(np.int32)
    want = np.asarray(jax_lookup(jnp.asarray(arr), jnp.asarray(s), 9, sign))
    got = shifted_row_lookup(torch.from_numpy(arr), torch.from_numpy(s), 9,
                             sign)
    np.testing.assert_array_equal(got.numpy(), want)
    # one [H, W] shift map for a batch of rows
    got2 = shifted_row_lookup(torch.from_numpy(arr), torch.from_numpy(s[0]),
                              9, sign)
    np.testing.assert_array_equal(got2[1].numpy(), np.asarray(jax_lookup(
        jnp.asarray(arr[1]), jnp.asarray(s[0]), 9, sign)))


@pytest.mark.parametrize("shape,kw", [
    ((1, 16, 128, 24), {}),                    # non-power-of-two D
    ((2, 23, 150, 16), {}),                    # odd H, W % 32 != 0, B > 1
    ((1, 40, 96, 48), {}),                     # D > W/2
    ((1, 18, 130, 16), {"true_right": True}),
    ((2, 21, 70, 24), {"num_paths": 4}),
])
def test_sgm_match_batch_equals_jax(shape, kw):
    B, H, W, D = shape
    rng = np.random.default_rng(H * W)
    left, right = _pair(rng, B, H, W)
    jp, tp = _params(D, **kw)
    dl, dr = sgm.sgm_match_batch(left, right, tp, device="cpu")
    assert dl.shape == (B, H, W) and dl.dtype == torch.float32
    for b in range(B):
        wl, wr = jsgm.sgm_match(jnp.asarray(left[b]), jnp.asarray(right[b]),
                                jp)
        np.testing.assert_array_equal(dl[b].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(dr[b].numpy(), np.asarray(wr))
        assert (np.asarray(wl) >= 0).mean() > 0.1
    one = sgm.sgm_match(left[-1], right[-1], tp, device="cpu")
    assert torch.equal(one[0], dl[-1]) and torch.equal(one[1], dr[-1])


def test_sgm_match_past_the_card_limit_equals_jax():
    """D = 320, past the register paths of kernels E and F: the port's
    plain engine computes the reference's function there; the card's
    D > 256 paths equal it
    (tests/test_torch_cuda.py::test_bm_and_sgm_card_past_d256_equal_cpu)."""
    _past_256(320, 360)


@pytest.mark.parametrize("D,W", [(512, 560), (1024, 1100)])
def test_sgm_match_at_large_d_equals_jax(D, W):
    """D = 512 and 1024 on narrow strips (W >= D + 40)."""
    _past_256(D, W)


def _past_256(D, W):
    rng = np.random.default_rng(D)
    left, right = _pair(rng, 1, 12, W, 40)
    jp, tp = _params(D)
    dl, dr = sgm.sgm_match(left[0], right[0], tp, device="cpu")
    wl, wr = jsgm.sgm_match(jnp.asarray(left[0]), jnp.asarray(right[0]), jp)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(wr))
    assert (np.asarray(wl) >= 0).mean() > 0.1


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("fix", ["elas_golden_s640_boxes",
                                 "elas_golden_photo"])
def test_golden_scenes_equal_jax(fix, D):
    g = np.load(f"tests/fixtures/{fix}.npz")
    jp, tp = _params(D)
    wl, wr = jsgm.sgm_match(jnp.asarray(g["left"]), jnp.asarray(g["right"]),
                            jp)
    dl, dr = sgm.sgm_match(g["left"], g["right"], tp, device="cpu")
    assert dl.shape == (480, 640)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(wr))
    assert (np.asarray(wl) >= 0).mean() > 0.2


@pytest.fixture(scope="module")
def nodes():
    port = make_pipeline(device="cpu")         # the default engine: SGM
    pairs = [synthetic_raw_pair(port, 0, 12, 0.0),
             synthetic_raw_pair(port, 1, 6, 0.15)]
    return port, jax_make_pipeline(engine="sgm"), pairs


def _scans_close(got, want_scan):
    ws, gs = np.asarray(want_scan), got.numpy()
    filled = ws < 1e9 - 1
    assert filled.sum() >= 10
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)


@pytest.mark.parametrize("k", [0, 1])
def test_process_frame_matches_jax(nodes, k):
    port, ref, pairs = nodes
    assert port.engine == "sgm"
    want = ref.process_frame(*pairs[k])
    got = port.process_frame(*pairs[k])
    assert got.dmap.dtype == np.uint8 and got.dmap.shape == (180, 320)
    np.testing.assert_array_equal(got.dmap, want.dmap)
    assert (want.dmap > 0).mean() > 0.4
    _scans_close(got.scan.scan, want.scan.scan)
    np.testing.assert_allclose(format_laser_scan_ranges(got.scan.scan),
                               jax_ranges(want.scan.scan), rtol=SCAN_RTOL)
    for key in ("angle_min", "angle_max", "range_min", "range_max"):
        np.testing.assert_allclose(float(getattr(got.scan, key)),
                                   float(getattr(want.scan, key)),
                                   rtol=SCAN_RTOL)


def test_batch_paths_equal_process_frame(nodes):
    port, _, pairs = nodes
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    dmaps, scans = port.process_batch_fused(lb, rb)
    assert dmaps.dtype == torch.uint8 and dmaps.shape == (2, 180, 320)
    d2, s2 = port.process_batch(lb, rb)
    assert torch.equal(d2, dmaps) and torch.equal(s2.scan, scans.scan)
    for b, pair in enumerate(pairs):
        fr = port.process_frame(*pair)
        np.testing.assert_array_equal(fr.dmap, dmaps[b].numpy())
        assert torch.equal(fr.scan.scan, scans.scan[b])
        assert float(fr.scan.range_min) == float(scans.range_min[b])


def test_process_batch_fused_timing(nodes):
    """timing=True gives the same maps and scans and per-frame stage
    times."""
    port, _, pairs = nodes
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    dmaps, scans = port.process_batch_fused(lb, rb)
    d2, s2, (dmap_t, scan_t) = port.process_batch_fused(lb, rb, timing=True)
    assert torch.equal(d2, dmaps) and torch.equal(s2.scan, scans.scan)
    assert dmap_t > 0 and scan_t > 0


def test_streaming_runner_publishes_process_frame(nodes):
    port, _, pairs = nodes
    frames = [port.process_frame(*p) for p in pairs]
    bus = TopicBus()
    depth, scan_msgs = [], []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    bus.subscribe(TOPIC_SCAN, scan_msgs.append)
    runner = StreamingRunner(port, bus, batch_size=2, stage_sample_every=2)
    order = [0, 1, 1, 0, 0]
    assert runner.run(iter([pairs[k] for k in order])) == 5
    assert runner.batch_no == 3          # batches 0 and 2 ran staged
    assert [m.header.seq for m in depth] == list(range(5))
    assert len(scan_msgs) == 5
    for i, k in enumerate(order):
        np.testing.assert_array_equal(depth[i].data, frames[k].dmap)
        np.testing.assert_array_equal(
            scan_msgs[i].ranges, format_laser_scan_ranges(frames[k].scan.scan))
    assert runner.run(iter([pairs[0]] * 4), max_frames=3) == 3
    assert len(depth) == 8


def test_entry_matches_jax():
    """The flagship step, rectify -> SGM (D = 64) -> scan at 640x480,
    against the reference package's __graft_entry__.entry."""
    import __graft_entry__
    from jackal_tpu_torch.entry import entry

    fn, (left, right) = entry(device="cpu")
    assert left.shape == (1, 480, 640) and left.dtype == torch.uint8
    jfn, (jl, jr) = __graft_entry__.entry()
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    dmaps, scan = fn(left, right)
    jd, js = jfn(jl, jr)
    assert dmaps.shape == (1, 480, 640) and scan.shape == (1, 90)
    np.testing.assert_array_equal(dmaps.numpy(), np.asarray(jd))
    ws, gs = np.asarray(js), scan.numpy()
    filled = ws < 1e9 - 1
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)
