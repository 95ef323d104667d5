"""The batched ELAS path on the CPU == jackal_tpu's, bit for bit:
elas_match_batch on crops of a golden scene and a flat (support-free)
frame, content-permuted, by chunks of 1 and of 2; elas_match_stream ==
the batch path, batch by batch, in order; StereoPipeline.process_batch ==
jackal_tpu's (u8 maps bit for bit, scans within the per-frame test's
relative 1e-5, see test_torch_pipeline.py); StreamingRunner publishes one
depth map and one scan per frame, equal to process_batch's."""
import dataclasses

import numpy as np
import pytest
import torch

from jackal_tpu import config as jconfig
from jackal_tpu.matching.elas.pipeline import (
    elas_match_batch as jax_elas_match_batch)
from jackal_tpu.pipeline.default import default_calibration as jax_calib
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu_torch.compat import state_from_numpy
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.io_bus.bus import TopicBus
from jackal_tpu_torch.io_bus.timelog import TimeLogWriter
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas.pipeline import (elas_match,
                                                     elas_match_batch,
                                                     elas_match_batch_device,
                                                     elas_match_stream)
from jackal_tpu_torch.pipeline.frame_pipeline import StereoPipeline
from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_SCAN,
                                              StreamingRunner)
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
from jackal_tpu_torch.scan.obstacle import format_laser_scan_ranges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCAN_RTOL = 1e-5
CROPS = [(40, 60), (0, 0), (80, 150)]


@pytest.fixture(scope="module")
def frames():
    """Three 96x160 crops of elas_golden_s320_flat and a flat frame (no
    support point: the bail-out)."""
    g = np.load("tests/fixtures/elas_golden_s320_flat.npz")
    lb = [g["left"][y:y + 96, x:x + 160] for y, x in CROPS]
    rb = [g["right"][y:y + 96, x:x + 160] for y, x in CROPS]
    lb.insert(1, np.full((96, 160), 128, np.uint8))
    rb.insert(1, np.full((96, 160), 128, np.uint8))
    return np.stack(lb), np.stack(rb)


@pytest.fixture(scope="module")
def jax_batch(frames):
    """The reference package's batch output, content-permuted, chunk 2
    (its outputs do not depend on the chunking)."""
    return jax_elas_match_batch(*frames, chunk=2)


@pytest.mark.parametrize("chunk", [1, 2])
def test_elas_match_batch_equals_jax(frames, jax_batch, chunk):
    lb, rb = frames
    B = len(lb)
    counts = [int((pl._front(torch.from_numpy(lb), torch.from_numpy(rb),
                             ElasParams())[2][b] >= 0).sum())
              for b in range(B)]
    assert (np.argsort(counts, kind="stable") != np.arange(B)).any()
    D1, D2 = elas_match_batch(lb, rb, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(D1, jax_batch[0])
    np.testing.assert_array_equal(D2, jax_batch[1])
    assert (D1[1] == -10).all() and (D1[0] >= 0).mean() > 0.4
    s1, s2 = elas_match(lb[0], rb[0], device="cpu")
    np.testing.assert_array_equal(s1.numpy(), D1[0])
    np.testing.assert_array_equal(s2.numpy(), D2[0])


def test_stream_equals_batch(frames):
    lb, rb = frames
    batches = [(lb[0:2], rb[0:2]), (lb[2:4], rb[2:4]), (lb[1:3], rb[1:3])]
    outs = list(elas_match_stream(iter(batches), ElasParams(), chunk=1,
                                  depth=2, device="cpu"))
    assert len(outs) == len(batches)
    for (l, r), (D1, D2) in zip(batches, outs):
        W1, W2 = elas_match_batch_device(l, r, chunk=1, device="cpu")
        assert torch.equal(D1, W1) and torch.equal(D2, W2)


def test_batch_entry_points_raise_without_the_card(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lb, rb = frames
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elas_match_batch_device(lb, rb)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(elas_match_stream(iter([(lb, rb)])))
    with pytest.raises(ValueError, match="does not support subsampling"):
        elas_match_batch(lb, rb, dataclasses.replace(ElasParams(),
                                                     subsampling=True),
                         device="cpu")


@pytest.fixture(scope="module")
def nodes():
    c = jax_calib()
    params = {"elas": dataclasses.asdict(jconfig.ElasParams()),
              "pipeline": dataclasses.asdict(jconfig.PipelineParams()),
              "scan": dataclasses.asdict(jconfig.ScanParams()),
              "ground_plane": dataclasses.asdict(jconfig.GroundPlaneParams())}
    st = state_from_numpy(dataclasses.asdict(c), params)
    port = StereoPipeline(st.calib, st.pipeline, "elas", st.elas,
                          st.ground_plane, st.scan, device="cpu")
    pairs = [synthetic_raw_pair(port, 0, 12, 0.0),
             synthetic_raw_pair(port, 1, 6, 0.15)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    ref = jax_make_pipeline(engine="elas")
    return port, pairs, port.process_batch(lb, rb), ref.process_batch(lb, rb)


def test_process_batch_matches_jax(nodes):
    _, _, (dmaps, scans), (jd, js) = nodes
    np.testing.assert_array_equal(dmaps.numpy(), np.asarray(jd))
    assert dmaps.dtype == torch.uint8 and dmaps.shape == (2, 180, 320)
    for b in range(2):
        ws, gs = np.asarray(js.scan[b]), scans.scan[b].numpy()
        filled = ws < 1e9 - 1
        assert filled.sum() >= 10
        np.testing.assert_array_equal(gs < 1e9 - 1, filled)
        np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)
        for k in ("angle_min", "angle_max", "range_min", "range_max"):
            np.testing.assert_allclose(float(getattr(scans, k)[b]),
                                       float(getattr(js, k)[b]),
                                       rtol=SCAN_RTOL)


def test_process_batch_equals_process_frame(nodes):
    port, pairs, (dmaps, scans), _ = nodes
    fr = port.process_frame(*pairs[1])
    np.testing.assert_array_equal(fr.dmap, dmaps[1].numpy())
    assert torch.equal(fr.scan.scan, scans.scan[1])
    assert float(fr.scan.range_min) == float(scans.range_min[1])


def test_streaming_runner_publishes_every_frame(nodes, tmp_path):
    port, pairs, (dmaps, scans), _ = nodes
    bus = TopicBus()
    depth, scan_msgs = [], []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    bus.subscribe(TOPIC_SCAN, scan_msgs.append)
    log = TimeLogWriter(dmap_file=str(tmp_path / "d.txt"),
                        scan_file=str(tmp_path / "s.txt"))
    runner = StreamingRunner(port, bus, batch_size=2, timelog=log,
                             stage_sample_every=2)
    stream = [pairs[0], pairs[1], pairs[1], pairs[0], pairs[0]]
    assert runner.run(iter(stream)) == 5
    # batches 0 and 2 are sampled: their 3 frames each log one line
    for f in ("d.txt", "s.txt"):
        times = [float(x) for x in (tmp_path / f).read_text().split()]
        assert len(times) == 3 and min(times) > 0
    assert [m.header.seq for m in depth] == list(range(5))
    assert len(scan_msgs) == 5 and runner.batch_no == 3
    for i, k in enumerate([0, 1, 1, 0, 0]):
        np.testing.assert_array_equal(depth[i].data, dmaps[k].numpy())
        np.testing.assert_array_equal(
            scan_msgs[i].ranges, format_laser_scan_ranges(scans.scan[k]))
        assert scan_msgs[i].range_min == float(scans.range_min[k])
    assert runner.run(iter(stream), max_frames=3) == 3 and len(depth) == 8
    log.close()
