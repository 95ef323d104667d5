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
    (2, 60, 160, 47, 0), (1, 43, 101, 30, 4), (1, 120, 333, 255, 0)])
def test_support_kernel_equals_plain(dev, B, H, W, disp_max, disp_min):
    rng = np.random.default_rng(W)
    l = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    r = np.roll(l, -9, axis=2)    # right(u - 9) = left(u)
    d1 = create_descriptor(torch.from_numpy(l).to(dev))
    d2 = create_descriptor(torch.from_numpy(r).to(dev))
    step = sm.effective_stepsize(ElasParams())
    ncv = -(-H // step)
    Q, T = sm.grid_row_blocks(d1, step, ncv), sm.grid_row_blocks(d2, step, ncv)
    n0 = sm.launches
    got = sm.support_keys(Q, T, disp_min, disp_max + 1)
    want = sm.support_keys_plain(Q, T, disp_min, disp_max + 1)
    assert sm.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    p = ElasParams(disp_max=disp_max, disp_min=disp_min)
    cpu = sm.support_candidates(d1.cpu(), d2.cpu(), p)
    assert torch.equal(sm.support_candidates(d1, d2, p).cpu(), cpu)


@pytest.mark.parametrize("right_image", [False, True])
@pytest.mark.parametrize("B,H,W,preset", [
    (1, 40, 128, "robotics"), (2, 33, 75, "middlebury"),
    (1, 480, 640, "robotics")])
def test_dense_kernel_equals_plain(dev, B, H, W, preset, right_image):
    rng = np.random.default_rng(H * W)
    p = getattr(ElasParams, preset)()
    l = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    d1 = create_descriptor(torch.from_numpy(l).to(dev))
    d2 = create_descriptor(torch.from_numpy(np.roll(l, 7, axis=2)).to(dev))
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-3, 260, (B, H, W)).astype(np.int32),
        rng.random((B, H, W)) < 0.7, rng.random((B, H, W)) < 0.9,
        dm.pack_grid(rng.random((B, -(-H // 20), -(-W // 20), p.disp_num))
                     < 0.1))]
    n0 = dm.launches
    got = dm.dense_match(d1, d2, *args, p, right_image)
    assert dm.launches == n0 + 1
    want = dm.dense_match_plain(d1, d2, *args, p, right_image)
    assert torch.equal(got, want)


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
