"""Where the per-frame ELAS path may run its speckle filter on the card.

The reference's per-frame path runs the C++ BFS (remove_small_segments_
native); its batched path, and kernel L, compute the device function
(post.remove_small_segments_batch_plain). The BFS also grows a segment from
an invalid start into a valid neighbour within the threshold, so on maps
whose invalid pixels are -10 the two agree below a threshold of 10 and
differ at 10 and above. elas_match therefore runs kernel L only where
speckle_sim_threshold < 10 and keeps the BFS elsewhere; at 12 the port's
elas_match still equals the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import pipeline as ep
from jackal_tpu_torch.matching.elas.native_prior import (
    remove_small_segments_native)
from jackal_tpu_torch.matching.elas.post import (
    remove_small_segments_batch_plain)

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


def _field():
    """30 maps of 20 x 30 integer disparities 0-40, 30 % of them -10, as
    the L/R check leaves invalid pixels."""
    rng = np.random.default_rng(1)
    D = rng.integers(0, 41, (30, 20, 30)).astype(np.float32)
    D[rng.random(D.shape) < 0.3] = -10.0
    return D


@pytest.mark.parametrize("t,differ", [(1.0, False), (9.0, False),
                                      (10.0, True), (12.0, True)])
def test_bfs_and_device_function_split_at_threshold_10(t, differ):
    D = _field()
    p = dataclasses.replace(ElasParams(), speckle_sim_threshold=t,
                            speckle_size=2)
    dev = remove_small_segments_batch_plain(torch.from_numpy(D), p).numpy()
    bfs = np.stack([remove_small_segments_native(d, p) for d in D])
    assert (dev != bfs).any() == differ
    assert (dev != D).any()          # the filter removed something
    assert ep._speckle_on_card(torch.device("cuda"), p) == (not differ)
    assert not ep._speckle_on_card(torch.device("cpu"), p)


def test_elas_match_at_threshold_12_equals_jax():
    """At speckle_sim_threshold 12 the port's per-frame elas_match (BFS
    route) equals the reference's, whose per-frame path runs the BFS."""
    from jackal_tpu.config import ElasParams as JaxElasParams
    from jackal_tpu.matching.elas.pipeline import elas_match as jax_elas

    g = np.load(f"{FIX}/elas_golden_s320_boxes.npz")
    jp = dataclasses.replace(JaxElasParams(), speckle_sim_threshold=12.0)
    tp = dataclasses.replace(ElasParams(), speckle_sim_threshold=12.0)
    W1, W2 = jax_elas(g["left"], g["right"], jp)
    n0 = dict(ep.speckle_routes)
    D1, D2 = ep.elas_match(g["left"], g["right"], tp, device="cpu")
    assert ep.speckle_routes == {"elas_speckle": n0["elas_speckle"],
                                 "bfs": n0["bfs"] + 1}
    np.testing.assert_array_equal(D1.numpy(), np.asarray(W1))
    np.testing.assert_array_equal(D2.numpy(), np.asarray(W2))
    assert (np.asarray(W1) >= 0).mean() > 0.3
