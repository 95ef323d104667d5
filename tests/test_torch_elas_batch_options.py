"""The batched ELAS entries with use_native=False (the numpy host prior
and triangle wire on the pool's workers) against jackal_tpu's on two
frames, bit for bit. Apart from the other option tests: the JAX package's
batched path compiles for most of this file's ~30 s."""
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import pipeline as pl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stages():
    return dict(np.load("tests/fixtures/elas_stages_st160.npz"))


def test_batched_use_native_false_equals_jax(stages):
    """The batched entries with use_native=False on two frames (the
    fixture pair and its 8-pixel shift) == the JAX batched entry's; the
    stream, the replicas (two CPU devices) and the native route give the
    same maps."""
    left, right = stages["left"], stages["right"]
    lb = np.stack([left, np.roll(left, 8, 1)])
    rb = np.stack([right, np.roll(right, 8, 1)])
    W1, W2 = jpl.elas_match_batch(lb, rb, JaxElasParams(), use_native=False,
                                  chunk=1)
    D1, D2 = pl.elas_match_batch(lb, rb, ElasParams(), use_native=False,
                                 chunk=1, device="cpu")
    np.testing.assert_array_equal(D1, np.asarray(W1))
    np.testing.assert_array_equal(D2, np.asarray(W2))
    S1, S2 = next(pl.elas_match_stream(iter([(lb, rb)]), ElasParams(),
                                       use_native=False, chunk=2,
                                       device="cpu"))
    np.testing.assert_array_equal(S1.numpy(), D1)
    np.testing.assert_array_equal(S2.numpy(), D2)
    N1, _ = pl.elas_match_batch_device(lb, rb, ElasParams(), chunk=2,
                                       device="cpu")
    np.testing.assert_array_equal(N1.numpy(), D1)
    M1, M2 = pl.elas_match_batch_multichip(lb, rb, ElasParams(),
                                           use_native=False,
                                           devices=["cpu", "cpu"])
    np.testing.assert_array_equal(M1, D1)
    np.testing.assert_array_equal(M2, D2)
