"""The port's ELAS replicas (elas_match_batch_multichip) on the CPU ==
the port's single-device batched path and == jackal_tpu's replicas, bit
for bit, with distinct frames on every replica; and their ValueErrors.

The port's replicas run on ["cpu"] * n; the JAX side on the virtual CPU
devices of tests/conftest.py, as tests/test_parallel.py runs it. A file of
its own beside tests/test_torch_parallel.py, so that the two run on two
test workers.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas.pipeline import (
    elas_match_batch_multichip as jax_elas_multichip)
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas.pipeline import (
    elas_match_batch, elas_match_batch_multichip)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(n):
    return ["cpu"] * n


JAX_CASE = (2, 2)


@pytest.fixture(scope="module")
def frames():
    """8 distinct 96x160 pairs (crops of one golden pair, rolled, and every
    third mirrored, so support counts and the content order differ by
    shard) and the port's single-device elas_match_batch of them at
    chunk 1. A case of B frames takes the first B."""
    g = np.load("tests/fixtures/elas_golden_s320_flat.npz")
    l0, r0 = g["left"][:96, :160], g["right"][:96, :160]
    lb = np.stack([np.roll(l0, 7 * b, axis=0) if b % 3 else l0[:, ::-1]
                   for b in range(8)])
    rb = np.stack([np.roll(r0, 7 * b, axis=0) if b % 3 else r0[:, ::-1]
                   for b in range(8)])
    return lb, rb, elas_match_batch(lb, rb, chunk=1, device="cpu")


@pytest.mark.parametrize("n,chunk", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_elas_replicas_equal_single_device_and_jax(frames, n, chunk):
    """n replicas, chunk frames of each shard, distinct frames on every
    replica: the port's replicas == its single-device elas_match_batch at
    chunk 1; at JAX_CASE also == JAX's replicas (one configuration, as the
    reference's compile takes most of this file's time)."""
    B = n * chunk
    lb, rb, (S1, S2) = frames[0][:B], frames[1][:B], frames[2]
    D1, D2 = elas_match_batch_multichip(lb, rb, ElasParams(), chunk=chunk,
                                        devices=_cpus(n))
    assert D1.shape == D2.shape == (B, 96, 160) and D1.dtype == np.float32
    np.testing.assert_array_equal(D1, S1[:B])
    np.testing.assert_array_equal(D2, S2[:B])
    if (n, chunk) == JAX_CASE:
        if len(jax.devices()) < n:
            pytest.skip("needs the virtual devices of tests/conftest.py")
        W1, W2 = jax_elas_multichip(lb, rb, chunk=chunk,
                                    devices=jax.devices()[:n])
        np.testing.assert_array_equal(D1, W1)
        np.testing.assert_array_equal(D2, W2)
    assert (D1 >= 0).mean() > 0.3


def test_elas_value_errors_as_the_reference():
    """Subsampling, a batch the devices do not divide and a chunk that
    does not divide the shard raise the reference's ValueErrors."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    l3, l4, l6 = (np.zeros((b, 40, 64), np.uint8) for b in (3, 4, 6))
    jdevs = jax.devices()[:2]
    sub = dataclasses.replace(ElasParams(), subsampling=True)
    jsub = dataclasses.replace(JaxElasParams(), subsampling=True)
    for port_call, jax_call, msg in (
            (lambda: elas_match_batch_multichip(l4, l4, sub,
                                                devices=_cpus(2)),
             lambda: jax_elas_multichip(l4, l4, jsub, devices=jdevs),
             "subsampling"),
            (lambda: elas_match_batch_multichip(l3, l3, devices=_cpus(2)),
             lambda: jax_elas_multichip(l3, l3, devices=jdevs),
             "batch 3 not divisible by 2 devices"),
            (lambda: elas_match_batch_multichip(l6, l6, chunk=2,
                                                devices=_cpus(2)),
             lambda: jax_elas_multichip(l6, l6, chunk=2, devices=jdevs),
             "chunk 2 must divide shard 3")):
        with pytest.raises(ValueError, match=msg):
            jax_call()
        with pytest.raises(ValueError, match=msg):
            port_call()
