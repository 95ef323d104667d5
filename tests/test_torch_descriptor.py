"""Port descriptor == JAX create_descriptor == libelas stage fixture."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from jackal_tpu_torch.ops.descriptor import create_descriptor

FIX = "tests/fixtures"


@pytest.mark.parametrize("img,ref", [("left", "desc1"), ("right", "desc2")])
def test_descriptor_matches_stage_fixture(img, ref):
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    got = create_descriptor(torch.from_numpy(z[img])).numpy()
    np.testing.assert_array_equal(got, z[ref])


@pytest.mark.parametrize("shape", [(37, 61), (60, 160), (8, 9)])
def test_descriptor_matches_jax(shape):
    """Saturating gradients included: full-range noise drives the bias-128
    encoding into both u8 limits."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jax_descriptor(jnp.asarray(img)))
    got = create_descriptor(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    # the batch dimension is written out, not vmapped
    both = create_descriptor(torch.from_numpy(np.stack([img, img[::-1]])))
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(), np.asarray(jax_descriptor(jnp.asarray(img[::-1]))))
