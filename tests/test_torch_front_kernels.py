"""The ELAS front on the CPU: the descriptor (kernel R's plain version) and
the support search with its epilogue (kernels A and Q's plain route)
against the JAX package, bit for bit; and the grid rows that kernel A
reads from the descriptors against the blocks its plain twin builds. The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas.support import support_candidates as jax_support
from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from chip_smoke import FRONT_EDGE_CASES, front_edge_images
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import support as sm
from jackal_tpu_torch.ops import descriptor as dm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = FRONT_EDGE_CASES


def _images(name):
    return front_edge_images(name)[:2]


def _params(name):
    return front_edge_images(name)[2]


@pytest.mark.parametrize("name", list(CASES))
def test_descriptor_plain_equals_jax(name):
    left, right = _images(name)
    half = _params(name).get("subsampling", False)
    for img in (left, right):
        want = np.asarray(jax.vmap(lambda x: jax_descriptor(x, half))(
            jnp.asarray(img)))
        got = dm.create_descriptor_plain(torch.from_numpy(img), half)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_support_candidates_plain_route_equals_jax(name):
    left, right = _images(name)
    kw = _params(name)
    half = kw.get("subsampling", False)
    d1 = jax.vmap(lambda x: jax_descriptor(x, half))(jnp.asarray(left))
    d2 = jax.vmap(lambda x: jax_descriptor(x, half))(jnp.asarray(right))
    want = np.asarray(jax.vmap(
        lambda a, b: jax_support(a, b, JaxElasParams(**kw)))(d1, d2))
    a0, q0 = sm.launches, sm.epilogue_launches
    got = sm.support_candidates(
        dm.create_descriptor(torch.from_numpy(left), half),
        dm.create_descriptor(torch.from_numpy(right), half),
        ElasParams(**kw))
    assert (sm.launches, sm.epilogue_launches) == (a0, q0)   # plain route
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "constant images":      # no texture: every point rejected
        assert (want[:, 1:, 1:] == -1).all()
    else:
        assert (want > 0).sum() > 0


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("shape", [(2, 37, 61), (1, 8, 9), (1, 6, 40),
                                   (1, 17, 70)])
def test_descriptor_plain_equals_jax_at_tile_edges(shape, half):
    """The shapes kernel R's card test takes at its tile edges: frames too
    small for a valid pixel (H < 7) and sizes that cut its 8 x 32 tiles."""
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)
    want = np.asarray(jax.vmap(lambda x: jax_descriptor(x, half))(
        jnp.asarray(img)))
    got = dm.create_descriptor_plain(torch.from_numpy(img), half)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- kernel A's rows ------------------------------------------------------

@pytest.mark.parametrize("step", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("H", [11, 12, 30])
def test_rows_read_from_the_descriptors_equal_the_blocks(step, H):
    """Kernel A reads grid row k's halves from image
    rows (k + 1) * step -+ 2, the bias value 128 outside the image
    (support_kernel.cu grid_half): the blocks grid_row_blocks builds."""
    B, W = 2, 9
    rng = np.random.default_rng(H * 10 + step)
    desc = rng.integers(0, 256, (B, H, W, 16)).astype(np.uint8)
    ncv = -(-H // step)
    want = sm.grid_row_blocks(torch.from_numpy(desc), step, ncv).numpy()
    got = np.full((B, ncv - 1, W, 32), 128, np.uint8)
    for k in range(ncv - 1):
        vs = (k + 1) * step
        for half, y in ((0, vs - 2), (1, vs + 2)):
            if 0 <= y < H:
                got[:, k, :, 16 * half:16 * half + 16] = desc[:, y]
    np.testing.assert_array_equal(got, want)


def test_epilogue_without_grid_rows():
    """H <= step: one grid row, the border; no key row (nv = 0)."""
    p = ElasParams()
    d = torch.full((2, 5, 40, 16), 128, dtype=torch.uint8)
    keys = sm.grid_row_keys(d, d, 5, 0, 256)
    assert keys.shape == (4, 2, 0, 40)
    got = sm.support_epilogue(keys, d, d, p)
    assert got.shape == (2, 1, 8) and not got.any()
    assert torch.equal(sm.support_candidates(d, d, p), got)


def test_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing."""
    left, right = _images("odd W")
    p = ElasParams(**_params("odd W"))
    img = torch.from_numpy(left)
    r0, a0, q0 = dm.launches, sm.launches, sm.epilogue_launches
    assert torch.equal(dm.create_descriptor(img),
                       dm.create_descriptor_plain(img))
    d1 = dm.create_descriptor(img)
    d2 = dm.create_descriptor(torch.from_numpy(right))
    keys = sm.grid_row_keys(d1, d2, 5, 0, 31)
    assert torch.equal(sm.support_epilogue(keys, d1, d2, p),
                       sm.support_epilogue_plain(keys, d1, d2, p))
    assert (dm.launches, sm.launches, sm.epilogue_launches) == (r0, a0, q0)

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel's launch")

    monkeypatch.setattr(dm, "_descriptor_cuda", refuse)
    monkeypatch.setattr(sm, "_keys_cuda", refuse)
    monkeypatch.setattr(sm, "_epilogue_cuda", refuse)
    sm.support_candidates(dm.create_descriptor(img),
                          dm.create_descriptor(img), p)


def test_grid_row_blocks_at_step_1_equals_jax_blocks():
    """The repaired plain twin: at step 1 row vs - 2 = -1 reads 128, as
    the reference's 128-padded blocks do; before, the slice desc[:, -1::1]
    took the last row and the grid failed to build."""
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 256, (1, 9, 7, 16)).astype(np.uint8)
    got = sm.grid_row_blocks(torch.from_numpy(desc), 1, 9).numpy()
    assert got.shape == (1, 8, 7, 32)
    assert (got[0, 0, :, :16] == 128).all()
    np.testing.assert_array_equal(got[0, 1, :, :16], desc[0, 0])
    np.testing.assert_array_equal(got[0, 0, :, 16:], desc[0, 3])
    assert (got[0, 7, :, 16:] == 128).all()      # row 10 is past the image
