"""The ELAS front as the nodes run it on the card, on the CPU: kernel R's
pair entry (both views, one launch) and support_candidates (kernel A with
Q's tests as its epilogue) through their plain routes against the JAX
package, bit for bit, at the shapes where R's warp strips and row bands
and the grid's first and last key rows end mid-way; and the
forward-backward check where u - dL is clamped at column 0. The kernels
themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, phase 15 of chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas.support import support_candidates as jax_support
from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from chip_smoke import (DESCRIPTOR_EDGE_SHAPES, FRONT_EDGE_CASES,
                        front_edge_images)
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


def _jax_desc(img, half):
    return np.asarray(jax.vmap(lambda x: jax_descriptor(x, half))(
        jnp.asarray(img)))


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


# ---- kernel R -------------------------------------------------------------

@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("shape", DESCRIPTOR_EDGE_SHAPES)
def test_descriptor_pair_plain_route_equals_jax(shape, half):
    """W < 16, W % 16 of 1, 3, 15, H under a band, frames too small for a
    valid pixel: the pair entry's CPU route is each view's JAX
    descriptor."""
    left = _noise(shape, sum(shape))
    right = _noise(shape, sum(shape) + 1)
    r0 = dm.launches
    got = dm.create_descriptor_pair(torch.from_numpy(left),
                                    torch.from_numpy(right), half)
    assert dm.launches == r0                       # plain route
    assert got.shape == (2,) + shape + (16,) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy(), _jax_desc(left, half))
    np.testing.assert_array_equal(got[1].numpy(), _jax_desc(right, half))


# ---- kernel A with Q's tests as its epilogue ------------------------------

# the grid's first and last key rows at step 1 and 2, and R's band edges
# with half resolution (FRONT_EDGE_CASES; tests/test_torch_front_kernels.py
# takes every case through create_descriptor)
PAIR_CASES = ("step 2, the last grid row past the image",
              "step 1, B = 3 frames off 16-byte rows",
              "step 2, half resolution", "H ends mid-band, half resolution")


@pytest.mark.parametrize("name", PAIR_CASES)
def test_front_as_the_nodes_run_it_equals_jax(name):
    """create_descriptor_pair then support_candidates, as the nodes call
    them (the card: one launch of R, one call of A whose last launch
    writes the grid), through their CPU routes against the JAX package's
    descriptors and support_candidates."""
    left, right, kw = front_edge_images(name)
    half = kw.get("subsampling", False)
    want = np.asarray(jax.vmap(
        lambda a, b: jax_support(a, b, JaxElasParams(**kw)))(
            jnp.asarray(_jax_desc(left, half)),
            jnp.asarray(_jax_desc(right, half))))
    desc = dm.create_descriptor_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), half)
    counts = (dm.launches, sm.launches, sm.fused_launches,
              sm.epilogue_launches)
    got = sm.support_candidates(desc[0], desc[1], ElasParams(**kw))
    assert (dm.launches, sm.launches, sm.fused_launches,
            sm.epilogue_launches) == counts               # plain routes
    np.testing.assert_array_equal(got.numpy(), want)
    step = sm.effective_stepsize(ElasParams(**kw))
    H = left.shape[1]
    assert (want.shape[1] - 1) * step + 2 >= H        # the last key row's
    assert (want[:, 0] == 0).all() and (want > 0).sum() > 0   # vs+2 pads


def _tail_reference(keys, desc1, desc2, p):
    """The JAX package's support_candidates after its cost scan
    (jackal_tpu/matching/elas/support.py:139-173), in numpy, from key maps
    instead of its cost scan: min1 = k1 >> 9, d1 = k1 & 511, min2 = k2 >>
    9, and the count >= 2 of live d (dmax - disp_min + 1), then the
    forward-backward check with np.clip, as jnp.clip clamps."""
    B, H, W, _ = desc1.shape
    step = sm.effective_stepsize(p)
    ncu, ncv = -(-W // step), -(-H // step)
    us, vs = np.arange(1, ncu) * step, np.arange(1, ncv) * step
    u_all = np.arange(W)
    in_v = (vs >= 5) & (vs <= H - 6)

    def acc(k1, k2, desc, dmax):
        tex = np.abs(desc[:, vs].astype(np.int64) - 128).sum(-1)
        ok_col = (u_all >= 5) & (u_all <= W - 6) & (dmax - p.disp_min >= 10)
        a = (ok_col & in_v[:, None] & (tex >= p.support_texture)
             & (np.maximum(dmax - p.disp_min + 1, 0) >= 2) & (k1 < (1 << 24))
             & ((k1 >> 9).astype(np.float32)
                < np.float32(p.support_threshold)
                * (k2 >> 9).astype(np.float32)))
        return np.where(a, k1 & 511, -1)

    dL = acc(keys[0], keys[1], desc1, np.minimum(p.disp_max, u_all - 5))
    dR = acc(keys[2], keys[3], desc2, np.minimum(p.disp_max, W - u_all - 5))
    dg = dL[:, :, us]
    back = np.clip(us - dg, 0, W - 1)
    d2 = np.take_along_axis(dR, back, axis=2)
    ok = (dg >= 0) & (d2 >= 0) & (np.abs(dg - d2) <= p.lr_threshold)
    out = np.zeros((B, ncv, ncu), np.int16)
    out[:, 1:, 1:] = np.where(ok, dg, -1)
    return out, back, dg


def test_back_column_clamped_at_zero():
    """Keys whose accepted left disparity dL exceeds u (no cost scan makes
    them: a live left key has d <= u - 5) send the check to u - dL < 0,
    clamped to column 0, where the right view never accepts: the plain
    epilogue (the kernels' twin) gives -1 there, as the reference's tail
    does; and every other grid point as that tail."""
    rng = np.random.default_rng(11)
    B, H, W = 1, 31, 90
    p = ElasParams(disp_max=60, lr_threshold=2)
    nv = -(-H // 5) - 1
    cost = rng.integers(100, 400, (4, B, nv, W))
    d = rng.integers(0, 61, (4, B, nv, W))
    keys = cost * 512 + d
    keys[1] = (cost[0] * 2 + 50) * 512 + (d[0] + 1) % 61     # ratio passes
    keys[3] = (cost[2] * 2 + 50) * 512 + (d[2] + 1) % 61
    for u in range(5, W, 5):       # the right view agrees at u - dL
        back = u - d[0, :, :, u]
        ok = back >= 0
        rows = np.nonzero(ok[0])[0]
        keys[2, 0, rows, back[0, rows]] = (cost[2, 0, rows, back[0, rows]]
                                           * 512 + d[0, 0, rows, u])
    keys[0, :, :, 15:50:5] = cost[0, :, :, 15:50:5] * 512 + 55  # dL > u
    desc = rng.integers(0, 256, (2, B, H, W, 16)).astype(np.uint8)
    want, back, dg = _tail_reference(keys, desc[0], desc[1], p)
    clamped = (dg > np.arange(1, -(-W // 5)) * 5) & (dg >= 0)
    assert clamped.sum() >= 10 and (back[clamped] == 0).all()
    got = sm.support_epilogue_plain(
        torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(desc[0]),
        torch.from_numpy(desc[1]), p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1:, 1:][clamped] == -1).all()
    assert (got > 0).sum() > 10


@pytest.mark.parametrize("name", ["step 1, B = 3 frames off 16-byte rows",
                                  "W % 16 = 15, frames off 16-byte rows"])
def test_scanned_keys_never_reach_the_clamp(name):
    """From a cost scan every accepted left disparity is at most u - 5, so
    on every path the check reads a column >= 5 and the clamp at column 0
    acts only on constructed keys (test_back_column_clamped_at_zero)."""
    left, right, kw = front_edge_images(name)
    p = ElasParams(**kw)
    desc = dm.create_descriptor_pair(torch.from_numpy(left),
                                     torch.from_numpy(right))
    step = sm.effective_stepsize(p)
    keys = sm.grid_row_keys(desc[0], desc[1], step, p.disp_min,
                            p.disp_max + 1).numpy()
    _, back, dg = _tail_reference(keys, desc[0].numpy(), desc[1].numpy(), p)
    assert (dg >= 0).sum() > 0 and (back[dg >= 0] >= 5).all()


def test_front_edge_cases_cover_the_new_shapes():
    """The card tests and phase 15 take these from FRONT_EDGE_CASES and
    DESCRIPTOR_EDGE_SHAPES: R's strip and band edges, W < 16, and the
    grid's first and last key rows at step 1 and 2."""
    widths = {W % 16 for _, _, W, _ in FRONT_EDGE_CASES.values()}
    assert {1, 3, 15} <= widths
    assert any(W < 16 for _, _, W in DESCRIPTOR_EDGE_SHAPES)
    assert any(H < 8 for _, H, _ in DESCRIPTOR_EDGE_SHAPES)
    assert any(H % 8 for _, H, _, _ in FRONT_EDGE_CASES.values())
    steps = {kw.get("candidate_stepsize", 5)
             for *_, kw in FRONT_EDGE_CASES.values()}
    assert {1, 2} <= steps
    for name in PAIR_CASES:
        assert name in FRONT_EDGE_CASES
