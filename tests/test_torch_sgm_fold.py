"""F with O2 folded in (ops/sgm_kernel.sgm_wta_epilogue) on the CPU ==
jackal_tpu's SGM, bit for bit.

On the card the SGM engine's tail is one launch of kernel F with O2's
epilogue in it (csrc/sgm_wta_kernel.cu), or F then O2 where
sgm_tail_route says so; the card holds both to the plain twin,
sgm_wta_epilogue_plain (sgm_epilogue_plain of sgm_wta_maps_plain). Here
that twin, on the volume the port's plain census, cost and aggregation make
of seeded frames (chip_smoke.FOLD_CASES), is held against the JAX package's
sgm_match (dL, dR) and the reference node's u8 conversion
(jackal_tpu/pipeline/frame_pipeline.py:170), true_right too; on a seeded
volume of ties against the reference's _finalize; the epilogue alone, on
maps with half-way sub-pixel offsets, against _wta_from_maps and _lr_tail.
The route is a function of the volume's shape and true_right, checked at
every FOLD_CASES shape and at D = 65, 200, 256 and 320.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FOLD_CASES, fold_inputs, fold_volume, tail_maps
from jackal_tpu.config import SGMParams as JaxSGMParams
from jackal_tpu.matching import sgm as jsgm
from jackal_tpu_torch.config import SGMParams
from jackal_tpu_torch.ops import sgm_kernel as sk

# the cases the CPU computes: the shapes past D = 128 take long on the
# plain path and differ from these only on the card (the route)
CPU_CASES = [n for n, c in FOLD_CASES.items() if c[4] <= 64]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(d):
    """The reference node's u8 conversion (frame_pipeline._match_fused)."""
    return np.asarray(jnp.clip(jnp.round(d), 0, 255).astype(jnp.uint8))


def _held(got, want_l, want_r):
    dl, dr, u8 = got
    np.testing.assert_array_equal(dl.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(u8.numpy(), _u8(want_l))


@pytest.mark.parametrize("name", CPU_CASES)
def test_fold_twin_equals_the_reference(name):
    kind, a, b, D = fold_inputs(name)
    p = SGMParams(disp_num=D)
    jp = JaxSGMParams(disp_num=D)
    if kind == "volume":
        S = torch.from_numpy(a)
        want = jax.vmap(lambda v: jsgm._finalize(v, jp))(
            jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3))))
    else:
        S = fold_volume(torch.from_numpy(a), torch.from_numpy(b), p)
        want = jsgm.sgm_match_batch(jnp.asarray(a), jnp.asarray(b), jp)
    got = sk.sgm_wta_epilogue_plain(S, p, u8=True)
    _held(got, *want)
    assert bool((got[0] >= 0).any())
    if kind == "volume":
        assert bool((got[0] % 1 == 0.5).any())
    # the wrapper on a CPU tensor is the twin, and launches nothing
    n0 = dict(sk.launches)
    for g, w in zip(sk.sgm_wta_epilogue(S, p, True), got):
        assert torch.equal(g, w)
    assert sk.launches == n0


def test_fold_twin_true_right_equals_the_reference():
    """With true_right the right view's maps come from its own volume (on
    the card a second F, then O2)."""
    _, a, b, _ = fold_inputs("W = 300, D = 64: lookups across the tiles' "
                             "edges")
    D = 24
    p = dataclasses.replace(SGMParams(disp_num=D), true_right=True)
    S, S_right = fold_volume(torch.from_numpy(a), torch.from_numpy(b), p,
                             true_right=True)
    want = jsgm.sgm_match_batch(jnp.asarray(a), jnp.asarray(b),
                                JaxSGMParams(disp_num=D, true_right=True))
    _held(sk.sgm_wta_epilogue_plain(S, p, True, S_right), *want)


def test_epilogue_alone_at_half_way_offsets():
    """O2's plain version on seeded maps, half their pixels with cp == best
    (an offset of exactly 0.5, rounded half to even in the u8 map), against
    the reference's _wta_from_maps on both views and _lr_tail."""
    D = 64
    m = tail_maps(np.random.default_rng(27), 2, 7, 96, D, 20, halves=0.5)
    p = SGMParams(disp_num=D, lr_threshold=1000)
    jp = JaxSGMParams(disp_num=D, lr_threshold=1000)
    mi = jnp.asarray(m.astype(np.int32))
    dL = jsgm._wta_from_maps(*(mi[:, :, k] for k in range(5)), D, jp)
    dR = jsgm._wta_from_maps(*(mi[:, :, k] for k in range(5, 10)), D, jp)
    want = jax.vmap(lambda x, y: jsgm._lr_tail(x, y, D, jp))(dL, dR)
    got = sk.sgm_epilogue_plain(torch.from_numpy(m), None, D, p, u8=True)
    _held(got, *want)
    assert bool((got[0] % 1 == 0.5).any())


# (shape [B, H, D, W], true_right, the route) beside every FOLD_CASES
# shape: the fold up to FOLD_MAX_D (D = 64, measured faster than F then
# O2; slower from D = 72), F then O2 for true_right and past it
ROUTES = [((1, 480, 64, 640), False, "fold"),
          ((4, 960, 64, 1280), False, "fold"),
          ((1, 480, 64, 640), True, "F then O2"),
          ((1, 4, 65, 300), False, "F then O2"),
          ((1, 4, 200, 300), False, "F then O2"),
          ((1, 4, 256, 300), False, "F then O2"),
          ((1, 3, 320, 300), False, "F then O2")] + [
    ((c[1], c[2], c[4], c[3]), False,
     "F then O2" if "(F then O2" in n else "fold")
    for n, c in FOLD_CASES.items()]


@pytest.mark.parametrize("shape,true_right,route", ROUTES)
def test_tail_route(shape, true_right, route):
    assert sk.sgm_tail_route(shape, true_right) == route
