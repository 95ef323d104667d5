"""Kernel G with kernel S's texture gate and u8 map folded in
(ops/bm_kernel.bm_match_gated): its plain twin on the CPU == the JAX
package's bm_match and the node's u8 map, bit for bit.

The card runs G's strip with the texture summed beside the costs and the
u8 map written by its L/R check (or, past the strip, G then S), and holds
it to bm_match_gated_plain (tests/test_torch_cuda.py, chip_smoke.py phase
17). Here the twin is held to jackal_tpu.matching.bm.bm_match, followed by
jnp.clip(jnp.round(dL), 0, 255).astype(jnp.uint8) (the reference node's
u8 map, jackal_tpu/pipeline/frame_pipeline.py:170), on
chip_smoke.GATE_FOLD_CASES: windows 1, 3, 9, 15, 225 and 227; D = 16, 64,
256 and 257; W not a multiple of 32 (65, 97, 100, 150, 260, 300); frames
whose texture equals the threshold at some pixels (a ramp, flat areas, a
constant frame at threshold 0).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GATE_FOLD_CASES, gate_fold_case
from jackal_tpu.config import BMParams as JaxBMParams
from jackal_tpu.matching import bm as jbm
from jackal_tpu_torch.config import BMParams, PipelineParams
from jackal_tpu_torch.matching import bm
from jackal_tpu_torch.ops import bm_kernel as bk
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_bm_u8(left, right, params):
    """The reference's BM on a batch (bm_match_batch: the texture gate,
    then the L/R check) and the node's u8 map of its left view."""
    dL, dR = jbm.bm_match_batch(left, right, params)
    return dL, dR, jnp.clip(jnp.round(dL), 0, 255).astype(jnp.uint8)


def _texture(left, window):
    """The texture of each pixel as the reference defines it: the box sum,
    zero outside the frame, of |L(x+1) - L(x-1)| on the edge-replicated
    frame (numpy, int64)."""
    r = window // 2
    L = left.astype(np.int64)
    Lp = np.concatenate([L[..., :1], L, L[..., -1:]], -1)
    g = np.abs(Lp[..., 2:] - Lp[..., :-2])
    gp = np.pad(g, [(0, 0), (r + 1, r), (r + 1, r)])
    c = gp.cumsum(-1).cumsum(-2)
    k = 2 * r + 1
    return c[..., k:, k:] - c[..., :-k, k:] - c[..., k:, :-k] \
        + c[..., :-k, :-k]


@pytest.mark.parametrize("name", GATE_FOLD_CASES)
def test_gated_twin_equals_jax_bm_and_u8(name):
    left, right, kw = gate_fold_case(name)
    p, jp = BMParams(**kw), JaxBMParams(**kw)
    wl, wr, wu = (np.asarray(x) for x in _jax_bm_u8(
        jnp.asarray(left), jnp.asarray(right), jp))
    dl, dr, u8 = bk.bm_match_gated_plain(torch.from_numpy(left),
                                         torch.from_numpy(right), p)
    assert dl.dtype == dr.dtype == torch.float32 and u8.dtype == torch.uint8
    np.testing.assert_array_equal(dl.numpy().view(np.int32),
                                  wl.view(np.int32))
    np.testing.assert_array_equal(dr.numpy().view(np.int32),
                                  wr.view(np.int32))
    np.testing.assert_array_equal(u8.numpy(), wu)
    # the gate decides: some matched pixels dropped for their texture
    tex = _texture(left, p.window)
    thr = p.texture_threshold * p.window
    ungated = bk.bm_match_fused_plain(torch.from_numpy(left),
                                      torch.from_numpy(right), p)[0].numpy()
    dropped = (ungated >= 0) & (tex < thr)
    assert (dl.numpy()[dropped] == -1).all()
    np.testing.assert_array_equal(dl.numpy()[~dropped], ungated[~dropped])
    if "ramp" in name or "constant" in name:
        # pixels at exactly the threshold keep their disparity
        at = (tex == thr) & (ungated >= 0)
        assert at.any()
        np.testing.assert_array_equal(dl.numpy()[at], ungated[at])
    if "constant" in name:
        # texture 0 at threshold 0 everywhere: the gate drops nothing
        assert (tex == 0).all() and not dropped.any()
    else:
        assert dropped.any() and (u8.numpy() > 0).any()


def test_gated_twin_is_the_gate_of_g():
    """bm_match_gated_plain's u8 map is bm_gate_u8_plain of G's plain twin,
    and its float map bm_texture_gate_plain of it, frame by frame."""
    left, right, kw = gate_fold_case(GATE_FOLD_CASES[3])
    p = BMParams(**kw)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    dL = bk.bm_match_fused_plain(tl, tr, p)[0]
    dl, dr, u8 = bk.bm_match_gated_plain(tl, tr, p)
    assert torch.equal(u8, bm.bm_gate_u8_plain(tl, dL, p))
    assert torch.equal(dl, bm.bm_texture_gate_plain(tl, dL, p))
    for b in range(left.shape[0]):
        one = bk.bm_match_gated_plain(tl[b:b + 1], tr[b:b + 1], p)
        assert all(torch.equal(x, y[b:b + 1]) for x, y in zip(one,
                                                              (dl, dr, u8)))


def test_gated_wrapper_on_cpu_tensors_runs_the_plain_twin():
    n0, g0 = dict(bk.launches), dict(bm.launches)
    for name in (GATE_FOLD_CASES[0], GATE_FOLD_CASES[6]):
        left, right, kw = gate_fold_case(name)
        tl, tr, p = torch.from_numpy(left), torch.from_numpy(right), \
            BMParams(**kw)
        assert all(torch.equal(a, b) for a, b in zip(
            bk.bm_match_gated(tl, tr, p), bk.bm_match_gated_plain(tl, tr, p)))
    assert bk.launches == n0 and bm.launches == g0


def test_bm_node_step_is_the_gated_twin():
    """The BM node's batched step on the CPU publishes the gated twin's u8
    map of its rectified frames."""
    size = dict(crop_offset_y=80, crop_im_height=20)
    pipe = make_pipeline(engine="bm", bm_params=BMParams(disp_num=16),
                         params=PipelineParams(**size), device="cpu")
    pairs = [synthetic_raw_pair(pipe, s, 9.0 + 4 * s, 0.05 * s)
             for s in range(2)]
    lb = np.stack([x[0] for x in pairs])
    rb = np.stack([x[1] for x in pairs])
    maps, _ = pipe.process_batch_fused(lb, rb)
    L, R = pipe._rectify_crop(torch.from_numpy(lb), torch.from_numpy(rb))
    want = bk.bm_match_gated_plain(L, R, pipe.bm_params)[2]
    assert torch.equal(maps, want) and bool((want > 0).any())
