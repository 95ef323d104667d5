"""The SGM and BM tails on the CPU == jackal_tpu's, bit for bit.

Kernels O1 (the SGM cost volume), O2 (the SGM epilogue and u8 map) and S
(the BM texture gate and u8 map) run on the card only; here their plain
versions, which the card holds the kernels to, are held against the JAX
package's functions on chip_smoke.TAIL_EDGE_CASES: O1 against the vmapped
census_cost_volume_hdw and right_view_volume as sgm_match_pallas builds
them, O2 against _wta_from_maps on both views, _lr_tail and the node's u8
conversion (frame_pipeline._match_fused), S against bm_texture_gate and the
u8 conversion, each jitted as the reference runs it. Then the slice: small
SGM and BM nodes' process_batch_fused against the JAX node's _match_fused,
and the wrappers on CPU tensors, which run the plain versions and count no
launch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TAIL_EDGE_CASES, tail_edge_case
from jackal_tpu.config import BMParams as JaxBMParams
from jackal_tpu.config import PipelineParams as JaxPipelineParams
from jackal_tpu.config import SGMParams as JaxSGMParams
from jackal_tpu.matching import bm as jbm
from jackal_tpu.matching import sgm as jsgm
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu_torch.config import BMParams, PipelineParams, SGMParams
from jackal_tpu_torch.matching import bm
from jackal_tpu_torch.ops import sgm_kernel as sk
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

COST_CASES = [n for n in TAIL_EDGE_CASES if n.startswith("cost")]
EPILOGUE_CASES = [n for n in TAIL_EDGE_CASES if n.startswith("epilogue")]
GATE_CASES = [n for n in TAIL_EDGE_CASES if n.startswith("gate")]


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
    return jnp.clip(jnp.round(d), 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_cost(cl, cr, D):
    """The left and right cost volumes as sgm_match_pallas builds them
    (jackal_tpu/matching/sgm.py l.292, l.301-302)."""
    cost = jax.vmap(lambda a, b: jsgm.census_cost_volume_hdw(a, b, D))(cl,
                                                                       cr)
    right = jnp.moveaxis(jax.vmap(jsgm.right_view_volume)(
        jnp.moveaxis(cost, 2, 1)), 1, 2)
    return cost, right


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_epilogue(m, mr, D, params):
    """sgm_match_pallas's epilogue (l.295-310) and the node's u8 map
    (frame_pipeline.py l.170) on kernel F's maps; mr: the right view's five
    rows."""
    m, mr = m.astype(jnp.int32), mr.astype(jnp.int32)
    dL = jsgm._wta_from_maps(*(m[:, :, i] for i in range(5)), D, params)
    dR = jsgm._wta_from_maps(*(mr[:, :, i] for i in range(5)), D, params)
    dLc, dR = jax.vmap(lambda a, b: jsgm._lr_tail(a, b, D, params))(dL, dR)
    return dLc, dR, _u8(dLc)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_gate(left, dL, params):
    g = jbm.bm_texture_gate(left, dL, params)
    return g, _u8(g)


@pytest.mark.parametrize("name", COST_CASES)
def test_cost_volume_plain_equals_jax(name):
    _, cl, cr, D = tail_edge_case(name)
    want, want_r = _jax_cost(jnp.asarray(cl), jnp.asarray(cr), D)
    got = sk.sgm_cost_volume_plain(torch.from_numpy(cl),
                                   torch.from_numpy(cr), D)
    got2, got_r = sk.sgm_cost_volume_plain(torch.from_numpy(cl),
                                           torch.from_numpy(cr), D, True)
    assert got.dtype == torch.int16 and got.shape == (*cl.shape[:2], D,
                                                      cl.shape[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got2, got)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    W = cl.shape[2]
    # every d >= W is a row of 12000 in both views
    assert (got.numpy()[:, :, W:] == 12000).all()
    assert (got_r.numpy()[:, :, W:] == 12000).all()


@pytest.mark.parametrize("name", EPILOGUE_CASES)
def test_epilogue_plain_equals_jax(name):
    _, m, mr, D, kw = tail_edge_case(name)
    p, jp = SGMParams(**kw), JaxSGMParams(**kw)
    right5 = m[:, :, 5:10] if mr is None else mr[:, :, 0:5]
    wl, wr, wu = _jax_epilogue(jnp.asarray(m[:, :, 0:5]),
                               jnp.asarray(right5), D, jp)
    tm = torch.from_numpy(m)
    tr = None if mr is None else torch.from_numpy(mr)
    dl, dr, u8 = sk.sgm_epilogue_plain(tm, tr, D, p, u8=True)
    assert dl.dtype == dr.dtype == torch.float32 and u8.dtype == torch.uint8
    np.testing.assert_array_equal(dl.numpy().view(np.int32),
                                  np.asarray(wl).view(np.int32))
    np.testing.assert_array_equal(dr.numpy().view(np.int32),
                                  np.asarray(wr).view(np.int32))
    np.testing.assert_array_equal(u8.numpy(), np.asarray(wu))
    assert all(torch.equal(a, b) for a, b in zip(
        sk.sgm_epilogue_plain(tm, tr, D, p), (dl, dr)))
    d = dl.numpy()
    if name.startswith("epilogue halves"):
        half = d[d >= 0] % 1 == 0.5
        bd = np.floor(d[d >= 0][half]).astype(int)
        # halves kept at even and odd best_d, rounded half to even
        assert (bd % 2 == 0).any() and (bd % 2 == 1).any()
        np.testing.assert_array_equal(
            u8.numpy()[dl.numpy() >= 0][half], bd + (bd % 2))
    if "ratio's edge" in name:
        # the factor as float32: some pair decides otherwise in float64
        best = np.arange(101)[:, None]
        second = np.arange(111)[None, :]
        f32 = best < np.float32(kw["uniqueness"]) * second.astype(np.float32)
        np.testing.assert_array_equal(d[0] >= 0, f32)
        if kw["uniqueness"] != 0.95:
            assert (f32 != (best < kw["uniqueness"] * second)).any()
    if "D > W" in name:
        assert ((d == -1) & (m[:, :, 2] <= m[:, :, 0])).any()


def test_epilogue_reads_the_true_right_maps_only():
    """With true_right the right view is rows 0-4 of its own maps: rows
    5-9 of both inputs are never read."""
    _, m, mr, D, kw = tail_edge_case("epilogue true_right maps")
    p = SGMParams(**kw)
    want = sk.sgm_epilogue_plain(torch.from_numpy(m), torch.from_numpy(mr),
                                 D, p, u8=True)
    m2, mr2 = m.copy(), mr.copy()
    m2[:, :, 5:10] = 7
    mr2[:, :, 5:10] = 30000
    got = sk.sgm_epilogue_plain(torch.from_numpy(m2), torch.from_numpy(mr2),
                                D, p, u8=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    alone = sk.sgm_epilogue_plain(torch.from_numpy(m), None, D, p)
    assert not torch.equal(alone[1], want[1])


@pytest.mark.parametrize("name", GATE_CASES)
def test_gate_plain_equals_jax(name):
    _, left, dL, kw = tail_edge_case(name)
    p, jp = BMParams(**kw), JaxBMParams(**kw)
    wg, wu = _jax_gate(jnp.asarray(left), jnp.asarray(dL), jp)
    tl, td = torch.from_numpy(left), torch.from_numpy(dL)
    g = bm.bm_texture_gate_plain(tl, td, p)
    u8 = bm.bm_gate_u8_plain(tl, td, p)
    assert g.dtype == torch.float32 and u8.dtype == torch.uint8
    np.testing.assert_array_equal(g.numpy().view(np.int32),
                                  np.asarray(wg).view(np.int32))
    np.testing.assert_array_equal(u8.numpy(), np.asarray(wu))
    kept = g.numpy() == dL
    if name == "gate flat frame":
        assert not kept[dL != -1].any()
    elif "threshold 0" in name:
        assert kept.all()
    else:
        assert kept[dL != -1].any() and not kept[dL != -1].all()
    # a frame on its own equals its slice of the batch
    one = bm.bm_gate_u8_plain(tl[-1], td[-1], p)
    assert torch.equal(one, u8[-1])


@pytest.fixture(scope="module")
def small_nodes():
    """SGM and BM nodes at D = 16 on 12 rows of the default 320x180 frame,
    the port's and the JAX package's, with two seeded raw pairs."""
    size = dict(crop_offset_y=84, crop_im_height=12)
    out = {}
    for engine in ("sgm", "bm"):
        kw = ({"sgm_params": SGMParams(disp_num=16)} if engine == "sgm"
              else {"bm_params": BMParams(disp_num=16)})
        jkw = ({"sgm_params": JaxSGMParams(disp_num=16)} if engine == "sgm"
               else {"bm_params": JaxBMParams(disp_num=16)})
        port = make_pipeline(engine=engine, params=PipelineParams(**size),
                             device="cpu", **kw)
        ref = jax_make_pipeline(engine=engine,
                                params=JaxPipelineParams(**size), **jkw)
        out[engine] = (port, ref)
    pairs = [synthetic_raw_pair(out["sgm"][0], s, 9.0 + 4 * s, 0.05 * s)
             for s in range(2)]
    return out, pairs


@pytest.mark.parametrize("engine", ["sgm", "bm"])
def test_small_node_equals_jax_match_fused(small_nodes, engine):
    nodes, pairs = small_nodes
    port, ref = nodes[engine]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    dmaps, _ = port.process_batch_fused(lb, rb)
    assert dmaps.dtype == torch.uint8 and dmaps.shape == (2, 12, 320)
    for b in range(2):
        jl, jr = ref._rectify_crop(jnp.asarray(lb[b]), jnp.asarray(rb[b]))
        want = np.asarray(ref._match_fused(jl, jr))
        np.testing.assert_array_equal(dmaps[b].numpy(), want)
        assert (want > 0).mean() > 0.02


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """Each wrapper on CPU tensors equals its plain version and launches
    nothing."""
    n0, g0 = dict(sk.launches), dict(bm.launches)
    _, cl, cr, D = tail_edge_case("cost D = 3, W = 61, no multiple of 8")
    cl, cr = torch.from_numpy(cl), torch.from_numpy(cr)
    assert torch.equal(sk.sgm_cost_volume(cl, cr, D),
                       sk.sgm_cost_volume_plain(cl, cr, D))
    assert all(torch.equal(a, b) for a, b in zip(
        sk.sgm_cost_volume(cl, cr, D, True),
        sk.sgm_cost_volume_plain(cl, cr, D, True)))
    _, m, mr, D, kw = tail_edge_case("epilogue true_right maps")
    m, mr = torch.from_numpy(m), torch.from_numpy(mr)
    p = SGMParams(**kw)
    for right in (None, mr):
        assert all(torch.equal(a, b) for a, b in zip(
            sk.sgm_epilogue(m, right, D, p, u8=True),
            sk.sgm_epilogue_plain(m, right, D, p, u8=True)))
    _, left, dL, kw = tail_edge_case("gate window 1, B = 3, odd W")
    left, dL, bp = torch.from_numpy(left), torch.from_numpy(dL), BMParams(**kw)
    assert torch.equal(bm.bm_texture_gate(left, dL, bp),
                       bm.bm_texture_gate_plain(left, dL, bp))
    assert torch.equal(bm.bm_gate_u8(left, dL, bp),
                       bm.bm_gate_u8_plain(left, dL, bp))
    left2 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 9, 40)).astype(np.uint8))
    codes = sk.census5x5_pair(left2, left2.flip(-1))
    assert torch.equal(codes, sk.census5x5_batch_plain(
        torch.cat([left2, left2.flip(-1)])))
    assert sk.launches == n0 and bm.launches == g0


def test_sgm_match_batch_u8_is_the_epilogues():
    """sgm_match_batch(u8=True) gives dL's u8 map beside (dL, dR), true_right
    too, on the CPU's plain path."""
    rng = np.random.default_rng(11)
    left = rng.integers(0, 256, (2, 14, 90)).astype(np.uint8)
    right = np.roll(left, 6, axis=2)
    from jackal_tpu_torch.matching.sgm import sgm_match_batch
    from jackal_tpu_torch.ops.convert import dmap_u8
    for tr in (False, True):
        p = dataclasses.replace(SGMParams(disp_num=24), true_right=tr)
        dl, dr = sgm_match_batch(left, right, p, device="cpu")
        dl2, dr2, u8 = sgm_match_batch(left, right, p, device="cpu", u8=True)
        assert torch.equal(dl, dl2) and torch.equal(dr, dr2)
        assert torch.equal(u8, dmap_u8(dl))
        want = jsgm.sgm_match_batch(jnp.asarray(left), jnp.asarray(right),
                                    JaxSGMParams(disp_num=24, true_right=tr))
        np.testing.assert_array_equal(dl.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(dr.numpy(), np.asarray(want[1]))
