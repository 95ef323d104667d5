"""The port's multi-device paths on the CPU == jackal_tpu's, and == the
port's single-device paths.

The port's meshes are ["cpu"] * n (one process drives every rank, as JAX's
single controller does); the JAX side runs on the 8 virtual CPU devices of
tests/conftest.py, as tests/test_parallel.py runs it. Maps, keys and ELAS
outputs are held bit-equal. Scans against the JAX package are held to the
relative 1e-5 of tests/test_torch_pipeline.py with the same filled bins;
against the port's own unsharded step they are torch.equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import BMParams as JaxBMParams
from jackal_tpu.matching.bm import bm_match as jax_bm_match
from jackal_tpu.parallel import mesh as jmesh
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu_torch.config import BMParams
from jackal_tpu_torch.matching.elas.pipeline import elas_match_batch_multichip
from jackal_tpu_torch.entry import dryrun_multichip
from jackal_tpu_torch.matching.bm import bm_match
from jackal_tpu_torch.parallel import mesh as pmesh
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

SCAN_RTOL = 1e-5
# the reference's bm_match_tp against its bm_match at D = 30 on 4 ranks,
# 96x320 of elas_golden_s320_flat: the first differing pixel (v, u) of the
# left map, and (TP, bm_match) there
FIRST_DIFF_D30 = (0, 177)
FIRST_DIFF_D30_VALUES = (2.6880531311035156, -1.0)
SCAN_FIELDS = ("scan", "angle_min", "angle_max", "range_min", "range_max")


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


def _need_8_jax_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")


@pytest.fixture(scope="module")
def golden():
    g = np.load("tests/fixtures/elas_golden_s320_flat.npz")
    return g["left"], g["right"]


# ---- make_mesh and the collectives -------------------------------------

@pytest.mark.parametrize("n,disp", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2),
                                    (6, 3)])
def test_make_mesh_shapes_equal_jax(n, disp):
    _need_8_jax_devices()
    m = pmesh.make_mesh(n, disp_parallel=disp, devices=_cpus(8))
    want = jmesh.make_mesh(n, disp_parallel=disp)
    assert m.shape == dict(want.shape)
    assert m.axis_names == tuple(want.axis_names) == ("data", "disp")
    assert len(m.rows()) == n // disp
    assert all(d == torch.device("cpu") for row in m.devices for d in row)


def test_make_mesh_errors_and_default_devices(monkeypatch):
    _need_8_jax_devices()
    for n, disp in ((8, 3), (6, 4)):
        with pytest.raises(ValueError, match="not divisible"):
            jmesh.make_mesh(n, disp_parallel=disp)
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_mesh(n, disp_parallel=disp, devices=_cpus(8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elas_match_batch_multichip(np.zeros((2, 40, 64), np.uint8),
                                   np.zeros((2, 40, 64), np.uint8))


def test_pmin_and_gather():
    xs = [torch.tensor([[3, 1], [7, 2]]), torch.tensor([[2, 5], [7, 9]]),
          torch.tensor([[4, 0], [8, 2]])]
    out = pmesh.pmin(xs)
    assert len(out) == 3
    for o in out:
        assert torch.equal(o, torch.tensor([[2, 0], [7, 2]]))
    assert torch.equal(pmesh.gather(xs), torch.cat(xs))
    from jackal_tpu_torch.scan.obstacle import ScanResult
    sr = [ScanResult(*(torch.full((k + 1,), float(i)) for i in range(5)))
          for k in range(2)]
    g = pmesh.gather(sr)
    assert [getattr(g, f).tolist() for f in SCAN_FIELDS] == [
        [float(i)] * 3 for i in range(5)]


# ---- BM with the disparity axis over "disp" ----------------------------

def _rolled(img, B, axis):
    return np.stack([np.roll(img, 5 * b, axis=axis) for b in range(B)])


@pytest.mark.parametrize("disp_parallel", [2, 4, 8])
def test_tp_bm_equal_jax_and_bm_match(golden, disp_parallel):
    """96x320, D = 32: the port's bm_match_tp == JAX bm_match_tp == the
    port's single-device bm_match, both maps, frame by frame; distinct
    frames per data row."""
    _need_8_jax_devices()
    l, r = (x[:96, :320] for x in golden)
    B = 8 // disp_parallel
    lb, rb = _rolled(l, B, 0), _rolled(r, B, 0)
    mesh = pmesh.make_mesh(8, disp_parallel=disp_parallel, devices=_cpus(8))
    dl, dr = pmesh.bm_match_tp(mesh, BMParams(disp_num=32))(lb, rb)
    assert len(dl) == len(dr) == B
    dl, dr = pmesh.gather(dl), pmesh.gather(dr)
    jtp = jmesh.bm_match_tp(jmesh.make_mesh(8, disp_parallel=disp_parallel),
                            JaxBMParams(disp_num=32))
    wl, wr = jtp(lb, rb)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(wr))
    for b in range(B):
        sl, sr = bm_match(lb[b], rb[b], BMParams(disp_num=32))
        assert torch.equal(dl[b], sl) and torch.equal(dr[b], sr)
    assert (dl >= 0).float().mean() > 0.3


def test_tp_bm_d_not_divisible_by_ranks(golden):
    """D = 30 on 4 ranks: Dl = 7, so d = 28 and 29 are scored by no rank
    (mesh.py:126 of the reference). The reference's TP matcher then
    differs from its own bm_match (ROADMAP.md Queue 3); the port keeps the
    reference's TP function, and equals it."""
    _need_8_jax_devices()
    l, r = (x[:96, :320] for x in golden)
    lb, rb = l[None], r[None]
    mesh = pmesh.make_mesh(4, disp_parallel=4, devices=_cpus(4))
    dl, dr = (pmesh.gather(x) for x in
              pmesh.bm_match_tp(mesh, BMParams(disp_num=30))(lb, rb))
    jtp = jmesh.bm_match_tp(jmesh.make_mesh(4, disp_parallel=4),
                            JaxBMParams(disp_num=30))
    wl, wr = (np.asarray(x) for x in jtp(lb, rb))
    np.testing.assert_array_equal(dl.numpy(), wl)
    np.testing.assert_array_equal(dr.numpy(), wr)
    rl, rr = (np.asarray(x) for x in jax_bm_match(
        jnp.asarray(l), jnp.asarray(r), JaxBMParams(disp_num=30)))
    diff = np.argwhere(wl[0] != rl)
    assert len(diff) > 0 and (wr[0] != rr).any()
    v, u = diff[0]
    # the first difference (row-major) and both values, as Queue 3 records
    assert (int(v), int(u)) == FIRST_DIFF_D30
    assert (float(wl[0, v, u]), float(rl[v, u])) == FIRST_DIFF_D30_VALUES
    sl, _ = bm_match(l, r, BMParams(disp_num=30))
    np.testing.assert_array_equal(sl.numpy(), rl)


# ---- data parallelism over the fused step ------------------------------

@pytest.fixture(scope="module")
def pairs():
    port = make_pipeline(engine="bm", device="cpu")
    ps = [synthetic_raw_pair(port, s, 6 + 2 * s, 0.05 * (s % 3))
          for s in range(8)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def _scans_close(got, want):
    gs, ws = got.scan.numpy(), np.asarray(want.scan)
    filled = ws < 1e9 - 1
    assert filled.sum() >= 10
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)
    for k in SCAN_FIELDS[1:]:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=SCAN_RTOL)


@pytest.mark.parametrize("engine,disp", [("bm", 1), ("sgm", 2)])
def test_dp_step_equal_unsharded_and_jax(pairs, engine, disp):
    """The DP step over 8 / disp data rows == the unsharded
    process_batch_fused (maps and every scan field torch.equal, closest
    the least range) and == JAX's dp_sharded_step (maps bit-equal, scans
    within 1e-5)."""
    _need_8_jax_devices()
    lb, rb = pairs
    B = 8 // disp
    lb, rb = lb[:B], rb[:B]
    pipe = make_pipeline(engine=engine, device="cpu")
    mesh = pmesh.make_mesh(8, disp_parallel=disp, devices=_cpus(8))
    dmaps, scans, closest = pmesh.dp_sharded_step(pipe, mesh)(lb, rb)
    assert len(dmaps) == len(scans) == B
    dm, sc = pmesh.gather(dmaps), pmesh.gather(scans)
    wd, ws = pipe.process_batch_fused(lb, rb)
    assert torch.equal(dm, wd)
    for f in SCAN_FIELDS:
        assert torch.equal(getattr(sc, f), getattr(ws, f)), f
    assert closest.dim() == 0 and torch.equal(closest, ws.scan.min())

    ref = jax_make_pipeline(None, engine)
    jstep = jmesh.dp_sharded_step(ref, jmesh.make_mesh(8, disp_parallel=disp))
    jd, js, jc = jstep(lb, rb)
    np.testing.assert_array_equal(dm.numpy(), np.asarray(jd))
    _scans_close(sc, js)
    np.testing.assert_allclose(float(closest), float(jc), rtol=SCAN_RTOL)
    assert (dm > 0).float().mean() > 0.3


def test_dp_replicas_follow_update_extrinsics(pairs):
    """A replica on another device (here "cpu:0", not the pipeline's
    "cpu") is built from the pipeline's arguments and takes up its
    extrinsics at every call, before and after update_extrinsics."""
    lb, rb = (x[:4] for x in pairs)
    pipe = make_pipeline(engine="bm", device="cpu")
    pipe.update_extrinsics((1.35, -3.1, 1.6), (0.05, 0.0, 0.3))
    mesh = pmesh.make_mesh(devices=["cpu", "cpu:0"])
    step = pmesh.dp_sharded_step(pipe, mesh)

    def check():
        _, scans, closest = step(lb, rb)
        want = pipe.process_batch_fused(lb, rb)[1]
        got = pmesh.gather(scans)
        for f in SCAN_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(closest, want.scan.min())
        return got.scan

    before = check()
    pipe.update_extrinsics((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    after = check()
    assert not torch.equal(before, after)


def test_value_errors_as_the_reference(pairs):
    """The data-parallel step and the TP matcher raise as shard_map does
    on a batch the data rows do not divide; the step needs a fused
    engine."""
    _need_8_jax_devices()
    lb, rb = (x[:3] for x in pairs)
    pipe = make_pipeline(engine="bm", device="cpu")
    mesh = pmesh.make_mesh(2, devices=_cpus(2))
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.dp_sharded_step(pipe, mesh)(lb, rb)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.bm_match_tp(mesh)(lb[..., :64], rb[..., :64])
    with pytest.raises(ValueError):
        jmesh.bm_match_tp(jmesh.make_mesh(2))(lb[..., :64], rb[..., :64])
    with pytest.raises(ValueError, match="engine='sgm'"):
        pmesh.dp_sharded_step(make_pipeline(engine="elas", device="cpu"),
                              mesh)


def test_dryrun_multichip_on_the_cpu():
    """The reference dry run's four steps on an 8-rank CPU mesh (TP over 4
    ranks, 2 data rows), its asserts kept."""
    dryrun_multichip(8, device="cpu")
