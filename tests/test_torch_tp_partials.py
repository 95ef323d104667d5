"""The plain twins of TP BM's kernels T1 and T2 on the CPU == jackal_tpu's
bm_match_tp, and == the port's bm_match where the ranks divide D.

ops/bm_tp_kernel.tp_partials_plain (a rank's nine partials a pixel and
view) and tp_combine_plain (the row's combine and L/R check), then the
texture gate, against the JAX package's bm_match_tp on the 8 virtual CPU
devices of tests/conftest.py (2 data rows of the ranks), the port's eager
TP path (bm_match_tp on a CPU mesh) and its bm_match. Frames: 2 seeded
48x96 pairs of each of chip_smoke.TP_PAIR_KINDS (random shifts; shifts on
the ranks' first and last d; rows periodic with period Dl, whose costs tie
across ranks), at D = 16 on 2 and 4 ranks and D = 30 on 4 (d = 28 and 29
scored by no rank). tests/test_torch_cuda.py holds the kernels to these
twins on the card.
"""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import TP_PAIR_KINDS, tp_pair
from jackal_tpu.config import BMParams as JaxBMParams
from jackal_tpu.parallel import mesh as jmesh
from jackal_tpu_torch.config import BMParams
from jackal_tpu_torch.matching.bm import bm_match, bm_texture_gate_plain
from jackal_tpu_torch.ops import bm_tp_kernel as tpk
from jackal_tpu_torch.parallel import mesh as pmesh

B, H, W = 2, 48, 96
CASES = [(D, K, kind) for D, K in ((16, 2), (16, 4), (30, 4))
         for kind in TP_PAIR_KINDS]


def _twins(left, right, p, K):
    """Both maps through the twins (T1's partials a rank, T2's combine, the
    gate) and the partials."""
    D = p.disp_num
    Dl = D // K
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    parts = torch.stack([tpk.tp_partials(L, R, k * Dl, Dl, D, p.window // 2)
                         for k in range(K)])
    assert parts.shape == (K, 2, tpk.NF, B, H, W)
    dl, dr = tpk.tp_combine(parts, D, Dl, p)
    return bm_texture_gate_plain(L, dl, p), dr, parts


@pytest.mark.parametrize("D,K,kind", CASES)
def test_tp_twins_equal_jax_bm_match_tp(D, K, kind):
    if len(jax.devices()) < 2 * K:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    left, right, uniq = tp_pair(kind, B, H, W, D, K)
    p = BMParams(disp_num=D, uniqueness=uniq)
    dl, dr, parts = _twins(left, right, p, K)
    jtp = jmesh.bm_match_tp(jmesh.make_mesh(2 * K, disp_parallel=K),
                            JaxBMParams(disp_num=D, uniqueness=uniq))
    wl, wr = (np.asarray(x) for x in jtp(left, right))
    np.testing.assert_array_equal(dl.numpy(), wl)
    np.testing.assert_array_equal(dr.numpy(), wr)
    mesh = pmesh.make_mesh(2 * K, disp_parallel=K, devices=["cpu"] * 2 * K)
    el, er = (pmesh.gather(x) for x in pmesh.bm_match_tp(mesh, p)(left,
                                                                  right))
    assert torch.equal(el, dl) and torch.equal(er, dr)
    if D % K == 0:
        sl, sr = bm_match(left, right, p)
        assert torch.equal(dl, sl) and torch.equal(dr, sr)
    kept = torch.stack([dl, dr]) >= 0
    assert kept.float().mean() > 0.2
    Dl = D // K
    best = parts[:, :, tpk.KEY].amin(0) % D
    if kind == "rank edges":        # most kept pixels' best d on an edge
        on_edge = (best % Dl == 0) | (best % Dl == Dl - 1)
        assert on_edge[kept].float().mean() > 0.6
    if kind == "ties across ranks":
        # where ranks 0 and 1 hold the least cost alike, rank 0's d wins
        cost = parts[:, :, tpk.BEST]
        tied = (cost[0] == cost[1]) & (cost[0] == cost.amin(0)) & kept
        assert tied.float().mean() > 0.3
        assert bool((best[tied] < Dl).all())
