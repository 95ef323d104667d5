"""Port elas_match on the CPU == libelas goldens == JAX elas_match."""
import glob
import os

import numpy as np
import pytest

from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas.pipeline import elas_match

FIX = "tests/fixtures"
GOLDENS = sorted(os.path.basename(p)[len("elas_golden_"):-len(".npz")]
                 for p in glob.glob(f"{FIX}/elas_golden_s320_*.npz"))


def _params(preset: str) -> ElasParams:
    return {"ROBOTICS": ElasParams.robotics,
            "MIDDLEBURY": ElasParams.middlebury}[preset.upper()]()


@pytest.mark.parametrize("fix", GOLDENS)
def test_golden_bit_exact(fix):
    g = np.load(f"{FIX}/elas_golden_{fix}.npz")
    D1, D2 = elas_match(g["left"], g["right"], _params(str(g["preset"])),
                        device="cpu")
    np.testing.assert_array_equal(D1.numpy(), g["D1"])
    np.testing.assert_array_equal(D2.numpy(), g["D2"])


def test_goldens_cover_both_presets():
    presets = {str(np.load(f"{FIX}/elas_golden_{f}.npz")["preset"]).upper()
               for f in GOLDENS}
    assert presets == {"ROBOTICS", "MIDDLEBURY"}, presets


def test_matches_jax_elas_match():
    from jackal_tpu.matching.elas.pipeline import elas_match as jax_elas

    g = np.load(f"{FIX}/elas_golden_s320_boxes.npz")
    left = np.ascontiguousarray(g["left"][40:136, 60:260])
    right = np.ascontiguousarray(g["right"][40:136, 60:260])
    W1, W2 = jax_elas(left, right)
    D1, D2 = elas_match(left, right, device="cpu")
    np.testing.assert_array_equal(D1.numpy(), W1)
    np.testing.assert_array_equal(D2.numpy(), W2)
    assert (W1 >= 0).mean() > 0.3


def test_reference_triangulation_override():
    """tri_left/tri_right replace the Delaunay step (stage fixture)."""
    z = np.load(f"{FIX}/elas_stages_st320.npz")
    D1, _ = elas_match(z["left"], z["right"], tri_left=z["tri1"],
                       tri_right=z["tri2"], device="cpu")
    np.testing.assert_array_equal(D1.numpy(), z["final_D1"])
