"""The port stands alone: no JAX, no jackal_tpu, and the card by default."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "jackal_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_pulls_in_no_jax():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter; sys.modules then holds neither jax nor jackal_tpu."""
    code = r"""
import importlib, pkgutil, sys
import jackal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jackal_tpu_torch.__path__,
                                               "jackal_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jackal_tpu"
             or m.startswith("jackal_tpu."))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
batched = {"jackal_tpu_torch.matching.elas.device_prior",
           "jackal_tpu_torch.matching.elas.device_fit",
           "jackal_tpu_torch.ops.convert", "jackal_tpu_torch.ops.transfer",
           "jackal_tpu_torch.io_bus.bus", "jackal_tpu_torch.io_bus.messages",
           "jackal_tpu_torch.io_bus.timelog",
           "jackal_tpu_torch.pipeline.runner"}
assert batched <= set(names), batched - set(names)
sgm = {"jackal_tpu_torch.matching.sgm", "jackal_tpu_torch.ops.sgm_kernel",
       "jackal_tpu_torch.ops.shifts", "jackal_tpu_torch.entry"}
assert sgm <= set(names), sgm - set(names)
bm = {"jackal_tpu_torch.matching.bm", "jackal_tpu_torch.ops.bm_kernel"}
assert bm <= set(names), bm - set(names)
rest = {"jackal_tpu_torch.parallel.mesh", "jackal_tpu_torch.ops.filters",
        "jackal_tpu_torch.ops.linalg",
        "jackal_tpu_torch.experiments.feature_matching",
        "jackal_tpu_torch.experiments.confidence"}
assert rest <= set(names), rest - set(names)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(_port_sources()))
def test_source_imports_no_jax(path):
    """No import statement of the port names jax or jackal_tpu, even one
    inside a function."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jackal_tpu", "jaxlib"), (path, n)


def test_entry_points_need_the_card_unless_cpu(monkeypatch):
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.pipeline.default import make_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((40, 64), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(engine="elas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elas_match(img, img)
    D1, D2 = elas_match(img, img, ElasParams(), device="cpu")
    assert D1.device.type == "cpu" and (D1 == -10).all()

    from jackal_tpu_torch.matching.elas.device_fit import fit_planes_device
    from jackal_tpu_torch.matching.elas.pipeline import (
        elas_match_batch_device, elas_match_stream)
    batch = np.zeros((2, 40, 64), np.uint8)
    for call in (lambda: elas_match_batch_device(batch, batch),
                 lambda: next(elas_match_stream(iter([(batch, batch)]))),
                 lambda: fit_planes_device(np.zeros((3, 3), np.int32),
                                           np.zeros((1, 3), np.int32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    B1, _ = elas_match_batch_device(batch, batch, device="cpu")
    assert B1.device.type == "cpu" and (B1 == -10).all()

    from jackal_tpu_torch.entry import entry
    from jackal_tpu_torch.matching.sgm import sgm_match, sgm_match_batch
    for call in (make_pipeline, lambda: make_pipeline(engine="sgm"),
                 lambda: sgm_match_batch(batch, batch),
                 lambda: sgm_match(img, img), entry):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    S1, _ = sgm_match_batch(batch, batch, device="cpu")
    assert S1.device.type == "cpu" and S1.shape == (2, 40, 64)
    assert make_pipeline(device="cpu").engine == "sgm"

    from jackal_tpu_torch.config import PipelineParams
    for kw in ({"engine": "bm"},
               {"engine": "bm", "params": PipelineParams(gen_pcl=True)},
               {"engine": "elas", "params": PipelineParams(gen_pcl=True)}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_pipeline(**kw)
        assert make_pipeline(device="cpu", **kw).device.type == "cpu"


def test_later_slices_raise_not_implemented():
    import dataclasses
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.pipeline.default import make_pipeline

    img = np.zeros((40, 64), np.uint8)
    # subsampling is the per-frame path's (a featureless pair has no
    # support points: the reference's full-size -10 maps)
    D1, _ = elas_match(img, img, dataclasses.replace(ElasParams(),
                                                     subsampling=True),
                       device="cpu")
    assert D1.shape == (40, 64) and bool((D1 == -10).all())
    pipe = make_pipeline(engine="elas", device="cpu")
    with pytest.raises(ValueError, match="engine='sgm'"):
        pipe.process_batch_fused(img[None], img[None])
    with pytest.raises(ValueError, match="engine='sgm'"):
        pipe.process_batch_fused_pcl(img[None], img[None])


@pytest.mark.parametrize("engine", ["elas", "sgm", "bm"])
def test_gen_pcl_builds_on_the_cpu(engine):
    """Every engine takes gen_pcl on device="cpu" and gives a cloud of
    every pixel beside its map; BM builds with its parameters."""
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine=engine, device="cpu",
                         bm_params=BMParams(disp_num=32),
                         params=PipelineParams(
                             gen_pcl=True, calib_im_size=(128, 72),
                             im_width=64, im_height=36, crop_im_width=64,
                             crop_im_height=36))
    assert pipe.engine == engine and pipe.bm_params.disp_num == 32
    img = np.random.default_rng(0).integers(0, 256, (2, 72, 128)).astype(
        np.uint8)
    dmaps, (pts, rgb, valid), scans = pipe.process_batch_pcl(img, img)
    assert dmaps.shape == (2, 36, 64) and pts.shape == (2, 36 * 64, 3)
    assert rgb.dtype == torch.float32 and valid.dtype == torch.bool
    assert scans.scan.shape == (2, 90)
