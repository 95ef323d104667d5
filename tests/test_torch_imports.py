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


def test_later_slices_raise_not_implemented():
    import dataclasses
    from jackal_tpu_torch.config import ElasParams, PipelineParams
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.pipeline.default import make_pipeline

    for engine in ("sgm", "bm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_pipeline(engine=engine, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_pipeline(device="cpu")     # the default engine is still sgm
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_pipeline(engine="elas", device="cpu",
                      params=PipelineParams(gen_pcl=True))
    img = np.zeros((40, 64), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        elas_match(img, img, dataclasses.replace(ElasParams(),
                                                 subsampling=True),
                   device="cpu")
