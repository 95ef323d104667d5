"""jackal_tpu_torch: the stereo obstacle-avoidance stack in PyTorch + CUDA.

A port of the ``jackal_tpu`` package (JAX/XLA/Pallas for TPU) to PyTorch
on an NVIDIA H100. It grows slice by slice; so far it has the point_cloud
node's ELAS paths, per frame and batched, and its SGM engine:

    raw u8 stereo pair -> rectify (15-bit fixed-point remap)
      -> ELAS: descriptors, support search [CUDA kernel A], host prior
         (C++), dense MAP matching of both views [CUDA kernel B], L/R
         check, speckle (C++ BFS), gap fill, adaptive mean, median
      -> u8 disparity map -> 90-bin obstacle scan

    batched: the same, with only support pruning and Delaunay on the host
      (worker threads) and the plane fit, candidate grids, prior raster
      [CUDA kernel C] and the speckle filter on the card

    SGM (make_pipeline's default engine): rectify -> census [CUDA kernel
      D] -> Hamming cost volume -> 8-path aggregation [CUDA kernel E] ->
      WTA maps of both views [CUDA kernel F] -> uniqueness, sub-pixel, L/R
      check -> u8 disparity -> scan, all on the card

Entry points: ``pipeline.default.make_pipeline()`` (SGM) or
``make_pipeline(engine="elas")``, then ``StereoPipeline.process_frame``,
``process_batch`` or ``process_batch_fused`` (SGM);
``pipeline.runner.StreamingRunner`` (the node's --batch > 1 loop);
``matching.elas.pipeline.elas_match``, ``elas_match_batch(_device)``,
``elas_match_stream``; ``matching.sgm.sgm_match(_batch)``; and
``entry.entry()``, the rectify -> SGM -> scan step as one callable.

Rules of the port:

  - The JAX package is the reference and is not changed. Every stage here
    is held bit-equal to it (the scan to a stated tolerance) by the tests.
  - No import of ``jax`` or of ``jackal_tpu``, not even of its modules
    that do not use JAX: what the port needs of them (config, calib,
    rectify, valid_disp, the numpy prior, the C++ engine, the bundled
    calibration) it keeps as its own copy.
  - The card is the default. Entry points take ``device=None`` and run on
    ``cuda``; with no card they raise, and they never move to the CPU on
    their own. ``device="cpu"`` runs everything on the CPU.
  - A kernel's wrapper launches its CUDA kernel for a CUDA tensor, or
    raises; for a CPU tensor it runs the kernel's plain PyTorch version,
    which sits in the same module. No code falls back from a kernel to
    its plain version.
  - PyTorch idiom: plain functions on tensors with an explicit device,
    dataclasses of tensors, no jit and no torch.compile; a JAX vmap is a
    batch dimension written out.
  - Kernels are CUDA C++ for sm_90a under csrc/, built by nvcc at first
    use into the ignored _build/ and loaded through ctypes (ops/cuda_lib).
    Each wrapper counts its launches in a module-level int ``launches``.
"""

__version__ = "0.1.0"

from .calib import StereoCalibration, load_calibration  # noqa: F401
from .config import (  # noqa: F401
    ElasParams,
    GroundPlaneParams,
    PipelineParams,
    ScanParams,
)
