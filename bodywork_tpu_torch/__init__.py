"""bodywork_tpu_torch: the PyTorch/CUDA port of bodywork_tpu.

The JAX package (``bodywork_tpu``) stays the reference; this package is
its port to PyTorch on an NVIDIA H100, slice by slice. The first slice
serves the pipeline's MLP end to end: drift-data generation, the
checkpoint format both packages share, the scoring service (the torch
engine and the hand-written fused-MLP CUDA kernel behind ``/score/v1``)
and the live-service test stage.

The package imports ``torch`` and never ``jax`` nor anything of
``bodywork_tpu`` (a subprocess test pins it). Entry points run on the
card unless the caller asks for the CPU (:mod:`.device`).
"""
from bodywork_tpu_torch.version import __version__

__all__ = ["__version__"]
