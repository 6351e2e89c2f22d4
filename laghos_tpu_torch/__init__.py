"""laghos_tpu_torch -- Lagrangian shock hydrodynamics on PyTorch and CUDA.

The PyTorch port of `laghos_tpu`: the conforming, single-device,
partial-assembly `Hydro` step on quad/hex meshes, with the pointwise
quadrature physics as a hand-written CUDA kernel (csrc/qphys.cu).  It
imports neither JAX nor `laghos_tpu`, and changes no global torch default
at import: every tensor is built with an explicit device and dtype.
"""

__version__ = "0.1.0"
