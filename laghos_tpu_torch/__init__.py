"""laghos_tpu_torch -- Lagrangian shock hydrodynamics on PyTorch and CUDA.

The PyTorch port of `laghos_tpu`: the conforming, single-device `Hydro`
step on segment/quad/hex meshes, partial assembly (the whole-lattice
operators on Cartesian meshes, the gather path elsewhere) or full assembly,
with the pointwise quadrature physics and the Ozaki split as hand-written
CUDA kernels (csrc/qphys.cu, csrc/split.cu), the reference's CLI and its
I/O, the simplex solver and the AMR variant (`amr/`).  It imports neither
JAX nor `laghos_tpu`, and changes no global torch default at import:
every tensor is built with an explicit device and dtype.
"""

__version__ = "0.1.0"
