"""epivo_tpu: visual odometry + bundle adjustment on an accelerator.

A from-scratch JAX re-design with the capabilities of the
reference epipolar-geometry VO engine (Ronnypetson/epivo): feature
detection/tracking/matching, robust essential-matrix pose estimation,
closed-form epipolar-depth triangulation, analytic SE(3) Jacobians, and
windowed Levenberg-Marquardt bundle adjustment, scaled over device meshes.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Epipolar geometry in f32 needs f32 matmuls. On a Hopper GPU, XLA may run
# float32 dots on the tensor cores in TF32, which keeps ~3 significant
# digits — enough to push two-view pose estimates from ~0.02 to ~0.07
# direction error on the synthetic check. Every geometry-critical matmul
# in this framework is tiny (3x3 / 9x9 / 6Zx6Z normal equations), so full
# f32 costs nothing measurable; the bandwidth-bound frontend does no
# matmuls. Opt out with EPIVO_DEFAULT_MATMUL_PRECISION (any value accepted
# by jax_default_matmul_precision, e.g. "tensorfloat32").
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("EPIVO_DEFAULT_MATMUL_PRECISION", "highest"),
)
