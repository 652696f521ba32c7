"""densepoints: a JAX multi-view-stereo densification framework.

A from-scratch JAX/XLA/Pallas re-design of the capability set of the reference
C++ project `manlito/densepoints` (PMVS-style patch-based MVS densification:
seed -> optimize -> expand -> filter -> export), plus the stages the reference
left unfinished: the PMVS filter pass, multi-scale pyramids, Schur-complement
bundle adjustment, surface extraction, and multi-host distribution.

Layout (bottom-up):
  core/       batched cameras, photometric scores, grid index math
  geometry/   fundamental matrices, epipolar lines, batched DLT triangulation
  ops/        the all-views scoring kernel (Pallas, Triton backend, CUDA)
              + XLA reference implementations (NCC, warp, batched
              Nelder-Mead)
  features/   batched detector / descriptors / matching / tracks (seeding)
  pmvs/       the PMVS method: patch SoA, visibility, optimization, expansion,
              filtering, pipeline driver
  io/         scene JSON reader (reference-compatible schema), images, PLY
  parallel/   device mesh, shardings, multi-host pipeline
  ba/         bundle adjustment (Schur complement, batched Jacobians)
  surface/    TSDF fusion + marching cubes surface extraction
  multiscale/ image pyramids, coarse-to-fine densification
"""

__version__ = "0.1.0"

# Geometry correctness contract: f32 matmuls/einsums must be computed at
# f32 accuracy. On an NVIDIA GPU the default matmul precision lets XLA run
# f32 operands on the tensor cores in TF32 (10 mantissa bits), which moves
# projective geometry (camera einsums, DLT, BA normal equations) by whole
# pixels at scan-scale coordinates (1600x1200, focal ~2900) — the same
# failure bf16 geometry causes. Matmuls that are exact at low precision
# request it explicitly (the +-1 Hamming descriptor matmuls in bf16).
#
# The contract is enforced at TWO levels (tests/core/test_precision_contract
# pins both):
#   1. every pixel-coordinate-producing matmul site pins
#      `precision=jax.lax.Precision.HIGHEST` explicitly (core/cameras.py,
#      ops/warp.py, geometry/homography.py, ba/ba.py) — correct even under
#      a caller's own precision context; the scoring kernel
#      (ops/allview.py) projects with scalar f32 arithmetic;
#   2. the PACKAGE-WIDE default below covers everything else (DLT/QR/BA
#      linear algebra and future call sites). This is a deliberate global:
#      a geometry framework whose f32 linear algebra silently runs in
#      TF32 is wrong, not slow. It is applied only when the embedding
#      application has NOT chosen its own default, so user configuration
#      is never clobbered.
import jax as _jax

if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")
