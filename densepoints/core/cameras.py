"""Batched pinhole cameras as a struct-of-arrays pytree.

Reference parity: the per-view `View` class of the reference
(`modules/core/types.h:37-75`, `types.cpp:28-89`) holds one 3x4 projection
matrix plus a precomputed decomposition (camera center via the SVD nullspace
of P, K/R via an RQ decomposition implemented as a flipped QR with diagonal
sign fixing). Here all views live in one `(V, 3, 4)` array; the decomposition
runs once per scene on the host in float64 (numpy) and the results are stored
as float32 device arrays, because projection/bounds tests are the only ops on
the hot path and they are pure batched arithmetic.

No OpenCV/Eigen: the RQ decomposition is the textbook flipped-QR construction
and everything else is plain (batched) linear algebra.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Cameras",
    "decompose_projection_matrix",
    "project_points",
    "project_point_all_views",
    "is_inside",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cameras:
    """All views of a scene, struct-of-arrays.

    Attributes:
      P: (V, 3, 4) projection matrices.
      K: (V, 3, 3) intrinsics, K[2,2] == 1, positive diagonal.
      E: (V, 3, 4) extrinsics [R | -R C] with K @ E == P (up to scale).
      C: (V, 3) camera centers.
      x_axis: (V, 3) camera x axes in world coordinates (row 0 of R),
        normalized. Reference: `View::GetXAxis`, types.cpp:86-89.
      width: (V,) image widths in pixels (int32).
      height: (V,) image heights in pixels (int32).
    """

    P: jax.Array
    K: jax.Array
    E: jax.Array
    C: jax.Array
    x_axis: jax.Array
    width: jax.Array
    height: jax.Array

    @property
    def num_views(self) -> int:
        return self.P.shape[0]

    def project(self, points: jax.Array) -> jax.Array:
        """Project (..., 3) world points into all views -> (V, ..., 2).

        Uses the decomposed form pix = K @ R @ (p - C), which is far better
        conditioned in f32 than the raw P @ [p; 1] product when translations
        are large (the reference multiplies raw f64 P, types.cpp:70-75;
        on the accelerator we stay in f32 so conditioning matters).
        """
        return self.project_with_depth(points)[0]

    def project_with_depth(self, points: jax.Array):
        """As `project`, also returning the camera-frame depth (V, ...)."""
        R = self.E[:, :, :3]  # (V, 3, 3)
        rel = points[None, ...] - _expand(self.C, points.ndim - 1)  # (V, ..., 3)
        # Pinned HIGHEST: pixel coordinates must never be computed in
        # TF32 or bf16 (whole-pixel errors at scan scale), regardless of
        # the ambient matmul-precision context.
        hi = jax.lax.Precision.HIGHEST
        cam = jnp.einsum("vij,v...j->v...i", R, rel, precision=hi)
        pix_h = jnp.einsum("vij,v...j->v...i", self.K, cam, precision=hi)
        depth = cam[..., 2]
        return pix_h[..., :2] / pix_h[..., 2:3], depth

    def points_inside(self, points: jax.Array) -> jax.Array:
        """(V, ...) strict-bounds visibility of world points in every view."""
        pix = self.project(points)
        extra = (1,) * (pix.ndim - 2)
        w = self.width.reshape((-1,) + extra).astype(pix.dtype)
        h = self.height.reshape((-1,) + extra).astype(pix.dtype)
        return is_inside(pix, w, h)


    @classmethod
    def from_projection_matrices(
        cls,
        P: np.ndarray,
        widths,
        heights,
        dtype=jnp.float32,
    ) -> "Cameras":
        """Build cameras from (V, 3, 4) projection matrices (host, float64)."""
        P = np.asarray(P, dtype=np.float64)
        if P.ndim == 2:
            P = P[None]
        V = P.shape[0]
        K = np.zeros((V, 3, 3))
        E = np.zeros((V, 3, 4))
        C = np.zeros((V, 3))
        for i in range(V):
            K[i], E[i], C[i] = decompose_projection_matrix(P[i])
        x_axis = E[:, 0, :3]
        x_axis = x_axis / np.linalg.norm(x_axis, axis=-1, keepdims=True)
        widths = np.broadcast_to(np.asarray(widths, np.int32), (V,))
        heights = np.broadcast_to(np.asarray(heights, np.int32), (V,))
        return cls(
            P=jnp.asarray(P, dtype),
            K=jnp.asarray(K, dtype),
            E=jnp.asarray(E, dtype),
            C=jnp.asarray(C, dtype),
            x_axis=jnp.asarray(x_axis, dtype),
            width=jnp.asarray(widths),
            height=jnp.asarray(heights),
        )


def _expand(arr: jax.Array, n: int) -> jax.Array:
    """Insert n singleton axes after the leading (view) axis."""
    return arr.reshape(arr.shape[:1] + (1,) * n + arr.shape[1:])


def _rq3(M: np.ndarray):
    """RQ decomposition of a 3x3 matrix: M = R @ Q, R upper-triangular.

    Textbook flipped-QR construction (reverse rows, QR of the transpose,
    un-flip) — same algorithm family as the reference's
    `View::SetProjectionMatrix` (types.cpp:38-55) but via the standard
    row-reversal identity.
    """
    # Reverse the rows of M, transpose, QR, then undo the permutations.
    Prev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((Prev @ M).T)
    R = Prev @ r.T @ Prev
    Q = Prev @ q.T
    return R, Q


def decompose_projection_matrix(P: np.ndarray):
    """Decompose a 3x4 projection matrix into (K, E, C).

    K: 3x3 intrinsics with positive diagonal and K[2,2] == 1.
    E: 3x4 extrinsics [R | -R C].
    C: camera center (nullspace of P, dehomogenized).

    Parity anchors (BASELINE.md): for the fixed P of
    tests/core/test_projection_matrix_decomposition.cpp:10-36 this must give
    fx=468.2, fy=427.2, cx=300, cy=200, K[2,2]=1 (+-0.1) and
    C=(1000, 2000, 1500) (+-0.01), with K @ E == P elementwise (+-0.5).
    """
    P = np.asarray(P, dtype=np.float64)
    # Camera center: right-singular vector of the smallest singular value.
    _, _, vt = np.linalg.svd(P)
    c_h = vt[-1]
    C = c_h[:3] / c_h[3]

    M = P[:, :3]
    K, Q = _rq3(M)
    # Force a positive diagonal on K; absorb the signs into the rotation.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    Q = S @ Q
    K = K / K[2, 2]
    E = np.concatenate([Q, (-Q @ C)[:, None]], axis=1)
    return K, E, C


def project_points(P: jax.Array, points: jax.Array) -> jax.Array:
    """Project world points with one projection matrix.

    P: (..., 3, 4); points: (..., 3) -> pixel coords (..., 2).
    Reference: `View::ProjectPoint`, types.cpp:70-75.
    """
    xyz = jnp.einsum(
        "...ij,...j->...i", P[..., :3], points,
        precision=jax.lax.Precision.HIGHEST,
    ) + P[..., 3]
    return xyz[..., :2] / xyz[..., 2:3]


def project_point_all_views(P_all: jax.Array, points: jax.Array) -> jax.Array:
    """Project (..., 3) points into all V views -> (V, ..., 2)."""
    return jax.vmap(lambda P: project_points(P, points))(P_all)


def is_inside(xy: jax.Array, width, height) -> jax.Array:
    """Strict in-image bounds test (exclusive on all four edges).

    Reference: `View::IsPointInside`, types.cpp:77-84 (0 < x < cols,
    0 < y < rows).
    """
    x, y = xy[..., 0], xy[..., 1]
    return (x > 0) & (x < width) & (y > 0) & (y < height)
