"""Patch state: the unit of reconstruction, as a struct-of-arrays pytree.

Reference parity: `methods/pmvs/patch.h` — one `Patch` object holds
position/normal/color in a PCL point, a reference image id, and
variable-length truly-visible / candidate image index lists. Batched redesign:
ALL patches live in one fixed-capacity SoA with boolean visibility bitmasks
`(P, V)` instead of index lists, and an `alive` mask instead of vector
erasure (`Seed::RemovePatches`, seed.cpp:146-156). Every pipeline stage is a
pure function PatchState -> PatchState.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PatchState"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PatchState:
    """Struct-of-arrays patch store.

    position: (P, 3) world positions.
    normal:   (P, 3) unit normals, pointing AWAY from the reference camera
              (seed convention n = (p - C_ref)/|.|, seed.cpp:42-43).
    ref:      (P,) int32 reference view ids.
    vis:      (P, V) bool truly-visible mask (excludes the reference view,
              patch.cpp:30).
    cand:     (P, V) bool potentially-visible mask.
    alive:    (P,) bool.
    color:    (P, 3) float32 RGB in [0, 255].
    """

    position: jax.Array
    normal: jax.Array
    ref: jax.Array
    vis: jax.Array
    cand: jax.Array
    alive: jax.Array
    color: jax.Array

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def num_views(self) -> int:
        return self.vis.shape[1]

    def num_alive(self) -> int:
        return int(jnp.sum(self.alive))

    def num_visible(self) -> jax.Array:
        """(P,) count of truly-visible views per patch."""
        return jnp.sum(self.vis, axis=1).astype(jnp.int32)

    @classmethod
    def empty(cls, capacity: int, num_views: int, dtype=jnp.float32):
        z3 = jnp.zeros((capacity, 3), dtype)
        return cls(
            position=z3,
            normal=z3,
            ref=jnp.zeros((capacity,), jnp.int32),
            vis=jnp.zeros((capacity, num_views), bool),
            cand=jnp.zeros((capacity, num_views), bool),
            alive=jnp.zeros((capacity,), bool),
            color=z3,
        )

    @classmethod
    def create(cls, position, normal, ref, vis, cand=None, alive=None, color=None):
        position = jnp.asarray(position, jnp.float32)
        P, V = position.shape[0], jnp.asarray(vis).shape[1]
        return cls(
            position=position,
            normal=jnp.asarray(normal, jnp.float32),
            ref=jnp.asarray(ref, jnp.int32),
            vis=jnp.asarray(vis, bool),
            cand=(
                jnp.asarray(cand, bool)
                if cand is not None
                else jnp.zeros((P, V), bool)
            ),
            alive=(
                jnp.asarray(alive, bool)
                if alive is not None
                else jnp.ones((P,), bool)
            ),
            color=(
                jnp.asarray(color, jnp.float32)
                if color is not None
                else jnp.zeros((P, 3), jnp.float32)
            ),
        )

    def compact(self) -> "PatchState":
        """Drop dead patches (host-side; changes the leading shape)."""
        keep = np.asarray(self.alive)
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[keep]), self)

    def concatenate(self, other: "PatchState") -> "PatchState":
        return jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self, other
        )

    def masked(self, keep: jax.Array) -> "PatchState":
        """Kill patches where keep is False (shape-preserving)."""
        return dataclasses.replace(self, alive=self.alive & keep)
