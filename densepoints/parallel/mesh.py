"""Device mesh construction and sharding helpers.

No analog exists in the reference (single-process OpenMP only; SURVEY.md
§2.7): this layer is the data-parallel distribution design — a 1-D or 2-D
`jax.sharding.Mesh` whose axes shard the PATCH dimension (pure data parallel
over the photometric hot path) and optionally the VIEW dimension (for
view-heavy scenes, NCC score aggregation rides a psum over the view axis).
Collectives go through XLA's lowering of pjit/shard_map programs (NCCL
over NVLink between the GPUs of one host).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_patches", "replicate", "PATCH_AXIS"]

PATCH_AXIS = "patch"


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the patch axis (the dominant scaling dimension)."""
    if devices is None:
        devices = jax.devices()
    if num_devices:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (PATCH_AXIS,))


def shard_patches(mesh: Mesh) -> NamedSharding:
    """Sharding for (P, ...) patch-major arrays: split dim 0 over the mesh."""
    return NamedSharding(mesh, P(PATCH_AXIS))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple
