from densepoints.surface.tsdf import (
    extract_surface,
    fuse_tsdf,
    marching_tetrahedra,
)
