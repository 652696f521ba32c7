from densepoints.multiscale.pyramid import (
    build_pyramid,
    densify_multiscale,
    downsample2,
    scale_cameras,
)
