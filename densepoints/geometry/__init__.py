from densepoints.geometry.fundamental import (
    epipolar_distance_matrix,
    epipolar_lines,
    fundamental_from_projections,
    fundamental_matrices_for_pairs,
    point_line_distance,
)
from densepoints.geometry.homography import (
    apply_homography,
    homography_from_4pts,
    plane_homography,
)
from densepoints.geometry.triangulation import triangulate, triangulate_pair
