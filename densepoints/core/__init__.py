from densepoints.core.cameras import (
    Cameras,
    decompose_projection_matrix,
    is_inside,
    project_point_all_views,
    project_points,
)
from densepoints.core.scores import (
    ncc_score,
    ncc_score_by_channel,
    sad_score,
    ssd_score,
)
