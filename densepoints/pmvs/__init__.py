from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.visibility import classify_views, compute_color
from densepoints.pmvs.optimize import (
    filter_by_error,
    optimize_patches,
    parametrize,
    patch_ncc_scores,
    photometric_objective,
    unparametrize,
)
