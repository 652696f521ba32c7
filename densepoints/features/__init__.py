from densepoints.features.descriptors import brief_pattern, compute_descriptors
from densepoints.features.detector import (
    detect_keypoints,
    gaussian_blur,
    harris_response,
)
from densepoints.features.matching import (
    direct_epipolar_pair,
    filter_matches_epipolar,
    hamming_distance_matrix,
    match_pair,
    match_pair_absolute,
)
from densepoints.features.tracks import build_tracks, triangulate_tracks
