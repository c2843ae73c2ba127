from .transforms import (
    pose_to_box,
    box_to_edges,
    world_to_ego,
    edges_to_ego,
    polygon_area,
)
from .segments import (
    segments_intersect,
    segment_intersection_points,
    ray_hits,
)
from .clip import convex_clip_area

__all__ = [
    "pose_to_box",
    "box_to_edges",
    "world_to_ego",
    "edges_to_ego",
    "polygon_area",
    "segments_intersect",
    "segment_intersection_points",
    "ray_hits",
    "convex_clip_area",
]
