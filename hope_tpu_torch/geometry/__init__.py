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
    point_segment_distance,
    ray_hits,
    boxes_collide,
)
from .clip import convex_clip_area, convex_clip_area_sh

__all__ = [
    "pose_to_box",
    "box_to_edges",
    "world_to_ego",
    "edges_to_ego",
    "polygon_area",
    "segments_intersect",
    "segment_intersection_points",
    "point_segment_distance",
    "ray_hits",
    "boxes_collide",
    "convex_clip_area",
    "convex_clip_area_sh",
]
