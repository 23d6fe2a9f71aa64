from .plan import DiffusionPlanner, agent_to_world, process_next_waypoint, way_point_to_pixel

__all__ = ["DiffusionPlanner", "agent_to_world", "process_next_waypoint", "way_point_to_pixel"]
