from .controller import Controller
from .evaluator import RouteEvaluator
from .fake_env import FakeDrivingEnv, ReplayEnv
from .gps import gps2xyz, xyz2gps
from .interact_agent import InteractAgent
from .leaderboard_agent import DiffusionAgent, get_entry_point
from .pid import PIDController
from .plan import DiffusionPlanner, agent_to_world, process_next_waypoint, way_point_to_pixel
from .planner import RoutePlanner
from .routes import parse_routes_xml, parse_scenarios_json, route_length_m
from .scoring import PENALTIES, EpisodeCounters, episode_stats
from .statistics import aggregate, cal_std

__all__ = [
    "PIDController",
    "Controller",
    "RoutePlanner",
    "RouteEvaluator",
    "EpisodeCounters",
    "episode_stats",
    "PENALTIES",
    "gps2xyz",
    "xyz2gps",
    "parse_routes_xml",
    "parse_scenarios_json",
    "route_length_m",
    "DiffusionPlanner",
    "agent_to_world",
    "process_next_waypoint",
    "way_point_to_pixel",
    "InteractAgent",
    "DiffusionAgent",
    "get_entry_point",
    "FakeDrivingEnv",
    "ReplayEnv",
    "aggregate",
    "cal_std",
]
