"""The port's simulator layer: its own copy of the JAX package's ``sim/``.

Host-only numpy and standard library; the CARLA server stays an external
process. ``carla_env.CarlaDrivingEnv`` connects to it through the ``carla``
client, which every module imports lazily inside its functions, so the
package imports without it (the tests install ``tests/mock_carla.py`` in its
place). The env's camera frame goes to the port's ``InteractAgent``, whose
planner runs on the card; nothing here computes on the device. The
birdview renderer and the map rasterizer need ``cv2`` (and ``h5py`` for
their ``.h5`` files), the collector writes its PNGs with ``data/png.py``.
"""

from .birdview import BirdviewRenderer
from .map_raster import LaneStrip, rasterize_map, save_h5, strips_from_carla_map
from .collector import DataCollector, count_current_saved, world_to_agent
from .collect_loop import collect_loop, collect_sharded, merge_shards
from .create_agent import ENV_FACTORIES, create_env, create_server, register_env_factory
from .criteria import (
    Blocked,
    CollisionTracker,
    EncounterLight,
    OutsideRouteLaneTracker,
    RouteDeviation,
    RunRedLight,
    RunStopSign,
)
from .expert import ExpertPID, LocalPlanner, RoadOption, expert_control
from .noiser import ExpertNoiser
from .obs_handler import OBS_MODULES, ObsHandler, register_obs_module
from .obs import (
    ActorState,
    control_obs,
    object_finder_obs,
    process_obs,
    speed_obs,
    velocity_obs,
)
from .reward import (
    ValeoActionReward,
    desired_speed_from_hazards,
    lbc_hazard_vehicle,
    lbc_hazard_walker,
)
from .route_planner import (
    GlobalRoutePlanner,
    RouteTracker,
    downsample_route,
    location_route_to_gps,
    location_to_gps,
)
from .scenario_actors import (
    BasicAgent,
    ConstantSpeedAgent,
    ScenarioActorHandler,
    ScenarioVehicle,
)
from .server_utils import CarlaServerManager, kill_carla
from .suites import (
    SUITES,
    TransformSpec,
    build_corl2017_tasks,
    build_endless_tasks,
    build_leaderboard_tasks,
    build_nocrash_tasks,
    WEATHER_GROUPS,
    build_suite_tasks,
    parse_suite_routes,
)
from .terminal import (
    LeaderboardDaggerTerminal,
    LeaderboardTerminal,
    ValeoStuckTerminal,
    ValeoTerminal,
)
from .traffic_lights import (
    LaneObservation,
    StopSignRegistry,
    TrafficLightRegistry,
    lane_observation,
)
from .weather import DynamicWeather, Storm, Sun

__all__ = [
    "DataCollector",
    "count_current_saved",
    "world_to_agent",
    "collect_loop",
    "collect_sharded",
    "merge_shards",
    "CarlaServerManager",
    "kill_carla",
    "create_server",
    "create_env",
    "register_env_factory",
    "ENV_FACTORIES",
    "Blocked",
    "CollisionTracker",
    "EncounterLight",
    "OutsideRouteLaneTracker",
    "RouteDeviation",
    "RunRedLight",
    "RunStopSign",
    "ValeoActionReward",
    "desired_speed_from_hazards",
    "lbc_hazard_vehicle",
    "lbc_hazard_walker",
    "ValeoTerminal",
    "ValeoStuckTerminal",
    "LeaderboardTerminal",
    "LeaderboardDaggerTerminal",
    "ExpertNoiser",
    "ObsHandler",
    "OBS_MODULES",
    "register_obs_module",
    "DynamicWeather",
    "Sun",
    "Storm",
    "ExpertPID",
    "LocalPlanner",
    "RoadOption",
    "expert_control",
    "ActorState",
    "speed_obs",
    "control_obs",
    "velocity_obs",
    "object_finder_obs",
    "process_obs",
    "ScenarioActorHandler",
    "ScenarioVehicle",
    "ConstantSpeedAgent",
    "BasicAgent",
    "SUITES",
    "WEATHER_GROUPS",
    "TransformSpec",
    "build_endless_tasks",
    "build_nocrash_tasks",
    "build_corl2017_tasks",
    "build_leaderboard_tasks",
    "build_suite_tasks",
    "parse_suite_routes",
    "GlobalRoutePlanner",
    "RouteTracker",
    "downsample_route",
    "location_route_to_gps",
    "location_to_gps",
    "TrafficLightRegistry",
    "StopSignRegistry",
    "LaneObservation",
    "lane_observation",
    "BirdviewRenderer",
    "LaneStrip",
    "rasterize_map",
    "save_h5",
    "strips_from_carla_map",
]
