"""CARLA server lifecycle management (reference: misc/server_utils.py:13-57).

The port's own copy of the JAX package's ``sim/server_utils.py``, which it may not import.

Shell-launches the UE4 server binary at 10 fps in server mode, with
off-screen flags chosen by CARLA version; teardown is killall-based.
Host-side only: these paths run in deployments with a CARLA install.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time

log = logging.getLogger(__name__)

__all__ = ["kill_carla", "CarlaServerManager"]


def kill_carla():
    kill_process = subprocess.Popen("killall -9 -r CarlaUE4-Linux", shell=True)
    kill_process.wait()
    time.sleep(1)
    log.info("Kill Carla Servers!")


def _version_at_least(version: str, target=(0, 9, 12)) -> bool:
    parts = []
    for tok in version.strip().split("."):
        try:
            parts.append(int(tok))
        except ValueError:
            break
    return tuple(parts) >= target


class CarlaServerManager:
    def __init__(self, carla_sh_str: str, port: int = 2000, config=None, t_sleep: int = 5):
        self._carla_sh_str = carla_sh_str
        self._t_sleep = t_sleep
        version_file = os.path.join(os.path.dirname(carla_sh_str), "VERSION")
        carla_version = "0.9.10"
        if os.path.exists(version_file):
            with open(version_file) as f:
                carla_version = f.read().strip()
        self.larger_than_0_9_12 = _version_at_least(carla_version)
        env_config = dict(config) if config is not None else {"gpu": 0}
        env_config["port"] = port
        self.env_config = env_config

    def start(self, off_screen: bool = False):
        kill_carla()
        cmd = (
            f"bash {self._carla_sh_str} -fps=10 -carla-server "
            f"-carla-rpc-port={self.env_config['port']}"
        )
        if off_screen:
            cmd = f"{cmd} -RenderOffScreen" if self.larger_than_0_9_12 else f"DISPLAY= {cmd} -opengl"
        log.info(cmd)
        subprocess.Popen(cmd, shell=True, preexec_fn=os.setsid)
        time.sleep(self._t_sleep)

    def stop(self):
        kill_carla()
        time.sleep(self._t_sleep)
        log.info("Kill Carla Servers!")
