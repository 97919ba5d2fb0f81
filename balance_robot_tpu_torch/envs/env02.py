"""Env02-v1: balance with per-episode randomized wheel/floor friction.

Counterpart of `balance_robot_tpu/envs/env02.py`. Reset draws one
U(0.5, 1.0) friction per env into `aux["friction"]`; it replaces the
wheel-floor pair friction in the contact rows (kernel K1's friction
branch), while the chassis-floor contact keeps mu = 1.
"""

from ..physics import robot_core as rc
from .env01 import Env01V1


class Env02V1(Env01V1):
    id = "Env02-v1"
    max_episode_steps = 6000
    params = rc.ENV02_PARAMS

    def _init_aux(self, n):
        return {"friction": self._uniform(n) / 2.0 + 0.5}
