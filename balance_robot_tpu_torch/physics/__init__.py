"""Physics package: solver-grade presets.

`fast_solver(params)` returns a training-grade copy of a RobotSceneParams:
newton_iters=4 / ls_iters=6 instead of the exact 8/10. Iteration counts are
runtime arguments of the CUDA kernel, so switching grade rebuilds nothing.
"""
from dataclasses import replace


def fast_solver(params, newton_iters=4, ls_iters=6):
    return replace(params, newton_iters=newton_iters, ls_iters=ls_iters)
