"""A frozen copy of the port's plain physics (the kernels' plain versions).

Copied once, when the benchmark was defined, so that a later change to the
port's physics or kernels cannot move the yardstick it is held to. The
modules keep their names and relative imports; only this file is new.
"""
from dataclasses import replace


def with_grade(params, solver):
    """`params` at a solver grade: `solver` is a dict of the scene's
    settings that the grade changes (such as newton_iters, ls_iters);
    empty keeps the registered ones."""
    return replace(params, **solver)
