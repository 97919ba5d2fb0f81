"""The plain reference the benchmark holds the port's timed path to.

Plain PyTorch, run in float64: a frozen copy of the plain physics
(`physics/`), the envs' step semantics (`envs/`, one file per env id) and
the 64-64 policy's mean (`mlp.py`). It imports nothing of the port, nor
`jax`, nor the JAX package, and takes nothing the port computed: the
harness hands both sides the same inputs.
"""
