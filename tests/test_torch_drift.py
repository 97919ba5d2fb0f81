"""The kernels' drift probe (`utils/drift.py`) on the CPU, and on the card.

On the CPU the measured side is the plain version in float32
(`device="cpu"`), held to the same env in float64: the reset obs agree
exactly (both sides share the reset), and every step's drift is finite.
The bounds cover the JAX module's envs, no others. The `cuda` test runs
`assert_drift_bounded` for both envs on the card (K1, K2) and skips here;
there, `python -m pytest tests/test_torch_drift.py -m cuda --noconftest`.
"""

import math

import pytest
import torch

from balance_robot_tpu_torch.utils import drift

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", ["Env01-v2", "Env03-v2"])
def test_obs_drift_on_the_cpu(env_id):
    d = drift.obs_drift(env_id, steps=2, batch=2, device="cpu")
    assert len(d) == 3 and d[0] == 0.0
    assert all(math.isfinite(x) for x in d)


def test_bound_keys_equal_the_jax_modules():
    # imported here: the card's machine runs the `cuda` test without JAX
    from balance_robot_tpu.utils import drift as jdrift
    assert set(drift.STEP1_BOUND) == set(jdrift.STEP1_BOUND)
    assert set(drift.STEP5_BOUND) == set(jdrift.STEP5_BOUND)
    assert set(drift.STEP_UNIFORMS) == set(jdrift.STEP1_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Env01-v2", "Env03-v2"])
def test_drift_bounded_on_the_card(env_id):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build K1 and K2)")
    d = drift.assert_drift_bounded(env_id)
    assert len(d) == 6
