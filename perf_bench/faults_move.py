"""Faults planted in the move stack's timed path (`envs/move.py` and what
it runs), for the check that each comes out as not correct: in the CPU
tests (`tests/test_perf_bench_move.py`) at a tiny size, and on the card
at the cell's own size through `control.py --fault` once `faults.py` is
given the fault (`python -c "from perf_bench import control, faults,
faults_move; faults.unchanged_walls = faults_move.unchanged_walls;
control.main([...])"`). Each fault takes `patch(obj, name, value)`, as
`faults.py`'s do.
"""

from balance_robot_tpu_torch.envs import move
from balance_robot_tpu_torch.ops import quant


def unchanged_walls(patch):
    """K3's control step returning its state unchanged."""
    patch(move, "control_step",
          lambda qpos, qvel, ws, *a, **k: (qpos, qvel, ws))


def inner_zero_point_dropped(patch):
    """The int8 inner policy's output requantized without its zero point
    (dequantized with it, as before)."""
    def policy_fn(qm, device):
        layers = quant.device_layers(qm, device)
        no_zp = layers._replace(out_q=layers.out_q._replace(zero_point=0))

        def fn(obs):
            q_act = quant.int8_forward(no_zp,
                                       quant.quantize_obs(obs, layers.in_q))
            return quant.dequantize_action(q_act, layers.out_q)
        return fn
    patch(move.quant, "int8_policy_fn", policy_fn)


def ray_2_read_as_ray_1(patch):
    """The lidar's ray 2 read where ray 1 is."""
    lidar = move.lidar_distances

    def misread(qpos):
        d = lidar(qpos)
        return d[:, [0, 1, 1, 3, 4, 5, 6, 7]]
    patch(move, "lidar_distances", misread)


FAULTS = [unchanged_walls, inner_zero_point_dropped, ray_2_read_as_ray_1]
