"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--serve03-steps N]

Phases, in order; any failure exits non-zero before the final line:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: K1 (csrc/control_step.cu), K2 (csrc/control_step14.cu) and K3
     (csrc/control_step_walls.cu) with nvcc, all compiles started together,
     and ptxas's registers, stack and spills of each beside its launch
     shape (K1's and K3's two and K2's three instantiations, each from the
     batch at which it starts);
  3. each kernel against its plain PyTorch version on the card, B = 257
     (ragged), one control step (250 substeps), the same inputs on both
     sides: K1 on robot-floor states, at B = 257 and at a ragged batch
     above its crossover (its two instantiations; a second launch above it
     must give the same bits), K2 on robot + block states on which
     every block collider must have been active, K3 on robot-at-the-wall
     states on which every wall collider must have been active, at B = 257
     and at a ragged batch above its crossover (its two instantiations;
     float32 against the plain version in float64, see K3_F32_TOL; a
     second launch must give the same bits); K1 and K2 also at the turbo
     grade (Newton 2 / line search 4, `train_run --solver turbo`) on their
     fast cases' states, in float64 and float32;
  4. main paths at 4096 envs, 25 control steps, the checked-in PPO policies
     (forward + sample), fast solver: Env01-v2 must launch K1, Env03-v2 K2
     and EnvMove05-v1 (with its int8 inner policy inside every step) K3,
     each exactly once per step and no other kernel;
  5. serving, deterministic policy: 256 fresh Env01-v2 episodes of up to 200
     steps, a few Env02-v1 steps (K1's friction branch); 2 x 512 fresh
     Env03-v2 episodes at the exact solver grade over the full 1200-step
     horizon (--serve03-steps cuts the depth), a few Env03-v1 and
     Env03-v1-fail steps; 2 x 256 fresh EnvMove05-v1 episodes over the full
     700-step horizon at the fast and at the exact grade, held to the JAX
     package's float32 return (see RETURN_MOVE_JAX), a few Cal01 steps, and
     the int8 inner policy on the card against exact integer arithmetic
     (torch's CPU int8 path beside it, with its own tanh and with the
     card's check's one tanh);
  6. times: K1, K2 and K3 and their plain versions at B = 4096 on the main
     paths' states, against each kernel's bound; K3 with every env at a wall
     at B = 4096 and 512; K1 at B = 256 (Env01 serving's batch), K2 at
     B = 1024 at the exact grade (the flagship serving's batch and grade)
     and K3 at B = 512 at both grades (EnvMove05-v1 serving's batch);
  7. training (outside inference mode), PPO at the CLI's training defaults
     (1024 envs x 32 rollout steps, minibatch 1024, 10 epochs, the 64-64
     actor-critic) and gamma 0.999, fast solver: (a) Env01-v2 from a fresh
     init, 3 iterations, which must launch K1 once per rollout step and no
     other kernel; (b) the curriculum's second stage, Env03-v2 with the
     privileged critic warm-started from models/Env01-v2_PPO, 2 iterations,
     K2 only, the padded critic's value equal to the unpadded one's before
     the first update and the privileged rows nonzero after it; (c) the
     runner (`train.runner.train`) on Env01-v2 for 2 iterations with an
     eval of 5 episodes after each, its artifacts, and the resume state
     read back bit for bit. Each prints its ms per iteration, rollout and
     update (CUDA events) and its training env-steps/s;
  8. the CLI (`balance_robot_tpu_torch/cli.py`), through `cli.main(argv)`
     in this process, from a temporary working directory under build/ with
     copies of the checkpoints it reads (the repo's models/, logs/ and
     movies/ must be left as they were): (a) `test -e Cal01` with
     models/Env01-v2_PPO (one episode of 201 steps and 200 grace steps,
     one telemetry row and one K1 launch at B = 1 per step), then
     `cli._run_episodes` on Env03-v2 (models/Env03-v2_r2i, K2) and
     EnvMove05-v1 (models/EnvMove05-v1_PPO_r4, K3's 32-lane team) at B = 1,
     each step launching only its scene's kernel; ms per control step by
     the host clock; each kernel's launch at step CLI_HOLD_AT of its loop
     (B = 1, exact grade, float32) kept and held to its plain version on
     the same inputs, in float32 and in float64 (K3's float32 against the
     plain version in float64), then timed there by CUDA events beside
     the plain version and the bound;
     (b) `convert` (it stops at the SavedModel where TensorFlow is absent),
     its .onnx equal to the committed one, `onnx_runtime.session`
     on the native leg built into build/torch_native/, its actions within
     1e-5 of the card's policy mean on ONNX_OBS obs, the native int8
     runtime's codes equal to the card's `int8_forward` on the .brq, then
     `test-onnx -e Cal01`; (c) `bc-init -e Env01-v2` at the CLI's defaults
     (K1 at B = 256, one launch per collection step), the clone's survival
     within 3 standard errors of the JAX package's (BC_SURVIVAL_JAX), and
     K1's launch at collection step BC_HOLD_AT (exact grade, float32) held
     to its plain version as in (a);
     (d) `train -a PPO`, `-a A2C`, `-a SAC`, `-a TD3` and `-a DDPG` on
     Env01-v2 for 2 iterations with an eval after each, K1 once per env
     step, their artifacts; the off-policy params with the keys and
     shapes of the committed models/Env01-v2_<ALGO>, their resume state
     read back bit for bit, nothing under movies/; `convert` of the SAC
     artifact writes its .onnx. `chip_smoke.cli_phase(modules)` runs
     phase 8 alone (with `build_kernels()` for the modules);
  9. the off-policy trainers (outside inference mode) at the factory's
     defaults (256 envs, a 1e6-row buffer on the card, batch 256, one env
     step and one update per iteration), gamma 0.999, fast solver:
     (a) SAC on Env01-v2 from a fresh init, 300 iterations, one K1 launch
     per iteration and no other kernel, ptr = 300 x 256, every param
     finite, log_alpha moved; (b) TD3 and DDPG likewise, 100 iterations
     each, and TD3's actor_t unchanged across an update at an odd
     grad_steps, moved across one at an even; (c) SAC on Env03-v2 with
     the privileged critic warm-started from models/Env03-v2_SAC (Q's
     first layer 8 -> 16 rows), 50 iterations, K2 only, the padded Q equal
     to the checkpoint's on the first update's batch, the privileged rows
     nonzero after the updates; each prints ms per iteration, collect and
     update (CUDA events), training transitions/s and the buffer's bytes;
     (d) models/Env01-v2_SAC and _TD3 served through OffPolicy's
     evaluator, 256 fresh episodes of 200 steps each, survival >=
     SURVIVAL_FLOOR; (e) the harvest of fatal states
     (`train/harvest.py`) on Env03-v2 with models/Env03-v2_r2i, 512
     episodes of at most 300 steps, block_delay 0.04, chunks of 50,
     through K2: the bank's invariants, and bank[0] restarted at t = 0 on
     a fresh generator for one finite K2 step.
     `chip_smoke.off_policy_phase(modules)` runs phase 9 alone;
 10. PPO data-parallel over ranks (`parallel/`), at phase 7a's config,
     fast grade: (a) `distributed.initialize` with a file:// rendezvous,
     a NCCL world of one rank, Env01-v2 for 2 iterations through the
     sharded path (`mesh.shard_train_state`, one gather per iteration):
     params, Adam moments, stats and metrics bit-equal to the unsharded
     run of the same seed, K1 launched once per rollout step; rollout,
     gather (and its bytes) and update ms by CUDA events; (b) two
     processes of this script (--par-rank) on the one card over gloo,
     2 x 512 envs: Env01-v2 in float64 (1 iteration) and float32 (2), and
     Env03-v2 with the privileged critic warm-started from
     models/Env01-v2_PPO (1, K2); each rank's launches counted, the
     ranks' train states bit-equal to each other and to one process of
     1024 envs; a rank that dies or does not finish in PAR_TIMEOUT_S
     fails the script; (c) `utils/drift.py` on K1
     (Env01-v2) and K2 (Env03-v2), 16 envs, 5 steps, seeds 0 and 1,
     against float64 on the CPU, within its bounds. `chip_smoke.parallel_phase(modules)` runs
     phase 10 alone;
 11. the flagship's selection workflow (`train/burst.py`, `sweep.py`,
     `eval_policy.py`) through their `main(argv)`, from a temporary
     directory under build/ with copies of the checkpoints, Env03-v2 at the
     training grade through K2, each part's K2 launches counted and
     printed: (a) the burst ratchet from models/Env03-v2_r2i at the JAX
     tool's defaults (1024 envs x 32 steps, minibatch 1024, 10 epochs,
     gamma 0.999, lr 5e-5), one burst of 2 iterations and 2 snapshots,
     512-episode evals cut to SEL_STEPS_11A steps, `--confirm --min-win -1`
     (a forced accept, so the confirm set and the pooled gate run): the
     JAX tool's history schema, accepted or reverted by the gate,
     best_model.npz read back bit for bit, ms per iteration (CUDA events)
     and seconds per eval; (b) a hardened burst (survival reward, back_frac
     0.7, block_delay 0.2, privileged critic, failure replay of 512
     episodes at 0.25) of one iteration, its first eval at the full
     1200-step horizon, its harvest and second eval cut to SEL_STEPS_11B
     steps: the bank not empty, every rollout reward 1.0, the replayed
     share of the resets and the front share of the plain slots within 3
     standard errors, and K2's first rollout launch (replayed bank states
     in its batch) held to the plain version in float32 and float64; (c)
     the paired eval of r2i at seed 0, 512 x 1200, bit-equal to 11b's
     first eval (the same call), its full-horizon rate inside
     SEL_RATE_BAND, and
     11a's snapshot at seed 0 resetting the same qpos; (d) the sweep of a
     copy of models/Env03-v2_PPO (`--every 4`, 256 episodes) and the eval
     of r2i (float and `--int8`, 512 episodes), both cut to SEL_STEPS_11D
     steps, and the eval of models/Env01-v2_SAC on Env01-v2 (256 x 200,
     K1), its survival within 3 standard errors of 9d's 0.8633.
     `chip_smoke.selection_phase(modules)` runs phase 11 alone;
 12. the run drivers, the PPO profiler and round 4's teacher-student
     recipe (`train/train_run.py`, `train_offpolicy.py`,
     `profile_train.py`, `widen_policy.py`, `distill_teacher.py`) through
     their `main(argv)`, from a temporary working directory under build/
     with copies of the checkpoints, each part's launches counted:
     (a) `train_run Env03-v2 --privileged-actor --init <r2i> --gamma 0.999
     --lr 1e-4` (a teacher, round 4's settings) for 2 iterations at the
     defaults (1024 envs x 32 steps), the runner's evals cut to
     RUNNER_EVAL_STEPS: 32 K2 launches per iteration, the padded actor's
     mean on [obs, priv] bit-equal to r2i's on obs before the first update,
     the privileged rows of pi_w1 nonzero after it, the run's params with
     14 inputs; then `Env01-v2 --solver turbo` for 1 iteration, 32 K1
     launches at Newton 2 / line search 4; (b) `train_offpolicy SAC
     Env01-v2` at the tool's defaults (64 envs, 8 updates per iteration,
     batch 256, a 1e6-row buffer, learning_starts 10,000) until 20
     iterations past learning_starts: no update before, exactly 8 per
     iteration after, collect and update ms by CUDA events; (c)
     `profile_train` at its defaults with `--reps 2 --trace`: its lines,
     the traced iteration's kernels and busy share per phase, and the
     update's ten largest kernels; (d) `widen_policy <r2i> --env Env03-v2
     --priv --hidden 256`: the tool's exactness check on the card, the
     file loads; (e) `distill_teacher --teacher
     models/Env03-v2_teacher/best_model.npz --init <r2i> --iters 2
     --eval-every 2` at the defaults (1024 envs, 64 collect steps, mb
     4096), the two evals cut to DISTILL_EVAL_STEPS: 64 K2 launches per
     collect, beta 1 then 0, the buffer at 65,536 then 131,072 rows, the
     teacher's labels at the first collect's 33rd step within 1e-5 of its
     float64 mean on the CPU, that step's K2 inputs held to the plain
     version (`hold_on_path`), best_model.npz with 6 inputs.
     `chip_smoke.tools_phase(modules)` runs phase 12 alone;
 13. the research tools (`train/value_probe.py`, `failure_forensics.py`,
     `oracle_probe.py`, `mpc_dagger.py` with `recovery.py`,
     `bc_finetune.py`, `move_probe.py`, `move_bc_init.py`,
     `make_inner_policy.py`) through their `main(argv)`, from a temporary
     working directory under build/ with copies of the checkpoints and
     data, each part's launches counted, the depth cut as the phase-13
     constants say: (a) `value_probe` of models/Env03-v2_r3a (the
     privileged critic), 128 episodes, and `failure_forensics` of r2i, 512
     with `--dump`, K2 once per step; (b) `oracle_probe` of r2i (pop 128,
     horizon 100): K2 launches by part (harvest, the seed mean at F, each
     generation at F x pop, the replay at F), the population-recoverable
     share never falling, the replayed best sequences scoring what they
     scored in their generation bit for bit, the dump's rows, one
     generation launch held to the plain version; (c) `mpc_dagger` of r2i
     (pop 64, plan 20, tail 60, exec 4): launches by part, the expert and
     ceiling lines, the dump's pairs, one plan launch held; (d)
     `bc_finetune` of r2i on runs/dagger_mpc_r5.npz and (c)'s dump with
     the KL anchor at 0.1: the value net and log_std bit-equal to r2i's,
     the selection winner, the file loads; (e) `move_probe` at its
     defaults (64 CYCLE and 48 THRESH members, 4 seeds, 700 steps): 700 K3
     launches per family on the team instantiation, one held, the starts
     and four members' returns against the JAX package's from the same
     starts (tests/move_probe_reference.py), each family's best and the
     log's best at >= 900 beside runs/move_probe_r4d.log's; (f)
     `move_bc_init` of the best THRESH member (log_std -1.5) and
     `make_inner_policy` into a temporary assets directory, byte-equal to
     the committed asset. The repo's models/, logs/, movies/, runs/ and
     the package's assets must be as they were.
     `chip_smoke.research_phase(modules)` runs phase 13 alone.
It ends with one JSON line per the contract: {"ok": true, "device": ...}.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

N_ENVS = 4096          # main path batch (bench.py's)
N_STEPS = 25           # control steps of the main paths
CHECK_B = 257          # ragged batch of the kernel-vs-plain checks
SERVE_EPISODES = 256
SERVE_STEPS = 200
SURVIVAL_FLOOR = 0.75  # the JAX package measured 0.89 on this protocol
SERVE03_EPISODES = 512     # per draw; the two draws run as one batch of 1024
SERVE03_DRAWS = 2
SERVE03_STEPS = 1200       # the full Env03-v2 horizon
SERVE03_SEED = 1001
# pooled full-horizon survival of models/Env03-v2_r2i: the JAX package
# records 0.895 pooled with draws between 0.84 and 0.92
SURVIVAL03_BAND = (0.84, 0.92)
TIMED_LAUNCHES = 11
SERVE_MOVE_EPISODES = 256   # per draw; the two draws run as one batch of 512
SERVE_MOVE_DRAWS = 2
SERVE_MOVE_SEED = 2001
# models/EnvMove05-v1_PPO_r4 over the full 700-step horizon, deterministic.
# The JAX package records 98.8% / 99.6% survival and returns 1073.1 / 1064.7
# on two draws of 256 (runs/move_r5_pooled.log), taken where the backend's
# default precision rounds the operands of a float32 matrix product to
# bfloat16. The reward's speed term is 0.03 (ws - tws) / tws with tws = 20 x
# the policy's previous action, which this policy holds near 0.001, so its
# return hangs on the 4th digit of the policy's output. The same JAX
# evaluation on the same 2 x 256 start states with float32 products kept in
# float32, as the port keeps them, returns RETURN_MOVE_JAX (mean, standard
# error; `tools/move_reference_cpu.py`, exact grade, on a CPU;
# `runs/move_cpu_reference.log`), and 1056 on the first 256 of them with the
# policy's operands rounded to bfloat16.
# The port's return, through its own `policy_mean`, is held to within 3
# standard errors (this run's and that one's combined) of that figure, and
# survival to its floor. The env's registered reward threshold is printed
# beside it: neither package reaches it in float32.
SURVIVAL_MOVE_FLOOR = 0.95
RETURN_MOVE_JAX = (845.35, 24.46)
RETURN_MOVE_REGISTERED = 900.0
# share of int8 outputs that may differ by 1 LSB between two correct tanh's
INT8_TANH_SHARE = 128 * 2 * 128 * 2.0 ** -22
# phase 7: PPO at the CLI's training defaults (balance_robot_tpu/cli.py,
# `train`) with the quickstart's gamma (README)
TRAIN_CONFIG = dict(n_envs=1024, n_steps=32, minibatch_size=1024,
                    n_epochs=10, gamma=0.999)
TRAIN_ITERS_01 = 3
TRAIN_ITERS_03 = 2
TRAIN_ITERS_RUNNER = 2
# phase 9: the off-policy trainers at the factory's defaults (256 envs,
# buffer 1e6, batch 256, one env step and one update per iteration), fast
# grade, gamma 0.999 as in phase 7
OFF_GAMMA = 0.999
OFF_ITERS = {"SAC": 300, "TD3": 100, "DDPG": 100}
OFF_ITERS_03 = 50
POLICY03_SAC = "models/Env03-v2_SAC/best_model.npz"
# 9d: the committed off-policy checkpoints served as phase 5a serves PPO
OFF_SERVED = {"SAC": "models/Env01-v2_SAC/best_model.npz",
              "TD3": "models/Env01-v2_TD3/best_model.npz"}
OFF_SERVE_SEED = 4001
# 9e: the harvest of fatal states (the JAX package's test settings at the
# serving batch)
HARVEST_EPISODES = 512
HARVEST_STEPS = 300
HARVEST_CHUNK = 50
HARVEST_DELAY = 0.04
HARVEST_SEED = 3
# phase 10: PPO over ranks at phase 7a's config, and the drift probe. 10a:
# a NCCL world of one rank; 10b: PAR_RANKS processes on one card over gloo
# (NCCL refuses two ranks on one card), PAR_ENVS envs in all, each case
# (env, dtype, iterations, privileged critic) against one process; 10c:
# `utils/drift.py` on DRIFT_BATCH envs
PAR_ITERS = 2
PAR_RANKS = 2
PAR_ENVS = TRAIN_CONFIG["n_envs"]
PAR_CASES = {"Env01-v2 float64": ("Env01-v2", torch.float64, 1, False),
             "Env01-v2 float32": ("Env01-v2", torch.float32, 2, False),
             "Env03-v2 privileged": ("Env03-v2", torch.float32, 1, True)}
PAR_TIMEOUT_S = 300
DRIFT_BATCH = 16
DRIFT_STEPS = 5
DRIFT_SEEDS = (0, 1)
# phase 11: the selection workflow (`train/burst.py`, `sweep.py`,
# `eval_policy.py`) on Env03-v2 from POLICY03, through K2. The ratchet's
# evals of SEL_EPISODES episodes (its default). 11b's first and 11c's run
# the full 1200 steps, 11b's second and its harvest SEL_STEPS_11B; 11a's
# ten and 11d's six are cut to 100 steps so that the script stays under
# 960 s (a 512-episode eval costs 27 ms per step on an H100, PERF.md)
SEL_EPISODES = 512
SEL_STEPS_11A = 100
SEL_STEPS_11B = 600
SEL_STEPS_11D = 100
SEL_SWEEP_EPISODES = 256
SWEEP_RUN = "models/Env03-v2_PPO"
SEL_SNAP_STEPS = 50
REPLAY_FRAC = 0.25
BACK_FRAC = 0.7
# r2i's full-horizon rate at 512 fast episodes in the JAX package: 84.0%
# and 89.8% (runs/burst_r5a.log, primary and confirm sets of
# models/Env03-v2_PPO, the same bytes), 86.5% (runs/burst_r2j.log), widened
# by 3 standard errors
SEL_RATE_BAND = (0.795, 0.943)
# phase 12: the run drivers, the profiler and round 4's teacher-student
# recipe through their main(argv). The runner's evals in 12a are cut to
# RUNNER_EVAL_STEPS steps and the distillation's two evals in 12e to
# DISTILL_EVAL_STEPS; 12b runs SAC at the tool's defaults until
# OFF_ITERS_PAST_STARTS iterations past learning_starts; 12e keeps the
# inputs of the first collect's K2 launch number HOLD_STEP_12E (from 0)
TEACHER03 = "models/Env03-v2_teacher/best_model.npz"
RUNNER_EVAL_STEPS = 20
DISTILL_EVAL_STEPS = 100
OFF_ITERS_PAST_STARTS = 20
HOLD_STEP_12E = 32
# 9d's survival of models/Env01-v2_SAC, 256 x 200, fast grade, on an
# H100 (PERF.md)
SAC_SURVIVAL_9D = 0.8633
# phase 13: the research tools through their main(argv), at full model
# width. The depth cuts: Env03-v2's horizon to RESEARCH_STEPS in the value
# probe, the forensics and the harvests, to RESEARCH_STEPS_13D in the
# clone's anchor episodes and evals; the oracle and the MPC expert to
# RESEARCH_FATAL banked states, the oracle to ORACLE_ITERS generations, the
# expert to MPC_REPLAY steps, the clone to BC_STEPS Adam steps. Each tool's
# K2 launch number HOLD_AT_13 (from 0) of its first rollout at F x P is
# kept and held to the plain version: qpos and qvel in float32 within
# K2_F32_TOL, all three in float64 within F64_TOL, and the float32 warm
# start against the plain version in float64, within WS_F64_MARGIN times
# the plain version's own float32 departure from it (at least
# K2_F32_TOL's ws_rel). Not against the plain float32: on the CEM
# candidates' impacts (a 64 g block at 7.5 m/s within a centimetre of the
# chassis) a contact that switches on or off in the last substep moves
# qacc by its own size in float32, in both versions, each its own way. On
# 13b's launch (B = 1,792, H100 80GB HBM3, 700 W) K2's warm start departed
# from the plain version in float64 by 0.135 of the batch's largest |ws|
# on 5 envs, the plain version's own float32 by 0.598 on 7, K2 from the
# plain version in float32 by 1.486; on 13c's (B = 896) both by 0.0112;
# K2 in float64 agreed to 6.5e-14 and qvel stayed within 1.8e-2 (PERF.md).
# The margin of 2 lets K2's float32 depart up to twice as far as the plain
# version's does on the same inputs
WS_F64_MARGIN = 2.0
POLICY03_R3A = "models/Env03-v2_r3a/best_model.npz"
DAGGER_R5 = "runs/dagger_mpc_r5.npz"
# move_probe's returns on the TPU (runs/move_probe_r4d.log) come from four
# starts of jax.random keys that the port cannot replay, and EnvMove05-v1's
# step draws no noise, so the starts decide the returns: one start gives a
# member 700 and another 4,000. Its claim, that both scripted families
# clear the registered 900 over 700 steps, is held for the port's best
# member and for the log's; the ranking is printed beside the log's, not
# held. What is held: the tool's starts are the 4 x 13 reset uniforms
# MOVE_PROBE_UNIFORMS (the card's generator seeded with 7, read on an
# H100), and from them tests/move_probe_reference.py runs the JAX tool's
# episode through the JAX package on the CPU; MOVE_PROBE_JAX is its
# float64 mean return of the members that the log and the port rank first.
# The port's float32 returns are held within MOVE_PROBE_REL of those: the
# JAX package's own float32 departs from its float64 by up to 1.6% there
# (THRESH (1, 0.1, 1, 0.001): 2303.77 against 2267.70), and the log's
# starts moved THRESH (4, 0.1, 1, 0.001) by 17% (2353.9 against 1932.8)
MOVE_PROBE_LOG = "runs/move_probe_r4d.log"
MOVE_PROBE_UNIFORMS = [
    ["0x1.e8c0f40000000p-1", "0x1.faebb60000000p-2", "0x1.e247ae0000000p-1",
     "0x1.2f66ae0000000p-1", "0x1.6632000000000p-1", "0x1.ab77bc0000000p-3",
     "0x1.59bef40000000p-1", "0x1.ec92880000000p-2", "0x1.44443c0000000p-1",
     "0x1.25894e0000000p-1", "0x1.d307100000000p-1", "0x1.7105f00000000p-1",
     "0x1.81e61a0000000p-1"],
    ["0x1.b778260000000p-2", "0x1.e84a1e0000000p-2", "0x1.3262440000000p-1",
     "0x1.c8992c0000000p-1", "0x1.486d940000000p-2", "0x1.633ec60000000p-3",
     "0x1.d2770c0000000p-2", "0x1.650f760000000p-2", "0x1.e70dfe0000000p-1",
     "0x1.5ff2b00000000p-1", "0x1.942ac00000000p-3", "0x1.ba52dc0000000p-3",
     "0x1.4264040000000p-4"],
    ["0x1.2d84120000000p-3", "0x1.e5fc720000000p-1", "0x1.24cf520000000p-1",
     "0x1.e26dfe0000000p-2", "0x1.14d01a0000000p-1", "0x1.6407020000000p-1",
     "0x1.4a57b60000000p-1", "0x1.4f11ae0000000p-1", "0x1.ee269c0000000p-3",
     "0x1.1bf6540000000p-1", "0x1.7f5a280000000p-3", "0x1.aa46300000000p-1",
     "0x1.f7fff20000000p-3"],
    ["0x1.8ce77c0000000p-1", "0x1.697e340000000p-1", "0x1.210b560000000p-6",
     "0x1.370a840000000p-3", "0x1.0e96060000000p-3", "0x1.6e1bd20000000p-3",
     "0x1.d06c4c0000000p-2", "0x1.2e37a40000000p-1", "0x1.b2e5040000000p-3",
     "0x1.fa5a7e0000000p-3", "0x1.ff38e40000000p-1", "0x1.4eb8b40000000p-1",
     "0x1.0401900000000p-5"],
]
MOVE_PROBE_JAX = {
    ("CYCLE", (40.0, 80.0, 1.0, 0.001)): 2397.8687,
    ("CYCLE", (40.0, 160.0, 1.0, 0.001)): 2416.4555,
    ("THRESH", (4.0, 0.1, 1.0, 0.001)): 1932.8246,
    ("THRESH", (1.0, 0.1, 1.0, 0.001)): 2267.7004,
}
MOVE_PROBE_REL = 0.05
RESEARCH_STEPS = 300
RESEARCH_STEPS_13D = 100
RESEARCH_FATAL = 16
ORACLE_ITERS = 4
MPC_REPLAY = 16
BC_STEPS = 1000
HOLD_AT_13 = 9
# phase 8: the CLI. The B = 1 serving loops on Env03-v2 and EnvMove05-v1
# run max_steps + 201 steps unless the robot falls
CLI_SERVE_STEPS = 300
# the launch of each phase-8 path whose inputs are kept and held to the
# plain version: the 151st step at B = 1 (every episode of `cli test` runs
# at least 1 + GRACE_STEPS steps), bc-init's 201st collection step
CLI_HOLD_AT = 150
BC_HOLD_AT = 200
ONNX_OBS = 4096
BC_EVAL_EPISODES = 64
BC_EVAL_STEPS = 400
BC_EVAL_SEED = 3001
# survival (share of BC_EVAL_EPISODES episodes reaching BC_EVAL_STEPS,
# fast grade) of the JAX package's `bc-init -e Env01-v2` at its defaults,
# and its standard error: `bc_reference_cpu.py --seed 0` and
# `--seed 1` on a CPU, 55 of 64 episodes each, pooled over the 128
BC_SURVIVAL_JAX = (0.859375, 0.0307)
POLICY = "models/Env01-v2_PPO/best_model.npz"
POLICY03 = "models/Env03-v2_r2i/best_model.npz"
POLICY_MOVE = "models/EnvMove05-v1_PPO_r4/best_model.npz"

# A kernel vs its plain version after one control step. float64: both sides
# do the same arithmetic in another order (fused multiply-adds on the card,
# batched LAPACK-style Cholesky and array-form colliders in the plain
# version); qpos and qvel agree to ~1e-13 and the warm start (qacc, up to
# ~1e4) to ~1e-9 relative.
F64_TOL = {"qpos": 1e-9, "qvel": 1e-9, "ws_rel": 1e-9}
# float32, K1: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 1.3e-5, qvel 5.9e-3, ws 2.2e-4 relative, over the random
# states at B = 257 and the main path's states at B = 4096 (PERF.md). A
# contact row that activates on one side and not the other moves qvel by
# ~1e-3, so qvel's bound is the widest. In phase 6 an env whose warm start
# departs further is set aside only where a floor row is included or
# active in one version's last substep and not in the other's, and is then
# held to the plain version in float64 taking that substep from the
# kernel's own state (`hold_k1_warm_start`): on the main path's states at
# 4096 one env's right wheel joint read qacc 184.4 in K1 and 1.06 in the
# plain float32, with qvel 1.5e-3 apart (PERF.md).
F32_TOL = {"qpos": 2e-4, "qvel": 6e-2, "ws_rel": 3e-3}
# float32, K2: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 6.4e-5, qvel 5.4e-2, ws 1.1e-3 relative, over the impact
# states at B = 257 and the main path's states at B = 4096 (PERF.md). The
# block weighs 64 g and flies at up to 7.5 m/s: a contact row that
# activates one substep earlier on one side moves its velocity by ~5e-2.
K2_F32_TOL = {"qpos": 6e-4, "qvel": 5e-1, "ws_rel": 1e-2}
# float32, K3: about 10x the largest drift measured on an H100 80GB HBM3
# (700 W): qpos 2.6e-5, qvel 1.0e-2, ws 7.2e-3 relative, over the
# at-the-wall states at B = 257 and the main path's states at B = 4096
# (PERF.md). The qvel figure is a wall contact that switches on a substep
# earlier on one side (largest for the chassis face flush on the wall); the
# warm-start figure is a robot landing on the floor in the main path's
# fresh episodes, where qacc jumps by its own size within a substep.
# Phase 3c holds K3's float32 output to the plain version in float64 on the
# same inputs, the arithmetic both float32 versions round, and prints its
# drift from the plain float32 version beside it: on the 1,118 at-the-wall
# states above the crossover, the plain version in float32 on the card
# departs from float64 by 0.12 in qvel where the chassis face lies flush
# on the wall, while every K3 build, the one-thread design before too,
# stays within 3.6e-3 of float64 (tools/time_kernels.py, its phase-3c
# cases; PERF.md).
K3_F32_TOL = {"qpos": 3e-4, "qvel": 1e-1, "ws_rel": 7e-2}
F32_TOLS = {"K1": F32_TOL, "K2": K2_F32_TOL, "K3": K3_F32_TOL}
# each kernel's wrapper (the function that counts its launches) and its
# plain version, by name in the kernel's module
WRAPPERS = {"K1": ("control_step_cuda", "control_step_plain"),
            "K2": ("control_step14_cuda", "control_step14_plain"),
            "K3": ("control_step_walls_cuda", "control_step_walls_plain")}
# the largest drift of each kernel from its plain version over the run's
# checks, for the `kernels` line: in float64; in float32 against the plain
# version in float32; K3's float32 against the plain version in float64
MAX_F64 = dict.fromkeys(WRAPPERS, 0.0)
MAX_F32 = {n: {"qpos": 0.0, "qvel": 0.0, "ws_rel": 0.0} for n in WRAPPERS}
MAX_F32_VS_F64 = dict.fromkeys(WRAPPERS)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi(query, fmt="csv,noheader"):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def random_states_np(rng, B):
    """Robot states touching the floor in every contact regime (the
    generator of tests/test_physics_parity.py), as numpy arrays qpos, qvel,
    warm start, ctrl, friction."""
    qpos = np.zeros((B, 9))
    qpos[:, :2] = rng.normal(size=(B, 2)) * 0.01
    qpos[:, 2] = -0.0205 + rng.uniform(-0.002, 0.004, B)
    q = rng.normal(size=(B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] = rng.normal(size=(B, 2))
    qvel = rng.normal(size=(B, 8)) * np.array([.1, .1, .1, 1, 1, 1, 5, 5])
    ctrl = rng.normal(size=(B, 2)) * 10
    fric = rng.uniform(0.5, 1.0, B)
    return qpos, qvel, np.zeros((B, 8)), ctrl, fric


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def random_states14(rng, B):
    """Robot + block states in every contact regime, as numpy arrays qpos
    (B,16), qvel (B,14), ctrl (B,2). Six kinds, in turn:
      0-1 the generator of tests/test_block_parity.py (robot touching the
          floor; block on the floor, in the air, or right at the robot);
      2   block parked at (10, 10, 0) with a leftover velocity;
      3   block just spawned: 0.3 m away at z = 0.15, 7.5 m/s at the robot;
      4   block 1-2 cm off a vertical chassis edge, closing at 1 m/s (the
          edge-edge contact);
      5   block about to hit a wheel at 3-7.5 m/s.
    """
    qpos = np.zeros((B, 16))
    qpos[:, :2] = rng.normal(size=(B, 2)) * 0.01
    qpos[:, 2] = -0.0205 + rng.uniform(-0.002, 0.004, B)
    kind = np.arange(B) % 6
    upright = kind >= 2
    tilt = rng.normal(size=B) * 0.1
    q = _unit_quats(rng, B)
    q[upright] = np.stack((np.cos(tilt / 2), np.sin(tilt / 2), 0 * tilt,
                           0 * tilt), 1)[upright]
    qpos[:, 3:7] = q
    qpos[:, 7:9] = rng.normal(size=(B, 2))
    qpos[:, 12:16] = _unit_quats(rng, B)
    qvel = rng.normal(size=(B, 14)) * np.array(
        [.1, .1, .1, 1, 1, 1, 5, 5, 2, 2, 2, 3, 3, 3])
    qvel[upright, :6] *= 0.1
    trial = np.arange(B) // 6
    near = trial % 3 == 0
    low = trial % 2 == 0
    # kinds 0-1
    qpos[:, 9:11] = np.where(near[:, None],
                             qpos[:, :2] + rng.normal(size=(B, 2)) * 0.05,
                             rng.normal(size=(B, 2)) * 0.3)
    qpos[:, 11] = np.where(low, 0.01 + rng.uniform(-0.005, 0.02, B),
                           rng.uniform(0.05, 0.2, B))
    side = rng.choice([-1.0, 1.0], B)
    side2 = rng.choice([-1.0, 1.0], B)
    speed = rng.uniform(3.0, 7.5, B)
    k = kind == 2
    qpos[k, 9:12] = [10.0, 10.0, 0.0]
    qvel[k, 8:11] = rng.normal(size=(k.sum(), 3)) * 0.05
    k = kind == 3
    ang = rng.uniform(0, 2 * np.pi, B)
    qpos[k, 9] = qpos[k, 0] + 0.3 * np.sin(ang[k])
    qpos[k, 10] = qpos[k, 1] + 0.3 * np.cos(ang[k])
    qpos[k, 11] = 0.15
    aim = np.stack((qpos[:, 0], qpos[:, 1], rng.uniform(0.1, 0.175, B)), 1) \
        - qpos[:, 9:12]
    qvel[k, 8:11] = (7.5 * aim / np.linalg.norm(aim, axis=1,
                                                keepdims=True))[k]
    k = kind == 4
    gap = rng.uniform(0.012, 0.02, B)
    corner = np.stack((side * (0.05 + gap), side2 * (0.0185 + gap)), 1)
    qpos[k, 9:11] = (qpos[:, :2] + corner)[k]
    qpos[k, 11] = rng.uniform(0.03, 0.12, B)[k]
    qvel[k, 8:11] = np.stack((-side, -side2, 0 * side), 1)[k] / np.sqrt(2)
    k = kind == 5
    qpos[k, 9] = (qpos[:, 0] + side * 0.074)[k]
    qpos[k, 10] = (qpos[:, 1] + side2 * 0.06)[k]
    qpos[k, 11] = 0.012
    qvel[k, 8:11] = np.stack((0 * side, -side2 * speed, 0 * side), 1)[k]
    ctrl = rng.normal(size=(B, 2)) * 10
    return qpos, qvel, ctrl


def _quat_mul(a, b):
    w1, x1, y1, z1 = a.T
    w2, x2, y2, z2 = b.T
    return np.stack((w1*w2 - x1*x2 - y1*y2 - z1*z2,
                     w1*x2 + x1*w2 + y1*z2 - z1*y2,
                     w1*y2 - x1*z2 + y1*w2 + z1*x2,
                     w1*z2 + x1*y2 - y1*x2 + z1*w2), 1)

def _axis_quat(angle, axis):
    q = np.zeros((len(angle), 4))
    q[:, 0] = np.cos(angle / 2)
    q[:, 1 + axis] = np.sin(angle / 2)
    return q

def _quat_mat(q):
    w, x, y, z = q.T
    return np.stack((
        np.stack((1 - 2*(y*y + z*z), 2*(x*y - w*z), 2*(x*z + w*y)), 1),
        np.stack((2*(x*y + w*z), 1 - 2*(x*x + z*z), 2*(y*z - w*x)), 1),
        np.stack((2*(x*z - w*y), 2*(y*z + w*x), 1 - 2*(x*x + y*y)), 1)), 1)

def _reach(R, d):
    """How far the robot reaches from its body origin along world direction
    d (3,), per env: (chassis box support, wheel cylinder support)."""
    half = np.array([0.05, 0.0185, 0.0855])
    cc = R[:, :, 2] * 0.0995
    chassis = cc @ d + np.abs(np.einsum("bij,i->bj", R, d)) @ half
    ax = R[:, :, 0] @ d
    rim = 0.013 * np.abs(ax) + 0.034 * np.sqrt(np.maximum(1 - ax * ax, 0))
    wheel = (R[:, :, 2] @ d) * 0.034 + 0.074 * np.abs(ax) + rim
    return chassis, wheel

def random_states_walls(rng, B):
    """Robot states at the corridor's walls in every wall-contact regime, as
    numpy arrays qpos (B,9), qvel (B,8), ctrl (B,2). Each env touches the
    +x or the -x wall with its farthest point 0-2 mm inside. Six kinds, in
    turn:
      0   the JAX wall test's states: upright, the chassis side face flush
          in the wall (1-4 cm deep at +-0.18..0.21), 2 m/s wall-ward;
      1   upright beside the wall at a small yaw, a wheel rim rubbing along
          it at 0.5-1.5 m/s;
      2   facing the wall and leaning on it with the chassis' top edge;
      3   in a corner, yawed 25-65 degrees, touching two walls at once;
      4   lying flat with the chassis' top face flush on the wall (exact
          axes: every separating-axis and rank tie at once), sliding along;
      5   lifted onto the wall's top edge with a generic rotation (the
          edge-edge contact).
    """
    qpos = np.zeros((B, 9))
    qvel = rng.normal(size=(B, 8)) * np.array([.02, .02, .02, .2, .2, .2, 5, 5])
    kind = np.arange(B) % 6
    side = rng.choice([-1.0, 1.0], B)
    pen = rng.uniform(0.0, 0.002, B)
    y = rng.uniform(-0.6, 0.6, B)
    slide = rng.uniform(0.5, 1.5, B) * rng.choice([-1.0, 1.0], B)
    ex = np.array([1.0, 0.0, 0.0])
    on_floor = -0.0205 + rng.uniform(-0.001, 0.002, B)
    quat = np.tile([1.0, 0, 0, 0], (B, 1))
    # 1: a small yaw, so that the rim and not the cap's centre leads
    k = kind == 1
    quat[k] = _axis_quat(rng.uniform(0.08, 0.25, B)
                         * rng.choice([-1.0, 1.0], B), 2)[k]
    # 2: facing the wall (yaw -side * 90 deg), leaning onto it
    yaw = _axis_quat(-side * np.pi / 2, 2)
    lean = _axis_quat(-rng.uniform(0.25, 0.6, B), 0)
    k = kind == 2
    quat[k] = _quat_mul(yaw, lean)[k]
    # 3: in a corner, yawed 25-65 deg
    k = kind == 3
    quat[k] = _axis_quat(rng.uniform(0.45, 1.1, B), 2)[k]
    # 4: lying flat, top face on the wall: chassis z -> +-x, exact axes
    flat = np.where(side[:, None] > 0, [[0.5, 0.5, 0.5, 0.5]],
                    [[-0.5, -0.5, 0.5, 0.5]])
    k = kind == 4
    quat[k] = flat[k]
    # 5: lifted onto the wall's top edge with a generic rotation
    k = kind == 5
    q5 = rng.normal(size=(B, 4))
    quat[k] = (q5 / np.linalg.norm(q5, axis=1, keepdims=True))[k]
    R = _quat_mat(quat)
    reach_c, reach_w = _reach(R, ex)
    reach_cn, reach_wn = _reach(R, -ex)
    reach = np.where(side > 0, np.maximum(reach_c, reach_w),
                     np.maximum(reach_cn, reach_wn))
    qpos[:, 0] = side * (0.24 - reach + pen)
    qpos[:, 1] = y
    qpos[:, 2] = on_floor
    qvel[:, 0] += side * 0.3
    # 0: the wall test's own states: upright, overlapping, sliding wall-ward
    k = kind == 0
    qpos[k, 0] = (side * rng.uniform(0.18, 0.21, B))[k]
    qpos[k, 1] = rng.normal(size=k.sum()) * 0.02
    qpos[k, 2] = 0.0
    qvel[k, 0] = 2.0 * side[k]
    # 1 and 4: sliding along the wall
    k = (kind == 1) | (kind == 4)
    qvel[k, 1] = slide[k]
    k = kind == 4
    qpos[k, 2] = -0.02 + 0.034 - 0.0005
    k = kind == 3
    ey = np.array([0.0, 1.0, 0.0])
    side_y = rng.choice([-1.0, 1.0], B)
    rc_, rw_ = _reach(R, ey)
    rcn, rwn = _reach(R, -ey)
    reach_y = np.where(side_y > 0, np.maximum(rc_, rw_), np.maximum(rcn, rwn))
    qpos[k, 1] = (side_y * (0.99 - reach_y + pen))[k]
    qvel[k, 1] += 0.3 * side_y[k]
    k = kind == 5
    centre = np.stack((side * (0.24 - rng.uniform(0.0, 0.02, B)), y,
                       0.175 + rng.uniform(0.0, 0.03, B)), 1)
    qpos[k, :3] = (centre - R[:, :, 2] * 0.0995)[k]
    qpos[:, 3:7] = quat
    qpos[:, 7:9] = rng.normal(size=(B, 2))
    ctrl = rng.normal(size=(B, 2)) * 10
    return qpos, qvel, ctrl


def check_states(crossover, k1_crossover=None):
    """The states of phase 3's kernel-vs-plain checks, as numpy arrays, all
    drawn from one seed in phase 3's order: {"K1": 6 x (qpos, qvel, ws,
    ctrl, friction) of B = CHECK_B, "K2": 3 x (qpos, qvel, ctrl), "K3": {B:
    3 x (qpos, qvel, ctrl)} at CHECK_B and at crossover + 61 envs}, and
    with `k1_crossover` (K1's), "K1 above": 4 x (qpos, qvel, ws, ctrl,
    friction) of k1_crossover + 61 envs, drawn last. The three draws of K3
    at each B are its float64 exact, float64 fast and float32 fast cases;
    the four of K1 above its crossover its float64 Env01 exact, float64
    Env02 fast, float32 Env01 fast and float32 Env02 fast cases."""
    rng = np.random.default_rng(0)
    states = {
        "K1": [random_states_np(rng, CHECK_B) for _ in range(6)],
        "K2": [random_states14(rng, CHECK_B) for _ in range(3)],
        "K3": {B: [random_states_walls(rng, B) for _ in range(3)]
               for B in (CHECK_B, crossover + 61)}}
    if k1_crossover is not None:
        states["K1 above"] = [random_states_np(rng, k1_crossover + 61)
                              for _ in range(4)]
    return states


def int8_exact(qm, obs):
    """The int8 policy `qm` (ops/quant.py's QuantizedMLP) on float32 obs
    (N, 6) in numpy: int64 accumulators, the float32 scalings, roundings
    (half to even) and clips of ops/quant.py, numpy's float32 tanh.
    Returns the dequantized actions (N, 2), float32."""
    f32 = np.float32
    scales_in = (qm.in_q.scale, qm.act_q[0].scale, qm.act_q[1].scale)
    eff = [f32(scales_in[i] * qm.w_scale[i]) for i in range(3)]
    eff[2] = f32(scales_in[2] * qm.w_scale[2] / qm.out_q.scale)
    x = np.clip(np.round(obs.astype(f32) / f32(qm.in_q.scale))
                + qm.in_q.zero_point, -128, 127).astype(np.int64)
    zp = (qm.in_q.zero_point, 0, 0)
    for i in range(3):
        acc = ((x - zp[i]) @ qm.w[i].astype(np.int64)
               + qm.b[i].astype(np.int64)).astype(f32)
        if i < 2:
            x = np.clip(np.round(np.tanh(acc * eff[i]) * f32(128.0)),
                        -128, 127).astype(np.int64)
        else:
            x = np.clip(np.round(acc * eff[i]) + qm.out_q.zero_point,
                        -128, 127)
    return f32(qm.out_q.scale) * (x.astype(f32) - f32(qm.out_q.zero_point))


def drift(kernel_out, plain_out):
    dq, dv, dw = ((a - b).abs().max().item()
                  for a, b in zip(kernel_out, plain_out))
    ws_scale = max(1.0, plain_out[2].abs().max().item())
    return {"qpos": dq, "qvel": dv, "ws_rel": dw / ws_scale}


def within(d, tol):
    return all(d[k] <= tol[k] for k in tol)


def record(kernel, dtype, name, d, B=CHECK_B, vs="plain",
           held=("qpos", "qvel", "ws_rel")):
    """Print a kernel's drift from its plain version (`vs`: "plain" or
    "plain in float64"), hold the kinds in `held` to F64_TOL or to the
    kernel's float32 tolerance, and keep the largest of each kind held for
    the `kernels` line."""
    print(f"{kernel} vs {vs} {name} {str(dtype)[6:]} B={B}: "
          + ", ".join(f"{key} {v:.3e}" + ("" if key in held else
                                            " (printed, not held)")
                      for key, v in d.items()))
    if dtype == torch.float64:
        check(within(d, F64_TOL), f"{kernel} f64 disagrees: {d}")
        MAX_F64[kernel] = max(MAX_F64[kernel], d["qpos"], d["qvel"])
        return
    check(within(d, {k: F32_TOLS[kernel][k] for k in held}),
          f"{kernel} f32 drift over bound: {d}")
    if vs == "plain":
        MAX_F32[kernel] = {key: max(MAX_F32[kernel][key], d[key])
                           for key in held}
    else:
        MAX_F32_VS_F64[kernel] = max(MAX_F32_VS_F64[kernel] or 0.0,
                                     d["qpos"], d["qvel"])


def floor_rows(qpos, qvel, qacc, params, friction=None):
    """The plain version's 64 floor rows of K1's scenes at (qpos, qvel), in
    float64: (included, active at qacc), (B, 64) bool masks, 4 rows per
    candidate in `contacts.robot_floor_contacts` order. A row is active
    where J qacc - aref < 0 (`solver.py`)."""
    from balance_robot_tpu_torch.physics import contacts as ct
    from balance_robot_tpu_torch.physics import robot_core as rc
    from balance_robot_tpu_torch.physics import rows as rw
    q, v, a = (t.double() for t in (qpos, qvel, qacc))
    fric = friction.double() if (params.dynamic_friction
                                 and friction is not None) else None
    k = rc.fk(q)
    rows = rw.build_rows(ct.robot_floor_contacts(k), k["cdof"], k["com"], v,
                         params, friction=fric)
    jar = (rows.J @ a.unsqueeze(-1)).squeeze(-1) - rows.aref
    included = rows.mask > 0
    return included, included & (jar < 0)


def hold_k1_warm_start(kernel, plain, args, k_out, p_out, tol,
                       frame_skip=250):
    """K1's float32 warm start (the last substep's qacc) against the plain
    version's in float32, env by env, within tol's ws_rel of the batch's
    largest |ws|, as `drift` measures it. An env over it is set aside only
    where the two versions' last substeps have different floor rows,
    included or active (`floor_rows` at each version's state after
    frame_skip - 1 substeps and its own warm start): a row that switches
    there moves qacc by up to its own size, in either version, each its own
    way (PERF.md). A set-aside env's warm start is held instead to the
    plain version in float64 taking that last substep from the kernel's own
    state, within the same ws_rel. `args` are the launch's (qpos, qvel, ws,
    ctrl, friction, params). Returns (the largest ws_rel of the envs held
    to the plain float32, one line per set-aside env)."""
    qpos, qvel, ws, ctrl, friction, params = args
    scale = max(1.0, p_out[2].abs().max().item())
    per_env = (k_out[2] - p_out[2]).abs().amax(1).double() / scale
    over = (per_env > tol["ws_rel"]).nonzero().flatten()
    if over.numel() == 0:
        return per_env.max().item(), []
    k_last = kernel(qpos, qvel, ws, ctrl, friction, params,
                    frame_skip=frame_skip - 1)
    again = kernel(*k_last, ctrl, friction, params, frame_skip=1)
    check(all(torch.equal(a, b) for a, b in zip(again, k_out)),
          f"K1's last substep from its own state after {frame_skip - 1} "
          "substeps does not repeat its bits")
    p_last = plain(qpos, qvel, ws, ctrl, friction, params,
                   frame_skip=frame_skip - 1)
    fr = None if friction is None else friction[over]
    inc_k, act_k = floor_rows(k_last[0][over], k_last[1][over],
                              k_out[2][over], params, fr)
    inc_p, act_p = floor_rows(p_last[0][over], p_last[1][over],
                              p_out[2][over], params, fr)
    ref = plain(*(t[over].double() for t in k_last), ctrl[over].double(),
                None if fr is None else fr.double(), params, frame_skip=1)
    ref_rel = ((k_out[2][over].double() - ref[2]).abs().amax(1)
               / scale).tolist()
    lines = []
    for j, i in enumerate(over.tolist()):
        included = (inc_k[j] != inc_p[j]).nonzero().flatten().tolist()
        active = (act_k[j] != act_p[j]).nonzero().flatten().tolist()
        line = (f"env {i}: ws_rel {per_env[i].item():.3e} from the plain "
                f"float32; floor rows of the last substep included in one "
                f"version only {included}, active in one only {active} "
                f"(kernel {int(act_k[j].sum())} active of "
                f"{int(inc_k[j].sum())}, plain {int(act_p[j].sum())} of "
                f"{int(inc_p[j].sum())}); from the kernel's own state the "
                f"plain version in float64 gives ws_rel {ref_rel[j]:.3e}")
        print(f"K1 main-path warm start over its bound, {line}")
        check(included or active, f"K1 f32 warm start over its bound with "
              f"the same floor rows in both versions' last substeps: {line}")
        check(ref_rel[j] <= tol["ws_rel"], "K1 f32 warm start of a "
              f"set-aside env over its bound from the plain version in "
              f"float64 on the kernel's own state: {line}")
        lines.append(line)
    per_env[over] = 0.0
    return per_env.max().item(), lines


def time_kernel(fn):
    """Median milliseconds of TIMED_LAUNCHES launches, by CUDA events."""
    times = []
    for _ in range(TIMED_LAUNCHES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def time_plain(fn):
    """(output, milliseconds) of one call, by the host clock around a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(ops_per_env, n_envs, tensors):
    """The least time the card could take: the kernel's operations over the
    fp32 non-tensor peak, or its bytes (each input read once, each output
    written once) over the memory rate. Returns a dict for the report."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    peak = sms * 128 * 2 * clock_mhz * 1e6
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops_ms = ops_per_env * n_envs / peak * 1e3
    bytes_ms = nbytes / 3.35e12 * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "peak": f"fp32 peak {peak / 1e12:.1f} TFLOP/s ({sms} SMs at "
                    f"{clock_mhz:.0f} MHz)"}


def launch_shapes(kernel, dtype):
    """[(batches, (lanes per env, envs per block, shared bytes per block))]
    of a kernel's launch (`cuda_kernel.Kernel`): one for each rung of its
    ladder (K1's and K3's two instantiations, K2's three), from the batch at
    which it starts."""
    return [(f" B >= {B}", kernel.launch_config(dtype, B))
            for B in [1] + kernel.crossovers()]


def print_build(name, kernel):
    info = kernel.build_info
    print(f"build: {name} in {info['seconds']:.1f} s "
          f"({'reused' if info['cached'] else 'compiled'})")
    for dtype in (torch.float32, torch.float64):
        for batches, (team, envs, smem) in launch_shapes(kernel, dtype):
            print(f"  launch {str(dtype)[6:]}{batches}: a team of {team} "
                  f"lanes per env, {envs} envs per block, {smem} bytes of "
                  "shared memory per block"
                  + (" (rows in each thread's local memory)"
                     if team == 1 else ""))
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:   # the kernel's mangled name
            print("  ptxas:", line.split("'")[1])
        elif "spill" in line or "Used" in line or "stack frame" in line:
            print("  ptxas:", line.strip())


def build_kernels():
    """Phase 2: build K1, K2 and K3, one nvcc per source, all started
    together; print each build. Returns {"K1": module, ...} of the kernels'
    wrappers (each with its `launches` count)."""
    from balance_robot_tpu_torch.physics import cuda_block, cuda_move
    from balance_robot_tpu_torch.physics import cuda_step, kernel_build
    modules = {"K1": cuda_step, "K2": cuda_block, "K3": cuda_move}
    procs = {name: kernel_build.start_build(m.LABEL, m.SOURCE)
             for name, m in modules.items()}
    for name, m in modules.items():
        m.KERNEL.build(procs[name])
        print_build(name, m.KERNEL)
    return modules


def zero_counts(modules):
    for m in modules.values():
        m.KERNEL.launches = 0
        m.KERNEL.launches_by_team.clear()


def counts_of(modules):
    return {name: m.KERNEL.launches for name, m in modules.items()}


def run_main_path(vec, policy, gen, modules, kernel, after_step=None):
    """N_STEPS sampled steps of `vec`; every kernel's count is set to 0
    just before and read just after, and only `kernel` may have been
    launched, once per step. `after_step(states)` is called after each
    step. Returns (states, obs, counts)."""
    states, obs = vec.reset()
    torch.cuda.synchronize()
    zero_counts(modules)
    t0 = time.perf_counter()
    rewards = []
    for _ in range(N_STEPS):
        mean, _, _ = policy(obs)
        actions = policy.sample(mean, gen)
        states, out = vec.step(states, actions)
        obs = out.obs
        rewards.append(out.reward.mean())
        if after_step is not None:
            after_step(states)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    check(counts == {name: N_STEPS * (name == kernel) for name in modules},
          f"{vec.env.id} main path must launch {kernel} {N_STEPS} times and "
          f"no other kernel: {counts}")
    rewards = torch.stack(rewards)
    finite = [torch.isfinite(t).all().item() for t in
              (obs, rewards, *states.phys)]
    check(all(finite), "main path produced non-finite values")
    check(obs.shape == (N_ENVS, vec.env.obs_dim),
          f"obs shape {tuple(obs.shape)}")
    teams = dict(modules[kernel].KERNEL.launches_by_team)
    team = modules[kernel].KERNEL.launch_config(torch.float32, N_ENVS)[0]
    check(teams == {team: N_STEPS}, f"{vec.env.id} main path: "
          f"{kernel}'s launches by team {teams}, not all on {team}")
    print(f"main path {vec.env.id}: {N_ENVS} envs x {N_STEPS} steps in "
          f"{seconds:.3f} s = {N_ENVS * N_STEPS / seconds:.1f} env-steps/s "
          f"({kernel} launches {counts[kernel]}, by team {teams}, mean reward "
          f"{rewards.mean().item():.4f})")
    return states, obs, counts


def run_training(name, env, cfg, iters, modules, kernel, init_params=None,
                 before=None, after_first=None):
    """`iters` PPO iterations on `env` with every kernel's count set to 0
    just before and read just after: only `kernel` may have been launched,
    once per rollout step. `before(ppo, ts)` checks the fresh train state,
    `after_first(ppo, ts)` the state after the first iteration. Prints the
    times (the first iteration apart: it includes the first use of autograd
    and of the optimizer)."""
    from balance_robot_tpu_torch.train.ppo import PPO
    from balance_robot_tpu_torch.utils.profiling import Timer
    ppo = PPO(env, cfg)
    ts = ppo.init(0, params=init_params)
    if before is not None:
        before(ppo, ts)
    pi_w1 = ts.net.pi_l1.weight.detach().clone()
    first, timer = Timer(), Timer()
    torch.cuda.synchronize()
    zero_counts(modules)
    t0 = time.perf_counter()
    for i in range(iters):
        t = first if i == 0 else timer
        with t("iteration"):
            ts, metrics = ppo.iteration(ts, timer=t)
        if i == 0 and after_first is not None:
            after_first(ppo, ts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    check(counts == {n: iters * cfg.n_steps * (n == kernel)
                     for n in modules},
          f"{name} training must launch {kernel} {iters * cfg.n_steps} times "
          f"and no other kernel: {counts}")
    values = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(values[k]) for k in (
        "loss", "pg_loss", "v_loss", "entropy", "explained_variance")),
        f"{name} training metrics not finite: {values}")
    check(not torch.equal(ts.net.pi_l1.weight, pi_w1),
          f"{name} training did not move pi_w1")
    n = cfg.n_envs * cfg.n_steps
    rep, rep1 = timer.report(), first.report()
    print(f"training {name}: {iters} iterations of {cfg.n_envs} envs x "
          f"{cfg.n_steps} steps, {cfg.n_epochs} epochs x "
          f"{n // cfg.minibatch_size} minibatches of {cfg.minibatch_size}, "
          f"in {seconds:.3f} s ({kernel} launches {counts[kernel]}); after "
          f"the first: {rep['iteration']['mean_ms']:.1f} ms per iteration = "
          f"rollout {rep['rollout']['mean_ms']:.1f} ms + update "
          f"{rep['update']['mean_ms']:.1f} ms, "
          f"{n / rep['iteration']['mean_ms'] * 1e3:.1f} training "
          f"env-steps/s; the first {rep1['iteration']['mean_ms']:.1f} ms "
          f"(rollout {rep1['rollout']['mean_ms']:.1f}, update "
          f"{rep1['update']['mean_ms']:.1f}); last metrics "
          + ", ".join(f"{k} {v:.4g}" for k, v in values.items()))


def train_with_runner(env, cfg):
    """Phase 7c: `runner.train` for TRAIN_ITERS_RUNNER iterations, an eval
    after each, into a temporary models/logs directory under build/."""
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, runner
    from balance_robot_tpu_torch.train.ppo import PPO

    class TimedPPO(PPO):
        def evaluate(self, net, n_episodes, max_steps=None):
            t0 = time.perf_counter()
            out = super().evaluate(net, n_episodes, max_steps)
            self.eval_seconds.append(time.perf_counter() - t0)
            return out

    per_iter = cfg.n_envs * cfg.n_steps
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = pathlib.Path(tmp)
        trainer = TimedPPO(env, cfg)
        trainer.eval_seconds = []
        t0 = time.perf_counter()
        _, history = runner.train(
            env, cfg, seed=0, total_timesteps=TRAIN_ITERS_RUNNER * per_iter,
            eval_freq=per_iter, n_eval_episodes=5, models_dir=tmp / "models",
            logs_dir=tmp / "logs", run_name="smoke", verbose=False,
            trainer=trainer)
        seconds = time.perf_counter() - t0
        run = tmp / "models" / "smoke"
        files = {f: (run / f).exists() for f in (
            "best_model.npz", "longest_model.npz", "final_model.npz",
            "resume_state.npz")}
        files["smoke.csv"] = (tmp / "logs" / "smoke.csv").exists()
        check(all(files.values()), f"runner artifacts missing: {files}")
        check(len(history) == TRAIN_ITERS_RUNNER,
              f"runner evaluated {len(history)} times")
        final = checkpoint.load(run / "final_model")
        ts, steps = checkpoint.load_train_state(
            run / "resume_state.npz", PPO(env, cfg).init(1))
        back = mlp.to_numpy_params(ts.net)
        check(steps == TRAIN_ITERS_RUNNER * per_iter
              and all(np.array_equal(back[k], final[k]) for k in final),
              "the resume state does not give back the final params")
    print(f"training runner: Env01-v2, {TRAIN_ITERS_RUNNER} iterations with "
          f"an eval of 5 episodes after each, in {seconds:.2f} s; evals "
          f"{[round(x, 3) for x in trainer.eval_seconds]} s, eval lengths "
          f"{[row['eval_len'] for row in history]}, returns "
          f"{[row['eval_return'] for row in history]}; artifacts {files}; "
          "resume state read back bit for bit")


def training_phase(modules):
    """Phase 7: 7a, 7b and 7c (see the module docstring)."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.ppo import PPOConfig
    cfg = PPOConfig(**TRAIN_CONFIG)
    t7 = time.perf_counter()
    run_training("7a Env01-v2", brt.make("Env01-v2").use_fast_solver(), cfg,
                 TRAIN_ITERS_01, modules, "K1")

    warm = checkpoint.load(POLICY)
    unpadded = mlp.from_numpy_params(warm, device="cuda")

    def padded_value_is_unchanged(ppo, ts):
        with torch.no_grad():
            padded = ts.net.value(ppo._vobs(ts.last_obs, ts.env_states))
            base = unpadded.value(ts.last_obs)
        gap = (padded - base).abs().max().item()
        scale = max(1.0, base.abs().max().item())
        print(f"training 7b: warm start from {POLICY}: vf_w1 "
              f"{tuple(warm['vf_w1'].shape)} -> "
              f"{tuple(ts.net.vf_l1.weight.T.shape)}; padded vs unpadded "
              f"value on the first obs: {gap:.3e} (values up to "
              f"{scale:.3f})")
        check(gap <= 1e-5 * scale, "7b: the padded critic's value departs "
              f"from the unpadded one's by {gap:.3e}")

    def privileged_rows_moved(ppo, ts):
        check(ts.net.vf_l1.weight[:, 6:].abs().max().item() > 0,
              "7b: the privileged critic rows are still zero after the "
              "first update")

    run_training("7b Env03-v2 privileged critic",
                 brt.make("Env03-v2").use_fast_solver(),
                 PPOConfig(privileged_critic=True, **TRAIN_CONFIG),
                 TRAIN_ITERS_03, modules, "K2", init_params=warm,
                 before=padded_value_is_unchanged,
                 after_first=privileged_rows_moved)
    train_with_runner(brt.make("Env01-v2").use_fast_solver(), cfg)
    print(f"training: phase 7 in {time.perf_counter() - t7:.1f} s")


# ---------------------------------------------------------------- phase 8

def _files(directory):
    """The files under `directory`, relative, sorted (none if absent)."""
    return sorted(str(f.relative_to(directory))
                  for f in directory.rglob("*") if f.is_file())


def run_cli(argv):
    """`cli.main(argv)` in this process with its standard output captured;
    returns (output lines, seconds by the host clock around a sync)."""
    from balance_robot_tpu_torch import cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def check_episode_lines(lines, what, length=None):
    """The one `episode 0: return=R len=L` line of a one-episode run, and
    its telemetry rows (`t, vel_l, vel_r`), all finite."""
    eps = [line for line in lines if line.startswith("episode ")]
    rows = [[float(x) for x in line.split(",")] for line in lines
            if line.count(",") == 2 and "[" not in line]
    check(len(eps) == 1 and eps[0].startswith("episode 0: return="),
          f"{what}: episode lines {eps}")
    if length is not None:
        check(eps[0].endswith(f"len={length}"),
              f"{what}: {eps[0]} (expected len={length})")
    check(np.isfinite(rows).all(), f"{what}: non-finite telemetry")
    return eps[0], rows


def cli_serving(modules):
    """8a: `cli test -e Cal01` (K1 at B = 1), then `cli._run_episodes` on
    Env03-v2 (K2) and EnvMove05-v1 (K3's team instantiation), max_steps
    CLI_SERVE_STEPS; ms per control step by the host clock. Each kernel's
    launch at step CLI_HOLD_AT is held to its plain version and timed."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch import cli
    from balance_robot_tpu_torch.train import checkpoint

    kept = {}
    zero_counts(modules)
    with inputs_of_launch(modules, "K1", CLI_HOLD_AT) as kept["K1"]:
        lines, seconds = run_cli(["-a", "PPO", "-m",
                                  "ck/Env01-v2_PPO/best_model", "test",
                                  "-e", "Cal01", "--episodes", "1"])
    counts = counts_of(modules)
    ep, rows = check_episode_lines(lines, "8a test -e Cal01", 201)
    check(401 <= len(rows) <= 402, f"8a: {len(rows)} telemetry rows")
    check(counts == {"K1": len(rows), "K2": 0, "K3": 0},
          f"8a: test -e Cal01 must launch K1 once per step ({len(rows)}) "
          f"and no other kernel: {counts}")
    check(min(rows[-1][1:]) > 1.0, f"8a: Cal01's wheels at rest: {rows[-1]}")
    print(f"cli 8a: test -e Cal01 (exact grade): {ep}; {len(rows)} "
          f"telemetry rows, the last {rows[-1]}; {counts['K1']} K1 launches "
          f"at B = 1; {seconds:.3f} s for the whole command = "
          f"{1e3 * seconds / len(rows):.3f} ms per control step")

    for env_id, name, kernel in (
            ("Env03-v2", "Env03-v2_r2i", "K2"),
            ("EnvMove05-v1", "EnvMove05-v1_PPO_r4", "K3")):
        env = brt.make(env_id)
        act = cli._policy_act(checkpoint.load(f"ck/{name}/best_model"), env)
        steps = []

        def counted(obs):
            steps.append(1)
            return act(obs)

        zero_counts(modules)
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), inputs_of_launch(
                modules, kernel, CLI_HOLD_AT) as kept[kernel]:
            cli._run_episodes(env, counted, 1, CLI_SERVE_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = counts_of(modules)
        ep, _ = check_episode_lines(buf.getvalue().splitlines(),
                                    f"8a {env_id}")
        check(counts == {n: len(steps) * (n == kernel) for n in modules},
              f"8a: {env_id} must launch {kernel} once per step "
              f"({len(steps)}) and no other kernel: {counts}")
        print(f"cli 8a: _run_episodes {env_id} (models/{name}, exact grade, "
              f"max_steps {CLI_SERVE_STEPS}): {ep}; {len(steps)} steps, "
              f"{counts[kernel]} {kernel} launches at B = 1, in "
              f"{seconds:.3f} s = {1e3 * seconds / len(steps):.3f} ms per "
              "control step")
    for kernel, env_id in (("K1", "Cal01"), ("K2", "Env03-v2"),
                           ("K3", "EnvMove05-v1")):
        hold_on_path(modules, kernel, f"{env_id} exact step {CLI_HOLD_AT}",
                     kept[kernel])


@contextlib.contextmanager
def inputs_of_launch(modules, kernel, at):
    """While the block runs, keep a copy of the inputs of `kernel`'s launch
    number `at` (from 0) through its wrapper; yields the list that receives
    them as (args, kwargs)."""
    module, name = modules[kernel], WRAPPERS[kernel][0]
    launch = getattr(module, name)
    kept, calls = [], [0]

    def spy(*args, **kwargs):
        if calls[0] == at:
            kept.append((tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args), kwargs))
        calls[0] += 1
        return launch(*args, **kwargs)

    with mock.patch.object(module, name, spy):
        yield kept


def hold_on_path(modules, kernel, what, kept, ws_vs_f64=False):
    """`kernel` against its plain version on the inputs kept from one of a
    path's launches (`inputs_of_launch`): in float32 as the path ran it,
    and on the same inputs in float64. K1's and K2's float32 is held to
    the plain version in float32; K3's to the plain version in float64
    (see K3_F32_TOL), which is the only plain version K3's hold runs.
    `ws_vs_f64=True` holds the float32 warm start to the plain version in
    float64 instead, within WS_F64_MARGIN times the plain float32's own
    departure from it (see the phase-13 constants). Then the kernel's
    median by CUDA events, the plain version's time and the bound, on
    those inputs."""
    check(len(kept) == 1, f"{what}: {kernel}'s launch was not reached")
    (args, kwargs), = kept
    module = modules[kernel]
    launch, plain = (getattr(module, f) for f in WRAPPERS[kernel])
    B = args[0].shape[0]
    check(args[0].dtype == torch.float32, f"{what}: {args[0].dtype}")
    args64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    plain_args = args64 if kernel == "K3" else args
    with torch.inference_mode():
        k = launch(*args, **kwargs)
        k64 = launch(*args64, **kwargs)
        p, plain_ms = time_plain(lambda: plain(*plain_args, **kwargs))
        p64 = p if kernel == "K3" else plain(*args64, **kwargs)
        check(all(torch.isfinite(t).all() for t in k + p + k64 + p64),
              f"{what}: non-finite {kernel} or plain output")
        if kernel == "K3":
            record(kernel, torch.float32, what, drift(k, p64), B,
                   "plain in float64")
        elif ws_vs_f64:
            record(kernel, torch.float32, what, drift(k, p), B,
                   held=("qpos", "qvel"))
            ws_k, ws_p = drift(k, p64)["ws_rel"], drift(p, p64)["ws_rel"]
            limit = max(F32_TOLS[kernel]["ws_rel"], WS_F64_MARGIN * ws_p)
            print(f"{kernel} {what} float32 B={B}, the warm start against "
                  f"the plain version in float64: {kernel} {ws_k:.3e}, the "
                  f"plain version {ws_p:.3e}; held to {limit:.3e}")
            check(ws_k <= limit, f"{kernel} {what}: the float32 warm start "
                  f"{ws_k:.3e} from the plain version in float64, over "
                  f"{limit:.3e}")
        else:
            record(kernel, torch.float32, what, drift(k, p), B)
        record(kernel, torch.float64, what, drift(k64, p64), B)
    ms = time_kernel(lambda: launch(*args, **kwargs))
    tensors = [a for a in args if torch.is_tensor(a)]
    ops = float(np.mean(module.count_ops(
        *(a[:16].cpu() if torch.is_tensor(a) else a for a in args),
        **kwargs)[0]))
    b = bound(ops, B, tensors + list(k))
    team = module.KERNEL.launch_config(torch.float32, B)[0]
    print(f"{kernel} B={B} f32 on {what} (a team of {team} lanes): median "
          f"{ms:.3f} ms over {TIMED_LAUNCHES} launches; plain "
          f"{plain_ms:.1f} ms ({str(p[0].dtype)[6:]}); "
          f"{ops:.0f} ops/env/control step -> bound "
          f"{b['bound_ms']:.6f} ms by {b['bound_by']}")


def cli_export(modules):
    """8b: `convert` (its .onnx, then the SavedModel, which needs
    TensorFlow), `pipeline.export_brq`, the native ONNX leg against the
    card's policy mean, the native int8 runtime against the card's
    int8_forward, then `test-onnx -e Cal01`."""
    from balance_robot_tpu_torch.export import native_runtime, onnx_runtime
    from balance_robot_tpu_torch.export import pipeline
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.ops import quant
    from balance_robot_tpu_torch.train import checkpoint

    root = pathlib.Path(__file__).resolve().parent
    base = pathlib.Path("ck/Env01-v2_PPO")
    convert = ["-a", "PPO", "-m", str(base / "best_model"), "convert", "-e",
               "Env01-v2"]
    if importlib.util.find_spec("tensorflow") is None:
        try:
            run_cli(convert)
            fail("8b: convert passed the SavedModel without TensorFlow")
        except ImportError as e:
            print(f"cli 8b: convert wrote the .onnx and stopped at the "
                  f"SavedModel: ImportError({e})")
    else:
        lines, _ = run_cli(convert)
        print("cli 8b: convert: " + "; ".join(lines))
    committed = (root / POLICY).parent / "best_model.onnx"
    check((base / "best_model.onnx").read_bytes() == committed.read_bytes(),
          "8b: convert's .onnx differs from the committed one")

    params = checkpoint.load(base / "best_model")
    onnx_path = base / "best_model.onnx"
    brq = pipeline.export_brq(params, base / "best_model_int8.brq")
    t0 = time.perf_counter()
    sess = onnx_runtime.session(onnx_path)
    build_s = time.perf_counter() - t0
    check(isinstance(sess, native_runtime.NativeOnnxSession)
          and sess.library.parent == root / "build" / "torch_native",
          f"8b: onnx_runtime.session took another leg: {type(sess)}")
    obs = np.random.default_rng(12).uniform(
        -3, 3, (ONNX_OBS, 6)).astype(np.float32)
    t0 = time.perf_counter()
    native = np.stack([sess.run(["output"], {"input": o[None]})[0][0]
                       for o in obs])
    native_s = time.perf_counter() - t0
    net = mlp.from_numpy_params(params, device="cuda")
    with torch.no_grad():
        card = net.policy_mean(torch.from_numpy(obs).cuda()).cpu().numpy()
    err = float(np.abs(native - card).max())
    check(err <= 1e-5, f"8b: native ONNX vs the card's policy mean {err}")

    qm = pipeline.load_brq(brq)
    native8 = native_runtime.NativeInt8Policy(qm)
    q_obs = quant.quantize_obs(torch.from_numpy(obs).cuda(), qm.in_q)
    card_codes = quant.int8_forward(qm, q_obs).cpu().numpy()
    host_codes = np.stack([native8.invoke_int8(q)
                           for q in q_obs.cpu().numpy()])
    n_diff = int((card_codes != host_codes).sum())
    check(n_diff == 0, f"8b: the native int8 runtime and the card's "
          f"int8_forward differ on {n_diff} of {host_codes.size} codes")
    print(f"cli 8b: convert's .onnx equal to the committed "
          f"{committed.relative_to(root)}; session() is the native leg "
          f"({sess.library.relative_to(root)}, built and loaded in "
          f"{build_s:.2f} s); {ONNX_OBS} obs in {native_s:.3f} s, within "
          f"{err:.3e} of the card's policy mean; the .brq's int8 codes from "
          f"the native runtime equal the card's int8_forward on all "
          f"{host_codes.size} ({native8.library.relative_to(root)})")

    zero_counts(modules)
    lines, seconds = run_cli(["-a", "PPO", "-m", str(base / "best_model"),
                              "test-onnx", "-e", "Cal01"])
    counts = counts_of(modules)
    ep, rows = check_episode_lines(lines, "8b test-onnx -e Cal01", 201)
    check(counts == {"K1": len(rows), "K2": 0, "K3": 0},
          f"8b: test-onnx -e Cal01 must launch K1 once per step "
          f"({len(rows)}) and no other kernel: {counts}")
    print(f"cli 8b: test-onnx -e Cal01: {ep}; {len(rows)} rows, "
          f"{counts['K1']} K1 launches at B = 1, in {seconds:.3f} s")


def cli_bc(modules):
    """8c: `bc-init -e Env01-v2` at the CLI's defaults (K1 at B = 256),
    then the cloned policy's survival over BC_EVAL_EPISODES fresh episodes
    of BC_EVAL_STEPS steps at the fast grade, against the JAX package's;
    K1's launch at collection step BC_HOLD_AT held to its plain version."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import bc, checkpoint
    from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
    from balance_robot_tpu_torch.train.ppo import deterministic_action

    zero_counts(modules)
    with inputs_of_launch(modules, "K1", BC_HOLD_AT) as kept:
        lines, seconds = run_cli(["-a", "PPO", "bc-init", "-e", "Env01-v2",
                                  "--out", "bc_init.npz"])
    counts = counts_of(modules)
    steps = bc.BCConfig().steps
    check(counts == {"K1": steps, "K2": 0, "K3": 0},
          f"8c: bc-init must launch K1 once per collection step ({steps}) "
          f"and no other kernel: {counts}")
    check(lines[-1] == "saved bc_init.npz — train with -m bc_init.npz"
          and sum(line.startswith("bc step ") for line in lines) == 5,
          f"8c: bc-init printed {lines}")
    params = checkpoint.load("bc_init.npz")
    env = brt.make("Env01-v2", seed=BC_EVAL_SEED).use_fast_solver()
    t0 = time.perf_counter()
    _, lens = ChunkedEvaluator(env, deterministic_action).evaluate_detail(
        mlp.from_numpy_params(params, device="cuda"), BC_EVAL_EPISODES,
        BC_EVAL_STEPS)
    eval_s = time.perf_counter() - t0
    p = float((lens >= BC_EVAL_STEPS).mean())
    se = float(np.sqrt(p * (1 - p) / BC_EVAL_EPISODES))
    reach = 3.0 * float(np.hypot(se, BC_SURVIVAL_JAX[1]))
    print(f"cli 8c: bc-init -e Env01-v2 in {seconds:.2f} s ({counts['K1']} "
          f"K1 launches at B = {bc.BCConfig().episodes}); "
          + "; ".join(lines[:-1]) + f"; survival of the clone over "
          f"{BC_EVAL_EPISODES} episodes of {BC_EVAL_STEPS} steps (fast "
          f"grade, {eval_s:.2f} s) {p:.4f} (s.e. {se:.4f}); the JAX "
          f"package's {BC_SURVIVAL_JAX[0]} (s.e. {BC_SURVIVAL_JAX[1]}), "
          f"band +-{reach:.4f}")
    check(abs(p - BC_SURVIVAL_JAX[0]) <= reach,
          f"8c: the clone's survival {p:.4f} is more than {reach:.4f} from "
          f"the JAX package's {BC_SURVIVAL_JAX[0]}")
    hold_on_path(modules, "K1", f"bc-init Env01-v2 exact step {BC_HOLD_AT}",
                 kept)


def cli_train(modules):
    """8d: `train -a PPO`, `-a A2C`, `-a SAC`, `-a TD3` and `-a DDPG` on
    Env01-v2 for 2 iterations each with an eval after each (K1 once per env
    step, the evals' included); the run directories' artifacts; the
    off-policy params with the committed checkpoints' keys and shapes,
    their resume state read back bit for bit, no recording; `convert` of
    the SAC artifact writes its .onnx."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.env01 import Env01V2
    from balance_robot_tpu_torch.train import checkpoint, factory, offpolicy

    root = pathlib.Path(__file__).resolve().parent
    for algo, per_iter in (("PPO", 1024 * 32), ("A2C", 1024 * 5),
                           ("SAC", 256), ("TD3", 256), ("DDPG", 256)):
        off = algo in OFF_ITERS
        movies = _files(pathlib.Path("movies"))
        env_steps = []
        step = Env01V2.step

        def counted(self, *args, **kwargs):
            env_steps.append(1)
            return step(self, *args, **kwargs)

        zero_counts(modules)
        with mock.patch.object(Env01V2, "step", counted):
            lines, seconds = run_cli([
                "-a", algo, "train", "-e", "Env01-v2", "--solver", "fast",
                "--total-timesteps", str(2 * per_iter), "--eval-freq",
                str(per_iter)] + (["--record-every", "1"] if off else []))
        counts = counts_of(modules)
        check(counts == {"K1": len(env_steps), "K2": 0, "K3": 0},
              f"8d: train -a {algo} must launch K1 once per env step "
              f"({len(env_steps)}) and no other kernel: {counts}")
        run = pathlib.Path("models") / f"Env01-v2_{algo}"
        files = {f: (run / f"{f}.npz").exists() for f in (
            "best_model", "longest_model", "final_model", "resume_state")}
        csv = pathlib.Path("logs") / f"Env01-v2_{algo}.csv"
        rows = csv.read_text().splitlines() if csv.exists() else []
        check(all(files.values()) and len(rows) == 3,
              f"8d: train -a {algo} artifacts: {files}, {csv}: {rows}")
        extra = ""
        if off:
            committed = checkpoint.load(
                root / "models" / f"Env01-v2_{algo}" / "best_model.npz")
            shapes = {k: v.shape for k, v in committed.items()}
            for f in ("best_model", "final_model"):
                mine = checkpoint.load(run / f)
                check({k: v.shape for k, v in mine.items()} == shapes,
                      f"8d: {algo} {f} keys/shapes differ from the "
                      f"committed models/Env01-v2_{algo}")
            tr, _ = factory.algorithm_factory(
                algo, brt.make("Env01-v2").use_fast_solver())
            ts, steps = checkpoint.load_train_state(
                run / "resume_state.npz", tr.init(1))
            final = checkpoint.load(run / "final_model")
            back = checkpoint.flatten(offpolicy.to_numpy_params(ts.net), "",
                                      {})
            checkpoint.save_train_state(run / "again.npz", ts, steps)
            with np.load(run / "resume_state.npz") as a, \
                    np.load(run / "again.npz") as b:
                same = a.files == b.files and all(
                    np.array_equal(a[k], b[k]) for k in a.files)
            check(same and steps == ts.ptr == 2 * per_iter
                  and all(np.array_equal(back[k], final[k]) for k in final),
                  f"8d: {algo}'s resume state is not read back bit for bit")
            (run / "again.npz").unlink()
            check(_files(pathlib.Path("movies")) == movies,
                  f"8d: train -a {algo} wrote into movies/")
            extra = (f"; params with the keys and shapes of the committed "
                     f"models/Env01-v2_{algo}, the resume state "
                     f"({ts.ptr} buffer rows) read back bit for bit, nothing "
                     "recorded")
        print(f"cli 8d: train -a {algo} -e Env01-v2: 2 iterations and 2 "
              f"evals in {seconds:.2f} s, {counts['K1']} K1 launches = "
              f"env steps (rollouts {2 * per_iter // (256 if off else 1024)}"
              f" at B = {256 if off else 1024}, the rest the evals' at "
              f"B = 5){extra}; " + "; ".join(lines))
    sac = pathlib.Path("models") / "Env01-v2_SAC"
    convert = ["-a", "SAC", "-m", str(sac / "best_model"), "convert", "-e",
               "Env01-v2"]
    if importlib.util.find_spec("tensorflow") is None:
        try:
            run_cli(convert)
            fail("8d: convert passed the SavedModel without TensorFlow")
        except ImportError:
            pass
    else:
        run_cli(convert)
    onnx = sac / "best_model.onnx"
    check(onnx.exists() and onnx.stat().st_size > 0,
          "8d: convert wrote no .onnx for the SAC artifact")
    print(f"cli 8d: convert -a SAC wrote {onnx} ({onnx.stat().st_size} "
          "bytes)")


def cli_phase(modules):
    """Phase 8: 8a-8d (see the module docstring), in a temporary working
    directory under build/ with copies of the checkpoints they read; the
    repo's models/, logs/ and movies/ must be as they were."""
    root = pathlib.Path(__file__).resolve().parent
    guarded = {d: _files(root / d) for d in ("models", "logs", "movies")}
    build = root / "build"
    build.mkdir(exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cwd = os.getcwd()
    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name in ("Env01-v2_PPO", "Env03-v2_r2i", "EnvMove05-v1_PPO_r4"):
            (pathlib.Path(tmp) / "ck" / name).mkdir(parents=True)
            shutil.copy(root / "models" / name / "best_model.npz",
                        pathlib.Path(tmp) / "ck" / name)
        os.chdir(tmp)
        try:
            cli_serving(modules)
            cli_export(modules)
            cli_bc(modules)
            cli_train(modules)
        finally:
            os.chdir(cwd)
    after = {d: _files(root / d) for d in guarded}
    check(after == guarded, "phase 8 wrote into the repo's models/, logs/ "
          "or movies/")
    print(f"cli: phase 8 in {time.perf_counter() - t8:.1f} s; nothing new "
          "under models/, logs/ or movies/")


# ---------------------------------------------------------------- phase 9

def buffer_bytes(buf):
    return sum(t.numel() * t.element_size() for t in buf)


def run_off_policy(name, tr, ts, iters, modules, kernel):
    """`iters` iterations of the off-policy trainer `tr` from `ts`, with
    every kernel's count set to 0 just before and read just after: only
    `kernel` may have been launched, once per iteration (one env step).
    Prints the times (the first iteration apart: it includes the first use
    of autograd and of the optimizers). Returns ts."""
    from balance_robot_tpu_torch.utils.profiling import Timer
    cfg = tr.cfg
    ptr0 = ts.ptr
    first, timer = Timer(), Timer()
    torch.cuda.synchronize()
    zero_counts(modules)
    t0 = time.perf_counter()
    for i in range(iters):
        t = first if i == 0 else timer
        with t("iteration"):
            ts, metrics = tr.iteration(ts, timer=t)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    check(counts == {n: iters * (n == kernel) for n in modules},
          f"{name} must launch {kernel} {iters} times and no other kernel: "
          f"{counts}")
    check(ts.ptr == ptr0 + iters * cfg.n_envs,
          f"{name}: ptr {ts.ptr}, expected {ptr0 + iters * cfg.n_envs}")
    values = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in values.values()),
          f"{name} metrics not finite: {values}")
    check(all(torch.isfinite(p).all().item() for p in ts.net.parameters()),
          f"{name}: a param is not finite")
    rep, rep1 = timer.report(), first.report()
    it = rep["iteration"]["mean_ms"]
    print(f"training {name}: {iters} iterations of {cfg.n_envs} envs x 1 "
          f"step + {cfg.train_freq * cfg.gradient_steps} update of batch "
          f"{cfg.batch_size}, in {seconds:.3f} s ({kernel} launches "
          f"{counts[kernel]}, {ts.grad_steps} updates, ptr {ts.ptr}); after "
          f"the first: {it:.3f} ms per iteration = collect "
          f"{rep['collect']['mean_ms']:.3f} ms + update "
          f"{rep['update']['mean_ms']:.3f} ms, "
          f"{cfg.n_envs / it * 1e3:.1f} training transitions/s; the first "
          f"{rep1['iteration']['mean_ms']:.1f} ms (collect "
          f"{rep1['collect']['mean_ms']:.1f}, update "
          f"{rep1['update']['mean_ms']:.1f}); buffer "
          f"{buffer_bytes(ts.buffer)} bytes ({cfg.buffer_size} rows), peak "
          f"allocated {torch.cuda.max_memory_allocated()} bytes; last "
          "metrics " + ", ".join(f"{k} {v:.4g}" for k, v in values.items()))
    return ts


def off_policy_phase(modules):
    """Phase 9: 9a-9e (see the module docstring)."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.base import tree_map
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, factory, offpolicy
    from balance_robot_tpu_torch.train.harvest import harvest_fatal_states

    t9 = time.perf_counter()
    # ---- 9a, 9b: SAC, TD3, DDPG on Env01-v2 from a fresh init
    for algo, iters in OFF_ITERS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr, cfg = factory.algorithm_factory(
            algo, brt.make("Env01-v2").use_fast_solver(), gamma=OFF_GAMMA)
        check((cfg.n_envs, cfg.buffer_size, cfg.batch_size, cfg.train_freq,
               cfg.gradient_steps) == (256, 1_000_000, 256, 1, 1),
              f"9: {algo}'s factory defaults changed: {cfg}")
        ts = run_off_policy(f"9{'a' if algo == 'SAC' else 'b'} {algo} "
                            "Env01-v2", tr, tr.init(0), iters, modules, "K1")
        if algo == "SAC":
            check(ts.net.log_alpha.item() != 0.0,
                  "9a: log_alpha did not move from 0")
        if algo == "TD3":
            # actor_t moves on the updates that step the actor (an even
            # grad_steps before the update) and only on those
            moved = {}
            for _ in range(2):
                before = [p.clone() for p in ts.net.actor_t.parameters()]
                parity = ts.grad_steps % 2
                ts, _ = tr._update(ts)
                moved[parity] = not all(torch.equal(a, b) for a, b in zip(
                    before, ts.net.actor_t.parameters()))
            check(moved == {0: True, 1: False},
                  f"9b: TD3's actor_t moved by grad_steps parity: {moved}")
            print("training 9b TD3: actor_t unchanged across an update at "
                  "an odd grad_steps, moved across one at an even")
        del tr, ts

    # ---- 9c: SAC on Env03-v2 with the privileged critic, warm-started
    # from the committed symmetric SAC
    warm = checkpoint.load(POLICY03_SAC)
    tr, cfg = factory.algorithm_factory(
        "SAC", brt.make("Env03-v2").use_fast_solver(), gamma=OFF_GAMMA,
        privileged_critic=True)
    ts = tr.init(0, params=warm)
    ck = offpolicy.from_numpy_params(warm, "SAC", device="cuda")
    check(tuple(ck.q1[0].w.shape) == (8, 256)
          and tuple(ts.net.q1[0].w.shape) == (16, 256),
          f"9c: Q widths {tuple(ck.q1[0].w.shape)} -> "
          f"{tuple(ts.net.q1[0].w.shape)}")
    update, seen = tr._update, {}

    def first_update(ts, idx=None, normals=None):
        """The first update's batch, drawn as `_update` draws it, on which
        the padded Q must equal the checkpoint's."""
        if not seen:
            idx = torch.randint(0, max(min(ts.ptr, cfg.buffer_size), 1),
                                (cfg.batch_size,), generator=ts.gen,
                                device="cuda")
            b = ts.buffer
            with torch.no_grad():
                padded = tr._q(ts.net.q1, b.obs[idx], b.act[idx], b.priv[idx])
                base = ck.q1(torch.cat((b.obs[idx], b.act[idx]), -1))[..., 0]
            seen.update(gap=(padded - base).abs().max().item(),
                        scale=max(1.0, base.abs().max().item()),
                        priv=b.priv[idx].abs().max().item())
        return update(ts, idx=idx, normals=normals)

    tr._update = first_update
    ts = run_off_policy("9c SAC Env03-v2 privileged critic", tr, ts,
                        OFF_ITERS_03, modules, "K2")
    print(f"training 9c: warm start from {POLICY03_SAC}: q1/0/w (8, 256) "
          f"-> (16, 256); padded vs the checkpoint's Q on the first batch: "
          f"{seen['gap']:.3e} (values up to {seen['scale']:.3f}; privileged "
          f"features up to {seen['priv']:.3f})")
    check(seen["gap"] <= 1e-5 * seen["scale"] and seen["priv"] > 0,
          f"9c: the padded Q departs from the checkpoint's: {seen}")
    check(all(getattr(ts.net, q)[0].w[8:].abs().max().item() > 0
              for q in ("q1", "q2")),
          "9c: the privileged Q rows are still zero after the updates")
    del tr, ts

    # ---- 9d: the committed off-policy checkpoints, served
    for algo, path in OFF_SERVED.items():
        env = brt.make("Env01-v2", seed=OFF_SERVE_SEED).use_fast_solver()
        tr, _ = factory.algorithm_factory(algo, env)
        net = offpolicy.from_numpy_params(checkpoint.load(path), algo,
                                          device="cuda")
        zero_counts(modules)
        t0 = time.perf_counter()
        rets, lens = tr.evaluator.evaluate_detail(net, SERVE_EPISODES,
                                                  SERVE_STEPS)
        seconds = time.perf_counter() - t0
        survival = float((lens >= SERVE_STEPS).mean())
        print(f"serving 9d: {path} through OffPolicy's evaluator, "
              f"{SERVE_EPISODES} Env01-v2 episodes, max {SERVE_STEPS} "
              f"steps, fast grade, in {seconds:.2f} s with "
              f"{modules['K1'].KERNEL.launches} K1 launches: survival "
              f"{survival:.4f}, mean return {rets.mean():.4f}")
        check(counts_of(modules)["K2"] == counts_of(modules)["K3"] == 0
              and modules["K1"].KERNEL.launches > 0,
              "9d: another kernel launched")
        check(survival >= SURVIVAL_FLOOR,
              f"9d: {algo} survival {survival:.3f} < {SURVIVAL_FLOOR}")

    # ---- 9e: the harvest of fatal states through K2
    env = brt.make("Env03-v2").use_fast_solver()
    env.block_delay = HARVEST_DELAY
    env.max_episode_steps = HARVEST_STEPS
    params = checkpoint.load(POLICY03)
    zero_counts(modules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank, info = harvest_fatal_states(env, params, HARVEST_EPISODES,
                                      HARVEST_SEED, HARVEST_CHUNK)
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    n = info["n_bank"]
    check(counts["K1"] == counts["K3"] == 0 and counts["K2"] > 0
          and counts["K2"] % HARVEST_CHUNK == 0,
          f"9e: the harvest must launch K2 only, per chunk: {counts}")
    check(0 < n <= info["n_fatal"] and (info["death_dt"] >= 0).all()
          and info["obs"].shape == (n, 6)
          and all(leaf.shape[0] == n for leaf in checkpoint.flatten(
              bank, "", {}).values()),
          f"9e: the bank breaks its invariants: "
          f"{ {k: v for k, v in info.items() if k != 'obs'} }")
    fresh = brt.make("Env03-v2", seed=9).use_fast_solver()
    one = tree_map(lambda x: x[:1], bank)
    one = one._replace(t=torch.zeros_like(one.t))
    one, obs = fresh._obs(one, fresh._noise(1, 2))
    net = mlp.from_numpy_params(params, device="cuda")
    before = modules["K2"].KERNEL.launches
    with torch.no_grad():
        s2, obs2, r, _, _ = fresh.step(one, net.policy_mean(obs).clamp(-1, 1))
    check(modules["K2"].KERNEL.launches == before + 1
          and torch.isfinite(obs2).all().item()
          and torch.isfinite(r).all().item()
          and all(torch.isfinite(t).all().item() for t in s2.phys),
          "9e: the step from bank[0] is not finite")
    print(f"harvest 9e: Env03-v2 {POLICY03}, {HARVEST_EPISODES} episodes of "
          f"at most {HARVEST_STEPS} steps, block_delay {HARVEST_DELAY}, "
          f"chunk {HARVEST_CHUNK}, fast grade, in {seconds:.2f} s with "
          f"{counts['K2']} K2 launches: full-horizon rate "
          f"{info['full_rate']:.4f}, {info['n_fatal']} fatal, {n} banked, "
          f"death_dt median {np.median(info['death_dt']):.1f} steps; bank[0] "
          "restarted at t = 0 on a fresh generator, one finite K2 step")
    print(f"off-policy: phase 9 in {time.perf_counter() - t9:.1f} s")


# --------------------------------------------------------------- phase 10

def _train_state_arrays(ts):
    """{name: numpy} of what a replicated PPO run must agree on: the params
    (the JAX layout), the Adam moments and steps, the episode stats."""
    from balance_robot_tpu_torch.models import mlp
    out = {f"params/{k}": v for k, v in mlp.to_numpy_params(ts.net).items()}
    for name, p in ts.net.named_parameters():
        for slot, value in ts.opt.state[p].items():
            out[f"opt/{name}/{slot}"] = value.detach().cpu().numpy()
    out["stat_sum_ret"] = ts.stat_sum_ret.cpu().numpy()
    out["stat_n_eps"] = ts.stat_n_eps.cpu().numpy()
    return out


def _largest_gap(a, b):
    """(max |a - b| over every array, the key where it is, keys equal)."""
    if sorted(a) != sorted(b):
        return float("inf"), "keys", False
    gaps = {k: float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64)), initial=0.0))
            for k in a}
    key = max(gaps, key=gaps.get)
    return gaps[key], key, all(np.array_equal(a[k], b[k]) for k in a)


def parallel_case(name, mesh=None):
    """One 10b case on this process's share of PAR_ENVS envs (all of them
    without a mesh): (trainer, train state after PAR_CASES[name]'s
    iterations)."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.parallel import mesh as pm
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.ppo import PPO, PPOConfig
    env_id, dtype, iters, privileged = PAR_CASES[name]
    env = brt.make(env_id, dtype=dtype).use_fast_solver()
    cfg = PPOConfig(**dict(TRAIN_CONFIG, n_envs=PAR_ENVS),
                    privileged_critic=privileged)
    ppo = PPO(env, cfg)
    ts = ppo.init(0, params=checkpoint.load(POLICY) if privileged else None)
    if mesh is not None:
        ts = pm.shard_train_state(ts, mesh, cfg.n_envs)
    for _ in range(iters):
        ts, _ = ppo.iteration(ts)
    torch.cuda.synchronize()
    return ppo, ts


def parallel_rank_main(rank, directory):
    """A rank of 10b's two-process gloo world on cuda:0 (chip_smoke.py
    --par-rank R --par-dir D): every case of PAR_CASES on its envs, the
    kernels' launches counted per case; writes D/rank<R>.npz and .json.
    Any failure exits nonzero."""
    from balance_robot_tpu_torch.parallel import distributed
    from balance_robot_tpu_torch.physics import cuda_block, cuda_move
    from balance_robot_tpu_torch.physics import cuda_step
    modules = {"K1": cuda_step, "K2": cuda_block, "K3": cuda_move}
    for m in modules.values():
        m.KERNEL.build()   # the parent built them: loads the libraries
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(backend="gloo",
                           init_method=f"file://{directory}/rendezvous",
                           world_size=PAR_RANKS, rank=rank)
    mesh = distributed.global_env_mesh()
    arrays, facts = {}, {}
    for name in PAR_CASES:
        zero_counts(modules)
        t0 = time.perf_counter()
        _, ts = parallel_case(name, mesh)
        facts[name] = dict(seconds=time.perf_counter() - t0,
                           counts=counts_of(modules))
        arrays.update({f"{name}/{k}": v
                       for k, v in _train_state_arrays(ts).items()})
        del ts
    np.savez(pathlib.Path(directory) / f"rank{rank}.npz", **arrays)
    (pathlib.Path(directory) / f"rank{rank}.json").write_text(
        json.dumps(facts))
    torch.distributed.destroy_process_group()


def parallel_phase(modules):
    """Phase 10: 10a, 10b and 10c (see the module docstring)."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.parallel import distributed
    from balance_robot_tpu_torch.parallel import mesh as pm
    from balance_robot_tpu_torch.train.ppo import PPO, PPOConfig
    from balance_robot_tpu_torch.utils import drift
    from balance_robot_tpu_torch.utils.profiling import Timer

    t10 = time.perf_counter()
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    cfg = PPOConfig(**TRAIN_CONFIG)
    per_iter = cfg.n_envs * cfg.n_steps

    # ---- 10a: a NCCL world of one rank, through the sharded path
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        distributed.initialize(init_method=f"file://{tmp}/rendezvous",
                               world_size=1, rank=0)
        check(torch.distributed.get_backend() == "nccl",
              f"10a: backend {torch.distributed.get_backend()}")
        mesh = distributed.global_env_mesh()
        ppo = PPO(brt.make("Env01-v2").use_fast_solver(), cfg)
        ts = ppo.init(0)
        for _ in range(PAR_ITERS):
            ts, metrics = ppo.iteration(ts)
        plain = _train_state_arrays(ts)
        sharded = PPO(brt.make("Env01-v2").use_fast_solver(), cfg)
        ts = pm.shard_train_state(sharded.init(0), mesh, cfg.n_envs)
        first, timer = Timer(), Timer()
        moved = []        # bytes of each gather's buffer (world x local)

        def gather_rows(tensors, mesh, dim=0):
            moved.append(mesh.size * sum(t.numel() * t.element_size()
                                         for t in tensors))
            return gather(tensors, mesh, dim)

        gather = pm.gather_rows
        torch.cuda.synchronize()
        zero_counts(modules)
        with mock.patch.object(pm, "gather_rows", gather_rows):
            for i in range(PAR_ITERS):
                t = first if i == 0 else timer
                with t("iteration"):
                    ts, metrics_s = sharded.iteration(ts, timer=t)
        torch.cuda.synchronize()
        counts = counts_of(modules)
        check(counts == {n: PAR_ITERS * cfg.n_steps * (n == "K1")
                         for n in modules},
              f"10a: the sharded run must launch K1 {PAR_ITERS * cfg.n_steps}"
              f" times and no other kernel: {counts}")
        check(len(moved) == PAR_ITERS,
              f"10a: {len(moved)} gathers in {PAR_ITERS} iterations")
        gap, key, equal = _largest_gap(plain, _train_state_arrays(ts))
        check(equal and all(torch.equal(metrics[k], metrics_s[k])
                            for k in metrics),
              f"10a: the sharded run at world 1 departs from the unsharded "
              f"one by {gap:.3e} ({key})")
        torch.distributed.destroy_process_group()
    del ppo, sharded, ts
    rep, rep1 = timer.report(), first.report()
    print(f"parallel 10a: NCCL world of 1, Env01-v2 {cfg.n_envs} envs x "
          f"{cfg.n_steps} steps, {PAR_ITERS} iterations through the sharded "
          f"path: params, Adam moments, stats and metrics bit-equal to the "
          f"unsharded run ({len(plain)} arrays), K1 launches {counts['K1']};"
          f" after the first: {rep['iteration']['mean_ms']:.1f} ms per "
          f"iteration = rollout {rep['rollout']['mean_ms']:.1f} ms (the "
          f"gather of {moved[-1]} bytes {rep['gather']['mean_ms']:.3f} ms "
          f"inside it) + update {rep['update']['mean_ms']:.1f} ms, "
          f"{per_iter / rep['iteration']['mean_ms'] * 1e3:.1f} training "
          f"env-steps/s; the first {rep1['iteration']['mean_ms']:.1f} ms "
          f"(gather {rep1['gather']['mean_ms']:.3f})")

    # ---- 10b: two ranks on cuda:0 over gloo (NCCL refuses two ranks on
    # one card), each with half of PAR_ENVS envs, against one process
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--par-rank", str(r), "--par-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(PAR_RANKS)]
        try:
            single = {}
            zero_counts(modules)
            for name in PAR_CASES:
                _, ts = parallel_case(name)
                single[name] = _train_state_arrays(ts)
                del ts
            single_counts = counts_of(modules)
            for r, p in enumerate(procs):
                try:
                    _, err = p.communicate(timeout=PAR_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    fail(f"10b: rank {r} did not finish in {PAR_TIMEOUT_S} s")
                check(p.returncode == 0,
                      f"10b: rank {r} exited {p.returncode}:\n{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        arrays = [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz"))
                  for r in range(PAR_RANKS)]
        facts = [json.loads((pathlib.Path(tmp) / f"rank{r}.json")
                            .read_text()) for r in range(PAR_RANKS)]
    seconds = time.perf_counter() - t0
    n_local = PAR_ENVS // PAR_RANKS
    for name, (env_id, dtype, iters, privileged) in PAR_CASES.items():
        kernel = "K2" if env_id.startswith("Env03") else "K1"
        want = {n: iters * cfg.n_steps * (n == kernel) for n in modules}
        for r, f in enumerate(facts):
            check(f[name]["counts"] == want,
                  f"10b {name}: rank {r} must launch {kernel} "
                  f"{want[kernel]} times at B = {n_local} and no other "
                  f"kernel: {f[name]['counts']}")
        ranks = [{k[len(name) + 1:]: v for k, v in a.items()
                  if k.startswith(name + "/")} for a in arrays]
        _, key, equal = _largest_gap(ranks[0], ranks[1])
        check(equal, f"10b {name}: the ranks' train states differ ({key})")
        gap, key, equal = _largest_gap(ranks[0], single[name])
        # each env's chain in K1 and K2 is its own, both of K1's batches
        # lie below its crossover (the team of 32 at both), K2's bits do
        # not depend on its team (its row sums are 32 lanes' at any
        # batch), and the policy's products per row do not depend on the
        # batch here: any gap is a finding (PERF.md)
        check(equal, f"10b {name}: two ranks depart from one process by "
              f"{gap:.3e} ({key})")
        print(f"parallel 10b {name}: {env_id} {str(dtype)[6:]}"
              f"{' privileged critic from ' + POLICY if privileged else ''}, "
              f"{PAR_RANKS} x {n_local} envs over gloo on one card, {iters} "
              f"iteration(s), {kernel} launches {want[kernel]} per rank at B "
              f"= {n_local} (team, envs per block, shared bytes: "
              f"{launch_shapes(modules[kernel].KERNEL, dtype)}): the ranks' "
              f"train states and one process's at B = {PAR_ENVS} bit-equal "
              f"({len(ranks[0])} arrays); rank 0 took "
              f"{facts[0][name]['seconds']:.2f} s")
    print(f"parallel 10b: {seconds:.1f} s with the one-process runs "
          f"({single_counts} launches at B = {PAR_ENVS})")

    # ---- 10c: the drift probe of K1 and K2 against float64, within its
    # bounds, on two draws
    for env_id, kernel in (("Env01-v2", "K1"), ("Env03-v2", "K2")):
        for seed in DRIFT_SEEDS:
            zero_counts(modules)
            t0 = time.perf_counter()
            try:
                d = drift.assert_drift_bounded(env_id, steps=DRIFT_STEPS,
                                               batch=DRIFT_BATCH, seed=seed)
            except AssertionError as e:
                fail(f"10c: {e}")
            counts = counts_of(modules)
            check(counts == {n: DRIFT_STEPS * (n == kernel) for n in modules},
                  f"10c {env_id}: the probe must launch {kernel} "
                  f"{DRIFT_STEPS} times: {counts}")
            print(f"parallel 10c drift {env_id} seed {seed} ({kernel} "
                  f"float32 fast on the card vs float64 on the CPU, "
                  f"{DRIFT_BATCH} envs, max |obs| per step): "
                  + ", ".join(f"{x:.3e}" for x in d)
                  + f"; bounds {drift.STEP1_BOUND[env_id]:.0e} at step 1, "
                  f"{drift.STEP5_BOUND[env_id]:.0e} at step 5; "
                  f"{time.perf_counter() - t0:.1f} s")
    print(f"parallel: phase 10 in {time.perf_counter() - t10:.1f} s")


# --------------------------------------------------------------- phase 11

@contextlib.contextmanager
def short_horizon(steps):
    """Every env that `brt.make` builds while the block runs has a horizon
    of `steps` control steps (the workflow's own `make` calls included),
    as tests/test_burst_gate.py cuts the JAX tool's."""
    import balance_robot_tpu_torch as brt
    make = brt.make

    def cut(env_id, **kwargs):
        env = make(env_id, **kwargs)
        env.max_episode_steps = steps
        return env

    with mock.patch.object(brt, "make", cut):
        yield


@contextlib.contextmanager
def workflow_spies(modules, kernel="K2"):
    """While the block runs, every paired eval and harvest of the workflow
    is timed by the host clock around a sync, every PPO iteration by CUDA
    events (`utils/profiling.Timer`: iteration, rollout, update), and each
    one's launches of `kernel` are counted. Yields {"evals": [...],
    "harvests": [...], "iterations": [...]}, one dict per call (its
    seconds or ms, its launches, and an eval's or a harvest's result)."""
    from balance_robot_tpu_torch.train import harvest, selection
    from balance_robot_tpu_torch.train.ppo import PPO
    from balance_robot_tpu_torch.utils.profiling import Timer
    log = {"evals": [], "harvests": [], "iterations": []}

    def timed(kind, fn):
        def spy(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = modules[kernel].KERNEL.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log[kind].append(dict(
                seconds=time.perf_counter() - t0, out=out,
                launches=modules[kernel].KERNEL.launches - before))
            return out
        return spy

    iteration = PPO.iteration

    def timed_iteration(self, ts, timer=None):
        t, before = Timer(), modules[kernel].KERNEL.launches
        with t("iteration"):
            out = iteration(self, ts, timer=t)
        log["iterations"].append(dict(
            launches=modules[kernel].KERNEL.launches - before,
            **{k: v["mean_ms"] for k, v in t.report().items()}))
        return out

    with mock.patch.object(selection, "paired_eval",
                           timed("evals", selection.paired_eval)), \
            mock.patch.object(harvest, "harvest_fatal_states",
                              timed("harvests",
                                    harvest.harvest_fatal_states)), \
            mock.patch.object(PPO, "iteration", timed_iteration):
        yield log


def check_eval_launches(what, log, horizon):
    """Each eval launched K2 once per step of its horizon, or ended early
    with every episode done."""
    for e in log["evals"]:
        lens = e["out"][4]
        check(e["launches"] == horizon or (
            e["launches"] < horizon and lens.max() <= e["launches"]),
            f"{what}: an eval of horizon {horizon} launched K2 "
            f"{e['launches']} times (longest episode {lens.max()})")


def report_workflow(what, log, counts):
    """Print a run's K2 launches by part, the ms per PPO iteration and the
    seconds of each eval and harvest."""
    its, evs, hvs = log["iterations"], log["evals"], log["harvests"]
    n_it, n_ev, n_hv = (sum(x["launches"] for x in part)
                        for part in (its, evs, hvs))
    check(counts["K1"] == counts["K3"] == 0
          and counts["K2"] == n_it + n_ev + n_hv,
          f"{what}: K2 only, {n_it} in the rollouts + {n_ev} in the evals "
          f"+ {n_hv} in the harvests: {counts}")
    line = (f"{what}: K2 launches {counts['K2']} = rollouts {n_it} + evals "
            f"{n_ev} ({len(evs)} evals) + harvests {n_hv}")
    if its:
        line += "; ms per iteration (CUDA events) " + ", ".join(
            f"{x['iteration']:.1f} = rollout {x['rollout']:.1f} + update "
            f"{x['update']:.1f}" for x in its)
    if evs:
        line += "; s per eval " + ", ".join(f"{x['seconds']:.2f}"
                                             for x in evs)
    if hvs:
        line += "; s per harvest " + ", ".join(f"{x['seconds']:.2f}"
                                                for x in hvs)
    print(line)


def check_history(what, hist, n_rows, confirm):
    """burst_history.json in the JAX tool's schema."""
    best = hist["best"]
    check(set(hist) == {"best", "history", "accepted", "min_win"}
          and {"score", "ret", "src"} <= set(best)
          and ({"cscore"} <= set(best)) == confirm
          and len(hist["history"]) == n_rows
          and all({"burst", "steps", "lr", "full", "ret", "len"} <= set(r)
                  for r in hist["history"]),
          f"{what}: burst_history.json departs from the JAX tool's "
          f"schema: {hist}")


def selection_11a(modules, tmp):
    """11a: the ratchet at the flagship's training width, one burst of two
    iterations and two snapshots, the accept forced so that the confirm
    set and the pooled gate run, the evals cut to SEL_STEPS_11A."""
    from balance_robot_tpu_torch.train import burst, checkpoint
    zero_counts(modules)
    t0 = time.perf_counter()
    with short_horizon(SEL_STEPS_11A), workflow_spies(modules) as log:
        res = burst.main([
            "--init", str(tmp / "r2i.npz"), "--out", str(tmp / "11a"),
            "--bursts", "1", "--burst-steps", "65536",
            "--snap-steps", "32768", "--eval-episodes", str(SEL_EPISODES),
            "--confirm", "--min-win", "-1", "--seed", "0",
            "--device", "cuda"])
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    hist = json.loads((tmp / "11a" / "burst_history.json").read_text())
    check_history("11a", hist, 2, True)
    best = hist["best"]
    check((hist["accepted"] and best["src"].startswith("burst0@"))
          or best.get("reverted_by_gate") is True,
          f"11a: neither accepted nor reverted by the gate: {best}")
    check(set(best["pooled"]) == {"incumbent", "winner"}
          and len(log["evals"]) == 10 and len(log["iterations"]) == 2
          and all(x["launches"] == 32 for x in log["iterations"]),
          f"11a: {len(log['evals'])} evals (1 + 1 + 2 + 2 + 4 expected), "
          f"iterations {log['iterations']}, pooled {best.get('pooled')}")
    check_eval_launches("11a", log, SEL_STEPS_11A)
    saved = checkpoint.load(tmp / "11a" / "best_model.npz")
    check(set(saved) == set(res["params"]) and all(
        np.array_equal(saved[k], res["params"][k]) for k in saved),
        "11a: best_model.npz does not load back bit for bit")
    report_workflow("selection 11a", log, counts)
    print(f"selection 11a: burst.main on Env03-v2 from {POLICY03}, 1024 "
          f"envs x 32 steps, 2 iterations, 2 snapshots, {SEL_EPISODES} "
          f"episodes per eval of {SEL_STEPS_11A} steps, --confirm "
          f"--min-win -1, in {seconds:.1f} s: accepted {hist['accepted']}, "
          f"best {best}; best_model.npz read back bit for bit")
    return res


def selection_11b(modules, tmp):
    """11b: the hardened burst with failure replay and the privileged
    critic, its first eval at the full horizon, its harvest and the eval
    after it at SEL_STEPS_11B steps; every rollout reward 1.0, the replayed
    and front shares, and K2's first rollout launch (replayed bank states
    in its batch) held to the plain version."""
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.train import burst, harvest
    rewards, first, kept = [], {}, []
    step, reset = VecEnv.step, VecEnv.reset

    def step_spy(self, states, actions, uniforms=None):
        if rewards:
            out = step(self, states, actions, uniforms)
        else:
            with inputs_of_launch(modules, "K2", 0) as k:
                out = step(self, states, actions, uniforms)
            kept.extend(k)
        rewards.append(out[1].reward)
        return out

    def reset_spy(self):
        states, obs = reset(self)
        first.update(env=self.env, aux=states.aux)
        return states, obs

    def cut(harvest_fatal_states):
        def spy(env, *args, **kwargs):
            # the burst's eval env: its harvest and the evals after it
            env.max_episode_steps = SEL_STEPS_11B
            return harvest_fatal_states(env, *args, **kwargs)
        return spy

    zero_counts(modules)
    t0 = time.perf_counter()
    with workflow_spies(modules) as log, \
            mock.patch.object(VecEnv, "step", step_spy), \
            mock.patch.object(VecEnv, "reset", reset_spy), \
            mock.patch.object(harvest, "harvest_fatal_states",
                              cut(harvest.harvest_fatal_states)):
        res = burst.main([
            "--init", str(tmp / "r2i.npz"), "--out", str(tmp / "11b"),
            "--bursts", "1", "--burst-steps", "32768",
            "--snap-steps", "32768", "--eval-episodes", str(SEL_EPISODES),
            "--failure-replay", str(SEL_EPISODES),
            "--replay-frac", str(REPLAY_FRAC), "--survival-reward",
            "--train-back-frac", str(BACK_FRAC), "--train-block-delay",
            "0.2", "--privileged-critic", "--seed", "0", "--device", "cuda"])
    seconds = time.perf_counter() - t0
    counts = counts_of(modules)
    hist = json.loads((tmp / "11b" / "burst_history.json").read_text())
    check_history("11b", hist, 1, False)
    check(len(log["evals"]) == 2 and len(log["harvests"]) == 1,
          f"11b: {len(log['evals'])} evals, {len(log['harvests'])} harvests")
    check_eval_launches("11b", {"evals": log["evals"][:1]}, 1200)
    check_eval_launches("11b", {"evals": log["evals"][1:]}, SEL_STEPS_11B)
    n_bank = res["banks"]
    check(len(n_bank) == 1 and n_bank[0] > 0,
          f"11b: the failure-replay bank is empty: {n_bank}")
    r = torch.stack(rewards)
    check(r.shape == (32, 1024) and bool((r == 1.0).all()),
          f"11b: rollout rewards other than 1.0 (min {r.min().item()}, "
          f"max {r.max().item()}) over {tuple(r.shape)}")
    wrap, aux = first["env"], first["aux"]
    n, n_rep = wrap.resets, int(wrap.replayed)
    se = (REPLAY_FRAC * (1 - REPLAY_FRAC) / n) ** 0.5
    check(abs(n_rep / n - REPLAY_FRAC) <= 3 * se,
          f"11b: {n_rep} of {n} resets replayed, {n_rep / n:.4f} against "
          f"{REPLAY_FRAC} +- 3 x {se:.4f}")
    plain = ~aux["replayed"]
    n_plain = int(plain.sum())
    front = aux["attack_front"][plain].double().mean().item()
    se_f = (BACK_FRAC * (1 - BACK_FRAC) / n_plain) ** 0.5
    check(abs(front - (1 - BACK_FRAC)) <= 3 * se_f,
          f"11b: {front:.4f} of {n_plain} plain slots attacked from the "
          f"front, against {1 - BACK_FRAC} +- 3 x {se_f:.4f}")
    report_workflow("selection 11b", log, counts)
    print(f"selection 11b: hardened burst (survival reward, back_frac "
          f"{BACK_FRAC}, block_delay 0.2, privileged critic, failure "
          f"replay {SEL_EPISODES} at {REPLAY_FRAC}) from {POLICY03}, 1 "
          f"iteration, the first eval at 1200 steps, the harvest and the "
          f"second eval at {SEL_STEPS_11B}, in {seconds:.1f} s: bank "
          f"{n_bank[0]} states; every one of {r.numel()} rollout rewards "
          f"1.0; {n_rep} of {n} resets replayed ({n_rep / n:.4f}, s.e. "
          f"{se:.4f}); {front:.4f} of the {n_plain} plain slots attacked "
          f"from the front (s.e. {se_f:.4f}); {int(aux['replayed'].sum())} "
          "replayed rows in the first rollout step's batch")
    hold_on_path(modules, "K2", "11b's first rollout step (replayed bank "
                 "states)", kept)
    return log["evals"][0]["out"]


def selection_11c(modules, tmp, first, snapshot):
    """11c: the paired eval of r2i at seed 0 again, bit-equal to 11b's
    first (the same call); another policy at seed 0 resets the same
    episodes."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.train import checkpoint, selection
    env = brt.make("Env03-v2").use_fast_solver()
    starts = []

    def keep(states, obs):
        starts.append(states.phys.qpos.clone())

    zero_counts(modules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = selection.paired_eval(
        *selection.act_fn_for(checkpoint.load(tmp / "r2i.npz"), env), 0,
        SEL_EPISODES, on_start=keep)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_eval = modules["K2"].KERNEL.launches
    check(np.array_equal(again[3], first[3])
          and np.array_equal(again[4], first[4]),
          "11c: two paired evals of r2i at seed 0 are not bit-equal "
          f"(full {first[0]} and {again[0]})")
    rate = again[0]
    se = (rate * (1 - rate) / SEL_EPISODES) ** 0.5
    check(SEL_RATE_BAND[0] <= rate <= SEL_RATE_BAND[1],
          f"11c: r2i's full-horizon rate {rate:.4f} outside "
          f"{SEL_RATE_BAND}")
    selection.paired_eval(*selection.act_fn_for(snapshot, env), 0,
                          SEL_EPISODES, SEL_SNAP_STEPS, on_start=keep)
    counts = counts_of(modules)
    check(torch.equal(starts[0], starts[1]),
          "11c: another policy at seed 0 saw other resets")
    check(counts == {"K1": 0, "K2": n_eval + SEL_SNAP_STEPS, "K3": 0},
          f"11c: K2 only, {n_eval} + {SEL_SNAP_STEPS}: {counts}")
    print(f"selection 11c: paired_eval of {POLICY03} at seed 0, "
          f"{SEL_EPISODES} x 1200, in {seconds:.1f} s with {n_eval} K2 "
          f"launches: returns and lengths bit-equal to 11b's first eval; "
          f"full-horizon rate {rate:.4f} (s.e. {se:.4f}; band "
          f"{SEL_RATE_BAND}), mean return {again[1]:.2f}, mean length "
          f"{again[2]:.1f}; 11a's snapshot at seed 0 ({SEL_SNAP_STEPS} "
          "steps) reset the same qpos bit for bit")


def selection_11d(modules, tmp):
    """11d: the sweep of a copy of models/Env03-v2_PPO and the large eval
    of r2i (float and int8), both cut to SEL_STEPS_11D, and of the
    committed Env01-v2 SAC at 256 x 200 (K1)."""
    from balance_robot_tpu_torch.train import eval_policy, sweep

    def run(what, fn, argv, steps, kernel):
        zero_counts(modules)
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with short_horizon(steps), contextlib.redirect_stdout(buf):
            out = fn(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = counts_of(modules)
        check(counts[kernel] > 0 and all(
            v == 0 for k, v in counts.items() if k != kernel),
            f"{what}: {kernel} only: {counts}")
        lines = buf.getvalue().splitlines()
        print(f"selection {what} in {seconds:.1f} s, {counts[kernel]} "
              f"{kernel} launches:\n  " + "\n  ".join(lines))
        return out, lines

    rows, _ = run("11d sweep", sweep.main, [
        str(tmp / "Env03-v2_PPO"), "--every", "4", "--episodes",
        str(SEL_SWEEP_EPISODES), "--out", str(tmp / "sweep.json")],
        SEL_STEPS_11D, "K2")
    keys = [(r["full_horizon"], r["mean_len"]) for r in rows]
    check([r["ckpt"] for r in rows if r["ckpt"].startswith("cp_")]
          == ["cp_4063232.npz"] and len(rows) == 4
          and keys == sorted(keys, reverse=True)
          and json.loads((tmp / "sweep.json").read_text()) == rows,
          f"11d: the sweep's rows: {rows}")
    for extra in ([], ["--int8"]):
        (ret, lens, p0), lines = run(
            f"11d eval_policy{' --int8' if extra else ''}",
            eval_policy.main, [str(tmp / "r2i.npz"), "--env", "Env03-v2",
                               "--episodes", str(SEL_EPISODES)] + extra,
            SEL_STEPS_11D, "K2")
        check(ret.shape == lens.shape == p0.shape == (SEL_EPISODES,)
              and np.isfinite(ret).all() and np.isfinite(p0).all()
              and any(line.strip().startswith("all ") for line in lines),
              f"11d: eval_policy {extra}: {lines}")
    (ret, lens, _), _ = run("11d eval_policy SAC", eval_policy.main, [
        str(tmp / "sac.npz"), "--env", "Env01-v2", "--episodes",
        str(SERVE_EPISODES)], SERVE_STEPS, "K1")
    survival = float((lens >= SERVE_STEPS).mean())
    se = (2 * SAC_SURVIVAL_9D * (1 - SAC_SURVIVAL_9D)
          / SERVE_EPISODES) ** 0.5
    check(abs(survival - SAC_SURVIVAL_9D) <= 3 * se,
          f"11d: SAC survival {survival:.4f} against 9d's "
          f"{SAC_SURVIVAL_9D} +- 3 x {se:.4f}")
    print(f"selection 11d: {OFF_SERVED['SAC']} survival {survival:.4f} of "
          f"{SERVE_EPISODES} x {SERVE_STEPS} (exact grade), 9d's "
          f"{SAC_SURVIVAL_9D} +- 3 x {se:.4f} (the two draws' s.e.)")


def selection_phase(modules):
    """Phase 11: 11a-11d (see the module docstring), from a temporary
    directory under build/ with copies of the checkpoints; the repo's
    models/, logs/ and movies/ must be as they were."""
    root = pathlib.Path(__file__).resolve().parent
    guarded = {d: _files(root / d) for d in ("models", "logs", "movies")}
    build = root / "build"
    build.mkdir(exist_ok=True)
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copy(root / POLICY03, tmp / "r2i.npz")
        shutil.copy(root / OFF_SERVED["SAC"], tmp / "sac.npz")
        (tmp / "Env03-v2_PPO").mkdir()
        for f in (root / SWEEP_RUN).glob("*.npz"):
            if f.name.startswith("cp_") or f.stem in (
                    "best_model", "longest_model", "final_model"):
                shutil.copy(f, tmp / "Env03-v2_PPO")
        res = selection_11a(modules, tmp)
        first = selection_11b(modules, tmp)
        selection_11c(modules, tmp, first, res["snapshots"][-1][1])
        selection_11d(modules, tmp)
    after = {d: _files(root / d) for d in guarded}
    check(after == guarded, "phase 11 wrote into the repo's models/, logs/ "
          "or movies/")
    print(f"selection: phase 11 in {time.perf_counter() - t11:.1f} s")



# --------------------------------------------------------------- phase 12

def run_main(what, fn, argv):
    """`fn(argv + ["--device", "cuda"])` (a module's `main`) with its
    standard output captured; prints its lines. Returns (result, lines,
    seconds by the host clock around a sync)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    print(f"tools {what} in {seconds:.1f} s:\n  " + "\n  ".join(lines))
    return out, lines, seconds


@contextlib.contextmanager
def grades_of(modules, kernel):
    """While the block runs, the (newton_iters, ls_iters) of every launch
    of `kernel` through its wrapper go into the yielded set."""
    module, name = modules[kernel], WRAPPERS[kernel][0]
    launch = getattr(module, name)
    seen = set()

    def spy(*args, **kwargs):
        params = args[5 if kernel == "K1" else 4]
        seen.add((params.newton_iters, params.ls_iters))
        return launch(*args, **kwargs)

    with mock.patch.object(module, name, spy):
        yield seen


def tools_12a(modules, tmp):
    """12a: `train_run` trains a teacher (round 4's settings) from r2i, 2
    iterations at the defaults, the runner's evals cut to RUNNER_EVAL_STEPS
    steps; then Env01-v2 at the turbo grade for 1 iteration."""
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, train_run
    from balance_robot_tpu_torch.train.ppo import PPO
    r2i = mlp.from_numpy_params(checkpoint.load(tmp / "r2i.npz"),
                                device="cuda")
    seen = {}
    iteration = PPO.iteration

    def watched(self, ts, timer=None):
        if "gap" not in seen:          # before the first update
            with torch.no_grad():
                padded = ts.net.policy_mean(ts.last_obs)
                base = r2i.policy_mean(ts.last_obs[:, :6])
            seen.update(equal=torch.equal(padded, base),
                        gap=(padded - base).abs().max().item(),
                        obs=tuple(ts.last_obs.shape))
        out = iteration(self, ts, timer=timer)
        seen.setdefault("rows", out[0].net.pi_l1.weight[:, 6:].abs().max()
                        .item())
        return out

    zero_counts(modules)
    with mock.patch.object(PPO, "iteration", watched), \
            short_horizon(RUNNER_EVAL_STEPS), \
            workflow_spies(modules) as log:
        _, lines, seconds = run_main("12a train_run teacher", train_run.main, [
            "Env03-v2", "--privileged-actor", "--init", str(tmp / "r2i.npz"),
            "--gamma", "0.999", "--lr", "1e-4", "--max-steps", "65536",
            "--eval-freq", "65536", "--run-name", "teacher"])
    counts = counts_of(modules)
    its = log["iterations"]
    check(len(its) == 2 and all(x["launches"] == 32 for x in its)
          and counts["K1"] == counts["K3"] == 0,
          f"12a: 2 iterations of 32 K2 launches each: {its}, {counts}")
    check(seen["obs"] == (1024, 14) and seen["equal"],
          f"12a: the padded actor's mean on [obs, priv] departs from r2i's "
          f"on obs by {seen['gap']:.3e} ({seen['obs']})")
    check(seen["rows"] > 0, "12a: the privileged rows of pi_w1 are still "
          "zero after the first update")
    run = pathlib.Path("models") / "teacher"
    saved = {f.stem: checkpoint.load(f) for f in run.glob("*_model.npz")}
    check(lines[-1] == "done; best saved under models/"
          and "final_model" in saved
          and all(v["pi_w1"].shape == (14, 64) for v in saved.values()),
          f"12a: the artifacts {sorted(saved)}: "
          f"{[v['pi_w1'].shape for v in saved.values()]}")
    n_eval = counts["K2"] - 64
    print(f"tools 12a: {' + '.join(str(x['launches']) for x in its)} K2 "
          f"launches in the rollouts (1024 envs x 32 steps), {n_eval} in "
          f"the runner's 2 evals of 5 x {RUNNER_EVAL_STEPS} steps; ms per "
          "iteration (CUDA events) " + ", ".join(
              f"{x['iteration']:.1f} = rollout {x['rollout']:.1f} + update "
              f"{x['update']:.1f}" for x in its)
          + f"; padded mean on [obs, priv] bit-equal to r2i's on obs "
          f"(largest gap {seen['gap']:.1e}); privileged rows of pi_w1 up to "
          f"{seen['rows']:.3e} after the first update; the run's params "
          f"{sorted(saved)} with 14 inputs (best_model.npz is written where "
          "an eval beats the warm start's)")

    zero_counts(modules)
    with grades_of(modules, "K1") as grades, workflow_spies(
            modules, "K1") as log:
        _, lines, _ = run_main("12a train_run turbo", train_run.main, [
            "Env01-v2", "--solver", "turbo", "--max-steps", "32768",
            "--run-name", "turbo"])
    counts = counts_of(modules)
    check(counts == {"K1": 32, "K2": 0, "K3": 0} and grades == {(2, 4)}
          and lines[-1] == "done; best saved under models/"
          and (pathlib.Path("models") / "turbo" / "final_model.npz")
          .exists(),
          f"12a turbo: {counts}, grades {grades}")
    x, = log["iterations"]
    print(f"tools 12a turbo: K1 launches {counts['K1']} at Newton "
          f"{sorted(grades)[0][0]} / line search {sorted(grades)[0][1]}; "
          f"{x['iteration']:.1f} ms = rollout {x['rollout']:.1f} + update "
          f"{x['update']:.1f} (the first iteration)")


def tools_12b(modules):
    """12b: `train_offpolicy` SAC on Env01-v2 at the tool's defaults, 20
    iterations past learning_starts; collect and update ms by CUDA
    events, updates per iteration."""
    from balance_robot_tpu_torch.train import train_offpolicy
    from balance_robot_tpu_torch.train.offpolicy import OffPolicy
    from balance_robot_tpu_torch.utils.profiling import Timer
    n_envs, grad_steps, starts = 64, 8, 10_000
    warm = -(-starts // n_envs) - 1          # iterations with no update
    iters = warm + OFF_ITERS_PAST_STARTS
    rows, timers = [], []
    iteration, update = OffPolicy.iteration, OffPolicy._update

    def timed(self, ts, timer=None):
        t = Timer()
        timers.append(t)
        rows.append(dict(updates=0, k1=modules["K1"].KERNEL.launches))
        with t("iteration"):
            out = iteration(self, ts, timer=t)
        rows[-1]["k1"] = modules["K1"].KERNEL.launches - rows[-1]["k1"]
        return out

    def counted(self, ts, idx=None, normals=None):
        rows[-1]["updates"] += 1
        return update(self, ts, idx, normals)

    zero_counts(modules)
    with mock.patch.object(OffPolicy, "iteration", timed), \
            mock.patch.object(OffPolicy, "_update", counted):
        _, lines, seconds = run_main("12b train_offpolicy SAC",
                                     train_offpolicy.main, [
            "SAC", "Env01-v2", "--max-steps", str(iters * n_envs)])
    counts = counts_of(modules)
    ups = [r["updates"] for r in rows]
    check(len(rows) == iters and ups == [0] * warm
          + [grad_steps] * OFF_ITERS_PAST_STARTS
          and all(r["k1"] == 1 for r in rows)
          and counts == {"K1": iters, "K2": 0, "K3": 0}
          and lines[-1] == "done; artifacts under models/Env01-v2_SAC/",
          f"12b: updates per iteration {ups}, {counts}")
    reps = [t.report() for t in timers]

    def mean(key, part):
        return float(np.mean([r[key]["mean_ms"] for r in part]))

    before, after = reps[1:warm], reps[warm:]
    print(f"tools 12b: {iters} iterations of 64 envs ({warm} before "
          f"learning_starts {starts}, then {grad_steps} updates of batch "
          f"256 each), K1 launches {counts['K1']}; ms per iteration (CUDA "
          f"events, means) before: {mean('iteration', before):.3f} = collect "
          f"{mean('collect', before):.3f} + update "
          f"{mean('update', before):.3f}; after: "
          f"{mean('iteration', after):.3f} = collect "
          f"{mean('collect', after):.3f} + update {mean('update', after):.3f}"
          f" ({mean('update', after) / grad_steps:.3f} per update step)")


def tools_12c(modules, tmp):
    """12c: `profile_train` at its defaults, 2 reps, with a trace; the
    per-phase kernels and busy share, the update's largest kernels."""
    from balance_robot_tpu_torch.train import profile_train
    zero_counts(modules)
    res, lines, seconds = run_main("12c profile_train", profile_train.main, [
        "--reps", "2", "--trace", str(tmp / "trace")])
    counts = counts_of(modules)
    names = ("config:", "rollout-only", "gae+update-only", "full iteration",
             "overhead (iter - roll - upd)")
    trace = res["trace"]
    roll_k1 = sum(c for n, _, c in trace["rollout"]["top"]
                  if "control_step_kernel" in n)
    check(all(line.startswith(n) for line, n in zip(lines, names))
          and counts == {"K1": 8 * 64, "K2": 0, "K3": 0} and roll_k1 == 64
          and all(trace[p]["kernels"] > 0 for p in profile_train.PHASES),
          f"12c: {counts}, K1 in the traced rollout {roll_k1}, "
          f"{ {p: v['kernels'] for p, v in trace.items()} }")
    upd = trace["update"]

    def short(name):
        for noise in ("void ", "at::native::", "(anonymous namespace)::"):
            name = name.replace(noise, "")
        return name[:110]

    print("tools 12c: the update's ten largest kernels by CUDA time (ms, "
          "launches): " + "; ".join(f"{short(n)} {ms:.3f} ({c})"
                                    for n, ms, c in upd["top"][:10]))
    print("tools 12c: busy share of the traced iteration's phases: "
          + ", ".join(
        f"{p} {100 * trace[p]['busy_ms'] / trace[p]['wall_ms']:.1f}% of "
        f"{trace[p]['wall_ms']:.1f} ms ({trace[p]['kernels']} kernels)"
        for p in profile_train.PHASES))


def tools_12d(modules, tmp):
    """12d: `widen_policy` of r2i with the privileged inputs, 256 units."""
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, widen_policy
    out = tmp / "wide" / "wide_init.npz"
    zero_counts(modules)
    _, lines, _ = run_main("12d widen_policy", widen_policy.main, [
        str(tmp / "r2i.npz"), "--env", "Env03-v2", "--priv", "--hidden",
        "256", "--out", str(out)])
    net = mlp.from_numpy_params(checkpoint.load(out), device="cuda")
    check(lines == [f"exact wide copy: in 6->14, hidden 64->256 -> {out}"]
          and tuple(net.pi_l1.weight.shape) == (256, 14)
          and tuple(net.vf_l1.weight.shape) == (256, 14)
          and counts_of(modules) == dict.fromkeys(modules, 0),
          f"12d: {lines}")


def tools_12e(modules, tmp):
    """12e: `distill_teacher` from the committed teacher into r2i, 2
    iterations at the defaults, the two evals cut to DISTILL_EVAL_STEPS; K2's
    33rd launch of the first collect held to the plain version, the
    teacher's labels there to its float64 mean on the CPU."""
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import checkpoint, distill_teacher
    from balance_robot_tpu_torch.train.distill_teacher import DAgger
    teacher = checkpoint.load(tmp / "teacher.npz")
    collects, kept, label_in = [], [], []
    collect, update = DAgger.collect, DAgger.update

    def timed(fn, what):
        def spy(self, *args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            before = modules["K2"].KERNEL.launches
            e0.record()
            out = fn(self, *args, **kwargs)
            e1.record()
            collects.append(dict(what=what, events=(e0, e1),
                                 launches=(modules["K2"].KERNEL.launches
                                           - before),
                                 beta=args[4] if what == "collect" else None,
                                 out=out if what == "collect" else None))
            return out
        return spy

    def first_collect(self, *args, **kwargs):
        if any(c["what"] == "collect" for c in collects):
            return timed(collect, "collect")(self, *args, **kwargs)
        mean = self.teacher.policy_mean
        calls = []

        def keep(x):
            if len(calls) == HOLD_STEP_12E:
                label_in.append(x.clone())
            calls.append(1)
            return mean(x)

        with mock.patch.object(self.teacher, "policy_mean", keep), \
                inputs_of_launch(modules, "K2", HOLD_STEP_12E) as k:
            out = timed(collect, "collect")(self, *args, **kwargs)
        kept.extend(k)
        return out

    zero_counts(modules)
    with mock.patch.object(DAgger, "collect", first_collect), \
            mock.patch.object(DAgger, "update", timed(update, "update")), \
            short_horizon(DISTILL_EVAL_STEPS), \
            workflow_spies(modules) as log:
        res, lines, seconds = run_main("12e distill_teacher",
                                       distill_teacher.main, [
            "--teacher", str(tmp / "teacher.npz"), "--init",
            str(tmp / "r2i.npz"), "--out", str(tmp / "dagger"), "--iters",
            "2", "--eval-every", "2"])
    counts = counts_of(modules)
    cols = [c for c in collects if c["what"] == "collect"]
    ups = [c for c in collects if c["what"] == "update"]
    n_eval = sum(e["launches"] for e in log["evals"])
    check(len(cols) == 2 and [c["launches"] for c in cols] == [64, 64]
          and [c["beta"] for c in cols] == [1.0, 0.0]
          and len(log["evals"]) == 2
          and counts == {"K1": 0, "K2": 128 + n_eval, "K3": 0},
          f"12e: collects {[(c['launches'], c['beta']) for c in cols]}, "
          f"{len(log['evals'])} evals, {counts}")
    check_eval_launches("12e", log, DISTILL_EVAL_STEPS)
    check(lines[1].startswith("[dagger 0] beta=1 buffer=65536 ")
          and lines[2].startswith("[dagger 1] beta=0 buffer=131072 ")
          and lines[-1].startswith("[dagger] best: "),
          f"12e: the tool's lines {lines}")
    # the teacher's labels at the 33rd step: its float32 mean on the card
    # against its float64 mean on the CPU, on the same inputs
    B = 1024
    labels = cols[0]["out"][3][HOLD_STEP_12E * B:(HOLD_STEP_12E + 1) * B]
    x, = label_in
    ref = mlp.from_numpy_params(teacher, dtype=torch.float64).policy_mean(
        x.double().cpu()).clamp(-1.0, 1.0)
    gap = (labels.double().cpu() - ref).abs().max().item()
    check(x.shape == (B, 14) and gap <= 1e-5,
          f"12e: the teacher's labels depart from its float64 mean by "
          f"{gap:.3e}")
    hold_on_path(modules, "K2", f"12e collect {HOLD_STEP_12E + 1}", kept)
    best = checkpoint.load(tmp / "dagger" / "best_model.npz")
    check(best["pi_w1"].shape == (6, 64)
          and (tmp / "dagger" / "final_model.npz").exists(),
          f"12e: best_model.npz pi_w1 {best['pi_w1'].shape}")
    col_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in cols]
    up_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in ups]
    print(f"tools 12e: K2 launches {counts['K2']} = collects "
          f"{' + '.join(str(c['launches']) for c in cols)} (B = {B}) + "
          f"evals {n_eval} ({len(log['evals'])} of {512} x "
          f"{DISTILL_EVAL_STEPS}); collect ms (CUDA events) "
          + ", ".join(f"{ms:.1f} ({ms / 64:.2f} per step)" for ms in col_ms)
          + "; update ms " + ", ".join(f"{ms:.1f}" for ms in up_ms)
          + f" ({res['dagger'].n_minibatches()} minibatch steps of 4096); "
          "s per eval "
          + ", ".join(f"{e['seconds']:.2f}" for e in log["evals"])
          + f"; labels at step {HOLD_STEP_12E + 1} within {gap:.2e} of the "
          f"teacher's float64 mean; best {res['best']}")


def tools_phase(modules):
    """Phase 12: 12a-12e (see the module docstring), in a temporary working
    directory under build/ with copies of the checkpoints; the repo's
    models/, logs/ and movies/ must be as they were."""
    root = pathlib.Path(__file__).resolve().parent
    guarded = {d: _files(root / d) for d in ("models", "logs", "movies")}
    build = root / "build"
    build.mkdir(exist_ok=True)
    cwd = os.getcwd()
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copy(root / POLICY03, tmp / "r2i.npz")
        shutil.copy(root / TEACHER03, tmp / "teacher.npz")
        os.chdir(tmp)
        try:
            tools_12a(modules, tmp)
            tools_12b(modules)
            tools_12c(modules, tmp)
            tools_12d(modules, tmp)
            tools_12e(modules, tmp)
        finally:
            os.chdir(cwd)
    after = {d: _files(root / d) for d in guarded}
    check(after == guarded, "phase 12 wrote into the repo's models/, logs/ "
          "or movies/")
    print(f"tools: phase 12 in {time.perf_counter() - t12:.1f} s")


# --------------------------------------------------------------- phase 13

def _digests(directory):
    """{relative path: sha256} of the files under `directory`."""
    import hashlib
    return {str(f.relative_to(directory)):
            hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(directory.rglob("*")) if f.is_file()}


def chunked_steps(lens, chunk, horizon):
    """The control steps a chunked rollout runs: whole chunks until every
    episode is done (the longest lasted max(lens) steps), at most the
    horizon."""
    return min(-(-int(lens.max()) // chunk) * chunk, horizon)


@contextlib.contextmanager
def rollout_spies(modules, hold_when):
    """While the block runs, every `train/recovery.rollout` call is logged
    (its batch, K2 launches, CUDA events around it); the first call whose
    batch satisfies `hold_when(B)` and reaches its K2 launch number
    HOLD_AT_13 keeps that launch's inputs. Yields (calls, kept)."""
    from balance_robot_tpu_torch.train import recovery
    rollout = recovery.rollout
    calls, kept = [], []

    def spy(env, states, obs, table, *args, **kwargs):
        B = table.shape[1]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        before = modules["K2"].KERNEL.launches
        e0.record()
        if not kept and hold_when(B):
            with inputs_of_launch(modules, "K2", HOLD_AT_13) as k:
                out = rollout(env, states, obs, table, *args, **kwargs)
            kept.extend(k)
        else:
            out = rollout(env, states, obs, table, *args, **kwargs)
        e1.record()
        calls.append(dict(B=B, launches=modules["K2"].KERNEL.launches - before,
                          events=(e0, e1)))
        return out

    with mock.patch.object(recovery, "rollout", spy):
        yield calls, kept


def ms_per_launch(calls):
    """The mean ms per K2 launch of logged rollouts, by CUDA events."""
    torch.cuda.synchronize()
    ms = sum(c["events"][0].elapsed_time(c["events"][1]) for c in calls)
    return ms / max(1, sum(c["launches"] for c in calls))


def research_13a(modules, tmp):
    """13a: `value_probe` of r3a (its privileged critic reads 14 inputs),
    128 episodes, and `failure_forensics` of r2i, 512 episodes with
    `--dump`, both at a horizon of RESEARCH_STEPS; K2 once per step."""
    import re
    from balance_robot_tpu_torch.train import failure_forensics, value_probe
    zero_counts(modules)
    with short_horizon(RESEARCH_STEPS):
        (V, R, F, A), lines, seconds = run_main(
            "13a value_probe", value_probe.main,
            [str(tmp / "r3a.npz"), "--episodes", "128"])
    counts = counts_of(modules)
    steps = chunked_steps(A.sum(0), 250, RESEARCH_STEPS)
    check(V.shape == (steps, 128) and np.isfinite(V).all()
          and np.isfinite(R).all()
          and counts == {"K1": 0, "K2": steps, "K3": 0},
          f"13a value_probe: V {V.shape} over {steps} steps, {counts}")
    check(lines[0] == "critic: privileged (vf input 14)"
          and lines[1].startswith(f"Env03-v2 {tmp / 'r3a.npz'}: 128 "
                                  "episodes, full-horizon ")
          and lines[2].startswith("explained variance of V vs discounted "
                                  "return-to-go (gamma=0.999, tails "
                                  "dropped): ")
          and len(lines) >= 5, f"13a value_probe: the tool's lines {lines}")
    n_full = int((A.sum(0) >= RESEARCH_STEPS).sum())
    print(f"research 13a value_probe: {counts['K2']} K2 launches at B = 128 "
          f"({1e3 * seconds / steps:.2f} ms per step by the host clock), "
          f"{int(F.sum())} launches seen, {n_full} of 128 episodes full")

    dump = tmp / "forensics.npz"
    zero_counts(modules)
    with short_horizon(RESEARCH_STEPS):
        rec, lines, seconds = run_main(
            "13a failure_forensics", failure_forensics.main,
            [str(tmp / "r2i.npz"), "--episodes", "512", "--dump", str(dump)])
    counts = counts_of(modules)
    steps = chunked_steps(rec["lens"], 250, RESEARCH_STEPS)
    full = int((rec["lens"] >= RESEARCH_STEPS).sum())
    sides = re.search(r"\(front \S+ n=(\d+), back \S+ n=(\d+)\)", lines[0])
    check(counts == {"K1": 0, "K2": steps, "K3": 0},
          f"13a failure_forensics: {steps} steps, {counts}")
    check(sides is not None
          and int(sides[1]) == int(rec["attack_front"].sum())
          and int(sides[1]) + int(sides[2]) == 512
          and (full == 512 or lines[1] == f"failures: {512 - full}")
          and lines[-1] == f"-> {dump}"
          and set(np.load(dump).files) == set(rec),
          f"13a failure_forensics: the tool's lines {lines}")
    print(f"research 13a failure_forensics: {counts['K2']} K2 launches at "
          f"B = 512 ({1e3 * seconds / steps:.2f} ms per step by the host "
          f"clock); {full} of 512 full, front n {sides[1]} + back n "
          f"{sides[2]} = 512")


def research_13b(modules, tmp):
    """13b: `oracle_probe` of r2i at its defaults (pop 128, horizon 100),
    RESEARCH_FATAL states, ORACLE_ITERS generations, `--dump-dagger`; the
    harvest at a horizon of RESEARCH_STEPS. K2 launches by part; the
    replayed best sequences score what they scored in their generation, bit
    for bit; one generation launch held to the plain version."""
    import re
    from balance_robot_tpu_torch.train import oracle_probe
    P, H = 128, 100
    dump = tmp / "oracle.npz"
    zero_counts(modules)
    with short_horizon(RESEARCH_STEPS), workflow_spies(modules) as log, \
            rollout_spies(modules, lambda B: B > RESEARCH_FATAL) as (
                calls, kept):
        res, lines, seconds = run_main(
            "13b oracle_probe", oracle_probe.main,
            [str(tmp / "r2i.npz"), "--max-fatal", str(RESEARCH_FATAL),
             "--iters", str(ORACLE_ITERS), "--dump-dagger", str(dump)])
    counts = counts_of(modules)
    check(res is not None, "13b: the harvest banked no fatal state")
    F = res["F"]
    n_hv = sum(x["launches"] for x in log["harvests"])
    parts = [(c["B"], c["launches"]) for c in calls]
    check(parts == [(F, H)] + [(F * P, H)] * ORACLE_ITERS + [(F, H)]
          and counts == {"K1": 0, "K2": n_hv + H * (ORACLE_ITERS + 2),
                         "K3": 0},
          f"13b: rollouts (batch, K2 launches) {parts}, harvest {n_hv}, "
          f"{counts}")
    shares = [int(re.search(r"population-recoverable (\d+)%", line)[1])
              for line in lines if line.startswith("[cem ")]
    check(len(shares) == ORACLE_ITERS and shares == sorted(shares),
          f"13b: the population-recoverable share by generation {shares}")
    same = res["score"] == res["run_best_score"]
    for f in np.nonzero(~same)[0]:
        print(f"13b: bank state {f}: replay score {res['score'][f]!r}, its "
              f"generation's {res['run_best_score'][f]!r}")
    check(same.all(), f"13b: {int((~same).sum())} of {F} replayed best "
          "sequences do not score what they scored in their generation")
    z = np.load(dump)
    n_traj = int(z["n_traj"])
    check(n_traj == int(res["recovered"].sum())
          and z["obs"].shape == (n_traj * H, 6)
          and z["act"].shape == (n_traj * H, 2),
          f"13b: the dump's rows {z['obs'].shape} for {n_traj} trajectories")
    gens = [c for c in calls if c["B"] == F * P]
    by_team = dict(modules["K2"].KERNEL.launches_by_team)
    print(f"research 13b oracle_probe: F = {F}; K2 launches {counts['K2']} "
          f"(by team {by_team}) "
          f"= harvest {n_hv} (B = 512) + seed mean {H} (B = {F}) + "
          f"generations {ORACLE_ITERS} x {H} (B = {F * P}) + replay {H} "
          f"(B = {F}); {ms_per_launch(gens):.3f} ms per generation launch, "
          f"{ms_per_launch([calls[0], calls[-1]]):.3f} per launch at B = "
          f"{F} (CUDA events around the rollouts); population-recoverable "
          f"{shares}%; the replay bit-equal to the generations' best scores "
          f"on all {F} states; {n_traj} trajectories dumped")
    hold_on_path(modules, "K2", f"13b generation 1 step {HOLD_AT_13 + 1}",
                 kept, ws_vs_f64=True)


def research_13c(modules, tmp):
    """13c: `mpc_dagger` of r2i at its defaults (pop 64, 2 CEM iterations,
    plan 20, tail 60, exec 4), RESEARCH_FATAL states, MPC_REPLAY steps,
    the harvest at a horizon of RESEARCH_STEPS; one plan launch held to
    the plain version. Returns the dump's path."""
    from balance_robot_tpu_torch.train import mpc_dagger
    P, iters, Hs, Ht, K = 64, 2, 20, 60, 4
    dump = tmp / "mpc.npz"
    zero_counts(modules)
    with short_horizon(RESEARCH_STEPS), workflow_spies(modules) as log, \
            rollout_spies(modules, lambda B: B > RESEARCH_FATAL) as (
                calls, kept):
        res, lines, seconds = run_main(
            "13c mpc_dagger", mpc_dagger.main,
            [str(tmp / "r2i.npz"), "--max-fatal", str(RESEARCH_FATAL),
             "--replay-steps", str(MPC_REPLAY), "--dump", str(dump)])
    counts = counts_of(modules)
    check(res is not None, "13c: the harvest banked no fatal state")
    F, R = res["F"], res["R"]
    n_hv = sum(x["launches"] for x in log["harvests"])
    n_plan = R // K * iters
    parts = [(c["B"], c["launches"]) for c in calls]
    check(R == MPC_REPLAY
          and parts == [(F, Hs)] + [(F * P, Hs + Ht)] * n_plan
          and counts == {"K1": 0, "K2": n_hv + Hs + n_plan * (Hs + Ht) + R,
                         "K3": 0},
          f"13c: rollouts (batch, K2 launches) {parts}, harvest {n_hv}, "
          f"{counts}")
    surv, rec = res["survived"], res["recovered"]
    check(lines[1].startswith(f"[mpc   0/{R}] expert-alive ")
          and f"MPC expert: {F} fatal launches -> survived {R} steps: "
              f"{surv.sum()} " in "\n".join(lines)
          and sum(line.startswith("  pooled ceiling if policy matched "
                                  "expert (") for line in lines) == 2,
          f"13c: the tool's lines {lines}")
    z = np.load(dump)
    check(z["obs"].shape == (int(res["keep"].sum()), 6)
          and int(z["n_traj"]) == int(rec.sum()),
          f"13c: {z['obs'].shape[0]} pairs dumped, keep holds "
          f"{int(res['keep'].sum())}")
    print(f"research 13c mpc_dagger: F = {F}; K2 launches {counts['K2']} = "
          f"harvest {n_hv} + policy plan {Hs} (B = {F}) + {n_plan} plan "
          f"rollouts x {Hs + Ht} (B = {F * P}) + execution {R} (B = {F}); "
          f"{ms_per_launch(calls[1:]):.3f} ms per plan launch (CUDA "
          f"events); survived {surv.sum()} of {F}, recovered {rec.sum()}; "
          f"{z['obs'].shape[0]} pairs dumped; {seconds:.1f} s")
    hold_on_path(modules, "K2", f"13c plan rollout 1 step {HOLD_AT_13 + 1}",
                 kept, ws_vs_f64=True)
    return dump


def research_13d(modules, tmp, mpc_dump):
    """13d: `bc_finetune` of r2i on runs/dagger_mpc_r5.npz and 13c's dump,
    the KL anchor at weight 0.1, BC_STEPS steps with one selection eval at
    the end; the anchor episodes and the evals at a horizon of
    RESEARCH_STEPS_13D. The value net and
    log_std come out bit-equal to r2i's."""
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.train import bc_finetune, checkpoint
    out = tmp / "klbc"
    steps = []
    train_step = bc_finetune.Clone.train_step

    def timed(self, gen, idx=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = train_step(self, gen, idx)
        e1.record()
        steps.append((e0, e1))
        return res

    zero_counts(modules)
    with short_horizon(RESEARCH_STEPS_13D), workflow_spies(modules) as log, \
            mock.patch.object(bc_finetune.Clone, "train_step", timed):
        res, lines, seconds = run_main(
            "13d bc_finetune", bc_finetune.main,
            [str(tmp / "r2i.npz"), "--dagger", str(tmp / "dagger_r5.npz"),
             "--dagger", str(mpc_dump), "--kl-anchor", "--anchor-weight",
             "0.1", "--steps", str(BC_STEPS), "--eval-every", str(BC_STEPS),
             "--out", str(out)])
    counts = counts_of(modules)
    n_ev = sum(e["launches"] for e in log["evals"])
    check(len(log["evals"]) == 3 and counts["K1"] == counts["K3"] == 0
          and counts["K2"] - n_ev == RESEARCH_STEPS_13D,
          f"13d: {len(log['evals'])} evals of {n_ev} K2 launches, {counts}")
    check_eval_launches("13d", log, RESEARCH_STEPS_13D)
    r2i = checkpoint.load(tmp / "r2i.npz")
    saved = checkpoint.load(out / "best_model.npz")
    untouched = [k for k in r2i if k.startswith("vf_") or k == "log_std"]
    check(set(saved) == set(r2i) and all(
        np.array_equal(saved[k], r2i[k]) for k in untouched),
          "13d: the value net or log_std moved")
    check(any(line.startswith("selection winner: step ") for line in lines)
          and lines[-1] == f"saved -> {out / 'best_model.npz'}"
          and tuple(mlp.from_numpy_params(saved, device="cuda").pi_l1
                    .weight.shape) == (64, 6),
          f"13d: the tool's lines {lines}")
    torch.cuda.synchronize()
    ms = steps[0][0].elapsed_time(steps[-1][1]) / len(steps)
    winner = next(line for line in lines if line.startswith("selection "
                                                            "winner"))
    print(f"research 13d bc_finetune: {len(steps)} Adam steps of 4096 rows "
          f"in {ms:.3f} ms each (CUDA events, first to last); K2 launches "
          f"{counts['K2']} = anchor {counts['K2'] - n_ev} (B = 256) + evals "
          f"{n_ev} (128, 128, 512 episodes of {RESEARCH_STEPS_13D} steps), s "
          "per eval "
          + ", ".join(f"{e['seconds']:.2f}" for e in log["evals"])
          + f"; {winner}; vf_* and log_std bit-equal to r2i's")


def r4d_tops(path):
    """{family: [(params, mean return)] of the top five} in a move_probe
    log."""
    import re
    tops, family = {}, None
    for line in path.read_text().splitlines():
        head = re.match(r"--- (\w+): top 5", line)
        if head:
            family = head[1]
            tops[family] = []
            continue
        row = re.match(r"\s+params=\(([^)]*)\)\s+ret=\s*([-\d.]+)", line)
        if row and family:
            tops[family].append((tuple(float(x) for x in row[1].split(",")),
                                 float(row[2])))
    return tops


def research_13e(modules, root):
    """13e: `move_probe` at its defaults (4 seeds, the full 700 steps): 64
    CYCLE and 48 THRESH members, 700 K3 launches per family on the team
    instantiation; one K3 launch held to the plain version; its starts
    drawn from MOVE_PROBE_UNIFORMS and the returns of the members in
    MOVE_PROBE_JAX within MOVE_PROBE_REL of the JAX package's from those
    starts; each family's best, and the log's best member, at >= 900,
    beside runs/move_probe_r4d.log's."""
    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.physics import cuda_move
    from balance_robot_tpu_torch.train import move_probe
    from balance_robot_tpu_torch.train.ppo import fork_env
    calls = []
    rollout = move_probe.rollout

    def spy(env, policy, grid, seeds, T, start=None):
        before = modules["K3"].KERNEL.launches
        out = rollout(env, policy, grid, seeds, T, start)
        calls.append((len(grid) * seeds,
                      modules["K3"].KERNEL.launches - before))
        return out

    at = 350
    zero_counts(modules)
    with mock.patch.object(move_probe, "rollout", spy), \
            inputs_of_launch(modules, "K3", at) as kept:
        res, lines, seconds = run_main("13e move_probe", move_probe.main, [])
    counts = counts_of(modules)
    check(calls == [(256, 700), (192, 700)]
          and counts == {"K1": 0, "K2": 0, "K3": 1400}
          and all(cuda_move.KERNEL.launch_config(torch.float32, B)[0] > 1
                  for B, _ in calls)
          and res["CYCLE"][0].shape == (64, 4)
          and res["THRESH"][0].shape == (48, 4),
          f"13e: (batch, K3 launches) {calls}, {counts}")
    draws = fork_env(brt.make("EnvMove05-v1"),
                     move_probe.START_SEED)._uniform(4, 13)
    check([[x.hex() for x in row] for row in draws.cpu().tolist()]
          == MOVE_PROBE_UNIFORMS, "13e: the tool's starts are not the "
          "ones tests/move_probe_reference.py runs (MOVE_PROBE_UNIFORMS)")
    grids = dict((name, grid) for name, _, grid in move_probe.FAMILIES)
    for (name, member), want in MOVE_PROBE_JAX.items():
        got = float(res[name][0][grids[name].index(member)].mean())
        err = abs(got - want) / want
        print(f"research 13e {name} {member}: return {got:.1f} on the card, "
              f"{want:.1f} in the JAX package in float64 from the same "
              f"starts "
              f"({100 * err:.2f}%; held within "
              f"{100 * MOVE_PROBE_REL:.0f}%)")
        check(err <= MOVE_PROBE_REL, f"13e {name} {member}: {got:.1f} "
              f"against the JAX package's {want:.1f}")
    tops = r4d_tops(root / MOVE_PROBE_LOG)
    for name, grid in grids.items():
        mean_r = res[name][0].mean(axis=1)
        best = int(np.argsort(-mean_r)[0])
        member = tuple(float(x) for x in grid[best])
        logged, logged_ret = tops[name][0]
        ret_logged = mean_r[grid.index(logged)]
        among = member in [p for p, _ in tops[name]]
        print(f"research 13e {name}: best {member} return "
              f"{mean_r[best]:.1f} (survival "
              f"{100 * (res[name][1][best] >= 700).mean():.0f}%), "
              f"{'' if among else 'not '}among {MOVE_PROBE_LOG}'s top five "
              f"(other starts: printed, not held); the log's best "
              f"{logged} {logged_ret} returns {ret_logged:.1f} here")
        check(mean_r[best] >= RETURN_MOVE_REGISTERED
              and ret_logged >= RETURN_MOVE_REGISTERED,
              f"13e {name}: the best return {mean_r[best]:.1f} or the "
              f"log's best member's {ret_logged:.1f} < "
              f"{RETURN_MOVE_REGISTERED}")
    print(f"research 13e move_probe: K3 launches {counts['K3']} = 700 at B = "
          f"256 + 700 at B = 192 (a team of "
          f"{cuda_move.KERNEL.launch_config(torch.float32, 256)[0]} lanes "
          "per env), "
          f"{seconds:.1f} s ({1e3 * seconds / 1400:.2f} ms per step by the "
          "host clock)")
    hold_on_path(modules, "K3", f"13e CYCLE step {at + 1}", kept)


def research_13f(modules, tmp, root):
    """13f: `move_bc_init` of the best THRESH member; `make_inner_policy`
    into a temporary assets directory, byte-equal to the committed
    asset."""
    from balance_robot_tpu_torch.train import checkpoint, make_inner_policy
    from balance_robot_tpu_torch.train import move_bc_init
    out = tmp / "move_bc" / "init.npz"
    zero_counts(modules)
    _, lines, seconds = run_main("13f move_bc_init", move_bc_init.main, [
        "--mid", "4.0", "--width", "0.1", "--a-hi", "1.0", "--a-lo",
        "0.001", "--out", str(out)])
    saved = checkpoint.load(out)
    fits = [line for line in lines if line.startswith("fit step ")]
    check([line.split(":")[0] for line in fits]
          == [f"fit step {i}" for i in (0, 500, 1000, 1500, 2000, 2500,
                                        2999)]
          and sum(line.startswith("  ws=") for line in lines) == 11
          and lines[-1] == f"saved -> {out}"
          and np.array_equal(saved["log_std"], [-1.5, -1.5])
          and counts_of(modules) == dict.fromkeys(modules, 0),
          f"13f move_bc_init: {lines}")
    assets = tmp / "assets"
    buf = io.StringIO()
    with mock.patch.object(make_inner_policy, "ASSETS", assets), \
            contextlib.redirect_stdout(buf):
        path = make_inner_policy.main([str(tmp / "env01")])
    made = buf.getvalue().splitlines()
    print("research 13f make_inner_policy:\n  " + "\n  ".join(made))
    committed = root / "balance_robot_tpu_torch/envs/assets/" \
        "inner_policy.brq.npz"
    check(path.read_bytes() == committed.read_bytes(),
          "13f: the rebuilt inner policy differs from the committed asset")
    print(f"research 13f: move_bc_init in {seconds:.1f} s, {fits[-1]}; the "
          "rebuilt inner_policy.brq.npz byte-equal to the committed asset")


def research_phase(modules):
    """Phase 13: 13a-13f (see the module docstring), in a temporary working
    directory under build/ with copies of the checkpoints and data; the
    repo's models/, logs/, movies/, runs/ and the package's assets must be
    as they were."""
    root = pathlib.Path(__file__).resolve().parent
    guarded = {d: _files(root / d) for d in ("models", "logs", "movies")}
    digests = {d: _digests(root / d) for d in (
        "runs", "balance_robot_tpu_torch/envs/assets")}
    build = root / "build"
    build.mkdir(exist_ok=True)
    cwd = os.getcwd()
    t13 = time.perf_counter()
    parts = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = pathlib.Path(tmp)
        for src, name in ((POLICY03, "r2i.npz"), (POLICY03_R3A, "r3a.npz"),
                          (DAGGER_R5, "dagger_r5.npz"),
                          (POLICY, "env01.npz")):
            shutil.copy(root / src, tmp / name)
        os.chdir(tmp)
        try:
            for name, fn in (
                    ("13a", lambda: research_13a(modules, tmp)),
                    ("13b", lambda: research_13b(modules, tmp)),
                    ("13c", lambda: research_13c(modules, tmp)),
                    ("13d", lambda: research_13d(modules, tmp,
                                                 tmp / "mpc.npz")),
                    ("13e", lambda: research_13e(modules, root)),
                    ("13f", lambda: research_13f(modules, tmp, root))):
                t0 = time.perf_counter()
                fn()
                parts[name] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    check({d: _files(root / d) for d in guarded} == guarded
          and {d: _digests(root / d) for d in digests} == digests,
          "phase 13 wrote into the repo's models/, logs/, movies/, runs/ "
          "or the package's assets")
    print(f"research: phase 13 in {time.perf_counter() - t13:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve03-steps", type=int, default=SERVE03_STEPS,
                    help="depth of the Env03-v2 serving episodes "
                         f"(full horizon {SERVE03_STEPS})")
    ap.add_argument("--par-rank", type=int, default=None,
                    help="run as rank R of phase 10b's world (the script "
                         "starts these itself)")
    ap.add_argument("--par-dir", default=None,
                    help="phase 10b's rendezvous and output directory")
    opts = ap.parse_args()

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if opts.par_rank is not None:
        parallel_rank_main(opts.par_rank, opts.par_dir)
        return
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    import balance_robot_tpu_torch as brt
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    from balance_robot_tpu_torch.physics import block_step as bs
    from balance_robot_tpu_torch.envs.move import MOVE05_PARAMS
    from balance_robot_tpu_torch.ops import quant
    from balance_robot_tpu_torch.physics import cuda_block, cuda_move
    from balance_robot_tpu_torch.physics import cuda_step
    from balance_robot_tpu_torch.physics import fast_solver
    from balance_robot_tpu_torch.physics import robot_core as rc
    from balance_robot_tpu_torch.physics import step as st
    from balance_robot_tpu_torch.train import checkpoint
    from balance_robot_tpu_torch.train.evaluation import ChunkedEvaluator
    from balance_robot_tpu_torch.train.train_run import TURBO

    # ---- 2. build: one nvcc per source, started together
    modules = build_kernels()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        # ---- 3a. K1 vs its plain version, B = 257 (the team of 32), then
        # at a ragged batch above its crossover (one lane per env)
        (x3,), (x1,) = (modules[k].KERNEL.crossovers() for k in ("K3", "K1"))
        states3 = check_states(x3, x1)
        k1_teams = {B: modules["K1"].KERNEL.launch_config(torch.float32, B)[0]
                    for B in (CHECK_B, x1 + 61)}
        check(len(set(k1_teams.values())) == 2,
              f"K1's checks must reach both instantiations: {k1_teams}")
        cases = [(torch.float64, "Env01 exact", rc.ENV01_PARAMS),
                 (torch.float64, "Env01 fast", fast_solver(rc.ENV01_PARAMS)),
                 (torch.float64, "Env02 exact", rc.ENV02_PARAMS),
                 (torch.float64, "Env02 fast", fast_solver(rc.ENV02_PARAMS)),
                 (torch.float32, "Env01 fast", fast_solver(rc.ENV01_PARAMS)),
                 (torch.float32, "Env02 fast", fast_solver(rc.ENV02_PARAMS))]
        # the turbo grade (Newton 2 / line search 4: train_run --solver
        # turbo) on the Env01 fast cases' states
        turbo01 = fast_solver(rc.ENV01_PARAMS, **TURBO)
        cases += [(torch.float64, "Env01 turbo", turbo01),
                  (torch.float32, "Env01 turbo", turbo01)]
        for (dtype, name, params), x in zip(
                cases, states3["K1"] + [states3["K1"][1], states3["K1"][4]]):
            qpos, qvel, ws, ctrl, fric = (
                torch.tensor(a, dtype=dtype, device="cuda") for a in x)
            fr = fric if params.dynamic_friction else None
            k = cuda_step.control_step_cuda(qpos, qvel, ws, ctrl, fr, params)
            p = cuda_step.control_step_plain(qpos, qvel, ws, ctrl, fr, params)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in k + p),
                  f"non-finite K1/plain output ({name}, {dtype})")
            record("K1", dtype, name, drift(k, p))
        cases = [(torch.float64, "Env01 exact", rc.ENV01_PARAMS),
                 (torch.float64, "Env02 fast", fast_solver(rc.ENV02_PARAMS)),
                 (torch.float32, "Env01 fast", fast_solver(rc.ENV01_PARAMS)),
                 (torch.float32, "Env02 fast", fast_solver(rc.ENV02_PARAMS))]
        for (dtype, name, params), x in zip(cases, states3["K1 above"]):
            qpos, qvel, ws, ctrl, fric = (
                torch.tensor(a, dtype=dtype, device="cuda") for a in x)
            B = qpos.shape[0]
            fr = fric if params.dynamic_friction else None
            k = cuda_step.control_step_cuda(qpos, qvel, ws, ctrl, fr, params)
            again = cuda_step.control_step_cuda(qpos, qvel, ws, ctrl, fr,
                                                params)
            check(all(torch.equal(a, b) for a, b in zip(k, again)),
                  f"K1 gave other bits on a second launch ({name}, "
                  f"{dtype}, B={B})")
            p = cuda_step.control_step_plain(qpos, qvel, ws, ctrl, fr, params)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in k + p),
                  f"non-finite K1/plain output ({name}, {dtype}, B={B})")
            print(f"K1 check {name} {str(dtype)[6:]} B={B}: a team of "
                  f"{k1_teams[B]} lanes per env")
            record("K1", dtype, name, drift(k, p), B)

        # ---- 3b. K2 vs its plain version, B = 257, on states where every
        # block collider is active during the step
        cases = [(torch.float64, "Env03 exact", bs.ENV03_PARAMS),
                 (torch.float64, "Env03 fast", fast_solver(bs.ENV03_PARAMS)),
                 (torch.float32, "Env03 fast", fast_solver(bs.ENV03_PARAMS))]
        turbo03 = fast_solver(bs.ENV03_PARAMS, **TURBO)
        cases += [(torch.float64, "Env03 turbo", turbo03),
                  (torch.float32, "Env03 turbo", turbo03)]
        for (dtype, name, params), x in zip(
                cases, states3["K2"] + [states3["K2"][1], states3["K2"][2]]):
            qpos, qvel, ctrl = (
                torch.tensor(a, dtype=dtype, device="cuda") for a in x)
            ws = torch.zeros_like(qvel)
            k = cuda_block.control_step14_cuda(qpos, qvel, ws, ctrl, params)
            seen = {}
            p = cuda_block.control_step14_plain(qpos, qvel, ws, ctrl, params,
                                                contact_counts=seen)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in k + p),
                  f"non-finite K2/plain output ({name}, {dtype})")
            active = {key: int(v.sum()) for key, v in seen.items()}
            print(f"K2 check {name} {str(dtype)[6:]}: envs with an active "
                  f"contact during the step: {active}")
            check(all(n > 0 for n in active.values()),
                  f"a block collider was never active: {active}")
            record("K2", dtype, name, drift(k, p))

        # ---- 3c. K3 vs its plain version on states where every wall
        # collider is active during the step, at B = 257 and at a ragged
        # batch above the crossover: through both instantiations. A second
        # launch on the same inputs must give the same bits (a race between
        # a team's lanes would not)
        move_fast = fast_solver(MOVE05_PARAMS)
        cases = [(torch.float64, "EnvMove05 exact", MOVE05_PARAMS),
                 (torch.float64, "EnvMove05 fast", move_fast),
                 (torch.float32, "EnvMove05 fast", move_fast)]
        teams = {B: modules["K3"].KERNEL.launch_config(torch.float32, B)[0]
                 for B in states3["K3"]}
        check(len(set(teams.values())) == 2,
              f"K3's checks must reach both instantiations: {teams}")
        for B, draws in states3["K3"].items():
            for (dtype, name, params), x in zip(cases, draws):
                qpos, qvel, ctrl = (
                    torch.tensor(a, dtype=dtype, device="cuda") for a in x)
                ws = torch.zeros_like(qvel)
                k = cuda_move.control_step_walls_cuda(qpos, qvel, ws, ctrl,
                                                      params)
                again = cuda_move.control_step_walls_cuda(qpos, qvel, ws,
                                                          ctrl, params)
                check(all(torch.equal(a, b) for a, b in zip(k, again)),
                      f"K3 gave other bits on a second launch ({name}, "
                      f"{dtype}, B={B})")
                seen = {}
                p = cuda_move.control_step_walls_plain(qpos, qvel, ws, ctrl,
                                                       params,
                                                       contact_counts=seen)
                torch.cuda.synchronize()
                check(all(torch.isfinite(t).all() for t in k + p),
                      f"non-finite K3/plain output ({name}, {dtype}, B={B})")
                active = {key: int(v.sum()) for key, v in seen.items()}
                print(f"K3 check {name} {str(dtype)[6:]} B={B} (a team of "
                      f"{teams[B]} lanes per env): envs with an active "
                      f"contact during the step: {active}")
                check(set(active) == set(st.WALL_CONTACT_KINDS)
                      and all(n > 0 for n in active.values()),
                      f"a wall collider was never active: {active}")
                if dtype == torch.float32:   # see K3_F32_TOL
                    d = drift(k, p)
                    print(f"K3 vs plain {name} float32 B={B} (printed, not "
                          "held): " + ", ".join(f"{key} {v:.3e}"
                                                for key, v in d.items()))
                    p = cuda_move.control_step_walls_plain(
                        *(t.double() for t in (qpos, qvel, ws, ctrl)), params)
                    record("K3", dtype, name, drift(k, p), B,
                           "plain in float64")
                else:
                    record("K3", dtype, name, drift(k, p), B)

        # ---- 4. main paths
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        env = brt.make("Env01-v2").use_fast_solver()
        policy = mlp.from_numpy_params(checkpoint.load(POLICY),
                                       device="cuda")
        states, obs, counts01 = run_main_path(VecEnv(env, N_ENVS), policy,
                                              gen, modules, "K1")
        env03 = brt.make("Env03-v2").use_fast_solver()
        policy03 = mlp.from_numpy_params(checkpoint.load(POLICY03),
                                         device="cuda")
        states03, obs03, counts03 = run_main_path(
            VecEnv(env03, N_ENVS), policy03, gen, modules, "K2")
        env_move = brt.make("EnvMove05-v1").use_fast_solver()
        policy_move = mlp.from_numpy_params(checkpoint.load(POLICY_MOVE),
                                            device="cuda")
        touched = torch.zeros(N_ENVS, dtype=torch.bool, device="cuda")

        def note_wall_contacts(s):
            sets = st.wall_sets(rc.fk(s.phys.qpos), env_move.params)
            touched.logical_or_(torch.cat([c.include for c in sets],
                                          1).any(-1))

        states_move, obs_move, counts_move = run_main_path(
            VecEnv(env_move, N_ENVS), policy_move, gen, modules, "K3",
            after_step=note_wall_contacts)
        print(f"main path EnvMove05-v1: {int(touched.sum())} of {N_ENVS} envs "
              f"had a wall contact at the end of one of the {N_STEPS} steps "
              "(fresh episodes start in mid-corridor; phase 3 covers the "
              "wall colliders)")

        # ---- 5a. serving, Env01-v2 and Env02-v1
        def act(net, o):
            return net.policy_mean(o).clamp(-1.0, 1.0)

        serve_env = brt.make("Env01-v2", seed=123).use_fast_solver()
        t0 = time.perf_counter()
        rets, lens = ChunkedEvaluator(serve_env, act).evaluate_detail(
            policy, SERVE_EPISODES, SERVE_STEPS)
        serve_s = time.perf_counter() - t0
        check(np.isfinite(rets).all(), "serving returned non-finite returns")
        survival = float((lens >= SERVE_STEPS).mean())
        print(f"serving: {SERVE_EPISODES} Env01-v2 episodes, max "
              f"{SERVE_STEPS} steps, in {serve_s:.2f} s: survival "
              f"{survival:.4f}, mean return {rets.mean():.4f}")
        check(survival >= SURVIVAL_FLOOR,
              f"survival {survival:.3f} < {SURVIVAL_FLOOR}")

        def few_steps(env_id, net, seed):
            vec = VecEnv(brt.make(env_id, seed=seed).use_fast_solver(),
                         SERVE_EPISODES)
            s, o = vec.reset()
            for _ in range(3):
                s, out = vec.step(s, act(net, o))
                o = out.obs
            check(torch.isfinite(o).all().item()
                  and all(torch.isfinite(t).all().item() for t in s.phys),
                  f"{env_id} state or obs not finite")
            print(f"serving: {env_id} 3 steps ok")

        few_steps("Env02-v1", policy, 7)

        # ---- 5b. serving, the flagship: Env03-v2 at the exact solver grade
        steps03 = opts.serve03_steps
        full = steps03 >= SERVE03_STEPS
        n03 = SERVE03_DRAWS * SERVE03_EPISODES
        before = cuda_block.KERNEL.launches
        ev = ChunkedEvaluator(brt.make("Env03-v2", seed=SERVE03_SEED), act)
        t0 = time.perf_counter()
        rets03, lens03 = ev.evaluate_detail(policy03, n03, steps03)
        serve03_s = time.perf_counter() - t0
        check(np.isfinite(rets03).all(),
              "Env03-v2 serving: non-finite return")
        alive = lens03 >= steps03
        draws = [float(a.mean()) for a in np.split(alive, SERVE03_DRAWS)]
        pooled = float(alive.mean())
        print(f"serving: {SERVE03_DRAWS} x {SERVE03_EPISODES} Env03-v2 "
              f"episodes (models/Env03-v2_r2i, exact solver, one batch of "
              f"{n03}), {'full horizon' if full else 'depth cut to'} "
              f"{steps03} steps, in {serve03_s:.1f} s with "
              f"{cuda_block.KERNEL.launches - before} K2 launches: survival "
              "pooled "
              f"{pooled:.4f}, draws {draws}, mean return "
              f"{rets03.mean():.2f}, mean length {lens03.mean():.1f}")
        if full:
            check(SURVIVAL03_BAND[0] <= pooled <= SURVIVAL03_BAND[1],
                  f"Env03-v2 full-horizon survival {pooled:.4f} outside the "
                  f"JAX package's band {SURVIVAL03_BAND}")
        else:
            # episodes only end early by falling, so survival to a cut depth
            # is at least the full-horizon survival
            check(pooled >= SURVIVAL03_BAND[0],
                  f"Env03-v2 survival to {steps03} steps {pooled:.4f} is "
                  f"below the full-horizon band {SURVIVAL03_BAND}")
        few_steps("Env03-v1", policy03, 8)
        few_steps("Env03-v1-fail", policy03, 9)

        # ---- 5c. serving, EnvMove05-v1 at both solver grades; then Cal01
        # and the int8 inner policy on the card
        n_move = SERVE_MOVE_DRAWS * SERVE_MOVE_EPISODES
        for grade in ("fast", "exact"):
            move_env = brt.make("EnvMove05-v1", seed=SERVE_MOVE_SEED)
            if grade == "fast":
                move_env.use_fast_solver()
            horizon = move_env.max_episode_steps
            before = cuda_move.KERNEL.launches
            t0 = time.perf_counter()
            rets_m, lens_m = ChunkedEvaluator(move_env, act).evaluate_detail(
                policy_move, n_move)
            seconds = time.perf_counter() - t0
            check(np.isfinite(rets_m).all(),
                  f"EnvMove05-v1 serving ({grade}): non-finite return")
            alive = lens_m >= horizon
            mean_ret = float(rets_m.mean())
            se = float(rets_m.std(ddof=1) / np.sqrt(n_move))
            reach = 3.0 * float(np.hypot(se, RETURN_MOVE_JAX[1]))
            print(f"serving: {SERVE_MOVE_DRAWS} x {SERVE_MOVE_EPISODES} "
                  f"EnvMove05-v1 episodes (models/EnvMove05-v1_PPO_r4, "
                  f"{grade} solver, int8 inner policy, one batch of "
                  f"{n_move}), full horizon {horizon} steps, in "
                  f"{seconds:.1f} s with "
                  f"{cuda_move.KERNEL.launches - before} K3 "
                  f"launches: survival pooled {alive.mean():.4f}, draws "
                  f"{[float(x.mean()) for x in np.split(alive, 2)]}, mean "
                  f"return pooled {mean_ret:.2f} (s.e. {se:.2f}), draws "
                  f"{[float(x.mean()) for x in np.split(rets_m, 2)]}, "
                  f"median {np.median(rets_m):.2f}, mean length "
                  f"{lens_m.mean():.1f}; the JAX package in float32 returns "
                  f"{RETURN_MOVE_JAX[0]} (s.e. {RETURN_MOVE_JAX[1]}), so "
                  f"the band is +-{reach:.1f}; the env's registered "
                  f"threshold of {RETURN_MOVE_REGISTERED:.0f} is "
                  f"{'' if mean_ret >= RETURN_MOVE_REGISTERED else 'not '}"
                  "reached")
            check(alive.mean() >= SURVIVAL_MOVE_FLOOR,
                  f"EnvMove05-v1 full-horizon survival {alive.mean():.4f} "
                  f"({grade}) < {SURVIVAL_MOVE_FLOOR}")
            check(abs(mean_ret - RETURN_MOVE_JAX[0]) <= reach,
                  f"EnvMove05-v1 mean return {mean_ret:.2f} ({grade}) is "
                  f"more than {reach:.1f} from the JAX package's float32 "
                  f"return {RETURN_MOVE_JAX[0]}")

        cal = brt.make("Cal01").use_fast_solver()
        s, o = cal.reset(SERVE_EPISODES)
        before = cuda_step.KERNEL.launches
        for i in range(3):
            s, o, _, _, _ = cal.step(s, o.new_zeros((SERVE_EPISODES, 2)))
            t_cal, vel_l, vel_r = cal.telemetry(s)
            check(vel_l.min().item() > 1.0 and vel_r.min().item() > 1.0,
                  f"Cal01 wheels did not spin up: {vel_l.min().item()}, "
                  f"{vel_r.min().item()} after {i + 1} steps")
        check(torch.isfinite(o).all().item()
              and cuda_step.KERNEL.launches == before + 3,
              "Cal01 obs not finite, or K1 not launched once per step")
        print(f"serving: Cal01 3 steps ok: t = {t_cal[0].item():.3f} s, "
              f"vel_l {vel_l[0].item():.3f}, vel_r {vel_r[0].item():.3f}")

        # the int8 policy's integer products, scalings and roundings are
        # exact; only tanh comes from each device's own library and may
        # differ in its last bits, which moves an int8 output by one step
        # where tanh * 128 sits on a rounding boundary. So the deciding
        # check is that with numpy's tanh the card agrees on every output
        # with int8_exact, the same arithmetic in numpy with int64
        # accumulators (independent of torch's CPU threads and BLAS: once,
        # on one host, torch's CPU path departed from it on 7 outputs of
        # the last 512 obs where the card did not; PERF.md). With the
        # card's own tanh no output may differ by more than 1 LSB, and the
        # share that differs is held to what two correct tanh's can cause:
        # they differ by at most 2^-22 (4 ulp at 1), so tanh x 128 rounds to
        # the other side of a boundary with probability 2 x 128 x 2^-22 per
        # activation, and 128 hidden activations stand behind each output:
        # 0.78% (0 and 13 of 8192 outputs measured against the CPU's tanh
        # on two hosts with an H100 80GB HBM3, CUDA 12.8). torch's CPU path
        # is printed beside them; the tests hold it to the JAX package.
        inner_obs = np.random.default_rng(11).uniform(
            -3, 3, (N_ENVS, 6)).astype(np.float32)
        exact = torch.from_numpy(int8_exact(env_move.inner, inner_obs))
        card_fn = quant.int8_policy_fn(env_move.inner, "cuda")
        on_card = card_fn(torch.from_numpy(inner_obs).cuda()).cpu()
        def shared(x):
            return torch.from_numpy(np.tanh(x.cpu().numpy())).to(x.device)

        with mock.patch.object(torch, "tanh", shared):
            shared_tanh = card_fn(torch.from_numpy(inner_obs).cuda()).cpu()
        if not torch.equal(shared_tanh, exact):
            bad = (shared_tanh != exact).any(1).nonzero().flatten()
            for i in bad[:8].tolist():
                print(f"int8 obs {i} {inner_obs[i].tolist()}: exact "
                      f"{exact[i].tolist()}, card {shared_tanh[i].tolist()}")
            fail("the int8 policy's integer arithmetic on the card departs "
                 f"from int8_exact: {int((shared_tanh != exact).sum())} of "
                 f"{exact.numel()} outputs on {bad.numel()} obs, by up to "
                 f"{(shared_tanh - exact).abs().max().item():.3e}")
        cpu_fn = quant.int8_policy_fn(env_move.inner, "cpu")
        on_cpu = cpu_fn(torch.from_numpy(inner_obs))
        with mock.patch.object(torch, "tanh", shared):
            cpu_shared = cpu_fn(torch.from_numpy(inner_obs))
        scale = float(env_move.inner.out_q.scale)
        lsb = (on_card - exact).abs() / scale
        n_diff = int((lsb > 0.5).sum())
        n_cpu = int(((on_cpu - exact).abs() / scale > 0.5).sum())
        n_cpu_shared = int((cpu_shared != exact).sum())
        print(f"int8 inner policy, card vs exact integer arithmetic on "
              f"{N_ENVS} obs: equal on all {lsb.numel()} int8 outputs with "
              f"one tanh; with the card's own tanh {n_diff} differ, by at "
              f"most {lsb.max().item():.2f} LSB; torch's CPU path differs "
              f"from it on {n_cpu} with torch's CPU tanh, and on "
              f"{n_cpu_shared} with the one tanh (numpy's, int8_exact's)")
        check(lsb.max().item() <= 1.001
              and n_diff <= INT8_TANH_SHARE * lsb.numel(),
              "the int8 policy disagrees between the card and int8_exact")

        # ---- 6. times at B = 4096, the main paths' inputs
        sample = torch.linspace(0, N_ENVS - 1, 16).long()
        report = []

        def measure(name, module, kernel, plain, tensors, extra, tol,
                    counts_contacts):
            """Time `kernel` and `plain` on tensors (qpos, qvel, ws, ctrl)
            followed by `extra` (friction, params), hold their float32
            drift to `tol`, and count the kernel's operations on a sample."""
            args = tensors + extra
            k_out = kernel(*args)
            k_ms = time_kernel(lambda: kernel(*args))
            seen = {}
            kwargs = {"contact_counts": seen} if counts_contacts else {}
            p_out, plain_ms = time_plain(lambda: plain(*args, **kwargs))
            d = drift(k_out, p_out)
            print(f"{name} vs plain main-path states f32 B={N_ENVS}: "
                  + ", ".join(f"{key} {v:.3e}" for key, v in d.items())
                  + ("; envs with an active contact: "
                     + str({key: int(v.sum()) for key, v in seen.items()})
                     if counts_contacts else ""))
            if name == "K1":
                d["ws_rel"], aside = hold_k1_warm_start(kernel, plain, args,
                                                        k_out, p_out, tol)
                print(f"K1 main-path warm start held to the plain float32 "
                      f"on {N_ENVS - len(aside)} envs: ws_rel "
                      f"{d['ws_rel']:.3e}; {len(aside)} set aside")
            check(within(d, tol),
                  f"{name} f32 drift over bound at B={N_ENVS}: {d}")
            MAX_F32[name] = {key: max(MAX_F32[name][key], d[key])
                             for key in d}
            ops = float(np.mean(module.count_ops(
                *(t[sample].cpu() for t in tensors), *extra)[0]))
            report.append((name, k_ms, plain_ms, ops,
                           bound(ops, N_ENVS, tensors + k_out)))

        qpos, qvel, ws = states.phys
        ctrl = qvel[:, 6:8] + act(policy, obs) * 4.0
        measure("K1", cuda_step, cuda_step.control_step_cuda,
                cuda_step.control_step_plain, (qpos, qvel, ws, ctrl),
                (None, env.params), F32_TOL, False)
        qpos, qvel, ws = states03.phys
        ctrl = qvel[:, 6:8] + act(policy03, obs03) * 4.0
        measure("K2", cuda_block, cuda_block.control_step14_cuda,
                cuda_block.control_step14_plain, (qpos, qvel, ws, ctrl),
                (env03.params,), K2_F32_TOL, True)
        qpos, qvel, ws = states_move.phys
        _, ctrl = env_move.wheel_ctrl(states_move, act(policy_move, obs_move))
        move_inputs = (qpos, qvel, ws, ctrl)
        measure("K3", cuda_move, cuda_move.control_step_walls_cuda,
                cuda_move.control_step_walls_plain, move_inputs,
                (env_move.params,), K3_F32_TOL, True)
        # no env of the main path touches a wall (phase 4 prints the count),
        # so the K3 time above is for floor rows only: time it once more
        # with every env at a wall, at the main path's batch (one lane per
        # env) and at the serving batch (a team per env)
        at_wall = [torch.tensor(x, dtype=torch.float32, device="cuda")
                   for x in random_states_walls(np.random.default_rng(5),
                                                N_ENVS)]
        at_wall.insert(2, torch.zeros_like(at_wall[1]))
        wall_ops = float(np.mean(cuda_move.count_ops(
            *(t[sample].cpu() for t in at_wall), env_move.params)[0]))
        for B in (N_ENVS, n_move):
            tensors = [t[:B].contiguous() for t in at_wall]
            wall_ms = time_kernel(lambda: cuda_move.control_step_walls_cuda(
                *tensors, env_move.params))
            print(f"K3 B={B} f32 fast with every env at a wall (a team of "
                  f"{cuda_move.KERNEL.launch_config(torch.float32, B)[0]} "
                  "lanes per "
                  f"env): median {wall_ms:.3f} ms over {TIMED_LAUNCHES} "
                  f"launches; {wall_ops:.0f} ops/env/control step")

        # the serving batches: Env01-v2 at 256 envs, the flagship Env03-v2
        # at 1024 envs and the exact grade, EnvMove05-v1 at 512 envs and
        # both grades; the first envs of the main paths' states
        def serving_time(name, module, kernel, tensors, extra, grade):
            B = tensors[0].shape[0]
            ms = time_kernel(lambda: kernel(*tensors, *extra))
            ops = float(np.mean(module.count_ops(
                *(t[:16].cpu() for t in tensors), *extra)[0]))
            b = bound(ops, B, list(tensors) + list(kernel(*tensors, *extra)))
            print(f"{name} B={B} f32 {grade}: median {ms:.3f} ms over "
                  f"{TIMED_LAUNCHES} launches; {ops:.0f} ops/env/control "
                  f"step -> bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
                  f"({100 * b['bound_ms'] / ms:.2f}% of the bound reached)")

        qpos, qvel, ws = states.phys
        ctrl = qvel[:, 6:8] + act(policy, obs) * 4.0
        serving_time("K1", cuda_step, cuda_step.control_step_cuda,
                     [t[:SERVE_EPISODES].contiguous()
                      for t in (qpos, qvel, ws, ctrl)],
                     (None, env.params), "fast")
        qpos, qvel, ws = states03.phys
        ctrl = qvel[:, 6:8] + act(policy03, obs03) * 4.0
        serving_time("K2", cuda_block, cuda_block.control_step14_cuda,
                     [t[:n03].contiguous() for t in (qpos, qvel, ws, ctrl)],
                     (bs.ENV03_PARAMS,), "exact")
        for grade, params in (("fast", env_move.params),
                              ("exact", MOVE05_PARAMS)):
            serving_time("K3", cuda_move, cuda_move.control_step_walls_cuda,
                         [t[:n_move].contiguous() for t in move_inputs],
                         (params,), grade)

        for name, k_ms, plain_ms, ops, b in report:
            print(f"{name} B={N_ENVS} f32 fast: median {k_ms:.3f} ms over "
                  f"{TIMED_LAUNCHES} launches; plain {plain_ms:.1f} ms; "
                  f"{ops:.0f} ops/env/control step; {b['peak']} -> bound "
                  f"{b['ops_ms']:.4f} ms by operations, {b['bytes_ms']:.6f} "
                  f"ms by bytes ({100 * b['bound_ms'] / k_ms:.2f}% of the "
                  f"bound reached)")

    # ---- 7. training, outside inference mode (autograd needs it off)
    training_phase(modules)
    # ---- 8. the CLI's commands, in-process (bc-init and train need
    # autograd too)
    cli_phase(modules)
    # ---- 9. the off-policy trainers and the harvest
    off_policy_phase(modules)
    # ---- 10. data-parallel PPO over ranks, and the drift probe
    parallel_phase(modules)
    # ---- 11. the selection workflow: the burst ratchet, the sweep, the
    # large eval (autograd on for the ratchet's PPO)
    selection_phase(modules)
    # ---- 12. the run drivers, the profiler, the teacher-student recipe
    tools_phase(modules)
    # ---- 13. the research tools
    research_phase(modules)

    static = {
        "K1": ("k1_control_step",
               "balance_robot_tpu_torch/csrc/control_step.cu",
               "balance_robot_tpu/physics/pallas_step.py:147::_kernel",
               counts01["K1"]),
        "K2": ("k2_control_step14",
               "balance_robot_tpu_torch/csrc/control_step14.cu",
               "balance_robot_tpu/physics/pallas_block.py:567::_kernel14",
               counts03["K2"]),
        "K3": ("k3_control_step_walls",
               "balance_robot_tpu_torch/csrc/control_step_walls.cu",
               "balance_robot_tpu/physics/pallas_move.py:132::_kernel_walls",
               counts_move["K3"])}
    kernels = []
    for name, k_ms, plain_ms, ops, b in report:
        label, source, replaces, launches = static[name]
        err32 = max(MAX_F32[name]["qpos"], MAX_F32[name]["qvel"])
        kernels.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err32, "max_abs_f64": MAX_F64[name],
            "max_abs_f32": err32,
            "max_abs_f32_vs_f64": MAX_F32_VS_F64[name], "ms": k_ms,
            "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
