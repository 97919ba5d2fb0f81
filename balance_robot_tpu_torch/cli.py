"""CLI: the reference's sb_rl.py workflow surface, on the port.

Counterpart of `balance_robot_tpu/cli.py`, on `argparse`: the same global
options `-a/--algorithm` and `-m/--model`, the same commands (train,
bc-init, test, convert, quantize, test-tflite, test-tflite-quant,
test-onnx, test-tflite-arduino) with the same options and defaults, the
same default model path `models/{env}_{algo}/best_model` (sb_rl.py:98,150)
and the folders models/ logs/ movies/ made up front in the working
directory (sb_rl.py:596-600). Its output lines are the JAX package's:
`episode {ep}: return={ret:.1f} len={t}` and Cal01's `time, vel_l, vel_r`
telemetry rows.

`--device cuda|cpu` takes the place of the JAX package's `--platform`.
Left at its default it is the card, and the CLI raises where there is no
GPU; nothing retries on the CPU. There is no physics switch: the device of
the state picks the physics (the kernels on the card, their plain versions
on the CPU).

Run:  python -m balance_robot_tpu_torch.cli -a PPO train -e Env01-v2
      python -m balance_robot_tpu_torch.cli -a PPO --device cpu \\
          test -e Env01-v2 --episodes 1
"""

import argparse
import pathlib

import numpy as np
import torch

from .device import resolve_device
from .utils.profiling import span

# train.factory.KNOWN: train runs each of them, test and convert read
# every kind of checkpoint
ALGORITHMS = ("PPO", "A2C", "SAC", "TD3", "DDPG")
MODEL_DIR = "models"
LOG_DIR = "logs"
MOVIE_DIR = "movies"
GRACE_STEPS = 200   # post-termination viewer steps before the next episode
                    # (reference sb_rl.py:175-180)


def _make_folders():
    for d in (MODEL_DIR, LOG_DIR, MOVIE_DIR):
        pathlib.Path(d).mkdir(exist_ok=True)


def _default_model(env, algo):
    return f"{MODEL_DIR}/{env}_{algo}/best_model"


def _model_dir(args):
    return pathlib.Path(args.model
                        or _default_model(args.env_id, args.algo)).parent


# ------------------------------------------------------------------ train

def train(args):
    """Train (warm start with -m: the curriculum mechanism)."""
    import balance_robot_tpu_torch as brt
    from .train import checkpoint, runner
    from .train.factory import algorithm_factory
    from .train.ppo import PPOConfig

    env = brt.make(args.env_id, device=args.device)
    if args.solver == "fast":
        env.use_fast_solver()
    init = None
    if args.model:
        init = checkpoint.load(args.model)
        print(f"warm start from {args.model}")
    trainer = None
    if args.algo == "PPO":
        cfg = PPOConfig(n_envs=args.num_envs, n_steps=args.rollout_steps,
                        minibatch_size=args.minibatch, gamma=args.gamma,
                        lr=args.lr, n_epochs=args.epochs,
                        privileged_critic=args.privileged_critic)
    else:
        # A2C, SAC, TD3 and DDPG at SB3's defaults (the off-policy
        # trainers at min(num_envs, 256) envs)
        trainer, cfg = algorithm_factory(
            args.algo, env, n_envs=args.num_envs, gamma=args.gamma,
            privileged_critic=args.privileged_critic)
    runner.train(env, cfg, seed=args.seed,
                 total_timesteps=args.total_timesteps, init_params=init,
                 max_wall_s=args.max_wall, eval_freq=args.eval_freq,
                 run_name=f"{args.env_id}_{args.algo}", resume=args.resume,
                 trainer=trainer, record_every=args.record_every)


def bc_init(args):
    """Stage 0 of the curriculum: clone the PD balance expert into the
    policy MLP as a PPO warm start."""
    import balance_robot_tpu_torch as brt
    from .train import bc, checkpoint

    env = brt.make(args.env_id, device=args.device)
    cfg = bc.BCConfig(gamma=args.gamma, log_std=args.log_std)
    gen = torch.Generator(device=env.device).manual_seed(args.seed)
    params = bc.fit(env, cfg, gen, verbose=True)
    out = args.out or f"{MODEL_DIR}/bc_init_{args.env_id}.npz"
    checkpoint.save(out, params)
    print(f"saved {out} — train with -m {out}")


# -------------------------------------------------------------- inference

@torch.no_grad()
def _run_episodes(env, act_fn, episodes, max_steps, show_io=False,
                  record=None, show_i=False):
    """The inference loop of the test-* commands (reference
    sb_rl.py:163-182): deterministic episodes of one env, the return
    printed at termination, then GRACE_STEPS more steps (the reference's
    viewer keeps stepping so a fall plays out) before the next episode.
    `act_fn(obs)` maps a numpy obs (obs_dim,) to an action (act_dim,).
    show_io / show_i log every 30th step like the reference
    (sb_rl.py:168-171); `record` saves the qpos trajectory for
    tools/replay.py; an env with `telemetry(state)` (Cal01) gets its
    `time, vel_l, vel_r` CSV row printed every step (cal01.py:31).
    Under a profiler each step is a `cli.step` span (`utils/profiling.
    span`) holding `cli.act`, `cli.env_step`, `cli.done` (the reward and
    done reads of a live episode) and one `cli.sync.*` span around each
    read that waits for the device (the act fn of `_policy_act` adds
    two)."""
    traj = []
    telemetry = getattr(env, "telemetry", None)
    for ep in range(episodes):
        state, obs = env.reset(1)
        ret, t, done_at = 0.0, 0, None
        while t < max_steps + GRACE_STEPS + 1:
            with span("cli.step"):
                with span("cli.sync.obs"):
                    o = obs[0].cpu().numpy()
                with span("cli.act"):
                    action = act_fn(o)
                if show_io and t % 30 == 0:
                    print(f"obs={o} action={action}")
                if show_i and t % 30 == 0:
                    # reference --show-i: obs in Python list syntax, ready
                    # to paste into a quantization envelope
                    # (sb_rl.py:170-171)
                    print(str([float(v) for v in o]) + ",")
                with span("cli.sync.action"):
                    a = torch.as_tensor(np.asarray(action), dtype=env.dtype,
                                        device=env.device).reshape(1, -1)
                with span("cli.env_step"):
                    state, obs, r, term, trunc = env.step(state, a)
                if record is not None:
                    traj.append(state.phys.qpos[0].cpu().numpy())
                if telemetry is not None:
                    tt, vl, vr = (float(x[0]) for x in telemetry(state))
                    print(f"{tt:.6f}, {vl:.6f}, {vr:.6f}")
                t += 1
                if done_at is None:
                    with span("cli.done"):
                        with span("cli.sync.reward"):
                            ret += float(r[0])
                        with span("cli.sync.term"):
                            done = bool(term[0])
                        if not done:
                            with span("cli.sync.trunc"):
                                done = bool(trunc[0])
                    if done:
                        done_at = t
                        print(f"episode {ep}: return={ret:.1f} len={t}")
                elif t - done_at > GRACE_STEPS:
                    break
        if done_at is None:
            print(f"episode {ep}: return={ret:.1f} len={t}")
    if record is not None:
        np.savez(record, qpos=np.stack(traj) if traj else np.zeros((0,)))
        print(f"trajectory recorded to {record} "
              f"(replay: python tools/replay.py {record})")


def _policy_act(params, env):
    """act_fn of the PPO/A2C params dict: the policy mean, computed on the
    env's device."""
    from .models import mlp

    net = mlp.from_numpy_params(params, device=env.device, dtype=env.dtype)

    def act(obs):
        with span("cli.sync.policy_in"):
            o = torch.as_tensor(obs, dtype=env.dtype, device=env.device)
        mean = net.policy_mean(o[None])[0]
        with span("cli.sync.policy_out"):
            return mean.cpu().numpy()
    return act


def test(args):
    """Run the trained policy in the env."""
    import balance_robot_tpu_torch as brt
    from .train import checkpoint

    env = brt.make(args.env_id, device=args.device)
    params = checkpoint.load(args.model
                             or _default_model(args.env_id, args.algo))
    _run_episodes(env, _policy_act(params, env), args.episodes,
                  env.max_episode_steps, args.show_io, args.record,
                  show_i=args.show_i)


# ----------------------------------------------------------------- export

def convert(args):
    """Export ONNX + TF SavedModel + .brq next to the checkpoint."""
    import balance_robot_tpu_torch as brt
    from .export import onnx_runtime, pipeline
    from .train import checkpoint

    path = args.model or _default_model(args.env_id, args.algo)
    params = checkpoint.load(path)
    act_dim = brt.env_class(args.env_id).act_dim
    base = pathlib.Path(path).parent
    onnx_path = base / "best_model.onnx"
    pipeline.export_onnx(params, onnx_path, act_dim)
    # check the artifact at once (the reference defers this to test-onnx's
    # onnx.checker, sb_rl.py:209): a broken graph must not ship
    onnx_runtime.check_model(onnx_runtime.load_model(onnx_path))
    print(f"wrote {onnx_path}")
    sm = base / "saved_model"
    pipeline.export_savedmodel(params, sm, act_dim)
    print(f"wrote {sm}")
    try:
        pipeline.export_brq(params, base / "best_model_int8.brq")
        print(f"wrote {base / 'best_model_int8.brq'}.npz")
    except NotImplementedError as e:
        print(f"skipping .brq: {e}")


def quantize(args):
    """SavedModel -> int8 TFLite -> model.h (replaces quantize_tflite.py)."""
    from .export import pipeline

    base = _model_dir(args)
    sm = base / "saved_model"
    if not sm.exists():
        raise SystemExit(f"Error: {sm} missing — run convert first")
    tfl = pipeline.quantize_tflite(sm, base / "int8_model.tflite")
    print(f"wrote {tfl}")
    f32 = pipeline.quantize_tflite(sm, base / "float_model.tflite",
                                   float32=True)
    print(f"wrote {f32}")
    hh = pipeline.write_model_h(tfl, base / "model.h")
    print(f"wrote {hh}")


def _tflite_act(tflite_path, quantized):
    """act_fn of a .tflite policy, through the reference's quantize /
    dequantize shim when `quantized`. The actions are read by the
    signature's output name: the first [1, 2] output of the PPO graph is
    log_std, which a lookup by shape (the JAX package's) acts on."""
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=str(tflite_path))
    run = interp.get_signature_runner()
    if not quantized:
        def act(obs):
            return run(input=obs.astype(np.float32)[None, :])["actions"][0]
        return act
    iscale, izp = run.get_input_details()["input"]["quantization"]
    oscale, ozp = run.get_output_details()["actions"]["quantization"]

    def act(obs):
        q = np.round(obs / iscale) + izp
        q = np.clip(q, -128, 127).astype(np.int8)[None, :]
        out = run(input=q)["actions"][0]
        return oscale * (out.astype(np.float32) - ozp)
    return act


def _run_tflite(args, name, quantized):
    import balance_robot_tpu_torch as brt

    env = brt.make(args.env_id, device=args.device)
    act = _tflite_act(_model_dir(args) / name, quantized)
    _run_episodes(env, act, args.episodes, env.max_episode_steps,
                  args.show_io)


def test_tflite(args):
    """Run the float32 TFLite model in the env."""
    _run_tflite(args, "float_model.tflite", quantized=False)


def test_tflite_quant(args):
    """Run the int8 TFLite model with the reference's quantize/dequantize
    shim (round, +zero_point, clip to [-128, 127]; sb_rl.py:336-357)."""
    _run_tflite(args, "int8_model.tflite", quantized=True)


def test_onnx(args):
    """Run the exported ONNX model in the env (reference sb_rl.py:185-230:
    checker + InferenceSession episode loop), on onnxruntime, the native
    executor or the numpy executor (`onnx_runtime.session`)."""
    import balance_robot_tpu_torch as brt
    from .export import onnx_runtime

    env = brt.make(args.env_id, device=args.device)
    path = args.model
    if path is None or not str(path).endswith(".onnx"):
        path = _model_dir(args) / "best_model.onnx"
    if not pathlib.Path(path).is_file():
        raise SystemExit(f"Error: could not open model file: {path} "
                         "(run `convert` first)")
    sess = onnx_runtime.session(path)
    input_name = sess.get_inputs()[0].name
    output_name = sess.get_outputs()[0].name

    def act(obs):
        feed = {input_name: obs.astype(np.float32)[None, :]}
        return sess.run([output_name], feed)[0][0]

    _run_episodes(env, act, args.episodes, env.max_episode_steps,
                  args.show_io)


def test_tflite_arduino(args):
    """Hardware-in-the-loop over serial (obs out, actions back at 115200
    baud, CSV; reference sb_rl.py:367-489). Needs pyserial and the
    robot."""
    try:
        import serial
    except ImportError:
        raise SystemExit(
            "Error: pyserial is not installed in this environment; HIL "
            "testing requires the physical robot attached over USB serial")
    import balance_robot_tpu_torch as brt

    env = brt.make(args.env_id, device=args.device)
    ser = serial.Serial(args.port, 115200, timeout=1)
    _run_episodes(env, _serial_act(ser), 1, env.max_episode_steps,
                  show_io=True)


def _serial_act(ser):
    """CSV-over-serial policy: obs out, action line back (the reference's
    MCU protocol, sb_rl.py:418-437). `ser` is any object with
    write(bytes) / readline(): a pyserial port on hardware, a loopback in
    tests."""
    def act(obs):
        ser.write((",".join(f"{v:.6f}" for v in obs) + "\n").encode())
        line = ser.readline().decode().strip()
        return np.array([float(x) for x in line.split(",")], np.float32)

    return act


# ----------------------------------------------------------------- parser

def build_parser():
    """The argument parser: global options, then one sub-command. Each
    option's `dest` is the name of the JAX package's click parameter."""
    p = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.cli",
        description="Train, run and export balance-robot policies.")
    p.add_argument("-a", "--algorithm", required=True,
                   help=f"RL algorithm, one of {ALGORITHMS}")
    p.add_argument("-m", "--model", default=None,
                   help="model file (warm start / inference)")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the envs and the policy run (default: the "
                        "GPU; raises without one)")
    sub = p.add_subparsers(dest="command", required=True,
                           metavar="COMMAND")

    def command(name, fn):
        doc = " ".join(fn.__doc__.split())
        c = sub.add_parser(name, help=doc.split(". ")[0], description=doc)
        c.set_defaults(func=fn)
        c.add_argument("-e", "--env", dest="env_id", required=True)
        return c

    def flag(c, *names, dest=None, help=None):
        c.add_argument(*names, dest=dest, action="store_true",
                       default=False, help=help)

    c = command("train", train)
    c.add_argument("--num-envs", type=int, default=1024)
    c.add_argument("--rollout-steps", type=int, default=32)
    c.add_argument("--minibatch", type=int, default=1024)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--total-timesteps", type=int, default=int(1e10))
    c.add_argument("--max-wall", type=float, default=None)
    c.add_argument("--gamma", type=float, default=0.99,
                   help="discount (SB3 default 0.99; 0.999 recommended at "
                        "scale, see README)")
    c.add_argument("--eval-freq", type=int, default=200_000,
                   help="global env steps between evals")
    flag(c, "--resume", help="continue from <run dir>/resume_state.npz")
    c.add_argument("--lr", type=float, default=3e-4)
    c.add_argument("--epochs", type=int, default=10,
                   help="PPO epochs per iteration")
    c.add_argument("--solver", choices=["fast", "exact"], default="fast",
                   help="constraint-solver grade: fast = training, exact = "
                        "MuJoCo parity")
    c.add_argument("--record-every", type=int, default=10,
                   help="record a deterministic eval trajectory to movies/ "
                        "every N evals (0 = off)")
    flag(c, "--privileged-critic",
         help="the value net also reads the env's privileged features "
              "(Env03); the deployed policy keeps the 6-obs interface")

    c = command("bc-init", bc_init)
    c.add_argument("--out", default=None,
                   help="output npz (default models/bc_init_<env>.npz)")
    c.add_argument("--gamma", type=float, default=0.999)
    c.add_argument("--log-std", type=float, default=-1.0)
    c.add_argument("--seed", type=int, default=0)

    c = command("test", test)
    flag(c, "--show-io")
    flag(c, "--show-i", help="log obs in Python list syntax every 30th "
                             "step (reference sb_rl.py:139,170-171)")
    c.add_argument("--episodes", type=int, default=3)
    c.add_argument("--record", default=None,
                   help="record the qpos trajectory (npz)")

    command("convert", convert)
    command("quantize", quantize)
    for name, fn in (("test-tflite", test_tflite),
                     ("test-tflite-quant", test_tflite_quant)):
        c = command(name, fn)
        flag(c, "--show-i", dest="show_io")
        c.add_argument("--episodes", type=int, default=1)

    c = command("test-onnx", test_onnx)
    flag(c, "--show-io")
    c.add_argument("--episodes", type=int, default=1)

    c = command("test-tflite-arduino", test_tflite_arduino)
    c.add_argument("--port", default="/dev/ttyACM0")
    return p


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the command."""
    args = build_parser().parse_args(argv)
    args.algo = args.algorithm.upper()
    if args.algo not in ALGORITHMS:
        raise SystemExit(f"Error: algorithm {args.algorithm!r} not "
                         f"available natively; choose from {ALGORITHMS}")
    args.device = resolve_device(args.device)
    _make_folders()
    args.func(args)


if __name__ == "__main__":
    main()
