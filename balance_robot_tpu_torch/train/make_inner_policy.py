"""Build the int8 inner balance policy of the move envs from a trained
balance checkpoint.

Counterpart of `tools/make_inner_policy.py`, with its argument, default and
output lines:

    python -m balance_robot_tpu_torch.train.make_inner_policy \\
        [models/Env01-v2_PPO/best_model]

writes `export.pipeline.export_brq` of the checkpoint into this package's
`envs/assets/inner_policy.brq.npz` (the file `envs/move.py` loads), then
the real TFLite int8 model `inner_policy.tflite` beside it for the MCU,
through a SavedModel in a temporary directory. Where TensorFlow is not
installed it prints `tflite export skipped: ...`, as the tool does on such
a host.

The build runs in numpy on the host, as the JAX tool's, so there is no
`--device`. It writes into the package itself: run it to replace the
committed asset on purpose, or with `ASSETS` pointed elsewhere.
"""

import argparse
import pathlib
import tempfile

import numpy as np

from ..export import pipeline
from . import checkpoint

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "envs" / "assets"
SOURCE = "models/Env01-v2_PPO/best_model"


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.make_inner_policy",
        description="Build the int8 inner balance policy of the move envs.")
    ap.add_argument("src", nargs="?", default=SOURCE,
                    help="the balance checkpoint")
    return ap


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and build; returns the path of
    the written .brq.npz."""
    args = build_parser().parse_args(argv)
    params = checkpoint.load(args.src)
    assets = ASSETS
    assets.mkdir(exist_ok=True)
    pipeline.export_brq(params, assets / "inner_policy.brq")
    print(f"wrote {assets / 'inner_policy.brq'}.npz")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            saved_model = pathlib.Path(tmp) / "saved_model"
            pipeline.export_savedmodel(params, saved_model,
                                       np.shape(params["pi_wout"])[1])
            pipeline.quantize_tflite(saved_model,
                                     assets / "inner_policy.tflite")
        print(f"wrote {assets / 'inner_policy.tflite'}")
    except Exception as e:
        print(f"tflite export skipped: {e}")
    return assets / "inner_policy.brq.npz"


if __name__ == "__main__":
    main()
