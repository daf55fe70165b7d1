"""Convert stable-baselines3 PPO checkpoints (best_model.zip) to the npz
that learn/policy.py::load_sb3_policy reads (the port's copy of
tools/convert_sb3_checkpoint.py):

    python -m tum_control_tpu_torch.tools.convert_sb3_checkpoint SRC_MODELS_DIR DST_DIR
        [--device cuda|cpu]

For every SRC_MODELS_DIR/<name>/best_model/best_model.zip it writes
DST_DIR/<name>/policy_weights.npz (the zip's policy.pth state dict, every
"." of a key replaced by "__") and copies <name>/rl_config.yaml beside it
when there is one. SB3 itself is not needed: policy.pth is a plain torch
state dict. The conversion runs on the host; each npz written is then
loaded as the port's policy (load_sb3_policy) on `--device`, the device the
policy will run on (cuda by default: without a card the run raises unless
`--device cpu` is given), and its layer widths are printed.
"""
import argparse
import io
import os
import shutil
import sys
import zipfile

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device


def convert(zip_path: str, out_dir: str) -> None:
    with zipfile.ZipFile(zip_path) as z:
        with z.open("policy.pth") as fh:
            sd = torch.load(io.BytesIO(fh.read()), map_location="cpu", weights_only=False)
    os.makedirs(out_dir, exist_ok=True)
    arrs = {k.replace(".", "__"): v.numpy() for k, v in sd.items()}
    np.savez(os.path.join(out_dir, "policy_weights.npz"), **arrs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src_root")
    ap.add_argument("dst_root")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the names converted, in order."""
    from tum_control_tpu_torch.learn.policy import load_sb3_policy

    args = parse_args(argv)
    device = resolve_device(args.device)
    src_root, dst_root = args.src_root, args.dst_root
    done = []
    for name in sorted(os.listdir(src_root)):
        zpath = os.path.join(src_root, name, "best_model", "best_model.zip")
        if not os.path.exists(zpath):
            continue
        out = os.path.join(dst_root, name)
        convert(zpath, out)
        cfg = os.path.join(src_root, name, "rl_config.yaml")
        if os.path.exists(cfg):
            shutil.copy(cfg, os.path.join(out, "rl_config.yaml"))
        policy = load_sb3_policy(os.path.join(out, "policy_weights.npz"), device=device)
        print(f"converted {name}")
        widths = [layer.out_features for layer in policy.pi]
        print(f"  policy on {device}: obs_dim {policy.pi[0].in_features}, hidden {widths}, "
              f"{policy.n_actions} actions")
        done.append(name)
    return done


if __name__ == "__main__":
    main(sys.argv[1:])
