"""Known-bad R5: fallbacks from a kernel to the CPU or a plain version."""
import argparse

import torch

from repro_torch.kernels import launch


def double_plain(x):
    return x * 2


def double(x):
    try:
        launch("double", x.data_ptr(), x.numel())
    except RuntimeError:
        return double_plain(x)                   # falls back
    return x


def quiet(x):
    try:
        launch("double", x.data_ptr(), x.numel())
    except Exception:
        pass                                     # carries on
    return x


def pick_device(device="cpu"):
    return "cuda" if torch.cuda.is_available() else "cpu"


def cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    return ap.parse_args(argv)
