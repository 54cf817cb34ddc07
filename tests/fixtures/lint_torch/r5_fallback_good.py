"""Known-good R5: the device picks the path; a failed launch raises."""
import argparse

import torch

from repro_torch.kernels import launch, route


def double_plain(x):
    return x * 2


def double(x):
    if route(x) == "cpu":
        return double_plain(x)
    try:
        launch("double", x.data_ptr(), x.numel())
    except RuntimeError as e:
        raise RuntimeError(f"double: {e}") from e
    return x


def resolve(device=None):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no card: pass device='cpu' explicitly")
    return dev


def cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)
