"""Known-bad R2: kernels built or generated outside kernels.build."""
import ctypes
import subprocess

import torch
from torch.utils.cpp_extension import load


def build_my_kernel(src):
    subprocess.run(["nvcc", "-shared", src, "-o", "k.so"], check=True)
    return ctypes.CDLL("k.so")


def jit_extension():
    return load(name="k", sources=["k.cu"])


def fused(x):
    return torch.compile(lambda t: t * 2)(x)


@torch.jit.script
def scripted(x: torch.Tensor) -> torch.Tensor:
    return x + 1
