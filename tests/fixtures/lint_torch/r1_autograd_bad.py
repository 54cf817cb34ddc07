"""Known-bad R1 inside an autograd.Function's backward (a hot entry)."""
import torch


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        norm = g.norm().item()           # a sync in every backward
        return g * w / norm, (g * x).sum()
