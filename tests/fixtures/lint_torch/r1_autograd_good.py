"""Known-good R1 inside an autograd.Function: device math only."""
import torch


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        norm = torch.clamp_min(g.norm(), 1e-12)
        return g * w / norm, (g * x).sum()
