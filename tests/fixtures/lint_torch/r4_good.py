"""Known-good R4: sums as one-hot matmuls, gathers with a fixed-order
backward or no autograd graph."""
import torch


class TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(idx, ctx.rows).to(g.dtype)
        return onehot.t() @ g, None


def aggregate(h, dst, num_nodes: int):
    onehot = torch.nn.functional.one_hot(dst, num_nodes).to(h.dtype)
    return onehot.t() @ h


def lookup(table, idx):
    with torch.no_grad():
        rows = table.index_select(0, idx)
    table.index_put_((idx,), rows, accumulate=False)
    return rows, TakeRows.apply(table, idx)
