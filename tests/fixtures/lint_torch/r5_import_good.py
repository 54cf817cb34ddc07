"""Known-good R5: the port imports only itself (copies, not imports)."""
import repro_torch
from repro_torch.core import rgcn


def encode(x):
    return rgcn, repro_torch.__name__, x
