"""JAX parameter pytrees <-> the port's encoder, through numpy only.

The JAX package stores RGCN params as a pytree flattened by
``flatten_tree`` (``repro_torch.sampling.store``) into '/'-joined keys::

    embed_instr, embed_var, embed_pseudo,
    layers/<i>/{basis, comb, w0, b, ln_scale, ln_bias},
    proj/{w1, b1, w2, b2}

which are exactly the port's ``RGCNEncoder.state_dict()`` names with '.'
for '/'.  Both directions take and give numpy arrays; nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.rgcn import RGCNConfig, RGCNEncoder


def _config_from_shapes(flat: dict, rc: Optional[RGCNConfig]) -> RGCNConfig:
    n_layers = len({k.split("/")[1] for k in flat if k.startswith("layers/")})
    if n_layers == 0:
        raise KeyError("params have no layers/<i>/... entries")
    dims = [flat["layers/0/basis"].shape[1]]
    dims += [flat[f"layers/{i}/basis"].shape[2] for i in range(n_layers)]
    nb, nr = flat["layers/0/comb"].shape[1], flat["layers/0/comb"].shape[0]
    hidden, out = flat["proj/w1"].shape[1], flat["proj/w2"].shape[1]
    if rc is None:
        return RGCNConfig(dims=tuple(dims), num_bases=nb, num_relations=nr,
                          proj_hidden=hidden, proj_out=out)
    want = (tuple(rc.dims), rc.num_bases, rc.num_relations, rc.proj_hidden,
            rc.proj_out)
    got = (tuple(dims), nb, nr, hidden, out)
    if want != got:
        raise ValueError(f"params shaped for (dims, bases, relations, "
                         f"proj_hidden, proj_out) = {got}, config has {want}")
    return rc


def params_from_jax(flat: dict[str, np.ndarray],
                    rc: Optional[RGCNConfig] = None) -> RGCNEncoder:
    """A CPU float32 ``RGCNEncoder`` holding the given JAX params.  ``rc``
    defaults to the configuration the shapes imply; a given ``rc`` must
    match them.  Every parameter must be present, and nothing else."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    enc = RGCNEncoder(_config_from_shapes(flat, rc))
    state = enc.state_dict()
    want = {k.replace(".", "/") for k in state}
    if set(flat) != want:
        raise KeyError(f"param keys differ: missing "
                       f"{sorted(want - set(flat))}, unexpected "
                       f"{sorted(set(flat) - want)}")
    new = {}
    for key, ref in state.items():
        arr = flat[key.replace(".", "/")]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape}, expected "
                             f"{tuple(ref.shape)}")
        new[key] = torch.from_numpy(np.array(arr, np.float32))
    enc.load_state_dict(new)
    return enc


def params_to_numpy(enc: RGCNEncoder) -> dict[str, np.ndarray]:
    """The encoder's parameters as float32 numpy arrays in the JAX
    ``flatten_tree`` key layout (the inverse of ``params_from_jax``)."""
    return {k.replace(".", "/"): v.detach().cpu().numpy().astype(np.float32)
            for k, v in enc.state_dict().items()}
