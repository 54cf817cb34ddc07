"""The port's packed RGCN encoder against the JAX package's.

JAX ``init_rgcn`` params go through ``params_from_jax`` into the port; both
sides encode the same numpy ``pack_graphs`` batch.  Tolerances:

- float32 policy: z within 1e-5 relative to the largest |z| (the two sides
  sum in different orders);
- bfloat16 policy: 3e-2 relative, the JAX parity suite's bf16 tolerance —
  activations are rounded to bf16 (2^-8 relative) after every layer, and a
  different float32 summation order can move a rounding by one bf16 ulp.
  JAX runs its fused-kernel path here (``use_pallas=True``, interpret mode),
  whose precision profile (bf16 gather, f32 after it) is the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batching import pack_graphs
from repro.core.graphs import NUM_RELATIONS, build_kernel_graph
from repro.core.precision import Policy as JPolicy
from repro.core.rgcn import RGCNConfig as JRGCNConfig
from repro.core.rgcn import encode_packed as jax_encode_packed
from repro.core.rgcn import init_rgcn as jax_init_rgcn
from repro.core.rgcn import project as jax_project
from repro.kernels.rgcn_fused.ops import (
    fused_two_level_readout as jax_readout,
)
from repro.kernels.rgcn_fused.ref import two_level_readout_ref
from repro.sampling.store import flatten_tree
from repro.tracing.templates import make_kernel
from repro_torch.core.precision import Policy
from repro_torch.core.rgcn import (
    RGCNConfig, edge_norm_packed, encode_packed, init_rgcn, project,
)
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels.rgcn_fused.ops import fused_two_level_readout

DIMS = {"narrow": (64, 32, 32, 48), "full": (64, 128, 128, 256)}


def _graphs(seed=0, n=5):
    templates = [("gemm", {"M": 128, "N": 128, "K": 128}),
                 ("elementwise", {"n": 4096, "nops": 3, "iters": 4}),
                 ("stencil", {"nx": 512, "ny": 4, "pts": 5, "iters": 8}),
                 ("reduction", {"n": 65536}),
                 ("softmax", {"rows": 64, "cols": 1000})]
    ks = [make_kernel(f"k{i}", *templates[i % len(templates)], i,
                      seed=seed * 10 + i) for i in range(n)]
    return [build_kernel_graph(k.trace(cap_warps=2, cap_instr=40))
            for k in ks]


def _batch(seed=0, n=5):
    packed, _ = pack_graphs(_graphs(seed, n), pad_graphs_to=8)
    return packed


def _scale_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("width", sorted(DIMS))
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_encode_packed_matches_jax(width, policy):
    dims = DIMS[width]
    compute = "float32" if policy == "f32" else "bfloat16"
    jrc = JRGCNConfig(dims=dims, use_pallas=(policy == "bf16"),
                      policy=JPolicy(compute_dtype=compute))
    rc = RGCNConfig(dims=dims, policy=Policy(compute_dtype=compute))
    jparams = jax_init_rgcn(jax.random.PRNGKey(3), jrc)
    enc = params_from_jax(flatten_tree(jparams), rc)
    packed = _batch(seed=1)
    want = jax_encode_packed(jparams, jrc,
                             {k: jnp.asarray(v) for k, v in packed.items()})
    with torch.inference_mode():
        got = encode_packed(enc, rc, {k: torch.from_numpy(v)
                                      for k, v in packed.items()})
    assert got.shape == (8, dims[-1]) and got.dtype == torch.float32
    assert not got[5:].any()                 # padding graphs -> zero rows
    _scale_close(got.numpy(), want, 1e-5 if policy == "f32" else 3e-2)
    if policy == "f32":
        pz = jax_project(jparams, jrc, want)
        with torch.inference_mode():
            tz = project(enc, rc, got)
        _scale_close(tz.numpy(), pz, 1e-5)


def test_encode_without_hoisted_edge_norm_matches():
    """Batches without the hoisted ``edge_norm`` recompute it in-graph; the
    recomputation equals pack_graphs' numpy normalizer bit for bit, so the
    embeddings are identical."""
    packed = _batch(seed=2)
    t = {k: torch.from_numpy(v) for k, v in packed.items()}
    norm = edge_norm_packed(t["edge_dst"], t["edge_type"], t["edge_mask"],
                            len(packed["node_mask"]), NUM_RELATIONS)
    assert np.array_equal(norm.numpy(), packed["edge_norm"])
    rc = RGCNConfig(dims=DIMS["narrow"])
    enc = init_rgcn(0, rc)
    with torch.inference_mode():
        a = encode_packed(enc, rc, t)
        b = encode_packed(enc, rc, {k: v for k, v in t.items()
                                    if k != "edge_norm"})
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["empty_warp", "random"])
def test_fused_two_level_readout_matches_jax(case):
    """The readout's two index_add_ levels vs JAX's segment sums; a warp
    with no live nodes stays out of its graph's mean."""
    if case == "empty_warp":
        P, D, W, G = 8, 4, 3, 2
        h = np.ones((P, D), np.float32)
        node_mask = np.ones(P, np.float32)
        warp_seg = np.zeros(P, np.int32)        # warps 1, 2 are empty
        warp_graph = np.array([0, 0, 1], np.int32)
    else:
        rng = np.random.default_rng(3)
        P, D, W, G = 37, 16, 9, 4
        h = rng.standard_normal((P, D)).astype(np.float32)
        node_mask = (rng.random(P) < 0.8).astype(np.float32)
        warp_seg = rng.integers(0, W, P).astype(np.int32)
        warp_graph = rng.integers(0, G, W).astype(np.int32)
    got = fused_two_level_readout(
        torch.from_numpy(h), torch.from_numpy(node_mask),
        torch.from_numpy(warp_seg), torch.from_numpy(warp_graph), G).numpy()
    j = [jnp.asarray(a) for a in (h, node_mask, warp_seg, warp_graph)]
    _scale_close(got, jax_readout(*j, G), 1e-6)
    _scale_close(got, two_level_readout_ref(*j, W, G), 1e-6)
    if case == "empty_warp":
        assert np.array_equal(got[1], np.zeros(D, np.float32))
        assert np.array_equal(got[0], np.ones(D, np.float32))


def test_params_round_trip_and_validation():
    jrc = JRGCNConfig(dims=DIMS["narrow"])
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jax_init_rgcn(jax.random.PRNGKey(0), jrc)).items()}
    enc = params_from_jax(flat)
    assert enc.rc.dims == DIMS["narrow"]
    back = params_to_numpy(enc)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        assert np.array_equal(back[k], flat[k]), k
    with pytest.raises(ValueError):
        params_from_jax(flat, RGCNConfig())          # widths disagree
    missing = dict(flat)
    missing.pop("layers/1/w0")
    with pytest.raises(KeyError):
        params_from_jax(missing)
