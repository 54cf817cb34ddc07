"""The port's packed RGCN encoder against the JAX package's.

JAX ``init_rgcn`` params go through ``params_from_jax`` into the port; both
sides encode the same numpy ``pack_graphs`` batch.  Tolerances:

- float32 policy: z within 1e-5 relative to the largest |z| (the two sides
  sum in different orders);
- bfloat16 policy: 3e-2 relative, the JAX parity suite's bf16 tolerance —
  activations are rounded to bf16 (2^-8 relative) after every layer, and a
  different float32 summation order can move a rounding by one bf16 ulp.
  JAX runs its fused-kernel path here (``use_pallas=True``, interpret mode),
  whose precision profile (bf16 gather, f32 after it) is the port's;
- bf16 messages (``message_dtype``) against JAX's XLA path, which rounds
  the products and sums to bf16 too: z within 5e-3 of the largest |z|,
  each gradient leaf within 1.5x of JAX's own f32-vs-bf16-message gap.
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


#: bf16 messages against JAX's XLA path (which also rounds the products
#: and sums to bf16, where the port's kernels keep float32 after the
#: gather): the embeddings' largest gap, relative to the largest |z|
MSG_TOL = 5e-3
#: the gradients' largest gap to JAX's bf16-message gradients, leaf by
#: leaf, as a multiple of JAX's own gap between its f32 and bf16 messages
MSG_GRAD_RATIO = 1.5


def _max_gap(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("width", sorted(DIMS))
def test_bf16_messages_match_jax_xla_path(width):
    """``message_dtype="bfloat16"`` through K1 (the main path) and K5
    (``unfused_ref``), each against JAX's XLA path (``use_pallas=False``):
    within 5e-3 of the largest |z|, and not the port's float32-message
    embeddings."""
    dims = DIMS[width]
    jrc = JRGCNConfig(dims=dims, message_dtype="bfloat16")
    rc = RGCNConfig(dims=dims, message_dtype="bfloat16")
    jparams = jax_init_rgcn(jax.random.PRNGKey(3), jrc)
    enc = params_from_jax(flatten_tree(jparams), rc)
    packed = _batch(seed=1)
    want = np.asarray(jax.jit(lambda p, b: jax_encode_packed(p, jrc, b))(
        jparams, {k: jnp.asarray(v) for k, v in packed.items()}))
    tb = {k: torch.from_numpy(v) for k, v in packed.items()}
    scale = float(np.abs(want).max())
    for unfused in (False, True):
        with torch.inference_mode():
            got = encode_packed(enc, rc, tb, unfused_ref=unfused)
            f32 = encode_packed(enc, RGCNConfig(dims=dims), tb,
                                unfused_ref=unfused)
        assert got.dtype == torch.float32 and not got[5:].any()
        assert _max_gap(got.numpy(), want) <= MSG_TOL * scale, unfused
        assert _max_gap(got.numpy(), f32.numpy()) > 0, unfused


def test_bf16_message_grads_within_jax_own_gap():
    """The gradients of ``packed_loss`` on JAX's draws with bf16 messages:
    each leaf within 1.5x of JAX's own gap between its float32 and bf16
    messages on that leaf (the port's kernels round only the gather)."""
    import dataclasses

    from repro.core.train import packed_loss as jax_packed_loss
    from repro_torch.core.train import packed_loss
    from test_torch_train import TAU, _jax_draws, _leaf_grads
    from test_torch_train import _packed as train_packed

    jrc32 = JRGCNConfig(dims=DIMS["narrow"])
    jrc16 = dataclasses.replace(jrc32, message_dtype="bfloat16")
    rc16 = RGCNConfig(dims=DIMS["narrow"], message_dtype="bfloat16")
    jparams = jax_init_rgcn(jax.random.PRNGKey(5), jrc32)
    packed = train_packed([0, 3, 5, 7, 8, 10])
    jb = {k: jnp.asarray(v) for k, v in packed.items()}
    rng = jax.random.PRNGKey(21)

    # both of JAX's gradients in one executable: one compile
    g32, g16 = (flatten_tree(g) for g in jax.jit(lambda p: tuple(
        jax.grad(lambda q, jrc=jrc: jax_packed_loss(
            q, jrc, TAU, jb, rng, train=True)[0])(p)
        for jrc in (jrc32, jrc16)))(jparams))
    enc = params_from_jax(flatten_tree(jparams), rc16)
    loss, _ = packed_loss(enc, rc16, TAU,
                          {k: torch.from_numpy(v) for k, v in packed.items()},
                          _jax_draws(rng, packed, jrc16), train=True)
    got = _leaf_grads(enc, loss)
    assert set(got) == set(g16)
    for k in g16:
        own = _max_gap(g32[k], g16[k])
        assert _max_gap(got[k], g16[k]) <= MSG_GRAD_RATIO * own, k


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
