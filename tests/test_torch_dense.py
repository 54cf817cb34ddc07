"""The port's dense encoder path against the JAX package's, on the CPU.

The dense path pads every graph of a batch to the batch's largest
(``core/graphs.pad_batch``): K6's plain version (``rgcn_spmm_dense_plain``)
against JAX's Pallas ``rgcn_spmm_fwd`` in interpret mode, the dense
``rgcn_message_agg`` with its gradients against JAX's custom-vjp op, the
dense ``encode`` against JAX's on both of its paths, the ablation switches
(``use_vstats``, ``relations_used``) on the dense and the packed paths,
the dense ``augment_view`` from JAX's draws, the dense InfoNCE loss and its
gradients against JAX's ``ContrastiveTrainer._loss`` on its rebuilt key
tree, ``embed_dense`` against JAX's and against the port's packed
``embed``, and the artifact key of the ablation configs.  Params start
from JAX ``init_rgcn`` through ``params_from_jax``; widths are narrow,
(64, 32, 32, 48), with one full-width case.

Tolerances, relative to the largest magnitude of each compared array: K6
1e-5 (sums in another order); the op's forward and gradients 1e-4 (two
autodiff systems); f32 embeddings 1e-5; bf16-policy embeddings 3e-2 (the
existing bf16 tolerance: activations rounded to bf16 after every layer); the
loss 1e-5 and its gradients 1e-4; dense against packed 1e-4 (JAX's own
dense-against-packed tolerance); bf16 messages against JAX's XLA path 5e-3
(JAX also rounds the products and sums to bf16, the port only the
gather).  Masks are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.augment import augment_view as jax_augment_view
from repro.core.graphs import build_kernel_graph
from repro.core.precision import Policy as JPolicy
from repro.core.rgcn import RGCNConfig as JRGCNConfig
from repro.core.rgcn import encode as jax_encode
from repro.core.rgcn import encode_packed as jax_encode_packed
from repro.core.rgcn import init_rgcn as jax_init_rgcn
from repro.core.sampler import GCLSamplerConfig as JSamplerConfig
from repro.core.train import ContrastiveTrainer as JTrainer
from repro.core.train import GCLTrainConfig as JGCLTrainConfig
from repro.kernels.rgcn_spmm.kernel import rgcn_spmm_fwd as jax_spmm_fwd
from repro.kernels.rgcn_spmm.ops import rgcn_message_agg as jax_message_agg
from repro.sampling.base import config_hash as jax_config_hash
from repro.sampling.methods import GCLMethod as JGCLMethod
from repro.sampling.store import flatten_tree
from repro.tracing.templates import make_kernel
from repro_torch.core.augment import augment_view
from repro_torch.core.batching import pack_graphs
from repro_torch.core.graphs import pad_batch
from repro_torch.core.precision import Policy
from repro_torch.core.rgcn import (
    EncodeDraws, RGCNConfig, encode, encode_packed,
)
from repro_torch.core.sampler import GCLSamplerConfig
from repro_torch.core.train import (
    ContrastiveTrainer, ViewDraws, dense_loss, draw_seed, draw_step,
)
from repro_torch.interop import params_from_jax
from repro_torch.kernels import dense_edge_csr
from repro_torch.kernels.rgcn_spmm.ops import (
    rgcn_message_agg, rgcn_spmm_dense, rgcn_spmm_dense_plain,
)
from repro_torch.sampling.base import config_hash
from repro_torch.sampling.methods import GCLMethod

DIMS = (64, 32, 32, 48)
FULL = (64, 128, 128, 256)
TAU = 0.05
JRC = JRGCNConfig(dims=DIMS)
RC = RGCNConfig(dims=DIMS)
TEMPLATES = [("gemm", {"M": 128, "N": 128, "K": 128}),
             ("elementwise", {"n": 4096, "nops": 3, "iters": 4}),
             ("stencil", {"nx": 512, "ny": 4, "pts": 5, "iters": 8}),
             ("reduction", {"n": 65536}),
             ("softmax", {"rows": 64, "cols": 1000})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes on one host slow each
    other down when every torch thread pool spins on all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(n=5, cap_instr=40, seed=0):
    ks = [make_kernel(f"k{i}", *TEMPLATES[i % len(TEMPLATES)], i,
                      seed=seed * 10 + i) for i in range(n)]
    return [build_kernel_graph(k.trace(cap_warps=2, cap_instr=cap_instr))
            for k in ks]


GRAPHS = _graphs()


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _scale_close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def jparams():
    return jax_init_rgcn(jax.random.PRNGKey(5), JRC)


def _encoder(jparams, rc=RC):
    return params_from_jax(flatten_tree(jparams), rc)


# ---------------------------------------------------------------------------
# K6 and the dense message aggregation
# ---------------------------------------------------------------------------

def _k6_inputs(case, seed=0):
    """(h, src, dst, w, N) as numpy: B=3 graphs of N=40 nodes; 'ragged':
    E=300 (not a multiple of JAX's 256-edge block); 'empty': E=0; 'bf16':
    h in bfloat16; 'padded': two thirds of each graph's edges are padding,
    src = dst = 0 with w = 0, as pad_batch leaves them."""
    rng = np.random.default_rng(seed)
    B, N, D, nb = 3, 40, 24, 2
    E = {"ragged": 300, "empty": 0, "bf16": 130, "padded": 180,
         "piled": 600}[case]
    h = rng.standard_normal((B, N, D)).astype(np.float32)
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N, (B, E)).astype(np.int32)
    w = rng.standard_normal((B, E, nb)).astype(np.float32)
    if case in ("padded", "piled"):
        cut = E // 3 if case == "padded" else E // 6
        src[:, cut:] = dst[:, cut:] = 0
        w[:, cut:] = 0.0
    return h, src, dst, w, N


@pytest.mark.parametrize("case", ["ragged", "empty", "bf16", "padded"])
def test_rgcn_spmm_dense_plain_matches_jax_kernel(case):
    """K6's plain version against JAX's Pallas ``rgcn_spmm_fwd`` in
    interpret mode (and the wrapper, which takes the plain version for CPU
    tensors), 1e-5 relative."""
    h, src, dst, w, N = _k6_inputs(case)
    hj = jnp.asarray(h, jnp.bfloat16 if case == "bf16" else jnp.float32)
    want = np.asarray(jax_spmm_fwd(hj, jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w), num_nodes=N,
                                   interpret=True))
    ht = _t(h).to(torch.bfloat16 if case == "bf16" else torch.float32)
    got = rgcn_spmm_dense_plain(ht, _t(src), _t(dst), _t(w), N)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if case == "empty":
        assert not got.any() and not want.any()
    else:
        _scale_close(got.numpy(), want, 1e-5)
    assert torch.equal(rgcn_spmm_dense(ht, _t(src), _t(dst), _t(w), N), got)


@pytest.mark.parametrize("case", ["ragged", "padded", "piled"])
def test_rgcn_message_agg_and_grads_match_jax(case):
    """The dense ``rgcn_message_agg`` (K6 + matmul forward, K1b backward over
    the flattened batch) against JAX's custom-vjp op: the output and the
    gradients of <agg, G> in h, basis and w, 1e-4 relative.  'piled': 500
    padded edges (src = dst = 0, w = 0) on each graph's node 0, which get
    their nonzero dw and add nothing to dh."""
    h, src, dst, w, N = _k6_inputs(case, seed=1)
    rng = np.random.default_rng(2)
    basis = (rng.standard_normal((2, h.shape[2], 16))
             / np.sqrt(h.shape[2])).astype(np.float32)
    G = rng.standard_normal(h.shape[:2] + (16,)).astype(np.float32)

    def jf(h_, b_, w_):
        out = jax_message_agg(h_, b_, jnp.asarray(src), jnp.asarray(dst), w_,
                              N, True)
        return jnp.sum(out * G), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(h), jnp.asarray(basis), jnp.asarray(w))
    ht, bt, wt = (_t(a).requires_grad_() for a in (h, basis, w))
    out = rgcn_message_agg(ht, bt, _t(src), _t(dst), wt, N)
    grads = torch.autograd.grad((out * _t(G)).sum(), [ht, bt, wt])
    _scale_close(out.detach().numpy(), jout, 1e-4)
    for got, want in zip(grads, jgrads):
        _scale_close(got.numpy(), want, 1e-4)
    if case == "piled":
        cut = src.shape[1] // 6
        assert (grads[2][:, cut:].abs().sum(-1) > 0).all()
        ht2 = _t(h).requires_grad_()
        out2 = rgcn_message_agg(ht2, _t(basis), _t(src[:, :cut]),
                                _t(dst[:, :cut]), _t(w[:, :cut]), N)
        (dh2,) = torch.autograd.grad((out2 * _t(G)).sum(), [ht2])
        _scale_close(grads[0].numpy(), dh2.numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_csr_walk_matches_jax_kernel_at_a_hub_row(dtype):
    """The CSR K6 walks (``dense_edge_csr``, key b*N + dst over the
    flattened batch): row o's run holds exactly the live edges with that
    key, in edge order, and the runs of consecutive rows follow each other
    across graphs; the dead edges (w = 0, pad_batch's src = dst = 0) sit
    after ``rowptr[B*N]``, in edge order.  Summing each run in that order,
    edge by edge in float32 as the kernel does, gives JAX's interpret-mode
    ``rgcn_spmm_fwd`` and the plain version, 1e-5 relative, with graph 1's
    node 3 a hub of 45 or more in-edges (more than one 32-slot step of
    the walk)."""
    h, src, dst, w, N = _k6_inputs("padded", seed=3)
    B, E = src.shape
    dst[1, :45] = 3                                     # the hub
    w[1, :45] = np.random.default_rng(4).standard_normal((45, 2))
    live = (w != 0).any(-1)
    csr = dense_edge_csr(_t(dst), _t(live), N)
    perm, rowptr = csr.perm.numpy(), csr.rowptr.numpy()
    assert perm.dtype == np.int32 and rowptr.shape == (B * N + 1,)
    key = np.where(live, dst + N * np.arange(B)[:, None], B * N).reshape(-1)
    np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(
        rowptr, np.concatenate([[0], np.cumsum(np.bincount(
            key[key < B * N], minlength=B * N))]))
    np.testing.assert_array_equal(perm[rowptr[-1]:],
                                  np.flatnonzero(~live.reshape(-1)))
    hub = rowptr[N + 4] - rowptr[N + 3]
    assert hub >= 45 and np.diff(rowptr).max() == hub

    hj = jnp.asarray(h, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    hw = np.asarray(hj.astype(jnp.float32)).reshape(B * N, -1)
    srcf, wf = src.reshape(-1), w.reshape(B * E, -1)
    walk = np.zeros((B * N, wf.shape[1], hw.shape[1]), np.float32)
    for o in range(B * N):
        for e in perm[rowptr[o]:rowptr[o + 1]]:
            walk[o] += wf[e][:, None] * hw[(e // E) * N + srcf[e]][None, :]
    walk = walk.reshape(B, N, -1)
    want = np.asarray(jax_spmm_fwd(hj, jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w), num_nodes=N,
                                   interpret=True))
    _scale_close(walk, want, 1e-5)
    ht = _t(h).to(getattr(torch, dtype))
    _scale_close(rgcn_spmm_dense_plain(ht, _t(src), _t(dst), _t(w),
                                       N).numpy(), walk, 1e-5)


# ---------------------------------------------------------------------------
# the dense encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,policy,use_pallas", [
    (DIMS, "f32", False), (DIMS, "f32", True), (FULL, "f32", False),
    (DIMS, "bf16", True)])
def test_encode_matches_jax(dims, policy, use_pallas):
    """Eval-mode dense ``encode`` against JAX's ``encode`` on its XLA path
    and on its Pallas path (``rgcn_spmm`` in interpret mode): float32
    within 1e-5 of the largest |z|; the bf16 policy against the Pallas
    path (the port's precision profile: bf16 gather, f32 after it) within
    3e-2."""
    compute = "float32" if policy == "f32" else "bfloat16"
    jrc = JRGCNConfig(dims=dims, use_pallas=use_pallas,
                      policy=JPolicy(compute_dtype=compute))
    rc = RGCNConfig(dims=dims, policy=Policy(compute_dtype=compute))
    jp = jax_init_rgcn(jax.random.PRNGKey(3), jrc)
    batch, mw = pad_batch(GRAPHS[:3])
    want = jax_encode(jp, jrc, _jb(batch), mw)
    with torch.inference_mode():
        got = encode(_encoder(jp, rc), rc, _tb(batch), mw)
    assert got.shape == (3, dims[-1]) and got.dtype == torch.float32
    _scale_close(got.numpy(), want, 1e-5 if policy == "f32" else 3e-2)


@pytest.mark.parametrize("dims", [DIMS, FULL], ids=["narrow", "full"])
def test_encode_bf16_messages_match_jax_xla_path(dims):
    """``message_dtype="bfloat16"`` through K6 against JAX's dense XLA
    path: within 5e-3 of the largest |z| (JAX also rounds the products and
    sums to bf16, the port only the gather), and not the port's
    float32-message embeddings."""
    jrc = JRGCNConfig(dims=dims, message_dtype="bfloat16")
    rc = RGCNConfig(dims=dims, message_dtype="bfloat16")
    jp = jax_init_rgcn(jax.random.PRNGKey(3), jrc)
    batch, mw = pad_batch(GRAPHS[:3])
    want = np.asarray(jax.jit(lambda p, b: jax_encode(p, jrc, b, mw))(
        jp, _jb(batch)))
    enc = _encoder(jp, rc)
    with torch.inference_mode():
        got = encode(enc, rc, _tb(batch), mw).numpy()
        f32 = encode(enc, RGCNConfig(dims=dims), _tb(batch), mw).numpy()
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    assert np.abs(got - f32).max() > 0


def test_encode_invariant_to_padding(jparams):
    """A larger pad (more node and edge slots, a warp slot more) leaves the
    embeddings as they are, within 1e-5; JAX's test_padding_invariance
    holds its own to 1e-4."""
    b1, w1 = pad_batch(GRAPHS[:3])
    b2, w2 = pad_batch(GRAPHS[:3], b1["token"].shape[1] + 64,
                       b1["edge_src"].shape[1] + 128, w1 + 1)
    enc = _encoder(jparams)
    with torch.inference_mode():
        z1 = encode(enc, RC, _tb(b1), w1)
        z2 = encode(enc, RC, _tb(b2), w2)
    _scale_close(z2.numpy(), z1.numpy(), 1e-5)


ABLATIONS = [dict(use_vstats=False), dict(relations_used=(0,)),
             dict(relations_used=(0, 2)),
             dict(use_vstats=False, relations_used=(1, 3))]


@pytest.mark.parametrize("ablation", ABLATIONS,
                         ids=["no_vstats", "cf_only", "cf_dst",
                              "no_vstats_src_mem"])
def test_ablation_switches_match_jax(jparams, ablation):
    """``use_vstats`` and ``relations_used`` on the dense and the packed
    encoders against JAX's (its packed path re-derives the normalizer from
    the filtered mask and ignores the hoisted one), 1e-5; both differ from
    the default config's embeddings."""
    jrc = dataclasses.replace(JRC, **ablation)
    rc = dataclasses.replace(RC, **ablation)
    enc = _encoder(jparams, rc)
    dense, mw = pad_batch(GRAPHS[:3])
    packed, _ = pack_graphs(GRAPHS[:3])
    with torch.inference_mode():
        zd = encode(enc, rc, _tb(dense), mw)
        zp = encode_packed(enc, rc, _tb(packed))
        z0 = encode(enc, RC, _tb(dense), mw)
    _scale_close(zd.numpy(), jax_encode(jparams, jrc, _jb(dense), mw), 1e-5)
    _scale_close(zp.numpy(), jax_encode_packed(jparams, jrc, _jb(packed)),
                 1e-5)
    assert float((zd - z0).abs().max()) > 1e-3


@pytest.mark.parametrize("ablation", [{}] + ABLATIONS)
def test_ablation_config_hash_matches_jax(ablation):
    """The ``gcl`` method's artifact config hashes to JAX's for the same
    options, so each package replays the other's store."""
    port = GCLMethod(GCLSamplerConfig(rgcn=RGCNConfig(**ablation)),
                     device="cpu")
    jax_m = JGCLMethod(JSamplerConfig(rgcn=JRGCNConfig(**ablation)))
    assert config_hash(port.config()) == jax_config_hash(jax_m.config())


@pytest.mark.parametrize("opt", [{"grad_compress": True},
                                 {"opt_dtype": "bfloat16"}, {"seed": 5}],
                         ids=["grad_compress", "bf16_moments", "seed"])
def test_optimizer_options_config_hash_matches_jax(opt):
    """JAX's optimizer options on the fit hash to JAX's key: the port's fit
    honours them as JAX's does (``_JAX_ONLY`` no longer pins them)."""
    import dataclasses as dc

    from repro_torch.core.train import GCLTrainConfig

    port = GCLMethod(GCLSamplerConfig(train=GCLTrainConfig(
        opt=dc.replace(GCLTrainConfig().opt, **opt))), device="cpu")
    jax_m = JGCLMethod(JSamplerConfig(train=JGCLTrainConfig(
        opt=dc.replace(JGCLTrainConfig().opt, **opt))))
    assert config_hash(port.config()) == jax_config_hash(jax_m.config())


@pytest.mark.parametrize("field,value", [
    ("message_dtype", "bfloat16"), ("prefetch", False),
    ("prefetch_depth", 2), ("eval_fold", 7)])
def test_staging_and_message_options_config_hash_matches_jax(field, value):
    """The four options the port now honours hash to JAX's key at their
    non-default values, and the default config still does."""
    from repro_torch.core.train import GCLTrainConfig
    from repro_torch.sampling.methods import _JAX_ONLY

    if field == "message_dtype":
        port = GCLSamplerConfig(rgcn=RGCNConfig(message_dtype=value))
        jax_c = JSamplerConfig(rgcn=JRGCNConfig(message_dtype=value))
    else:
        port = GCLSamplerConfig(train=GCLTrainConfig(**{field: value}))
        jax_c = JSamplerConfig(train=JGCLTrainConfig(**{field: value}))
    got = config_hash(GCLMethod(port, device="cpu").config())
    assert got == jax_config_hash(JGCLMethod(jax_c).config())
    assert got != config_hash(GCLMethod(device="cpu").config())
    assert config_hash(GCLMethod(device="cpu").config()) == \
        jax_config_hash(JGCLMethod().config())
    assert {k for f in _JAX_ONLY.values() for k in f} == {
        "use_pallas", "param_dtype", "engine", "microbatch"}


# ---------------------------------------------------------------------------
# augmentation, the dense loss and its gradients
# ---------------------------------------------------------------------------

def _jax_dense_view(rv, rp, batch, jrc):
    """One dense view's draws from JAX's keys (``augment_view``: split 3;
    ``encode``: split len(dims), dropout then feature noise; ``project``:
    ``rp``), as the port's ViewDraws."""
    B, N = batch["node_mask"].shape
    E = batch["edge_mask"].shape[1]
    r_combo, r_node, r_edge = jax.random.split(rv, 3)
    combo = jax.random.randint(r_combo, (B,), 0, 6)
    node_keep = jax.random.bernoulli(r_node, 1 - 0.15, (B, N))
    edge_keep = jax.random.bernoulli(r_edge, 1 - 0.15, (B, E))
    rngs = jax.random.split(rv, len(jrc.dims))
    noise = jax.random.normal(rngs[-1], (B, N, jrc.dims[0]),
                              jrc.policy.compute)
    dropout = tuple(
        _t(jax.random.bernoulli(rngs[i], 1 - jrc.dropout,
                                (B, N, jrc.dims[i + 1])))
        for i in range(len(jrc.dims) - 2))
    proj_keep = jax.random.bernoulli(rp, 1 - jrc.dropout,
                                     (B, jrc.proj_hidden))
    return ViewDraws(_t(combo).long(), _t(node_keep), _t(edge_keep),
                     EncodeDraws(noise=_t(noise), dropout=dropout),
                     _t(proj_keep))


def test_augment_view_matches_jax():
    """The dense view from JAX's draws: node and edge masks and the noise
    gate equal to JAX's ``augment_view``, element for element."""
    batch, _ = pad_batch(GRAPHS)
    for i in range(4):
        rv = jax.random.PRNGKey(200 + i)
        want, wnoise = jax_augment_view(rv, _jb(batch))
        vd = _jax_dense_view(rv, rv, batch, JRC)
        got, gnoise = augment_view(_tb(batch), vd.combo, vd.node_keep,
                                   vd.edge_keep)
        for k in ("node_mask", "edge_mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(gnoise.numpy(), np.asarray(wnoise))


def test_dense_loss_and_grads_match_jax(jparams):
    """``dense_loss`` on JAX's rebuilt key tree (``_loss``: r1, r2, rp1,
    rp2 = split(rng, 4); r1 feeds ``augment_view`` and ``encode``): the
    loss and metrics within 1e-5 and every parameter's gradient within
    1e-4 of ``jax.value_and_grad``."""
    batch, mw = pad_batch(GRAPHS)
    rng = jax.random.PRNGKey(31)
    trainer = JTrainer(JRC, JGCLTrainConfig())
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: trainer._loss(p, _jb(batch), mw, rng),
        has_aux=True)(jparams)
    r1, r2, rp1, rp2 = jax.random.split(rng, 4)
    draws = (_jax_dense_view(r1, rp1, batch, JRC),
             _jax_dense_view(r2, rp2, batch, JRC))
    enc = _encoder(jparams)
    loss, m = dense_loss(enc, RC, TAU, _tb(batch), mw, draws)
    _scale_close(loss.item(), float(jloss), 1e-5)
    for k in ("nce_acc", "pos_sim", "neg_sim"):
        _scale_close(m[k].item(), float(jm[k]), 1e-5)
    params = dict(enc.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    got = {k.replace(".", "/"): g.numpy() for k, g in zip(params, grads)}
    want = flatten_tree(jgrads)
    assert set(got) == set(want)
    for k in want:
        _scale_close(got[k], want[k], 1e-4)


def test_draw_step_shapes_dense_draws():
    """``draw_step`` on a dense batch gives dense-shaped draws (one strategy
    and noise gate per graph, (B, N) / (B, E) masks, (B, N, d) noise and
    dropout), and ``dense_loss`` on them is finite with a finite gradient;
    the same seed gives the same draws."""
    batch, mw = pad_batch(GRAPHS[:4])
    tb = _tb(batch)
    B, N = batch["node_mask"].shape
    E = batch["edge_mask"].shape[1]
    draws = draw_step(torch.Generator().manual_seed(draw_seed(0, 3)), tb, RC)
    again = draw_step(torch.Generator().manual_seed(draw_seed(0, 3)), tb, RC)
    for vd, va in zip(draws, again):
        assert vd.combo.shape == (B,) and vd.node_keep.shape == (B, N)
        assert vd.edge_keep.shape == (B, E)
        assert vd.enc.noise.shape == (B, N, DIMS[0])
        assert [k.shape for k in vd.enc.dropout] == [(B, N, d)
                                                     for d in DIMS[1:-1]]
        assert vd.proj_keep.shape == (B, RC.proj_hidden)
        assert torch.equal(vd.node_keep, va.node_keep)
        assert torch.equal(vd.enc.noise, va.enc.noise)
    enc = _encoder(jax_init_rgcn(jax.random.PRNGKey(0), JRC))
    loss, _ = dense_loss(enc, RC, TAU, tb, mw, draws)
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# embed_dense
# ---------------------------------------------------------------------------

def test_prepad_matches_jax():
    """``prepad`` is ``pad_batch`` (a verbatim copy) with the optional pad
    shapes: the arrays equal JAX's."""
    got, gw = ContrastiveTrainer.prepad(GRAPHS, (200, 400, 3))
    want, ww = JTrainer.prepad(GRAPHS, (200, 400, 3))
    assert gw == ww == 3 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_embed_dense_matches_jax_and_packed(jparams):
    """``embed_dense`` in batches of 2 against JAX's ``embed_dense`` (1e-5)
    and against the port's packed ``embed`` (1e-4); ``pad_shapes`` pads
    further and changes nothing."""
    graphs = GRAPHS + _graphs(2, cap_instr=24, seed=3)
    jt = JTrainer(JRC, JGCLTrainConfig())
    want = jt.embed_dense(jparams, graphs, batch_size=2)
    trainer = ContrastiveTrainer(RC, device="cpu")
    enc = _encoder(jparams)
    got = trainer.embed_dense(enc, graphs, batch_size=2)
    assert got.shape == (len(graphs), DIMS[-1]) and got.dtype == np.float32
    _scale_close(got, want, 1e-5)
    _scale_close(got, trainer.embed(enc, graphs), 1e-4)
    n, e = (max(g.n_nodes for g in graphs) + 10,
            max(g.n_edges for g in graphs) + 30)
    _scale_close(trainer.embed_dense(enc, graphs, batch_size=4,
                                     pad_shapes=(n, e, None)), got, 1e-5)
