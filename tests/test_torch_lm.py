"""The LM zoo's serving path of the PyTorch port against the JAX package, on
the CPU: layers, K7's and K8's plain versions, the attention and SSM
mixers, prefill and decode for every arch of the zoo (the MoE FFN's own
tests are in ``test_torch_moe.py``), the param interop, the serve CLI, and
the committed fixture ``reference_lm.npz``.

The JAX side runs its own functions (Pallas kernels in interpret mode where
a test is about a kernel); the port runs on CPU tensors, so every kernel
wrapper takes its plain version.  Inputs come from numpy seeds; the model
tests carry JAX ``init_params`` weights into the port through
``lm_params_from_jax`` (the constant leaves — norm scales, biases,
``dt_bias``, ``D_skip`` — perturbed so that a misplaced one shows).

Tolerances: float32 1e-5 of the largest magnitude (the two packages sum in
other orders); the layers 1e-6; K7 in bfloat16 2e-2 and the sequential SSD
recurrence 1e-3, as the JAX package's own kernel tests.

Regenerate the fixture (JAX on the CPU, about a minute)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py --write
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_arch as j_smoke_arch
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk as j_ssd_intra
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as j_ssd_seq
from repro.launch.serve import _splice_prefill as j_splice
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models.frontends import apply_frontend as j_apply_frontend
from repro.sampling.store import flatten_tree, unflatten_tree
from repro_torch.configs import smoke_arch
from repro_torch.interop import (
    _flatten, lm_params_from_jax, lm_params_to_numpy,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_plain,
)
from repro_torch.kernels.ssd_scan.ops import (
    ssd_chunked, ssd_intra_chunk, ssd_scan, ssd_sequential_ref,
)
from repro_torch.launch.serve import _splice_prefill
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.models.frontends import apply_frontend

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FIXTURE = os.path.join(ROOT, "src", "repro_torch", "assets",
                       "reference_lm.npz")
NON_MOE = ["llama3.2-3b", "granite-3-2b", "qwen2-72b", "yi-34b",
           "mamba2-780m", "musicgen-medium", "paligemma-3b"]
MOE = ["dbrx-132b", "grok-1-314b", "jamba-v0.1-52b"]
TOL = 1e-5
#: the fixture: smoke widths at two blocks (jamba: one block of 8 layers,
#: routed in MoE groups of 512), B=2, a 1024-token prompt (two 512-row K7
#: blocks; 32 K8 chunks of 32; two MoE groups), 16 greedy tokens
FIX_ARCHS = ("llama3.2-3b", "mamba2-780m", "jamba-v0.1-52b")
FIX_B, FIX_PROMPT, FIX_TOKENS = 2, 1024, 16
#: constant-initialized leaves, perturbed before a comparison
PERTURB = ("scale", "norm", "dt_bias", "D_skip", "bq", "bk", "bv")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: several test processes on one host
    slow down by oversubscribing the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale, err / scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().cpu().numpy()


def _carried(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params): JAX init_params with
    the constant leaves perturbed, carried across as numpy."""
    jcfg = j_smoke_arch(arch).replace(**kw)
    cfg = smoke_arch(arch).replace(**kw)
    jparams, _ = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    flat = {}
    for key, arr in flatten_tree(jparams).items():
        arr = np.asarray(arr, np.float32)
        if key.rsplit("/", 1)[-1] in PERTURB:
            arr = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(
                np.float32)
        flat[key] = arr
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, cfg, jparams, lm_params_from_jax(flat, cfg)


# ---------------------------------------------------------------------------
# layers and frontends
# ---------------------------------------------------------------------------


def test_layers_match_jax():
    arch = "llama3.2-3b"
    jcfg, cfg, jp, tp = _carried(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    z = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    bp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"])
    tbp = {k: {n: v[0] for n, v in d.items()}
           for k, d in tp["blocks"]["pos0"].items()}
    eps = cfg.norm_eps
    _close(_np(t_layers.rmsnorm(tbp["norm1"], _t(x), eps)),
           j_layers.rmsnorm(bp["norm1"], jnp.asarray(x), eps), 1e-6)
    _close(_np(t_layers.rmsnorm_gated(_t(scale), _t(x), _t(z), eps)),
           j_layers.rmsnorm_gated(jnp.asarray(scale), jnp.asarray(x),
                                  jnp.asarray(z), eps), 1e-6)
    pos = np.arange(12, dtype=np.int32)[None] + 1000
    hd = cfg.head_dim
    for got, want in zip(t_layers.rope_angles(_t(pos), hd, cfg.rope_theta),
                         j_layers.rope_angles(jnp.asarray(pos), hd,
                                              cfg.rope_theta)):
        _close(_np(got), want, 1e-6)
    xh = rng.standard_normal((2, 12, 4, hd)).astype(np.float32)
    cos, sin = t_layers.rope_angles(_t(pos), hd, cfg.rope_theta)
    jcos, jsin = j_layers.rope_angles(jnp.asarray(pos), hd, cfg.rope_theta)
    _close(_np(t_layers.apply_rope(_t(xh), cos, sin)),
           j_layers.apply_rope(jnp.asarray(xh), jcos, jsin), 1e-6)
    _close(_np(t_layers.apply_rope(_t(xh), cos[0], sin[0])),
           j_layers.apply_rope(jnp.asarray(xh), jcos[0], jsin[0]), 1e-6)
    _close(_np(t_layers.mlp_forward(cfg, tbp["ffn"], _t(x))),
           j_layers.mlp_forward(jcfg, bp["ffn"], jnp.asarray(x)), 1e-6)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _close(_np(t_layers.embed_tokens(cfg, tp["embed"], _t(toks))),
           j_layers.embed_tokens(jcfg, jp["embed"], jnp.asarray(toks)), 1e-6)
    _close(_np(t_layers.lm_head_weight(cfg, tp["embed"])),
           j_layers.lm_head_weight(jcfg, jp["embed"]), 1e-6)


@pytest.mark.parametrize("arch", ["musicgen-medium", "paligemma-3b",
                                  "llama3.2-3b"])
def test_frontends_match_jax(arch):
    jcfg, cfg = j_smoke_arch(arch), smoke_arch(arch)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    n = cfg.frontend_tokens if cfg.frontend == "vision" else 10
    fe = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    _close(_np(apply_frontend(cfg, _t(h), _t(fe))),
           j_apply_frontend(jcfg, jnp.asarray(h), jnp.asarray(fe)), 0.0)


# ---------------------------------------------------------------------------
# K7 and K8: plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (B, S, K, G, hd, bq, bk) — tests/test_kernels.py's
    (2, 128, 2, 2, 64, 32, 32),
    (1, 256, 1, 4, 128, 64, 128),
    (2, 64, 4, 1, 32, 64, 64),
    (1, 128, 2, 3, 16, 32, 64),
]


@pytest.mark.parametrize("B,S,K,G,hd,bq,bk", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(B, S, K, G, hd, bq, bk, dtype):
    rng = np.random.default_rng(S + hd)
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    scale = hd ** -0.5
    got = flash_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), scale)
    assert got.dtype == tdt and flash_attention.launches == 0
    tol = TOL if dtype == "float32" else 2e-2
    kernel = flash_attention_fwd(jq, jk, jv, scale=scale, block_q=bq,
                                 block_k=bk, interpret=True)
    for want in (kernel, attention_ref(jq, jk, jv, scale)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("bad", ["hd", "S", "dtype", "shape"])
def test_flash_attention_refuses_what_jax_refuses(bad):
    shapes = {"hd": (1, 64, 1, 2, 24), "S": (1, 520, 1, 2, 16),
              "dtype": (1, 64, 1, 2, 16), "shape": (1, 64, 1, 2, 16)}
    B, S, K, G, hd = shapes[bad]
    q = torch.zeros(B, S, K, G, hd)
    k = torch.zeros(B, S, K + (bad == "shape"), hd)
    v = torch.zeros(B, S, K + (bad == "shape"), hd)
    if bad == "dtype":
        q = q.double()
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, 0.25)
    # S > 512 that is a multiple of 512 is taken (as JAX's 512-row blocks)
    ok = flash_attention_plain(torch.zeros(1, 1024, 1, 1, 16),
                               torch.zeros(1, 1024, 1, 16),
                               torch.zeros(1, 1024, 1, 16), 0.25)
    assert ok.shape == (1, 1024, 1, 1, 16)


SSD_SHAPES = [
    # (B, S, nh, hp, ds, Q) — tests/test_kernels.py's
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 32, 1, 8, 4, 32),
]


def _ssd_inputs(B, S, nh, hp, ds, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, nh, hp)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    Bc = (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    return x, dt, A, Bc, Cc


@pytest.mark.parametrize("B,S,nh,hp,ds,Q", SSD_SHAPES)
def test_ssd_scan_plain_matches_jax(B, S, nh, hp, ds, Q):
    arrs = _ssd_inputs(B, S, nh, hp, ds)
    ja = [jnp.asarray(a) for a in arrs]
    ta = [_t(a) for a in arrs]
    y, f = ssd_scan(*ta, Q)
    assert ssd_intra_chunk.launches == 0
    yk, fk = j_ssd_scan(*ja, Q, True)
    yr, fr = j_ssd_ref(*ja, Q)
    ys, fs = j_ssd_seq(*ja)
    for got, want in ((y, yk), (f, fk), (y, yr), (f, fr)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(_np(y), np.asarray(ys), atol=1e-3)
    np.testing.assert_allclose(_np(f), np.asarray(fs), atol=1e-3)
    yc, fc = ssd_chunked(*ta, Q)
    np.testing.assert_allclose(_np(yc), np.asarray(yr), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(fc), np.asarray(fr), atol=TOL, rtol=TOL)
    yq, fq = ssd_sequential_ref(*ta)
    np.testing.assert_allclose(_np(yq), np.asarray(ys), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(fq), np.asarray(fs), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,nh,hp,ds,Q", SSD_SHAPES)
def test_ssd_intra_chunk_plain_matches_jax_kernel(B, S, nh, hp, ds, Q):
    """K8's own function: (y_intra, states) from the kernel's inputs."""
    rng = np.random.default_rng(7)
    nc = S // Q
    x = rng.standard_normal((B, nc, Q, nh, hp)).astype(np.float32)
    a = -np.abs(rng.standard_normal((B, nc, nh, Q))).astype(np.float32) * 0.3
    cum = np.cumsum(a, axis=-1).astype(np.float32)
    dt = rng.random((B, nc, nh, Q)).astype(np.float32)
    Bc = rng.standard_normal((B, nc, Q, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, nc, Q, ds)).astype(np.float32)
    got = ssd_intra_chunk(*(_t(v) for v in (x, cum, dt, Bc, Cc)))
    want = j_ssd_intra(*(jnp.asarray(v) for v in (x, cum, dt, Bc, Cc)),
                       interpret=True)
    for g, w in zip(got, want):
        _close(_np(g), w)


def test_ssd_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bc, Cc = (_t(a) for a in _ssd_inputs(1, 48, 1, 8, 4))
    with pytest.raises(ValueError):              # 48 is no multiple of 32
        ssd_scan(x, dt, A, Bc, Cc, 32)
    x, dt, A, Bc, Cc = (_t(a) for a in _ssd_inputs(1, 32, 1, 128, 4))
    with pytest.raises(ValueError):              # hp > 64
        ssd_scan(x, dt, A, Bc, Cc, 32)
    x = torch.zeros(1, 1, 32, 1, 8, dtype=torch.float64)
    cum = dt = torch.zeros(1, 1, 1, 32)
    Bc = torch.zeros(1, 1, 32, 4)
    with pytest.raises(TypeError):               # K8 takes float32 only
        ssd_intra_chunk(x, cum, dt, Bc, Bc)
    with pytest.raises(ValueError):
        ssd_intra_chunk(x.float(), cum, dt[..., :16], Bc, Bc)


# ---------------------------------------------------------------------------
# mixers with carried weights
# ---------------------------------------------------------------------------


def _block0(jp, tp):
    bp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    return bp, t_tf._block(tp["blocks"], 0)


def test_attention_forward_and_decode_match_jax():
    jcfg, cfg, jp, tp = _carried("qwen2-72b")      # GQA with qkv bias
    jb, tb = _block0(jp, tp)
    jm, tm = jb["pos0"]["mixer"], tb["pos0"]["mixer"]
    rng = np.random.default_rng(3)
    B, S, S_max = 2, 24, 32
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    out, (k, v) = t_attn.attention_forward(cfg, tm, _t(h), _t(pos))
    jout, (jk, jv) = j_attn.attention_forward(jcfg, jm, jnp.asarray(h),
                                              jnp.asarray(pos))
    for g, w in ((out, jout), (k, jk), (v, jv)):
        _close(_np(g), w)

    kc = rng.standard_normal((B, S_max, cfg.num_kv_heads, cfg.head_dim))
    vc = rng.standard_normal((B, S_max, cfg.num_kv_heads, cfg.head_dim))
    kc, vc = kc.astype(np.float32), vc.astype(np.float32)
    h1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = {"k": _t(kc.copy()), "v": _t(vc.copy())}
    out, new = t_attn.decode_attention_forward(cfg, tm, _t(h1), cache, 17)
    jout, jnew = j_attn.decode_attention_forward(
        jcfg, jm, jnp.asarray(h1), {"k": jnp.asarray(kc),
                                    "v": jnp.asarray(vc)}, jnp.int32(17))
    _close(_np(out), jout)
    assert new["k"] is cache["k"]                 # written in place
    _close(_np(new["k"]), jnew["k"])
    _close(_np(new["v"]), jnew["v"])


def test_ssm_forward_and_decode_match_jax():
    jcfg, cfg, jp, tp = _carried("mamba2-780m")
    jb, tb = _block0(jp, tp)
    jm, tm = jb["pos0"]["mixer"], tb["pos0"]["mixer"]
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    out, cache = t_ssm.ssm_forward(cfg, tm, _t(h), return_cache=True)
    jout, jcache = j_ssm.ssm_forward(jcfg, jm, jnp.asarray(h),
                                     return_cache=True)
    _close(_np(out), jout)
    for key, got in flatten_tree(_tree_np(cache)).items():
        _close(got, flatten_tree(jcache)[key])
    h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out1, new = t_ssm.ssm_decode_forward(cfg, tm, _t(h1), cache)
    jout1, jnew = j_ssm.ssm_decode_forward(jcfg, jm, jnp.asarray(h1), jcache)
    _close(_np(out1), jout1)
    assert new["ssm"] is cache["ssm"]             # written in place
    for key, got in flatten_tree(_tree_np(new)).items():
        _close(got, flatten_tree(jnew)[key])
    none_out, none_cache = t_ssm.ssm_forward(cfg, tm, _t(h))
    assert none_cache is None
    _close(_np(none_out), jout)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


# ---------------------------------------------------------------------------
# the backbone: prefill and decode for every arch
# ---------------------------------------------------------------------------


def _prompts(cfg, B, S, seed):
    """(tokens, frontend) as the serve launchers draw them."""
    rng = np.random.default_rng(seed)
    text = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
    fe = None
    if cfg.frontend == "vision":
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
    elif cfg.frontend == "audio":
        fe = rng.standard_normal((B, text, cfg.d_model))
    return toks, None if fe is None else fe.astype(np.float32)


@pytest.mark.parametrize("arch", NON_MOE + MOE)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and caches, then 3 teacher-forced decode steps
    (logits), against the JAX backbone with the same weights; S = 64 gives
    mamba two SSD chunks.  Two blocks, but jamba's one block of 8 layers;
    a decode step routes each MoE layer's group of one token."""
    blocks = 1 if arch == "jamba-v0.1-52b" else 2
    jcfg, cfg, jp, tp = _carried(arch, num_layers=blocks * j_smoke_arch(
        arch).block_size)
    B, S, steps = 2, 64, 3
    toks, fe = _prompts(cfg, B, S, seed=11)
    jfe = None if fe is None else jnp.asarray(fe)
    logits, caches, idx = t_tf.prefill(cfg, tp, _t(toks),
                                       None if fe is None else _t(fe))
    jlogits, jcaches, jidx = jax.jit(
        lambda p, t, f: j_tf.prefill(jcfg, p, t, f))(jp, jnp.asarray(toks),
                                                     jfe)
    assert idx == int(jidx) == S
    _close(_np(logits), jlogits)
    jflat = flatten_tree(jcaches)
    for key, got in flatten_tree(_tree_np(caches)).items():
        _close(got, jflat[key])

    state = _splice_prefill(cfg, t_tf.init_decode_state(cfg, B, S + steps,
                                                        idx), caches, idx)
    jstate = j_splice(jcfg, j_tf.init_decode_state(jcfg, B, S + steps,
                                                   int(jidx)),
                      jcaches, int(jidx))
    jdecode = jax.jit(lambda p, s, t: j_tf.decode_step(jcfg, p, s, t))
    nxt = np.random.default_rng(12).integers(0, cfg.vocab_size, (steps, B, 1))
    for t in range(steps):
        tok = nxt[t].astype(np.int32)
        logits, state = t_tf.decode_step(cfg, tp, state, _t(tok))
        jlogits, jstate = jdecode(jp, jstate, jnp.asarray(tok))
        assert state["index"] == int(jstate["index"]) == S + t + 1
        _close(_np(logits), jlogits)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "granite-3-2b"])
def test_decode_matches_prefill(arch):
    """The port's own cache path: prefill P tokens, decode the rest
    teacher-forced, and the last logits equal the prefill of all of them
    (float32: 1e-5 of their scale, sums in other orders)."""
    cfg = smoke_arch(arch).replace(num_layers=2)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    B, P, S = 2, 32, 64           # S and P multiples of mamba's chunk 32
    toks = _t(_prompts(cfg, B, S, seed=13)[0])
    want, _, _ = t_tf.prefill(cfg, params, toks)
    _, caches, idx = t_tf.prefill(cfg, params, toks[:, :P])
    state = _splice_prefill(cfg, t_tf.init_decode_state(cfg, B, S, idx),
                            caches, idx)
    for t in range(P, S):
        logits, state = t_tf.decode_step(cfg, params, state, toks[:, t:t + 1])
    assert state["index"] == S
    _close(_np(logits), _np(want))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(param_dtype):
    with pytest.raises(KeyError):
        lm_params_from_jax({}, smoke_arch("jamba-v0.1-52b"))
    for arch in ("qwen2-72b", "mamba2-780m", "paligemma-3b",
                 "jamba-v0.1-52b"):
        jcfg = j_smoke_arch(arch).replace(param_dtype=param_dtype)
        jparams, _ = j_tf.init_params(jcfg, jax.random.PRNGKey(1))
        flat = {k: np.asarray(v) for k, v in flatten_tree(jparams).items()}
        tp = lm_params_from_jax(flat, smoke_arch(arch).replace(
            param_dtype=param_dtype))
        back = lm_params_to_numpy(tp)
        assert sorted(back) == sorted(flat)
        for key, arr in flat.items():
            assert np.array_equal(back[key], arr.astype(np.float32)), key
        bad = dict(flat)
        bad.pop("final_norm/scale")
        with pytest.raises(KeyError):
            lm_params_from_jax(bad, smoke_arch(arch))
        bad = dict(flat, **{"final_norm/scale": np.zeros(3, np.float32)})
        with pytest.raises(ValueError):
            lm_params_from_jax(bad, smoke_arch(arch))


@pytest.mark.parametrize("arch,blocks,param_dtype", [
    ("dbrx-132b", 2, "float32"), ("jamba-v0.1-52b", 1, "float32"),
    ("llama3.2-3b", 3, "bfloat16")])
def test_init_compute_params_equals_compute_params_of_init(arch, blocks,
                                                           param_dtype):
    """The serving path's draw, each leaf cast as it is drawn, is bit-equal
    to ``compute_params(cfg, init_params(cfg, gen))`` (bf16 compute): the
    same keys, dtypes and bits, the router, norms and SSM constants in
    ``param_dtype``."""
    base = smoke_arch(arch)
    cfg = base.replace(num_layers=blocks * base.block_size,
                       param_dtype=param_dtype, compute_dtype="bfloat16")
    want = t_tf.compute_params(cfg, t_tf.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu"))
    got = t_tf.init_compute_params(cfg, torch.Generator().manual_seed(3),
                                   device="cpu")
    want, got = _flatten(want), _flatten(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape[0] == cfg.num_blocks or \
            not key.startswith("blocks/"), key
        assert torch.equal(got[key], want[key]), key
        leaf = key.rsplit("/", 1)[-1]
        assert (got[key].dtype == torch.bfloat16) == (
            leaf in t_tf.COMPUTE_LEAVES or param_dtype == "bfloat16"), key


# ---------------------------------------------------------------------------
# the serve CLI, and what the port imports
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serve_cli_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-780m", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2
    for i, ln in enumerate(lines):
        assert ln.startswith(f"[serve] batch {i}: prefill 64 toks x4 in ")
        assert "decode 32 toks in" in ln and "tok/s" in ln and "sample: [" in ln
    rec: list = []
    from repro_torch.launch.serve import main
    assert main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                 "--requests", "1", "--tokens", "4"], out=rec) == 0
    assert rec[0]["finite"] and rec[0]["tokens"].shape == (4, 4)
    rec = []
    assert main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                 "--requests", "1", "--tokens", "4"], out=rec) == 0
    assert rec[0]["finite"] and rec[0]["tokens"].shape == (4, 4)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of repro_torch (the LM slice and its training
    modules included) loads no module of jax or of the JAX package, and
    chip_smoke.py names neither."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "new = ('repro_torch.launch.train', 'repro_torch.launch.steps',\n"
        "       'repro_torch.data.tokens', 'repro_torch.optim.grad_compress')\n"
        "bad += [m + ' not imported' for m in new if m not in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        smoke = f.read()
    for needle in ("import jax", "from jax", "import repro.", "from repro.",
                   "from repro import"):
        assert needle not in smoke, needle


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------


def _fixture_cfg(arch, port=True):
    base = (smoke_arch if port else j_smoke_arch)(arch)
    if base.num_experts:
        return base.replace(moe_seq_chunk=FIX_PROMPT // 2)
    return base.replace(num_layers=2 * base.block_size)


def write_fixture(path: str = FIXTURE) -> dict:
    """JAX's prefill (Pallas kernels in interpret mode, checked against the
    XLA path) and 16 greedy decode steps for each fixture arch."""
    out: dict = {}
    for n, arch in enumerate(FIX_ARCHS):
        cfg = _fixture_cfg(arch, port=False)
        params, _ = j_tf.init_params(cfg, jax.random.PRNGKey(n))
        toks = np.random.default_rng(n).integers(
            0, cfg.vocab_size, (FIX_B, FIX_PROMPT)).astype(np.int32)
        logits = {}
        for impl in ("pallas_interpret", "xla"):
            c = cfg.replace(attn_impl=impl)
            logits[impl], caches, idx = jax.jit(
                lambda p, t, c=c: j_tf.prefill(c, p, t))(params,
                                                          jnp.asarray(toks))
        ref = np.asarray(logits["pallas_interpret"])
        xla = np.asarray(logits["xla"])
        gap = np.abs(ref - xla).max() / np.abs(xla).max()
        assert gap <= TOL, (arch, gap)
        state = j_splice(cfg, j_tf.init_decode_state(
            cfg, FIX_B, FIX_PROMPT + FIX_TOKENS, int(idx)), caches, int(idx))
        decode = jax.jit(lambda p, s, t, c=cfg: j_tf.decode_step(c, p, s, t))
        tok = jnp.argmax(logits["pallas_interpret"], -1)[:, None].astype(
            jnp.int32)
        greedy, steps = [], []
        for _ in range(FIX_TOKENS):
            greedy.append(np.asarray(tok))
            lg, state = decode(params, state, tok)
            steps.append(np.asarray(lg, np.float32))
            tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        out.update({
            f"{arch}:prompts": toks,
            f"{arch}:prefill_logits": ref.astype(np.float32),
            f"{arch}:tokens": np.concatenate(greedy, axis=1),
            f"{arch}:decode_logits": np.stack(steps),
        })
        for key, arr in flatten_tree(params).items():
            out[f"{arch}:param:{key}"] = np.asarray(arr, np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def _load_fixture():
    if not os.path.exists(FIXTURE):
        pytest.fail(f"missing fixture {FIXTURE}: run this file with --write")
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("arch", FIX_ARCHS)
def test_fixture_matches_port_on_cpu(arch):
    """The port's plain path on the CPU reproduces JAX's stored prefill
    logits and, fed JAX's greedy tokens, every decode step's logits
    (1e-5); its own greedy picks equal JAX's wherever JAX's top two logits
    differ by more than 1e-3 of their scale."""
    ref = _load_fixture()
    cfg = _fixture_cfg(arch)
    pre = f"{arch}:param:"
    params = lm_params_from_jax({k[len(pre):]: v for k, v in ref.items()
                                 if k.startswith(pre)}, cfg)
    toks = _t(ref[f"{arch}:prompts"])
    logits, caches, idx = t_tf.prefill(cfg, params, toks)
    _close(_np(logits), ref[f"{arch}:prefill_logits"])
    state = _splice_prefill(cfg, t_tf.init_decode_state(
        cfg, FIX_B, FIX_PROMPT + FIX_TOKENS, idx), caches, idx)
    greedy = ref[f"{arch}:tokens"]
    for t in range(FIX_TOKENS):
        want = ref[f"{arch}:decode_logits"][t]
        prev = ref[f"{arch}:prefill_logits"] if t == 0 else \
            ref[f"{arch}:decode_logits"][t - 1]
        top2 = np.sort(prev, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(prev).max()
        mine = (_np(logits) if t == 0 else _np(lg)).argmax(-1)
        assert np.array_equal(mine[clear], greedy[clear, t]), t
        lg, state = t_tf.decode_step(cfg, params, state,
                                     _t(greedy[:, t:t + 1]))
        _close(_np(lg), want)


def decode_gap(arch, num_layers, compute_dtype, seed, package="port",
               B=4, S=2048, P=1536):
    """The decode-vs-prefill check of ``chip_smoke.py`` at smoke width on
    the CPU: prefill P tokens, decode the rest teacher-forced, and return
    max |last logits - prefill(S) logits| / max |prefill(S) logits|."""
    toks = np.random.default_rng(seed).integers(0, 512, (B, S))
    if package == "jax":
        cfg = j_smoke_arch(arch).replace(compute_dtype=compute_dtype,
                                         num_layers=num_layers)
        params, _ = j_tf.init_params(cfg, jax.random.PRNGKey(seed))
        toks = jnp.asarray(toks, jnp.int32)
        pf = jax.jit(lambda p, t: j_tf.prefill(cfg, p, t))
        want, _, _ = pf(params, toks)
        _, caches, idx = pf(params, toks[:, :P])
        state = j_splice(cfg, j_tf.init_decode_state(cfg, B, S, int(idx)),
                         caches, int(idx))
        dec = jax.jit(lambda p, s, t: j_tf.decode_step(cfg, p, s, t))
        for t in range(P, S):
            lg, state = dec(params, state, toks[:, t:t + 1])
        want, lg = np.asarray(want), np.asarray(lg)
    else:
        cfg = smoke_arch(arch).replace(compute_dtype=compute_dtype,
                                       num_layers=num_layers)
        params = t_tf.compute_params(cfg, t_tf.init_params(
            cfg, torch.Generator().manual_seed(seed), device="cpu"))
        toks = _t(toks.astype(np.int32))
        want, _, _ = t_tf.prefill(cfg, params, toks)
        _, caches, idx = t_tf.prefill(cfg, params, toks[:, :P])
        state = _splice_prefill(cfg, t_tf.init_decode_state(cfg, B, S, idx),
                                caches, idx)
        for t in range(P, S):
            lg, state = t_tf.decode_step(cfg, params, state, toks[:, t:t + 1])
        want, lg = _np(want), _np(lg)
    return float(np.abs(lg - want).max() / np.abs(want).max())


if __name__ == "__main__":
    if "--write" in sys.argv:
        data = write_fixture()
        print(f"wrote {FIXTURE}: {len(data)} arrays, "
              f"{os.path.getsize(FIXTURE)} bytes")
    if "--decode-gap" in sys.argv:
        # the measurements behind chip_smoke.py's DECODE_TOL (~15 minutes)
        for pkg, arch, layers, dtype, seed in (
                ("port", "llama3.2-3b", 28, "bfloat16", 0),
                ("port", "llama3.2-3b", 28, "bfloat16", 1),
                ("port", "mamba2-780m", 48, "bfloat16", 0),
                ("port", "mamba2-780m", 48, "bfloat16", 1),
                ("port", "mamba2-780m", 48, "float32", 0),
                ("jax", "mamba2-780m", 48, "bfloat16", 0),
                ("jax", "mamba2-780m", 48, "bfloat16", 1)):
            gap = decode_gap(arch, layers, dtype, seed, pkg)
            print(f"{pkg} {arch} {layers} layers {dtype} seed {seed}: "
                  f"decode-vs-prefill rel gap {gap:.3e}", flush=True)
