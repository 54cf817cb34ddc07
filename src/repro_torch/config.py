"""Copy of ``repro/config.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).  ``TrainConfig``
is the one training config of the port (the LM launcher's and, as
``GCLTrainConfig.opt``, the contrastive fit's); ``MeshConfig`` gives
the shape of ``launch/train.py``'s ``--mesh pod|multipod`` (a mesh of a
``torch.distributed`` group's ranks, ``launch/mesh.py``).

Config system: model / shape / train / mesh configs.

Every assigned architecture is a `ModelConfig` registered under its public id
(``--arch <id>``).  Shapes are the four LM-family cells assigned to this paper.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Trace-window caps: the single source of truth for the graph subject's
# bounded per-warp window (paper §3.1).  Every trace call site —
# ``KernelInvocation.trace``, ``core.graphs.iter_kernel_graphs``, the
# ingestion engine and the graph cache key — resolves omitted caps here, so
# two paths can never silently trace the same kernel at different windows
# (they used to: trace() defaulted to 256 instructions while
# iter_kernel_graphs defaulted to 96).
# ---------------------------------------------------------------------------

DEFAULT_CAP_WARPS = 2
DEFAULT_CAP_INSTR = 96


def resolve_trace_caps(cap_warps=None, cap_instr=None, program=None):
    """Resolve (cap_warps, cap_instr): explicit argument > the program's own
    ``trace_caps`` (model-zoo programs carry 10-100x larger windows) > the
    repo-wide defaults above."""
    prog_caps = getattr(program, "trace_caps", None) or (None, None)
    cw = cap_warps if cap_warps is not None else prog_caps[0]
    ci = cap_instr if cap_instr is not None else prog_caps[1]
    return (int(cw) if cw is not None else DEFAULT_CAP_WARPS,
            int(ci) if ci is not None else DEFAULT_CAP_INSTR)


# ---------------------------------------------------------------------------
# Layer-position specs: each layer has a token mixer and an FFN kind.
# ---------------------------------------------------------------------------

MIXER_ATTN = "attention"
MIXER_MAMBA2 = "mamba2"

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # MIXER_ATTN | MIXER_MAMBA2
    ffn: str    # FFN_DENSE | FFN_MOE | FFN_NONE


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int           # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid layout (period structure).  block_size layers form one scanned
    # block; attn_positions/moe_positions index *within* the block.
    block_size: int = 1
    attn_positions: Sequence[int] = ()   # positions with attention mixer
    moe_positions: Sequence[int] = ()    # positions whose FFN is MoE

    # misc
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    frontend: Optional[str] = None       # 'audio' | 'vision'
    frontend_tokens: int = 0             # prepended embedding tokens (vlm)

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"           # 'full' | 'dots' (save matmul outputs)
    scan_layers: bool = True
    attn_chunk: int = 1024               # query-chunk size for chunked attention
    attn_chunk_threshold: int = 8192     # use chunked attention for seq >= this
    loss_chunk: int = 256                # seq-chunk size for chunked cross-entropy
    moe_seq_chunk: int = 1024            # routing-group size (bounds dispatch buffers)
    decode_split: int = 0                # >0: flash-decoding split-softmax over
                                         # this many seq chunks (shard-local
                                         # partials + tiny LSE merge instead of
                                         # all-gathering the KV cache)
    attn_impl: str = "xla"               # 'xla' | 'pallas' | 'pallas_interpret'

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.attn_positions and self.num_heads > 0:
            # default: attention at every position of the block
            object.__setattr__(
                self, "attn_positions", tuple(range(self.block_size))
            )
        if not self.moe_positions and self.num_experts > 0:
            object.__setattr__(
                self, "moe_positions", tuple(range(self.block_size))
            )
        if self.num_layers % self.block_size != 0:
            raise ValueError(
                f"{self.arch_id}: num_layers {self.num_layers} not divisible "
                f"by block_size {self.block_size}"
            )

    # -- derived -----------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.num_layers // self.block_size

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def layer_specs(self) -> list[LayerSpec]:
        """The LayerSpec for each position within one block."""
        specs = []
        for p in range(self.block_size):
            if p in tuple(self.attn_positions):
                mixer = MIXER_ATTN
            else:
                mixer = MIXER_MAMBA2
            if self.d_ff == 0:
                ffn = FFN_NONE
            elif p in tuple(self.moe_positions):
                ffn = FFN_MOE
            else:
                ffn = FFN_DENSE
            specs.append(LayerSpec(mixer=mixer, ffn=ffn))
        return specs

    def is_subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM/hybrid)."""
        specs = self.layer_specs()
        n_attn = sum(1 for s in specs if s.mixer == MIXER_ATTN)
        return n_attn < len(specs)  # any mamba layer -> sub-quadratic prefill

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (assigned LM-family set)
# ---------------------------------------------------------------------------

KIND_TRAIN = "train"
KIND_PREFILL = "prefill"
KIND_DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, KIND_TRAIN),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, KIND_PREFILL),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, KIND_DECODE),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, KIND_DECODE),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; long_500k needs sub-quadratic attn."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Train / mesh configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 7e-4          # paper: AdamW lr 7e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"             # paper: cosine annealing
    grad_clip: float = 1.0
    loss_scale: float = 1.0              # static scale on low-precision grads
                                         # (unscaled inside adamw_update)
    opt_dtype: str = "float32"           # bf16 moments for very large archs
    grad_compress: bool = False          # error-feedback int8 DP compression
    microbatch: int = 0                  # 0 = no gradient accumulation
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)


# ---------------------------------------------------------------------------
# Analytical parameter / FLOP accounting (used by roofline + sim substrate)
# ---------------------------------------------------------------------------


def param_counts(cfg: ModelConfig) -> dict[str, int]:
    """Total and active (per-token) parameter counts, matmul weights only."""
    D, F = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    total = 0
    active = 0
    for spec in cfg.layer_specs():
        if spec.mixer == MIXER_ATTN:
            p = D * H * hd + 2 * D * K * hd + H * hd * D
            if cfg.qkv_bias:
                p += H * hd + 2 * K * hd
            total += p
            active += p
        else:  # mamba2
            din, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            p = D * (2 * din + 2 * ds + nh)  # in_proj -> [z, x, B, C, dt]
            p += (din + 2 * ds) * cfg.ssm_conv  # depthwise conv
            p += din * D  # out_proj
            p += 2 * nh  # A_log, D skip
            total += p
            active += p
        if spec.ffn == FFN_DENSE:
            p = 3 * D * F
            total += p
            active += p
        elif spec.ffn == FFN_MOE:
            total += cfg.num_experts * 3 * D * F + D * cfg.num_experts
            active += cfg.top_k * 3 * D * F + D * cfg.num_experts
    total *= cfg.num_blocks
    active *= cfg.num_blocks
    embed = cfg.vocab_size * D
    total += embed if cfg.tie_embeddings else 2 * embed
    active += embed if cfg.tie_embeddings else 2 * embed
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6*N_active*D_tokens (train), 2*N_active (fwd)."""
    counts = param_counts(cfg)
    n_active = counts["active"]
    if shape.kind == KIND_TRAIN:
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == KIND_PREFILL:
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
