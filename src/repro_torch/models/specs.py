"""Shape-and-dtype stand-ins for every (arch x shape) cell — the dry run's
no-allocation inputs (counterpart of ``repro/models/specs.py``): ``meta``
tensors of the shapes and dtypes JAX's ``ShapeDtypeStruct``s have."""

from __future__ import annotations

import torch

from repro_torch.config import (
    KIND_DECODE, KIND_PREFILL, KIND_TRAIN, ModelConfig, ShapeConfig,
)
from repro_torch.models.frontends import text_len
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_decode_state


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input stand-ins for a shape cell.

    train:   {'tokens','labels'[,'frontend']}
    prefill: {'tokens'[,'frontend']}
    decode:  {'tokens'} + a decode state from decode_state_specs().
    """
    B, S = shape.global_batch, shape.seq_len
    tl = text_len(cfg, S)
    i32 = torch.int32
    if shape.kind == KIND_TRAIN:
        out = {"tokens": _sd((B, tl), i32), "labels": _sd((B, S), i32)}
    elif shape.kind == KIND_PREFILL:
        out = {"tokens": _sd((B, tl), i32)}
    else:  # decode: one new token against a seq_len cache
        out = {"tokens": _sd((B, 1), i32)}
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.frontend == "vision" and shape.kind != KIND_DECODE:
        out["frontend"] = _sd((B, cfg.frontend_tokens, cfg.d_model), cdt)
    elif cfg.frontend == "audio" and shape.kind != KIND_DECODE:
        out["frontend"] = _sd((B, tl, cfg.d_model), cdt)
    return out


#: the logical axes of every field a batch may hold
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "frontend": ("batch", "seq", "embed")}


def batch_axes_tree(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes for batch_specs (JAX's in_shardings;
    ``launch/steps.batch_specs_tree`` places them on a mesh of ranks)."""
    return {k: BATCH_AXES[k] for k in batch_specs(cfg, shape)}


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode state (caches of seq_len, leaves stacked over blocks) on
    ``meta``; its ``index`` is the host int 0."""
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             prefilled=0, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Everything the step consumes (minus the train state and params)."""
    specs = {"batch": batch_specs(cfg, shape)}
    if shape.kind == KIND_DECODE:
        specs["state"] = decode_state_specs(cfg, shape)
    return specs
