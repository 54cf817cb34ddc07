"""Modality frontends for the audio / vision archs — stubs, as in the JAX
package (counterpart of ``repro/models/frontends.py``).

- audio (musicgen): precomputed frame-conditioning embeddings (B, S, D),
  added to the token embeddings.
- vision (paligemma): precomputed patch embeddings (B, frontend_tokens, D),
  prepended prefix-LM style.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig


def apply_frontend(cfg: ModelConfig, h_tokens: torch.Tensor, frontend
                   ) -> torch.Tensor:
    if cfg.frontend is None or frontend is None:
        return h_tokens
    frontend = frontend.to(h_tokens.dtype)
    if cfg.frontend == "audio":
        return h_tokens + frontend
    if cfg.frontend == "vision":
        return torch.cat([frontend, h_tokens], dim=1)
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


def text_len(cfg: ModelConfig, total_seq: int) -> int:
    """Text-token portion of a total sequence length."""
    if cfg.frontend == "vision":
        return total_seq - cfg.frontend_tokens
    return total_seq
