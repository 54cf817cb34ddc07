"""LM serving launcher: batched prefill, then greedy decode with the KV /
SSM caches (counterpart of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch mamba2-780m --smoke --device cpu
    python -m repro_torch.launch.serve --arch llama3.2-3b --prompt-len 2048

Each of ``--requests`` batches draws ``--batch`` prompts from the same
``np.random.default_rng(seed)`` stream as the JAX launcher, prefills them
(attention through K7, SSD through K8 on the card), splices the prefill
caches into decode caches of ``prompt + tokens`` positions, and decodes
``--tokens`` tokens greedily.  Weights are random, drawn from ``--seed`` by
a ``torch.Generator`` on the device, each leaf cast to the compute dtype
as it is drawn (``init_compute_params``: the float32 tree is never held).
The decode loop keeps the tokens on the device and synchronizes only where
the timings are read.  It runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_arch
from repro_torch.models import transformer as tf
from repro_torch.models.frontends import text_len
from repro_torch.utils.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, out: list | None = None) -> int:
    """Serve the batches and print one line per batch.  ``out``, when
    given, receives one dict per batch: prefill / decode seconds, tok/s,
    the sampled tokens, whether every logit was finite, the peak device
    memory (CUDA; the prefill's alone as ``prefill_peak_bytes``, less what
    was allocated before the weights were drawn) and the last decode
    logits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=2,
                    help="number of batches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if cuda else None
    cfg = smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_compute_params(cfg, gen, device=dev)
    max_seq = args.prompt_len + args.tokens + cfg.frontend_tokens
    rng = np.random.default_rng(args.seed)
    tl = text_len(cfg, args.prompt_len + cfg.frontend_tokens)

    for req in range(args.requests):
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (args.batch, tl))
            .astype(np.int32)).to(dev)
        fe = None
        if cfg.frontend == "vision":
            fe = rng.standard_normal(
                (args.batch, cfg.frontend_tokens, cfg.d_model))
        elif cfg.frontend == "audio":
            fe = rng.standard_normal((args.batch, tl, cfg.d_model))
        if fe is not None:
            fe = torch.from_numpy(fe.astype(np.float32)).to(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches, idx = tf.prefill(cfg, params, prompts, fe)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_peak = (torch.cuda.max_memory_allocated(dev) - base if cuda
                        else None)
        finite = torch.isfinite(logits).all()

        state = tf.init_decode_state(cfg, args.batch, max_seq, prefilled=idx,
                                     device=dev)
        state = _splice_prefill(cfg, state, caches, idx)
        del caches
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, state = tf.decode_step(cfg, params, state, tok)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)[:, None]
            out_tokens.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        del state                   # the caches go before the next prefill
        seq = torch.cat(out_tokens, dim=1).cpu()
        tok_s = args.tokens * args.batch / max(t_decode, 1e-9)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        mem = f"; peak {peak / 2**30:.2f} GiB" if peak is not None else ""
        print(f"[serve] batch {req}: prefill {tl} toks x{args.batch} in "
              f"{t_prefill * 1e3:.0f}ms; decode {args.tokens} toks in "
              f"{t_decode * 1e3:.0f}ms ({tok_s:.1f} tok/s){mem}; "
              f"sample: {seq[0, :8].tolist()}", flush=True)
        if out is not None:
            out.append(dict(batch=req, prefill_s=t_prefill, decode_s=t_decode,
                            tok_s=tok_s, tokens=seq.numpy(),
                            finite=bool(finite), peak_bytes=peak,
                            prefill_peak_bytes=prefill_peak, logits=logits))
    return 0


def _splice_prefill(cfg, state: dict, caches: dict, prefilled: int) -> dict:
    """Write the prefill KV (length P) into the max_seq decode caches, in
    place; SSM and conv states transfer directly."""

    def splice(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                splice(dst[k], src[k])
        elif dst.shape == src.shape:          # ssm / conv states
            dst.copy_(src)
        else:                                 # KV: (nb,B,S_max,K,hd)
            dst[:, :, :src.shape[2]] = src.to(dst.dtype)

    splice(state["caches"], caches)
    return {"caches": state["caches"], "index": int(prefilled)}


if __name__ == "__main__":
    raise SystemExit(main())
