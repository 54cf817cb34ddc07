"""Batched LM serving on the PyTorch/H100 port (twin of ``serve_lm.py``):
prefill + KV/SSM-cache decode with batches of synthetic requests, at the
arch's reduced same-family (smoke) config, with 64-token prompts.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-780m
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --tokens 2

On the card (the default) mamba2-780m's SSD scan runs K8 in every layer's
prefill; attention archs run K7.
"""

import argparse
import sys

from repro_torch.launch.serve import main as serve_main

#: the prompt length: the original's 48 tokens are not a multiple of the
#: smoke mamba2-780m's SSD chunk (32), which both packages' ``ssd_scan``
#: require, so the twin prompts 64
PROMPT_LEN = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", args.arch, "--smoke",
        "--batch", str(args.batch),
        "--prompt-len", str(PROMPT_LEN),
        "--tokens", str(args.tokens),
        "--requests", "2",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
