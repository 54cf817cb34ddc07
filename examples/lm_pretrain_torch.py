"""LM pretraining on the PyTorch/H100 port (twin of ``lm_pretrain.py``):
trains a reduced config of any ``--arch`` on the deterministic synthetic
stream with checkpointing + watchdog, via the port's launcher.

    PYTHONPATH=src python examples/lm_pretrain_torch.py --arch llama3.2-3b \\
        --steps 300 --batch 8 --seq-len 256
    PYTHONPATH=src python examples/lm_pretrain_torch.py --device cpu --steps 2

On the card (the default) attention layers run K7 forward and K7b
backward every step.  A second run on the same ``--checkpoint-dir``
resumes from its last checkpoint.
"""

import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_torch_lm_pretrain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train_main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq-len", str(args.seq_len),
        "--lr", "1e-3",
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "100",
        "--resume", "auto",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
