"""Training launcher (the port of ``repro.launch.train``), on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --smoke --steps 50 --batch 4 --seq 64 --device cpu

``--smoke`` selects the reduced same-family config (CPU-runnable); without
it the published config trains on the card.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch import configs
from repro_torch.training import TrainConfig, Trainer


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (``sys.argv`` when None), train and print the final
    loss; returns ``Trainer.run``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (required on CPU hosts)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    tc = TrainConfig(steps=args.steps, seq_len=args.seq,
                     global_batch=args.batch, peak_lr=args.lr,
                     ckpt_dir=args.ckpt_dir, compress_grads=args.compress)
    out = Trainer(cfg, tc, device=args.device).run()
    h = out["history"]
    print(f"final loss {h[-1]['loss']:.4f} after {out['final_step']} steps; "
          f"stragglers={out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()
