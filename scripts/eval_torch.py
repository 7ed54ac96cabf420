"""Checkpoint sweep with the PyTorch port, the flags of ``scripts/eval.py``.

Checkpoints (``checkpoint_%06d.pth.tar``) come from DATASET.OUTPUT_PATH as
the config gives it *before* the inference overrides; the sweep's log goes
to INFERENCE.OUTPUT_PATH.  The model is built once and each checkpoint
restored into it.

Usage:
  python scripts/eval_torch.py --config-base ... --config-file ... \
      [--start 51000 | --checkpoint PATH] [--out sweep.json] \
      [--device cuda|cpu] [--opts ...]

``--checkpoint`` scores that one file (``checkpoint_swa.pth.tar``,
``checkpoint_best.pth.tar``) instead of the numbered sweep; its record's
``iter`` is the iteration saved in it.

``--name bbbc`` (or DATASET.DATA_TYPE ``BBBC`` / ``synthetic_bbbc``) scores
``test_bbbc`` over the test split, otherwise ``eval_cvppp`` over the val
split.  ``main(argv)`` runs in-process and returns the records
``[{"iter", **metrics}, ...]``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from pctrans_torch.config import load_cfg, update_inference_cfg  # noqa: E402
from pctrans_torch.engine import checkpoint as ckpt  # noqa: E402
from pctrans_torch.engine.trainer import Trainer  # noqa: E402


def get_args(argv=None):
    p = argparse.ArgumentParser(description="sweep checkpoints (PyTorch)")
    p.add_argument("--config-base", type=str, default=None)
    p.add_argument("--config-file", type=str, default=None)
    p.add_argument("--name", type=str, default="cvppp")
    p.add_argument("--start", type=int, default=51000,
                   help="first checkpoint iteration to evaluate")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="score this checkpoint file instead of the sweep")
    p.add_argument("--out", type=str, default=None,
                   help="write the sweep as a JSON list of {iter, **metrics}")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    cfg = load_cfg(args.config_base, args.config_file, args.opts, freeze=False)
    model_dir = cfg.DATASET.OUTPUT_PATH
    cfg = update_inference_cfg(cfg)
    cfg.freeze()

    trainer = Trainer(cfg, mode="test", device=args.device)
    sweep = [args.checkpoint] if args.checkpoint else [
        c for c in ckpt.list_checkpoints(model_dir)
        if ckpt.checkpoint_iteration(c) >= args.start]
    if not sweep:
        print(f"No checkpoints >= iter {args.start} in {model_dir}")
        return []
    records = []
    for path in sweep:
        iteration = ckpt.restore_checkpoint(path, trainer.model)
        name = os.path.basename(path)
        if args.name == "bbbc" or cfg.DATASET.DATA_TYPE in ("BBBC", "synthetic_bbbc"):
            res = trainer.test_bbbc(model_name=name)
        else:
            res = trainer.eval_cvppp(model_name=name)
        print(name, res)
        records.append({"iter": iteration,
                        **{k: float(v) for k, v in res.items()}})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out} ({len(records)} records)")
    return records


if __name__ == "__main__":
    main()
