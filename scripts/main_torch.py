"""Train / evaluate with the PyTorch port (``pctrans_torch``), the flags of
``scripts/main.py``.

Usage:
  python scripts/main_torch.py --config-base configs/CVPPP/CVPPP-PCTrans-Base.yaml \
      --config-file configs/CVPPP/CVPPP-PCTrans.yaml [--inference]
      [--checkpoint PATH] [--device cuda|cpu] [--opts KEY VALUE ...]

Checkpoints land in DATASET.OUTPUT_PATH as ``checkpoint_%06d.pth.tar``;
``PCTRANS_MSDA_IMPL=pallas`` selects the separable ms-deform kernel (K5).
``main(argv)`` runs in-process and returns the Trainer.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from pctrans_torch.config import load_cfg, update_inference_cfg  # noqa: E402
from pctrans_torch.engine.trainer import Trainer  # noqa: E402


def get_args(argv=None):
    p = argparse.ArgumentParser(description="PCTrans training / inference (PyTorch)")
    p.add_argument("--config-base", type=str, default=None)
    p.add_argument("--config-file", type=str, default=None)
    p.add_argument("--inference", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="multi-card training: not ported yet (ROADMAP slice 4)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--submission", action="store_true",
                   help="CVPPP test set to submission.h5: not ported yet "
                        "(ROADMAP item 19)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = get_args(argv)
    if args.distributed:
        raise NotImplementedError("--distributed: multi-card training is "
                                  "ROADMAP slice 4 (item 22)")
    cfg = load_cfg(args.config_base, args.config_file, args.opts, freeze=False)
    if args.inference:
        cfg = update_inference_cfg(cfg)
    cfg.freeze()

    t0 = time.time()
    trainer = Trainer(cfg, mode="test" if args.inference else "train",
                      checkpoint=args.checkpoint, device=args.device)
    if not args.inference:
        trainer.train()
    elif cfg.DATASET.DATA_TYPE in ("CVPPP", "synthetic"):
        if args.submission:
            print(trainer.test_cvppp())
        else:
            print(trainer.eval_cvppp(model_name=os.path.basename(args.checkpoint or "model")))
    else:
        print(trainer.test_bbbc(model_name=os.path.basename(args.checkpoint or "model")))
    print(f"Total runtime: {time.time() - t0:.1f}s")
    return trainer


if __name__ == "__main__":
    main()
