"""Train / evaluate with the PyTorch port (``pctrans_torch``), the flags of
``scripts/main.py``.

Usage:
  python scripts/main_torch.py --config-base configs/CVPPP/CVPPP-PCTrans-Base.yaml \
      --config-file configs/CVPPP/CVPPP-PCTrans.yaml [--inference]
      [--checkpoint PATH] [--device cuda|cpu] [--opts KEY VALUE ...]

Multi-card training, one process per card:
  torchrun --nproc_per_node=N scripts/main_torch.py --distributed \
      --config-base ... --config-file ... [--opts ...]
(SYSTEM.DISTRIBUTED_BACKEND: ``ici``, the default, is NCCL on the card and
gloo on the CPU; ``nccl`` or ``gloo`` as written.)

Checkpoints land in DATASET.OUTPUT_PATH as ``checkpoint_%06d.pth.tar``;
``--inference --submission`` writes the CVPPP test split's predictions to
INFERENCE.OUTPUT_PATH/submission.h5 (needs ``h5py``).
``main(argv)`` runs in-process and returns the Trainer.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from pctrans_torch.config import load_cfg, update_inference_cfg  # noqa: E402
from pctrans_torch.engine.trainer import Trainer  # noqa: E402
from pctrans_torch.parallel import mesh  # noqa: E402
from pctrans_torch.parallel.mesh import initialize_distributed  # noqa: E402


def get_args(argv=None):
    p = argparse.ArgumentParser(description="PCTrans training / inference (PyTorch)")
    p.add_argument("--config-base", type=str, default=None)
    p.add_argument("--config-file", type=str, default=None)
    p.add_argument("--inference", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card: join the process group from the "
                        "env:// variables torchrun sets (MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK, LOCAL_RANK); the backend is "
                        "SYSTEM.DISTRIBUTED_BACKEND")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--submission", action="store_true",
                   help="CVPPP: run the test split and write the CodaLab "
                        "submission.h5 (needs h5py) instead of the val-split eval")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = get_args(argv)
    cfg = load_cfg(args.config_base, args.config_file, args.opts, freeze=False)
    device = args.device
    if args.distributed:
        # the backend is a config key, so the group is joined once the
        # config is read and before anything touches the card
        device = initialize_distributed(cfg.SYSTEM.DISTRIBUTED_BACKEND, args.device)
        print(f"[distributed] rank {mesh.rank()} of {mesh.world_size()} on {device}")
    if args.inference:
        cfg = update_inference_cfg(cfg)
    cfg.freeze()

    t0 = time.time()
    trainer = Trainer(cfg, mode="test" if args.inference else "train",
                      checkpoint=args.checkpoint, device=device)
    if not args.inference:
        trainer.train()
    else:
        name = os.path.basename(args.checkpoint or "model")
        dt = cfg.DATASET.DATA_TYPE
        if dt in ("CVPPP", "synthetic"):
            print(trainer.test_cvppp() if args.submission
                  else trainer.eval_cvppp(model_name=name))
        elif dt == "BBBC":
            print(trainer.test_bbbc(model_name=name))
        else:
            raise ValueError(f"No inference path for DATA_TYPE={dt}")
    print(f"Total runtime: {time.time() - t0:.1f}s")
    return trainer


if __name__ == "__main__":
    main()
    mesh.destroy()
