"""Scan a dataset's instance counts against MODEL.MAX_INSTANCES, with the
PyTorch port's config reader and datasets (the twin of
``scripts/scan_dataset.py``: the same flags, the same lines; no PyYAML).

The training targets are padded to MODEL.MAX_INSTANCES slots
(``pctrans_torch/data/targets.py``); any image with more instances loses
the excess from the loss.  Run it once per dataset/config pair.

Usage:
  python scripts/scan_dataset_torch.py --config-base ... --config-file ... \
      [--mode train] [--samples 200] [--strict] [--opts KEY VALUE ...]

Exits non-zero in --strict mode if any sampled image exceeds the cap.
``main(argv)`` runs in-process.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-base", default=None)
    p.add_argument("--config-file", required=True)
    p.add_argument("--mode", default="train")
    p.add_argument("--samples", type=int, default=200,
                   help="augmented samples to draw (train mode re-crops)")
    p.add_argument("--strict", action="store_true")
    p.add_argument("--opts", nargs="*", default=[])
    args = p.parse_args(argv)

    from pctrans_torch.config import load_cfg
    from pctrans_torch.data.build import get_dataset

    cfg = load_cfg(args.config_base, args.config_file, args.opts, freeze=False)
    cap = int(cfg.MODEL.MAX_INSTANCES)
    ds = get_dataset(cfg, args.mode)

    rng = np.random.RandomState(0)
    counts = []
    n = min(args.samples, len(ds) if args.mode != "train" else args.samples)
    for k in range(n):
        idx = k % len(ds)
        try:
            item = ds.__getitem__(idx, rng=np.random.RandomState(rng.randint(2**31)))
        except TypeError:
            item = ds[idx]
        counts.append(int(np.max(item["label"])))
    counts = np.asarray(counts)
    print(f"dataset={cfg.DATASET.DATA_TYPE} mode={args.mode} "
          f"samples={n} cap={cap}")
    print(f"instance count: max={counts.max()} p99={np.percentile(counts, 99):.0f} "
          f"mean={counts.mean():.1f}")
    over = int((counts > cap).sum())
    print(f"images over MODEL.MAX_INSTANCES: {over}/{n}")
    if over and args.strict:
        sys.exit(f"FAIL: {over} sampled image(s) exceed MAX_INSTANCES={cap}")


if __name__ == "__main__":
    main()
