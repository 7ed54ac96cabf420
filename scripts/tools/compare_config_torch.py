"""Diff two config YAMLs with the PyTorch port's config reader (the twin of
``scripts/tools/compare_config.py``: the same flags, the same lines; no
PyYAML).

Both files are loaded through the config system (defaults and type
coercion apply) and compared key by key; ``--raw`` prints the reference's
unified text diff instead.

Usage: python scripts/tools/compare_config_torch.py --config1 a.yaml --config2 b.yaml
``main(argv)`` runs in-process.
"""

import argparse
import os
import sys
from difflib import unified_diff

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def flatten(node, prefix=""):
    out = {}
    for k, v in node.items():
        key = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Find differences between config files.")
    p.add_argument("--config1", type=str, required=True)
    p.add_argument("--config2", type=str, required=True)
    p.add_argument("--raw", action="store_true",
                   help="reference-style unified text diff")
    args = p.parse_args(argv)

    num_change = 0
    if args.raw:
        with open(args.config1) as f1:
            t1 = f1.read().strip().splitlines()
        with open(args.config2) as f2:
            t2 = f2.read().strip().splitlines()
        for line in unified_diff(t1, t2, fromfile="config1",
                                 tofile="config2", lineterm="", n=0):
            if not line.startswith("@@"):
                num_change += 1
                print(line)
    else:
        from pctrans_torch.config import load_cfg

        c1 = flatten(load_cfg(None, args.config1, freeze=False))
        c2 = flatten(load_cfg(None, args.config2, freeze=False))
        for key in sorted(set(c1) | set(c2)):
            v1, v2 = c1.get(key, "<absent>"), c2.get(key, "<absent>")
            if v1 != v2:
                num_change += 1
                print(f"{key}: {v1} -> {v2}")

    print("\nTotal number of changes: %d" % num_change)


if __name__ == "__main__":
    main()
