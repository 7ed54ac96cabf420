"""Test-time augmentation: a flip/transpose ensemble (mirror of
``pctrans_tpu/data/tta.py``).

4, 8 or 16 variants from H/V flips (and transposes for 8; 16 adds the
z-flip of volumes and folds to 8 on 2D inputs), each prediction transformed
back and blended by mean, min or max.  Tensors stay on the forward's
device.  The trainer builds it in test mode from INFERENCE.AUG_MODE for
output naming only: it is not applied to the per-query instance chain,
where learned queries are not flip-equivariant (query q on a flipped image
finds another instance, so a per-query blend averages unrelated masks).
"""

from __future__ import annotations

from typing import Callable, List

import torch

_FLIPS_4 = [(False, False), (False, True), (True, False), (True, True)]


class TestAugmentor:
    __test__ = False                # not a pytest class

    def __init__(self, mode: str = "mean", num_aug: int = 4):
        if mode not in ("mean", "min", "max"):
            raise ValueError(f"TTA mode {mode!r}: one of mean, min, max")
        if num_aug not in (2, 4, 8, 16):
            raise ValueError(f"TTA variants {num_aug}: one of 2, 4, 8, 16")
        self.mode = mode
        self.num_aug = num_aug

    @classmethod
    def build_from_cfg(cls, cfg) -> "TestAugmentor":
        num = cfg.INFERENCE.AUG_NUM if cfg.INFERENCE.AUG_NUM else 4
        mode = cfg.INFERENCE.AUG_MODE if cfg.INFERENCE.AUG_MODE else "mean"
        if mode in (None, "None"):
            mode = "mean"
        return cls(mode=mode, num_aug=int(num))

    def _variants(self, volumetric: bool):
        """(z-flip, y-flip, x-flip, transpose) per variant."""
        n_spatial = min(self.num_aug, 8)
        out = [(False, fy, fx, False) for fy, fx in _FLIPS_4[:max(n_spatial, 2)]]
        if n_spatial == 8:
            out += [(False, fy, fx, True) for fy, fx in _FLIPS_4]
        out = out[:n_spatial]
        if self.num_aug == 16 and volumetric:
            out = out + [(True, fy, fx, tr) for (_, fy, fx, tr) in out]
        return out

    def __call__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] (or volumes [B, D, H, W, C]); ``forward``
        returns [B, ..., H', W'] with the last two axes spatial (z at -3 for
        volumes)."""
        volumetric = images.dim() == 5
        sy, sx = (2, 3) if volumetric else (1, 2)
        preds: List[torch.Tensor] = []
        for fz, fy, fx, tr in self._variants(volumetric):
            x = images
            if fz:
                x = x.flip(1)
            if fy:
                x = x.flip(sy)
            if fx:
                x = x.flip(sx)
            if tr:
                x = x.transpose(sy, sx)
            y = forward(x.contiguous())
            if tr:
                y = y.transpose(-1, -2)
            if fx:
                y = y.flip(-1)
            if fy:
                y = y.flip(-2)
            if fz:
                y = y.flip(-3)
            preds.append(y)
        stack = torch.stack(preds)
        if self.mode == "mean":
            return stack.mean(0)
        return stack.amin(0) if self.mode == "min" else stack.amax(0)

    def update_name(self, name: str) -> str:
        """``name`` tagged with the variants and the blend, before the
        extension."""
        base, dot, ext = name.rpartition(".")
        tag = f"_aug{self.num_aug}{self.mode}"
        return f"{base}{tag}{dot}{ext}" if dot else f"{name}{tag}"
