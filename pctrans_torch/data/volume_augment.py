"""Volume (EM-stack) augmentation package (a copy of
``pctrans_tpu/data/volume_augment.py``, which imports no JAX; cv2 is
imported inside the functions that call it, never at import).

Equivalent of the reference ``connectomics/data/augmentation`` (the legacy
EM training path, built for non-CVPPP/BBBC dataset types —
engine/trainer.py:60-63): 13 augmentors subclassing a ``DataAugment``
contract (augmentor.py:6-64 — each declares a ``sample_params``
ratio/add sample-size inflation and transforms a ``{'image', ...}`` dict of
(z, y, x) volumes), composed by :class:`Compose` (composition.py:6-155:
flip-applied-last ordering, sample-size inflation, center crop, Gaussian
label smoothing), plus the config-driven :func:`build_train_augmentor`
(build.py:17-224).

Implementation notes: cv2 + scipy only (skimage is not in this image);
``skimage.draw.line`` -> dense linspace rasterization,
``skimage.transform.resize`` -> cv2 per-slice / scipy.ndimage.zoom.
Randomness flows through an explicit ``np.random.RandomState`` so
per-(seed, epoch, index) streams keep augmentation deterministic under any
thread schedule (same policy as data/build.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage


def _interp(ttype: str) -> int:
    """cv2's interpolation flag for a target type: linear for images,
    nearest for masks."""
    import cv2

    return {"img": cv2.INTER_LINEAR, "mask": cv2.INTER_NEAREST}[ttype]


def _cv2_safe(vol):
    """cv2 warp/resize/remap reject wide integer dtypes (uint32/int64 EM
    label volumes raise 'Assertion failed' on this cv2 build); round-trip
    through float32 — exact under INTER_NEAREST for instance ids < 2**24.
    Returns (converted, dtype-to-restore-or-None)."""
    if vol.dtype.kind in "iu" and vol.dtype.itemsize > 2:
        return vol.astype(np.float32), vol.dtype
    return vol, None


class DataAugment:
    """Base contract (augmentor.py:6-64): ``sample_params`` announces the
    extra sample size this transform needs; ``__call__(sample, rs)`` applies
    it to ``image`` and every ``additional_targets`` entry (typed 'img' or
    'mask') not in ``skip_targets``."""

    def __init__(self, p: float = 0.5,
                 additional_targets: Optional[Dict[str, str]] = None,
                 skip_targets: Sequence[str] = ()):
        assert 0.0 <= p <= 1.0
        self.p = p
        self.sample_params = {"ratio": np.array([1.0, 1.0, 1.0]),
                              "add": np.array([0, 0, 0])}
        self.additional_targets = dict(additional_targets or {})
        self.skip_targets = list(skip_targets)

    def set_params(self):
        pass

    def _targets(self, types: Sequence[str] = ("img", "mask")):
        return [k for k, t in self.additional_targets.items()
                if k not in self.skip_targets and t in types]


class Flip(DataAugment):
    """z/y/x flips + xy transpose (+ optional zx transpose) (flip.py:7-76)."""

    def __init__(self, do_ztrans: int = 0, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.do_ztrans = do_ztrans

    def _apply(self, data, rule):
        off = data.ndim - 3  # 0 for (z,y,x), 1 for (c,z,y,x)
        for ax in range(3):
            if rule[ax]:
                data = np.flip(data, axis=off + ax)
        if rule[3]:
            data = np.swapaxes(data, off + 1, off + 2)
        if self.do_ztrans == 1 and rule[4]:
            data = np.swapaxes(data, off + 0, off + 2)
        return data

    def __call__(self, sample, random_state):
        rule = random_state.randint(2, size=4 + self.do_ztrans)
        sample["image"] = self._apply(sample["image"].copy(), rule)
        for key in self._targets():
            sample[key] = self._apply(sample[key].copy(), rule)
        return sample


class Rotate(DataAugment):
    """xy-plane rotation: 90-degree steps or arbitrary angle with the
    sqrt(2) sample inflation (rotation.py:8-76)."""

    def __init__(self, rot90: bool = True, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.rot90 = rot90
        if not rot90:
            self.sample_params["ratio"] = np.array([1.0, 1.42, 1.42])

    @staticmethod
    def _warp_stack(vol, M, interp):
        import cv2

        vol, restore = _cv2_safe(vol)
        out = vol.copy()
        h, w = vol.shape[-2:]
        # cv2 dsize is (width, height); the reference passed (height, width)
        # (rotation.py:49), which only works for square crops
        for z in range(vol.shape[-3]):
            out[z] = cv2.warpAffine(vol[z], M, (w, h), 1.0, flags=interp,
                                    borderMode=cv2.BORDER_CONSTANT)
        return out if restore is None else out.astype(restore)

    def __call__(self, sample, random_state):
        import cv2

        if self.rot90:
            k = random_state.randint(0, 4)
            sample["image"] = np.rot90(sample["image"].copy(), k, axes=(1, 2))
            for key in self._targets():
                sample[key] = np.rot90(sample[key].copy(), k, axes=(1, 2))
        else:
            h, w = sample["image"].shape[-2:]
            # cv2 centers are (x, y) = (w/2, h/2)
            M = cv2.getRotationMatrix2D((w / 2, h / 2),
                                        random_state.rand() * 360.0, 1)
            sample["image"] = self._warp_stack(sample["image"].copy(), M,
                                               _interp("img"))
            for key in self._targets():
                sample[key] = self._warp_stack(
                    sample[key].copy(), M,
                    _interp(self.additional_targets[key]))
        return sample


class Rescale(DataAugment):
    """xy rescale by a random factor in [low, high] with crop/pad back to
    the original size (rescale.py:8-115)."""

    def __init__(self, low: float = 0.8, high: float = 1.25,
                 fix_aspect: bool = False, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.low, self.high, self.fix_aspect = low, high, fix_aspect
        ratio = 1.0 / low
        self.sample_params["ratio"] = np.array([1.0, ratio, ratio])

    def _coord(self, sf, n, rs):
        length = int(sf * n)
        if length <= n:
            start = rs.randint(0, n - length + 1)
            return start, start + length, "upscale"
        return (int(np.floor((length - n) / 2)),
                int(np.ceil((length - n) / 2)), "downscale")

    def _apply(self, vol, xp, yp, ttype):
        import cv2

        x0, x1, xm = xp
        y0, y1, ym = yp
        vol, restore = _cv2_safe(vol)
        t = vol.copy()
        t = t[:, y0:y1] if ym == "upscale" else np.pad(
            t, ((0, 0), (y0, y1), (0, 0)))
        t = t[:, :, x0:x1] if xm == "upscale" else np.pad(
            t, ((0, 0), (0, 0), (x0, x1)))
        out = np.empty_like(vol)
        for z in range(vol.shape[0]):
            out[z] = cv2.resize(t[z], (vol.shape[2], vol.shape[1]),
                                interpolation=_interp(ttype))
        return out if restore is None else out.astype(restore)

    def __call__(self, sample, random_state):
        def rand_scale():
            return 1.0 / (random_state.rand() * (self.high - self.low) + self.low)

        img = sample["image"]
        sfx = rand_scale()
        sfy = sfx if self.fix_aspect else rand_scale()
        yp = self._coord(sfy, img.shape[1], random_state)
        xp = self._coord(sfx, img.shape[2], random_state)
        sample["image"] = self._apply(img.copy(), xp, yp, "img")
        for key in self._targets():
            sample[key] = self._apply(sample[key].copy(), xp, yp,
                                      self.additional_targets[key])
        return sample


class Elastic(DataAugment):
    """Simard-style xy elastic deformation shared across slices
    (warp.py:10-89); sample inflated by alpha+1 per side."""

    def __init__(self, alpha: float = 16.0, sigma: float = 4.0,
                 p: float = 0.5, additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.alpha, self.sigma = alpha, sigma
        m = int(alpha) + 1
        self.sample_params["add"] = np.array([0, m, m])

    def _remap(self, vol, mapx, mapy, ttype):
        import cv2

        interp = _interp(ttype)
        vol, restore = _cv2_safe(vol)
        if vol.ndim == 3:
            out = np.stack([
                cv2.remap(vol[z], mapx, mapy, interp,
                          borderMode=cv2.BORDER_CONSTANT)
                for z in range(vol.shape[0])], 0)
        else:
            out = np.stack([
                np.stack([cv2.remap(vol[c, z], mapx, mapy, interp,
                                    borderMode=cv2.BORDER_CONSTANT)
                          for c in range(vol.shape[0])], 0)
                for z in range(vol.shape[1])], 1)
        return out if restore is None else out.astype(restore)

    def __call__(self, sample, random_state):
        h, w = sample["image"].shape[-2:]
        dx = np.float32(ndimage.gaussian_filter(
            random_state.rand(h, w) * 2 - 1, self.sigma) * self.alpha)
        dy = np.float32(ndimage.gaussian_filter(
            random_state.rand(h, w) * 2 - 1, self.sigma) * self.alpha)
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        mapx, mapy = np.float32(x + dx), np.float32(y + dy)
        sample["image"] = self._remap(sample["image"].copy(), mapx, mapy, "img")
        for key in self._targets():
            sample[key] = self._remap(sample[key].copy(), mapx, mapy,
                                      self.additional_targets[key])
        return sample


class Grayscale(DataAugment):
    """Contrast/brightness/gamma (2D per-slice or 3D), optional inversion
    (grayscale.py:7-117); images only."""

    def __init__(self, contrast_factor: float = 0.3,
                 brightness_factor: float = 0.3, mode: str = "mix",
                 invert: bool = False, invert_p: float = 0.0, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        assert mode in ("2D", "3D", "mix")
        self.mode = mode
        self.invert, self.invert_p = invert, invert_p
        self.cf, self.bf = contrast_factor, brightness_factor

    def _adjust(self, img, r0, r1, r2):
        img = img * (1 + (r0 - 0.5) * self.cf)
        img = img + (r1 - 0.5) * self.bf
        img = np.clip(img, 0, 1)
        return img ** (2.0 ** (r2 * 2 - 1))

    def _apply(self, vol, mode, ran, do_invert):
        out = np.copy(vol)
        if mode == "2D":
            for z in range(out.shape[-3]):
                out[z] = self._adjust(out[z], *ran[z * 3 : z * 3 + 3])
        else:
            out = self._adjust(out, *ran[:3])
        if do_invert:
            out = np.clip(1.0 - out, 0, 1)
        return out

    def __call__(self, sample, random_state):
        mode = self.mode
        if mode == "mix":
            mode = "3D" if random_state.rand() > 0.5 else "2D"
        n = sample["image"].shape[-3] * 3 if mode == "2D" else 3
        ran = random_state.rand(n)
        do_invert = self.invert and random_state.rand() < self.invert_p
        sample["image"] = self._apply(sample["image"].copy(), mode, ran,
                                      do_invert)
        for key in self._targets(("img",)):
            sample[key] = self._apply(sample[key].copy(), mode, ran, do_invert)
        return sample


class MisAlignment(DataAugment):
    """Slip/translation (optionally rotation) section mis-alignment
    (misalign.py:9-121)."""

    def __init__(self, displacement: int = 16, rotate_ratio: float = 0.0,
                 p: float = 0.5, additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.displacement = displacement
        self.rotate_ratio = rotate_ratio
        a = int(math.ceil(displacement / 2.0))
        self.sample_params["add"] = np.array([0, a, a])

    def _shift(self, vol, out_shape, x0, y0, x1, y1, idx, mode):
        if mode == "slip":
            out = vol[:, y0 : y0 + out_shape[1], x0 : x0 + out_shape[2]].copy()
            out[idx] = vol[idx, y1 : y1 + out_shape[1], x1 : x1 + out_shape[2]]
        else:
            out = np.zeros(out_shape, vol.dtype)
            out[:idx] = vol[:idx, y0 : y0 + out_shape[1], x0 : x0 + out_shape[2]]
            out[idx:] = vol[idx:, y1 : y1 + out_shape[1], x1 : x1 + out_shape[2]]
        return out

    def _rot(self, vol, idx, M, hw, ttype, mode):
        import cv2

        interp = _interp(ttype)
        vol, restore = _cv2_safe(vol)
        vol = vol.copy()
        rng = [idx] if mode == "slip" else range(idx, vol.shape[0])
        for i in rng:
            vol[i] = cv2.warpAffine(vol[i], M, hw, 1.0, flags=interp,
                                    borderMode=cv2.BORDER_CONSTANT)
        return vol if restore is None else vol.astype(restore)

    def __call__(self, sample, random_state):
        img = sample["image"]
        if img.shape[0] < 3:  # slip/translation needs an interior slice
            return sample
        if random_state.rand() < self.rotate_ratio:
            import cv2

            h, w = img.shape[-2:]
            assert h == w
            x = self.displacement / 2.0
            y = ((h - self.displacement) / 2.0) * 1.42
            angle = math.asin(x / y) * 2.0 * 57.2958
            rand_angle = (random_state.rand() - 0.5) * 2.0 * angle
            M = cv2.getRotationMatrix2D((h / 2, h / 2), rand_angle, 1)
            idx = random_state.choice(np.arange(1, img.shape[0] - 1), 1)[0]
            mode = "slip" if random_state.rand() < 0.5 else "translation"
            sample["image"] = self._rot(img, idx, M, (h, w), "img", mode)
            for key in self._targets():
                sample[key] = self._rot(sample[key], idx, M, (h, w),
                                        self.additional_targets[key], mode)
        else:
            d = self.displacement
            out_shape = (img.shape[0], img.shape[1] - d, img.shape[2] - d)
            kw = dict(
                out_shape=out_shape,
                x0=random_state.randint(d), y0=random_state.randint(d),
                x1=random_state.randint(d), y1=random_state.randint(d),
                idx=random_state.choice(np.arange(1, out_shape[0] - 1), 1)[0],
                mode="slip" if random_state.rand() < 0.5 else "translation",
            )
            sample["image"] = self._shift(img, **kw)
            for key in self._targets():
                sample[key] = self._shift(sample[key], **kw)
        return sample


class MissingSection(DataAugment):
    """Delete random z sections (missing_section.py:8-50)."""

    def __init__(self, num_sections: int = 2, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.num_sections = num_sections
        self.sample_params["add"] = np.array(
            [int(math.ceil(num_sections / 2.0)), 0, 0])

    def __call__(self, sample, random_state):
        img = sample["image"]
        # need >= num_sections interior slices to delete
        if img.shape[0] - 2 < self.num_sections:
            return sample
        idx = random_state.choice(np.arange(1, img.shape[0] - 1),
                                  self.num_sections, replace=False)
        sample["image"] = np.delete(img, idx, 0)
        for key in self._targets():
            sample[key] = np.delete(sample[key], idx, 0)
        return sample


class MissingParts(DataAugment):
    """Black out a dilated random line per (some) slices, filled with the
    slice mean (missing_parts.py:10-93); images only."""

    def __init__(self, iterations: int = 64, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.iterations = iterations

    def _line_mask(self, shape, rs):
        if rs.rand() < 0.5:  # fixed x: line spans rows
            x0, y0 = 0, rs.randint(1, shape[1] - 2)
            x1, y1 = shape[0] - 1, rs.randint(1, shape[1] - 2)
        else:
            x0, y0 = rs.randint(1, shape[0] - 2), 0
            x1, y1 = rs.randint(1, shape[0] - 2), shape[1] - 1
        mask = np.zeros(shape, bool)
        n = max(abs(x1 - x0), abs(y1 - y0)) + 1
        rr = np.round(np.linspace(x0, x1, n)).astype(int)
        cc = np.round(np.linspace(y0, y1, n)).astype(int)
        mask[rr, cc] = True
        return ndimage.binary_dilation(mask, iterations=self.iterations)

    def __call__(self, sample, random_state):
        img = sample["image"]
        transforms = {}
        i = 0
        while i < img.shape[0]:
            if random_state.rand() < self.p:
                transforms[i] = self._line_mask(img.shape[1:], random_state)
                i += 1  # at most one deformed slice in any consecutive two
            i += 1

        def apply(vol):
            out = np.copy(vol)
            for i, m in transforms.items():
                out[i][m] = out[i].mean()
            return out

        sample["image"] = apply(img)
        for key in self._targets(("img",)):
            sample[key] = apply(sample[key])
        return sample


class MotionBlur(DataAugment):
    """Horizontal/vertical motion-blur kernel on random slices
    (motion_blur.py:9-65); images only."""

    def __init__(self, sections: int = 2, kernel_size: int = 11,
                 p: float = 0.5, additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.size, self.sections = kernel_size, sections

    def __call__(self, sample, random_state):
        k = np.zeros((self.size, self.size), np.float32)
        if random_state.rand() > 0.5:
            k[(self.size - 1) // 2, :] = 1.0
        else:
            k[:, (self.size - 1) // 2] = 1.0
        k /= self.size
        img = sample["image"]
        n = min(self.sections, img.shape[0])
        idx = random_state.choice(img.shape[0], n, replace=False)

        def apply(vol):
            import cv2

            out = np.copy(vol)
            for i in idx:
                out[i] = cv2.filter2D(out[i], -1, k)
            return out

        sample["image"] = apply(img)
        for key in self._targets(("img",)):
            sample[key] = apply(sample[key])
        return sample


class CutBlur(DataAugment):
    """Downsample-then-upsample a random cuboid (super-resolution signal,
    cutblur.py:9-93); images only."""

    def __init__(self, length_ratio: float = 0.25, down_ratio_min: float = 2.0,
                 down_ratio_max: float = 8.0, downsample_z: bool = False,
                 p: float = 0.5, additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.length_ratio = length_ratio
        self.down_min, self.down_max = down_ratio_min, down_ratio_max
        self.downsample_z = downsample_z

    def _region(self, n, rs):
        ln = int(self.length_ratio * n)
        low = rs.randint(0, n - ln)
        return low, low + ln

    def _blur(self, vol, zl, zh, yl, yh, xl, xh, ratio):
        out = np.copy(vol)
        region = out[:, yl:yh, xl:xh] if vol.shape[0] == 1 else out[zl:zh, yl:yh, xl:xh]
        zr = ratio if (vol.shape[0] > 1 and self.downsample_z) else 1.0
        down = ndimage.zoom(region, (1.0 / zr, 1.0 / ratio, 1.0 / ratio),
                            order=1)
        up = ndimage.zoom(down, (region.shape[0] / down.shape[0],
                                 region.shape[1] / down.shape[1],
                                 region.shape[2] / down.shape[2]), order=0)
        up = up[: region.shape[0], : region.shape[1], : region.shape[2]]
        if vol.shape[0] == 1:
            out[:, yl : yl + up.shape[1], xl : xl + up.shape[2]] = up
        else:
            out[zl : zl + up.shape[0], yl : yl + up.shape[1],
                xl : xl + up.shape[2]] = up
        return out

    def __call__(self, sample, random_state):
        img = sample["image"]
        zl = zh = 0
        if img.shape[0] > 1:
            zl, zh = self._region(img.shape[0], random_state)
        yl, yh = self._region(img.shape[1], random_state)
        xl, xh = self._region(img.shape[2], random_state)
        ratio = random_state.uniform(self.down_min, self.down_max)
        sample["image"] = self._blur(img, zl, zh, yl, yh, xl, xh, ratio)
        for key in self._targets(("img",)):
            sample[key] = self._blur(sample[key], zl, zh, yl, yh, xl, xh, ratio)
        return sample


class CutNoise(DataAugment):
    """Add uniform noise to a random cuboid (cutnoise.py:7-82); images only."""

    def __init__(self, length_ratio: float = 0.25, mode: str = "uniform",
                 scale: float = 0.2, p: float = 0.5,
                 additional_targets=None, skip_targets=()):
        super().__init__(p, additional_targets, skip_targets)
        self.length_ratio, self.mode, self.scale = length_ratio, mode, scale

    def _region(self, n, rs):
        ln = int(self.length_ratio * n)
        low = rs.randint(0, n - ln)
        return low, low + ln

    def __call__(self, sample, random_state):
        img = sample["image"]
        zl = zh = 0
        if img.shape[0] > 1:
            zl, zh = self._region(img.shape[0], random_state)
        yl, yh = self._region(img.shape[1], random_state)
        xl, xh = self._region(img.shape[2], random_state)
        zlen = (zh - zl) if img.shape[0] > 1 else 1
        noise = random_state.uniform(-self.scale, self.scale,
                                     (zlen, yh - yl, xh - xl))

        def apply(vol):
            out = np.copy(vol)
            if vol.shape[0] == 1:
                out[:, yl:yh, xl:xh] = np.clip(out[:, yl:yh, xl:xh] + noise, 0, 1)
            else:
                out[zl:zh, yl:yh, xl:xh] = np.clip(
                    out[zl:zh, yl:yh, xl:xh] + noise, 0, 1)
            return out

        sample["image"] = apply(img)
        for key in self._targets(("img",)):
            sample[key] = apply(sample[key])
        return sample


class MixupAugmentor:
    """Batch-level mixup (mixup.py:7-57): linearly blend each of ``num_aug``
    volumes with another random volume; labels follow the major sample."""

    def __init__(self, min_ratio: float = 0.7, max_ratio: float = 0.9,
                 num_aug: int = 2):
        self.min_ratio, self.max_ratio, self.num_aug = min_ratio, max_ratio, num_aug

    def __call__(self, volume, random_state: Optional[np.random.RandomState] = None):
        rs = random_state or np.random.RandomState()
        num_vol = volume.shape[0]
        if num_vol < 2:  # nothing to mix with (e.g. a ragged batch of 1)
            return volume
        num_aug = min(self.num_aug, num_vol)
        major = rs.choice(num_vol, num_aug, replace=False)
        for i in major:
            others = [j for j in range(num_vol) if j != i]
            minor = others[rs.randint(len(others))]
            ratio = rs.uniform(self.min_ratio, self.max_ratio)
            volume[i] = volume[i] * ratio + volume[minor] * (1 - ratio)
        return volume


class CopyPasteAugmentor(DataAugment):
    """Copy the foreground object, find the flip/rotation placement with the
    least overlap with (then distance from) the original, and paste it back
    (copy_paste.py:10-118).  Pure numpy (the reference uses torch +
    torchvision rotate with nearest interpolation)."""

    def __init__(self, aug_thres: float = 0.7, p: float = 0.8,
                 additional_targets: Optional[Dict[str, str]] = None,
                 skip_targets=()):
        additional_targets = additional_targets or {"label": "mask"}
        assert "label" in additional_targets
        super().__init__(p, additional_targets, skip_targets)
        self.aug_thres = aug_thres

    @staticmethod
    def _rotate(vol, angle):
        """Nearest rotation of the last two axes, any leading axes."""
        import cv2

        h, w = vol.shape[-2:]
        M = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1)
        flat = vol.reshape(-1, h, w)
        out = np.stack([
            cv2.warpAffine(flat[i].astype(np.float32), M, (w, h),
                           flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_CONSTANT)
            for i in range(flat.shape[0])], 0)
        return out.reshape(vol.shape).astype(vol.dtype)

    @staticmethod
    def _center_dist(a, b):
        if not a.any() or not b.any():
            return np.inf
        ca = np.stack(np.where(a)).mean(1) / np.array(a.shape)
        cb = np.stack(np.where(b)).mean(1) / np.array(b.shape)
        return float(((ca - cb) ** 2).mean())

    def __call__(self, sample, random_state=None):
        volume = sample["image"]
        label = sample["label"].astype(bool)
        if label.mean() > self.aug_thres or not label.any():
            return sample
        gt = label
        neuron = volume * label

        candidates = [label, label[::-1]]  # identity and z-flip
        best = (np.inf, np.inf, 0, 0)  # (overlap, dist, angle, flip_idx)
        for ind, cand in enumerate(candidates):
            for angle in range(0, 360, 30):
                rot = self._rotate(cand.astype(np.uint8), angle).astype(bool) \
                    if angle else cand
                overlap = np.logical_and(rot, gt).sum()
                dist = self._center_dist(rot, gt) if overlap == 0 else np.inf
                key = (overlap, dist, angle, ind)
                if (overlap, dist) < (best[0], best[1]):
                    best = key
        _, _, angle, ind = best
        rot_label = candidates[ind]
        pasted = neuron[::-1] if ind else neuron
        if angle:
            rot_label = self._rotate(rot_label.astype(np.uint8), angle).astype(bool)
            pasted = self._rotate(pasted, angle)
        # clear the (dilated) original object region from the paste
        guard = ndimage.binary_dilation(
            gt, structure=ndimage.generate_binary_structure(3, 3), iterations=3)
        rot_label = rot_label & ~guard
        sample["image"] = volume * (~rot_label) + pasted * rot_label
        return sample


class Compose:
    """Compose transforms with sample-size inflation, flip-last ordering,
    center crop and Gaussian mask smoothing (composition.py:6-155)."""

    smooth_sigma = 2.0
    smooth_threshold = 0.5

    def __init__(self, transforms: List[DataAugment],
                 input_size=(8, 256, 256), smooth: bool = True,
                 keep_uncropped: bool = False, keep_non_smoothed: bool = False,
                 additional_targets: Optional[Dict[str, str]] = None):
        self.transforms = list(transforms)
        # flips go last: z/x transposes would break shape bookkeeping of the
        # xy-only transforms (composition.py:62-76)
        self.flip_aug = None
        for i, t in enumerate(self.transforms):
            if isinstance(t, Flip):
                self.flip_aug = self.transforms.pop(i)
                break
        self.input_size = np.array(input_size)
        self.sample_size = self.input_size.copy()
        for t in self.transforms:
            self.sample_size = np.ceil(
                self.sample_size * t.sample_params["ratio"]).astype(int)
            self.sample_size = self.sample_size + 2 * np.array(
                t.sample_params["add"])
        self.smooth = smooth
        self.keep_uncropped = keep_uncropped
        self.keep_non_smoothed = keep_non_smoothed
        self.additional_targets = dict(additional_targets or {})

    def smooth_edge(self, masks):
        out = masks.copy()
        for z in range(out.shape[0]):
            temp = out[z].copy()
            for idx in np.unique(temp):
                if idx == 0:
                    continue
                binary = (temp == idx).astype(np.float32)
                for _ in range(2):
                    binary = ndimage.gaussian_filter(binary, self.smooth_sigma)
                    binary = (binary > self.smooth_threshold).astype(np.float32)
                temp[temp == idx] = 0
                temp[binary > 0] = idx
            out[z] = temp
        return out

    def center_crop(self, images):
        zl, yl, xl = images.shape[-3:]
        mz = (zl - self.input_size[0]) // 2
        my = (yl - self.input_size[1]) // 2
        mx = (xl - self.input_size[2]) // 2
        sl = (slice(mz, mz + self.input_size[0]),
              slice(my, my + self.input_size[1]),
              slice(mx, mx + self.input_size[2]))
        return images[(Ellipsis,) + sl]

    def __call__(self, sample, random_state: Optional[np.random.RandomState] = None):
        rs = random_state or np.random.RandomState()
        if sample["image"].ndim != 3:
            # most transforms index axis 0 as z and (1, 2) as (y, x) — a
            # 4D [c, z, y, x] image would be corrupted SILENTLY (rot90 in
            # the (z, y) plane, per-channel warps written to wrong slices).
            # The reference augmentors are equally 3D-image-only.
            raise NotImplementedError(
                f"Compose augments 3D [z, y, x] images; got shape "
                f"{sample['image'].shape}. Augment multi-channel volumes "
                f"per channel or disable AUGMENTOR for this data.")
        sample["image"] = sample["image"].astype(np.float32)
        for name, t in self.additional_targets.items():
            if t == "img":
                sample[name] = sample[name].astype(np.float32)

        ran = rs.rand(len(self.transforms))
        for tid, t in enumerate(reversed(self.transforms)):
            if ran[tid] < t.p:
                sample = t(sample, rs)

        for key in ["image"] + list(self.additional_targets):
            if self.keep_uncropped:
                sample[f"uncropped_{key}"] = sample[key].copy()
            sample[key] = self.center_crop(sample[key])

        if self.flip_aug is not None and rs.rand() < self.flip_aug.p:
            sample = self.flip_aug(sample, rs)

        if self.smooth:
            for key, t in self.additional_targets.items():
                if t == "mask":
                    if self.keep_non_smoothed:
                        sample[f"not_smoothed_{key}"] = sample[key].copy()
                    sample[key] = self.smooth_edge(sample[key].copy())
        return sample


def build_train_augmentor(cfg, keep_uncropped=False, keep_non_smoothed=False):
    """Config-driven composition (reference build.py:17-224): every AUGMENTOR.*
    block with ENABLED adds its augmentor; targets from
    cfg.AUGMENTOR.ADDITIONAL_TARGETS_*."""
    aug = cfg.AUGMENTOR
    names = list(getattr(aug, "ADDITIONAL_TARGETS_NAME", None) or [])
    types = list(getattr(aug, "ADDITIONAL_TARGETS_TYPE", None) or [])
    additional_targets = dict(zip(names, types)) if names else {"label": "mask"}
    kw = {"additional_targets": additional_targets}

    transforms = []

    def on(block):
        return block is not None and getattr(block, "ENABLED", False)

    if on(aug.get("ROTATE", None)):
        transforms.append(Rotate(rot90=aug.ROTATE.ROT90, p=aug.ROTATE.P, **kw))
    if on(aug.get("RESCALE", None)):
        transforms.append(Rescale(p=aug.RESCALE.P, **kw))
    if on(aug.get("FLIP", None)):
        transforms.append(Flip(do_ztrans=aug.FLIP.DO_ZTRANS, p=aug.FLIP.P, **kw))
    if on(aug.get("ELASTIC", None)):
        transforms.append(Elastic(alpha=aug.ELASTIC.ALPHA,
                                  sigma=aug.ELASTIC.SIGMA,
                                  p=aug.ELASTIC.P, **kw))
    if on(aug.get("GRAYSCALE", None)):
        transforms.append(Grayscale(p=aug.GRAYSCALE.P, **kw))
    if on(aug.get("MISALIGNMENT", None)):
        transforms.append(MisAlignment(
            displacement=aug.MISALIGNMENT.DISPLACEMENT,
            rotate_ratio=aug.MISALIGNMENT.ROTATE_RATIO,
            p=aug.MISALIGNMENT.P, **kw))
    if on(aug.get("MISSINGSECTION", None)):
        transforms.append(MissingSection(
            num_sections=aug.MISSINGSECTION.NUM_SECTION,
            p=aug.MISSINGSECTION.P, **kw))
    if on(aug.get("MISSINGPARTS", None)):
        transforms.append(MissingParts(
            iterations=aug.MISSINGPARTS.ITER,
            p=aug.MISSINGPARTS.P, **kw))
    if on(aug.get("MOTIONBLUR", None)):
        transforms.append(MotionBlur(
            sections=aug.MOTIONBLUR.SECTIONS,
            kernel_size=aug.MOTIONBLUR.KERNEL_SIZE,
            p=aug.MOTIONBLUR.P, **kw))
    if on(aug.get("CUTBLUR", None)):
        transforms.append(CutBlur(
            length_ratio=aug.CUTBLUR.LENGTH_RATIO,
            down_ratio_min=aug.CUTBLUR.DOWN_RATIO_MIN,
            down_ratio_max=aug.CUTBLUR.DOWN_RATIO_MAX,
            downsample_z=aug.CUTBLUR.DOWNSAMPLE_Z,
            p=aug.CUTBLUR.P, **kw))
    if on(aug.get("CUTNOISE", None)):
        transforms.append(CutNoise(
            length_ratio=aug.CUTNOISE.LENGTH_RATIO,
            scale=aug.CUTNOISE.SCALE,
            p=aug.CUTNOISE.P, **kw))
    if on(aug.get("COPYPASTE", None)):
        transforms.append(CopyPasteAugmentor(p=aug.COPYPASTE.P, **kw))

    # input_size = MODEL.INPUT_SIZE (reference build.py:161): the augmented
    # item must come back at the model's INPUT size; the dataset crops
    # labels to OUTPUT_SIZE separately when they differ (valid-conv nets)
    in_size = list(cfg.MODEL.INPUT_SIZE)
    if len(in_size) == 2:
        in_size = [1] + in_size
    return Compose(transforms,
                   input_size=tuple(in_size),
                   smooth=getattr(aug, "SMOOTH", True),
                   keep_uncropped=keep_uncropped,
                   keep_non_smoothed=keep_non_smoothed,
                   **kw)
