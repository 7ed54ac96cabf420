"""Volumetric random-crop dataset + chunked tile dataset (legacy EM path; a
copy of ``pctrans_tpu/data/volume_dataset.py``, which imports no JAX).

Equivalent of the reference ``VolumeDataset`` / ``TileDataset``
(connectomics/data/dataset/dataset_volume.py / dataset_tile.py — published
only as compiled bytecode, SURVEY.md section 2.5; their construction and
option surface is documented by ``get_dataset``,
data/dataset/build.py:248-347, and ``run_chunk``, engine/trainer.py:708-741).

* :class:`VolumeDataset` — holds loaded volumes in host memory.  Train mode
  samples random static-shape crops (rejection sampling on foreground
  size/diversity), runs the :mod:`volume_augment` pipeline, then generates
  dense targets (``seg_to_targets``, TARGET_OPT) and loss weights
  (``seg_to_weights``, WEIGHT_OPT) on the host — the TPU step consumes a
  fixed-shape ``{image, target_i, weight_i_j}`` dict, so XLA compiles once.
  Val/test mode enumerates a deterministic stride grid of positions whose
  last window clamps to the border (every voxel covered, one window shape).
* :class:`TileDataset` — terabyte-scale datasets described by a JSON
  metadata dict (``create_json``): the volume is split into a chunk grid;
  ``updatechunk``/``loadchunk`` assemble one chunk at a time with
  :func:`~pctrans_torch.data.volume_io.tile2volume` and expose it as an inner
  :class:`VolumeDataset` (``self.dataset``), the contract
  ``Trainer.run_chunk`` drives.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from .label_utils import relabel_consecutive  # shared 0-preserving relabel
from .seg_targets import seg_to_targets, seg_to_weights
from .volume_io import readvol, tile2volume


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _grid_starts(extent: int, window: int, stride: int) -> List[int]:
    if extent <= window:
        return [0]
    starts = list(range(0, extent - window, max(stride, 1)))
    starts.append(extent - window)  # clamp last window to the border
    return starts


class VolumeDataset:
    """Random-crop (train) / stride-grid (val, test) sampler over a list of
    in-memory volumes.

    ``volume``: list of [z, y, x] or [c, z, y, x] arrays (multi-channel
    volumes only without an augmentor — Compose is 3D-image-only and
    raises on 4D); ``label`` and
    ``valid_mask`` (optional) must match spatially.  Items are dicts of
    fixed-shape float32 arrays ready for ``np.stack`` batching:

    - train: ``image`` [c, z, y, x], ``target_i`` (per TARGET_OPT entry),
      ``weight_i_j`` (per WEIGHT_OPT entry; the no-weight placeholder is the
      size-1 zeros array, matching LegacyCriterion's sentinel).
    - val/test: ``pos`` int32 [4] = (volume id, z, y, x), ``image``.
    """

    def __init__(
        self,
        volume: Sequence[np.ndarray],
        label: Optional[Sequence[np.ndarray]] = None,
        valid_mask: Optional[Sequence[np.ndarray]] = None,
        mode: str = "train",
        sample_volume_size: Sequence[int] = (8, 256, 256),
        sample_label_size: Optional[Sequence[int]] = None,
        sample_stride: Sequence[int] = (1, 1, 1),
        augmentor=None,
        target_opt: Sequence[str] = ("0",),
        weight_opt: Sequence[Sequence[str]] = (("1",),),
        iter_num: int = -1,
        reject_size_thres: int = -1,
        reject_diversity: int = -1,
        reject_p: float = 0.95,
        data_mean: float = 0.5,
        data_std: float = 0.5,
        do_relabel: bool = True,
        do_2d: bool = False,
        erosion_rates=None,
        dilation_rates=None,
    ):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.volume = [np.asarray(v) for v in _as_list(volume)]
        self.label = ([np.asarray(l) for l in _as_list(label)]
                      if label is not None else None)
        self.valid_mask = ([np.asarray(m) for m in _as_list(valid_mask)]
                           if valid_mask is not None else None)
        self.sample_size = tuple(int(s) for s in sample_volume_size)
        # label crop size (valid-conv nets emit smaller outputs); defaults
        # to the input sample size
        self.label_size = (tuple(int(s) for s in sample_label_size)
                           if sample_label_size else self.sample_size)
        self.augmentor = augmentor
        # augmentors inflate the crop so rotations/rescales can center-crop
        # back to sample_size (Compose.sample_size)
        self.aug_sample_size = (tuple(int(s) for s in augmentor.sample_size)
                                if augmentor is not None else self.sample_size)
        self.target_opt = list(target_opt)
        self.weight_opt = [list(w) for w in weight_opt]
        self.reject_size_thres = reject_size_thres
        self.reject_diversity = reject_diversity
        self.reject_p = reject_p
        self.data_mean = float(data_mean)
        self.data_std = float(data_std)
        self.do_relabel = do_relabel
        self.do_2d = do_2d
        self.erosion_rates = erosion_rates
        self.dilation_rates = dilation_rates

        spatial = [v.shape[-3:] for v in self.volume]
        for i, shp in enumerate(spatial):
            assert all(shp[d] >= self.aug_sample_size[d] for d in range(3)), (
                f"volume {i} {shp} smaller than sample size "
                f"{self.aug_sample_size}")
        # sample volumes proportionally to their number of valid positions
        counts = np.array(
            [np.prod([shp[d] - self.aug_sample_size[d] + 1 for d in range(3)])
             for shp in spatial], np.float64)
        self._vol_p = counts / counts.sum()

        if mode == "train":
            self._len = int(iter_num) if iter_num > 0 else 10 ** 9
        else:
            stride = tuple(int(s) for s in sample_stride)
            self._positions = []
            for vid, shp in enumerate(spatial):
                for z in _grid_starts(shp[0], self.sample_size[0], stride[0]):
                    for y in _grid_starts(shp[1], self.sample_size[1], stride[1]):
                        for x in _grid_starts(shp[2], self.sample_size[2], stride[2]):
                            self._positions.append((vid, z, y, x))
            self._len = len(self._positions)

    def __len__(self) -> int:
        return self._len

    # ------------------------------------------------------------- cropping
    def _crop(self, arr: np.ndarray, pos, size) -> np.ndarray:
        z, y, x = pos
        sl = (slice(z, z + size[0]), slice(y, y + size[1]),
              slice(x, x + size[2]))
        return arr[(Ellipsis,) + sl]

    def _random_pos(self, rng: np.random.RandomState):
        vid = int(rng.choice(len(self.volume), p=self._vol_p))
        shp = self.volume[vid].shape[-3:]
        pos = tuple(rng.randint(0, shp[d] - self.aug_sample_size[d] + 1)
                    for d in range(3))
        return vid, pos

    def _accept(self, label_crop: Optional[np.ndarray], valid_crop,
                rng: np.random.RandomState) -> bool:
        """Rejection sampling (reference REJECT_SAMPLING.{SIZE_THRES,
        DIVERSITY, P}): resample mostly-background / low-diversity crops
        with probability ``reject_p``."""
        if valid_crop is not None and valid_crop.mean() < 0.5:
            return False
        if label_crop is None:
            return True
        if self.reject_size_thres > 0:
            if (label_crop > 0).sum() < self.reject_size_thres:
                return rng.rand() > self.reject_p
        if self.reject_diversity > 0:
            n_ids = len(np.unique(label_crop[label_crop > 0]))
            if n_ids < self.reject_diversity:
                return rng.rand() > self.reject_p
        return True

    # ---------------------------------------------------------------- items
    def _normalize(self, img: np.ndarray) -> np.ndarray:
        # integer-typed volumes scale by their DTYPE's full range, not by
        # the crop's max — a dark crop (black borders, reflect padding)
        # must scale identically to a bright one.  Dividing by the dtype
        # max (255 for uint8, 65535 for uint16 microscopy, ...) lands every
        # integer input in [0, 1], matching the reference's
        # normalize_range-to-uint8-then-/255 flow (data_misc.py) without
        # its crop-dependent min-max.
        scale = None
        if np.issubdtype(img.dtype, np.integer):
            scale = float(np.iinfo(img.dtype).max)
        img = img.astype(np.float32)
        if scale:
            img = img / scale
        return (img - self.data_mean) / self.data_std

    def _finalize_shape(self, arr: np.ndarray) -> np.ndarray:
        """[z,y,x]->[1,z,y,x]; 2D mode squeezes the singleton z."""
        if arr.ndim == 3:
            arr = arr[None]
        if self.do_2d and arr.shape[1] == 1:
            arr = arr[:, 0]
        return arr

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        if self.mode != "train":
            vid, z, y, x = self._positions[index]
            img = self._crop(self.volume[vid], (z, y, x), self.sample_size)
            return {"pos": np.array([vid, z, y, x], np.int32),
                    "image": self._finalize_shape(self._normalize(img))}

        rng = rng or np.random.RandomState()
        for _ in range(50):
            vid, pos = self._random_pos(rng)
            img = self._crop(self.volume[vid], pos, self.aug_sample_size)
            lab = (self._crop(self.label[vid], pos, self.aug_sample_size)
                   if self.label is not None else None)
            vm = (self._crop(self.valid_mask[vid], pos, self.aug_sample_size)
                  if self.valid_mask is not None else None)
            if self._accept(lab, vm, rng):
                break

        if self.augmentor is not None and lab is not None:
            sample = self.augmentor({"image": img.copy(), "label": lab.copy()},
                                    rng)
            img, lab = sample["image"], sample["label"]
        elif self.augmentor is not None:
            # image-only crops still need the center-crop back to sample_size
            img = self.augmentor.center_crop(img.copy())

        out = {"image": self._finalize_shape(self._normalize(img))}
        if lab is not None:
            if self.label_size != self.sample_size:
                # valid-conv nets: labels center-cropped to OUTPUT_SIZE
                # (reference sample_label_size semantics)
                off = [(s - l) // 2 for s, l in
                       zip(lab.shape[-3:], self.label_size)]
                lab = lab[..., off[0]:off[0] + self.label_size[0],
                          off[1]:off[1] + self.label_size[1],
                          off[2]:off[2] + self.label_size[2]]
            if self.do_relabel:
                lab = relabel_consecutive(lab.astype(np.int64))
            targets = seg_to_targets(lab, self.target_opt,
                                     self.erosion_rates, self.dilation_rates)
            weights = seg_to_weights(targets, self.weight_opt, mask=None,
                                     seg=lab)
            for i, t in enumerate(targets):
                out[f"target_{i}"] = self._finalize_shape(
                    np.asarray(t, np.float32))
                for j, w in enumerate(weights[i]):
                    w = np.asarray(w, np.float32)
                    out[f"weight_{i}_{j}"] = (
                        w if w.size == 1 else self._finalize_shape(w))
        return out


class TileDataset:
    """Chunk-grid view over a tiled dataset described by ``create_json``
    metadata; one chunk at a time is materialized as ``self.dataset``
    (a :class:`VolumeDataset`).

    ``chunk_num`` [cz, cy, cx] splits the dataset extent into a grid;
    ``chunk_stride`` (train only) adds half-step chunk positions so chunk
    borders get sampled too (grid of 2n-1 per axis); ``chunk_ind`` restricts
    to a subset and ``chunk_ind_split`` ("rank-world") shards that list
    across data-loading hosts.
    """

    def __init__(
        self,
        volume_json: Sequence[str],
        label_json: Optional[Sequence[str]] = None,
        valid_mask_json: Optional[Sequence[str]] = None,
        chunk_num: Sequence[int] = (1, 1, 1),
        chunk_ind: Optional[Sequence[int]] = None,
        chunk_ind_split: Optional[str] = None,
        chunk_iter: int = 1000,
        chunk_stride: bool = True,
        mode: str = "train",
        pad_size: Sequence[int] = (0, 0, 0),
        **volume_kwargs,
    ):
        self.mode = mode
        self.metadata = [json.load(open(p)) for p in _as_list(volume_json)]
        self.label_metadata = ([json.load(open(p)) for p in _as_list(label_json)]
                               if label_json else None)
        self.valid_metadata = ([json.load(open(p))
                                for p in _as_list(valid_mask_json)]
                               if valid_mask_json else None)
        self.chunk_iter = int(chunk_iter)
        self.pad_size = tuple(int(p) for p in pad_size)
        self.volume_kwargs = dict(volume_kwargs)
        self.volume_kwargs["mode"] = mode

        m = self.metadata[0]
        self.extent = (int(m["depth"]), int(m["height"]), int(m["width"]))
        cz, cy, cx = (int(c) for c in chunk_num)
        half = chunk_stride and mode == "train"
        nz, ny, nx = ((2 * cz - 1, 2 * cy - 1, 2 * cx - 1)
                      if half else (cz, cy, cx))
        self._coords = []
        for iz in range(nz):
            for iy in range(ny):
                for ix in range(nx):
                    step = [self.extent[0] / cz, self.extent[1] / cy,
                            self.extent[2] / cx]
                    frac = 0.5 if half else 1.0
                    z0 = int(iz * step[0] * frac)
                    y0 = int(iy * step[1] * frac)
                    x0 = int(ix * step[2] * frac)
                    # end = int((i*frac + 1) * step): non-divisible extents
                    # must not leave unowned voxels between chunks (a start
                    # advancing by the float step with an int(step) window
                    # drops rows); in half-overlap mode this is the same
                    # step-sized window
                    self._coords.append(
                        (z0, min(int((iz * frac + 1) * step[0]), self.extent[0]),
                         y0, min(int((iy * frac + 1) * step[1]), self.extent[1]),
                         x0, min(int((ix * frac + 1) * step[2]), self.extent[2])))

        ind = list(chunk_ind) if chunk_ind else list(range(len(self._coords)))
        if chunk_ind_split:  # "rank-world": shard chunk list across hosts
            rank, world = (int(v) for v in str(chunk_ind_split).split("-"))
            ind = ind[rank::world]
        self.chunk_ind = ind
        self._ptr = -1
        self.coord = None
        self.dataset: Optional[VolumeDataset] = None

    def __len__(self) -> int:
        return len(self.chunk_ind)

    def get_coord_name(self) -> str:
        assert self.coord is not None, "call updatechunk() first"
        return "-".join(str(c) for c in self.coord)

    def updatechunk(self, do_load: bool = True) -> None:
        """Advance to the next chunk (cycled for training)."""
        self._ptr = (self._ptr + 1) % len(self.chunk_ind)
        self.coord = self._coords[self.chunk_ind[self._ptr]]
        if do_load:
            self.loadchunk()

    def _assemble(self, meta: dict, do_im: bool) -> np.ndarray:
        z0, z1, y0, y1, x0, x1 = self.coord
        p = self.pad_size
        coord = [z0 - p[0], z1 + p[0], y0 - p[1], y1 + p[1],
                 x0 - p[2], x1 + p[2]]
        coord_m = [0, self.extent[0], 0, self.extent[1], 0, self.extent[2]]
        return tile2volume(
            meta["image"], coord, coord_m, tile_sz=int(meta["tile_size"]),
            dt=np.dtype(meta.get("dtype", "uint8")),
            tile_st=meta.get("tile_st", [0, 0]),
            tile_ratio=meta.get("tile_ratio", 1.0), do_im=do_im)

    def loadchunk(self) -> None:
        """Materialize the current chunk into ``self.dataset``."""
        vols = [self._assemble(m, do_im=True) for m in self.metadata]
        labels = ([self._assemble(m, do_im=False)
                   for m in self.label_metadata]
                  if self.label_metadata else None)
        masks = ([self._assemble(m, do_im=False)
                  for m in self.valid_metadata]
                 if self.valid_metadata else None)
        kwargs = dict(self.volume_kwargs)
        if self.mode == "train":
            kwargs.setdefault("iter_num", self.chunk_iter)
        self.dataset = VolumeDataset(vols, labels, masks, **kwargs)


def load_volume_inputs(cfg, mode: str):
    """Load IMAGE_NAME/LABEL_NAME/VALID_MASK_NAME volumes with reflect
    padding (reference ``_get_input``, data/dataset/build.py:143-245,
    without the rescale/min-size paths PCTrans configs never set)."""
    root = cfg.DATASET.INPUT_PATH

    def _load(names, pad_mode="reflect"):
        if not names:
            return None
        out = []
        for n in _as_list(names):
            v = readvol(root + n if root and not n.startswith("/") else n)
            pad = cfg.DATASET.PAD_SIZE
            if max(pad) > 0:
                width = [(p, p) for p in pad]
                if v.ndim == 4:
                    width = [(0, 0)] + width
                v = np.pad(v, width, pad_mode)
            out.append(v)
        return out

    img = _load(cfg.DATASET.IMAGE_NAME)
    lab = _load(cfg.DATASET.LABEL_NAME) if mode != "test" else None
    vm = _load(cfg.DATASET.get("VALID_MASK_NAME", None)) if mode != "test" else None
    return img, lab, vm
