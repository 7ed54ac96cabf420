"""Volumetric data IO: HDF5 / TIFF / PNG volumes and tile stitching (a copy
of ``pctrans_tpu/data/volume_io.py``, which imports no JAX; cv2, PIL, h5py
and imageio are imported inside the functions that use them).

Equivalent of the reference ``connectomics/data/utils/data_io.py``: the
volume readers (``readvol``:42, ``readh5``:34, ``readimg_as_vol``:17,
``readimgs``:94), writers (``writeh5``:114, ``savevol``:71), the TileDataset
metadata builder (``create_json``:128) and the tile stitcher
(``tile2volume``:186 with ``vast2Seg``:176 24-bit RGB label decoding).

PIL replaces imageio (not in this image); TIFF multi-page volumes load
through PIL's frame interface (tifffile is absent — the common uint8/uint16
single-plane-per-frame files the reference reads are supported, exotic BigTIFF
layouts are not).
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional

import numpy as np
from scipy.ndimage import zoom


def _imread(path: str) -> np.ndarray:
    # cv2 IMREAD_UNCHANGED preserves bit depth (PIL silently converts
    # 16-bit RGB PNGs to 8-bit "RGB" mode); channels reordered to RGB for
    # parity with the reference's imageio loader
    import cv2

    data = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if data is None:  # formats cv2 can't parse: fall back to PIL
        from PIL import Image

        with Image.open(path) as im:
            return np.array(im)
    if data.ndim == 3 and data.shape[2] >= 3:
        data = np.ascontiguousarray(
            np.concatenate([data[..., 2::-1], data[..., 3:]], axis=2))
    return data


def _tiffread_volume(path: str) -> np.ndarray:
    from PIL import Image

    frames = []
    with Image.open(path) as im:
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            frames.append(np.array(im))
    return np.squeeze(np.stack(frames, 0))


def readh5(filename: str, dataset: Optional[str] = None) -> np.ndarray:
    import h5py

    with h5py.File(filename, "r") as fid:
        if dataset is None:
            dataset = list(fid)[0]  # first dataset in the file
        return np.array(fid[dataset])


def readimg_as_vol(filename: str, drop_channel: bool = False) -> np.ndarray:
    """One image file -> (c, y, x) or (1, y, x) volume (data_io.py:17-31)."""
    data = _imread(filename)
    if data.ndim == 3 and not drop_channel:
        return data.transpose(2, 0, 1)
    if drop_channel and data.ndim == 3:
        # preserve the source dtype (reference data_io.py keeps orig_dtype);
        # hardcoding uint8 truncated 16-bit microscopy values mod 256
        data = np.mean(data, axis=-1).astype(data.dtype)
    return data[None]


def readimgs(filename: str) -> np.ndarray:
    """Glob pattern -> stacked (z, y, x[, c]) volume (data_io.py:94-111)."""
    filelist = sorted(glob.glob(filename))
    assert filelist, f"no images match {filename}"
    first = _imread(filelist[0])
    data = np.zeros((len(filelist),) + first.shape, np.uint8)
    data[0] = first
    for i in range(1, len(filelist)):
        data[i] = _imread(filelist[i])
    return data


def readvol(filename: str, dataset: Optional[str] = None,
            drop_channel: bool = False) -> np.ndarray:
    """Load an HDF5/TIFF/PNG volume as (z, y, x) or (c, z, y, x)
    (data_io.py:42-68)."""
    suf = filename[filename.rfind(".") + 1:]
    if suf in ("h5", "hdf5"):
        data = readh5(filename, dataset)
    elif "tif" in suf:
        data = _tiffread_volume(filename)
        if data.ndim == 4:  # (z, c, y, x) -> (c, z, y, x)
            data = data.transpose(1, 0, 2, 3)
    elif "png" in suf:
        data = readimgs(filename)
        if data.ndim == 4:  # (z, y, x, c) -> (c, z, y, x)
            data = data.transpose(3, 0, 1, 2)
    else:
        raise ValueError(f"unrecognizable file format for {filename}")
    assert data.ndim in (3, 4)
    if drop_channel and data.ndim == 4:
        data = np.mean(data, axis=0).astype(data.dtype)
    return data


def writeh5(filename: str, dtarray, dataset="main") -> None:
    import h5py

    with h5py.File(filename, "w") as fid:
        if isinstance(dataset, list):
            for i, dd in enumerate(dataset):
                ds = fid.create_dataset(dd, dtarray[i].shape,
                                        compression="gzip",
                                        dtype=dtarray[i].dtype)
                ds[:] = dtarray[i]
        else:
            ds = fid.create_dataset(dataset, dtarray.shape,
                                    compression="gzip", dtype=dtarray.dtype)
            ds[:] = dtarray


def savevol(filename: str, vol: np.ndarray, dataset: str = "main",
            format: str = "h5") -> None:
    if format == "h5":
        writeh5(filename, vol, dataset=dataset)
    elif format == "png":
        from PIL import Image

        os.makedirs(filename, exist_ok=True)
        for i in range(vol.shape[0]):
            Image.fromarray(vol[i]).save(os.path.join(filename, f"{i:04d}.png"))
    elif format in ("tif", "tiff"):
        import imageio

        imageio.volwrite(filename, vol)  # reference data_io.py savevol
    else:
        raise ValueError(f"Unknown savevol format: {format!r}")


def create_json(ndim: int = 1, dtype: str = "uint8",
                data_path: str = "/path/to/data/", height: int = 10000,
                width: int = 10000, depth: int = 500, n_columns: int = 3,
                n_rows: int = 3, tile_size: int = 4096, tile_ratio: int = 1,
                tile_st: List[int] = (0, 0)) -> dict:
    """TileDataset metadata dict (data_io.py:128-170)."""
    digits = int(math.log10(depth)) + 1
    return {
        "ndim": ndim, "dtype": dtype,
        "image": [data_path + str(i).zfill(digits) + r"/{row}_{column}.png"
                  for i in range(depth)],
        "height": height, "width": width, "depth": depth,
        "n_columns": n_columns, "n_rows": n_rows,
        "tile_size": tile_size, "tile_ratio": tile_ratio,
        "tile_st": list(tile_st),
    }


def vast2Seg(seg: np.ndarray) -> np.ndarray:
    """24-bit RGB label image -> int id map (data_io.py:176-183)."""
    if seg.ndim == 2 or seg.shape[-1] == 1:
        return np.squeeze(seg)
    r = seg[..., 0].astype(np.uint32)
    g = seg[..., 1].astype(np.uint32)
    b = seg[..., 2].astype(np.uint32)
    return r * 65536 + g * 256 + b


def tile2volume(tiles: List[str], coord: List[int], coord_m: List[int],
                tile_sz: int, dt=np.uint8, tile_st: List[int] = (0, 0),
                tile_ratio: float = 1.0, do_im: bool = True,
                background: int = 128) -> np.ndarray:
    """Assemble the (z0..z1, y0..y1, x0..x1) crop of a tiled dataset
    (data_io.py:186-250): per z a tile-path pattern with {row}/{column}
    placeholders; out-of-dataset borders reflect-padded."""
    z0o, z1o, y0o, y1o, x0o, x1o = coord
    z0m, z1m, y0m, y1m, x0m, x1m = coord_m
    # out-of-dataset border amounts; the reference's max(-z0o, z0m)
    # (data_io.py:223) only equals this for zero-origin datasets
    bd = [max(0, z0m - z0o), max(0, z1o - z1m), max(0, y0m - y0o),
          max(0, y1o - y1m), max(0, x0m - x0o), max(0, x1o - x1m)]
    z0, y0, x0 = max(z0o, z0m), max(y0o, y0m), max(x0o, x0m)
    z1, y1, x1 = min(z1o, z1m), min(y1o, y1m), min(x1o, x1m)

    result = background * np.ones((z1 - z0, y1 - y0, x1 - x0), dt)
    c0, c1 = x0 // tile_sz, (x1 + tile_sz - 1) // tile_sz
    r0, r1 = y0 // tile_sz, (y1 + tile_sz - 1) // tile_sz
    for z in range(z0, z1):
        pattern = tiles[z]
        for row in range(r0, r1):
            for column in range(c0, c1):
                if r"{row}_{column}" in pattern:
                    path = pattern.format(row=row + tile_st[0],
                                          column=column + tile_st[1])
                else:
                    path = pattern
                if not os.path.exists(path):
                    continue
                patch = _imread(path)
                if patch.ndim == 2:
                    patch = patch[:, :, None]
                if tile_ratio != 1:  # linear for images, nearest for labels
                    patch = zoom(patch, [tile_ratio, tile_ratio, 1],
                                 order=int(do_im))
                xp0 = column * tile_sz
                yp0 = row * tile_sz
                x0a, x1a = max(x0, xp0), min(x1, xp0 + patch.shape[1])
                y0a, y1a = max(y0, yp0), min(y1, yp0 + patch.shape[0])
                if x1a <= x0a or y1a <= y0a:
                    continue
                crop = patch[y0a - yp0 : y1a - yp0, x0a - xp0 : x1a - xp0]
                if do_im:
                    result[z - z0, y0a - y0 : y1a - y0,
                           x0a - x0 : x1a - x0] = crop[..., 0]
                else:
                    result[z - z0, y0a - y0 : y1a - y0,
                           x0a - x0 : x1a - x0] = vast2Seg(crop)
    if max(bd) > 0:
        result = np.pad(result, ((bd[0], bd[1]), (bd[2], bd[3]),
                                 (bd[4], bd[5])), "reflect")
    return result
