"""Batched host->device image pipeline.

Replaces the reference's torch DataLoader + per-image PIL transform
(reference data/dataset.py:56-89 plus the batch-size-1 pseudolabel loop,
utils/clip_pseudolabels.py:31-44) with:

- a thread pool decoding/resizing to uint8 on the host,
- fixed-size batches (last batch zero-padded, with a validity count) so every
  device batch has one shape,
- optional in-RAM uint8 caching for the small train/val splits that are
  iterated for 150 epochs.

Normalization happens on the device, folded into the patch matmul
(ops/patch_embed.py).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from menghini_neurips23_tpu_torch.data.transforms import load_image


class Batch(NamedTuple):
    images: np.ndarray  # uint8 (B, R, R, 3), zero-padded to B
    labels: np.ndarray  # int32 (B,), -1 where padded/unlabeled
    index: np.ndarray  # int32 (B,) global sample indices, -1 where padded
    count: int  # number of valid samples in this batch


def _pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = [(0, size - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


class ImageLoader:
    """Loads/caches preprocessed uint8 images for a list of filepaths.

    Uses the C++ fast loader (native/fastloader.cpp: threaded libjpeg/libpng
    decode + Pillow-compatible bicubic resize + center crop) when available,
    falling back to PIL per file otherwise (MNT_NATIVE_LOADER=0 disables)."""

    out_dtype = np.uint8

    def __init__(self, resolution: int, num_workers: int = 8):
        self.resolution = resolution
        self.num_workers = num_workers

    def load_all(self, filepaths: Sequence[str]) -> np.ndarray:
        """Decode all files into one uint8 (N, R, R, 3) array."""
        R = self.resolution
        out = np.empty((len(filepaths), R, R, 3), np.uint8)
        if not filepaths:
            return out
        from menghini_neurips23_tpu_torch.data._native import get_fastloader

        native = get_fastloader()
        todo = list(range(len(filepaths)))
        if native is not None:
            raw, ok = native.decode_batch(list(filepaths), R, self.num_workers)
            arr = np.frombuffer(raw, np.uint8).reshape(len(filepaths), R, R, 3)
            done = [i for i in todo if ok[i]]
            out[done] = arr[done]
            todo = [i for i in todo if not ok[i]]
        if todo:
            # files the native decoder rejected fall back to PIL; a file
            # neither can decode must fail NAMING the file (a bare
            # "Truncated File Read" is useless inside a 16k-image pool)
            def _load(i):
                try:
                    return load_image(filepaths[i], R)
                except Exception as e:
                    raise OSError(
                        f"cannot decode image {filepaths[i]!r}: {e}"
                    ) from e

            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for i, img in zip(todo, pool.map(_load, todo)):
                    out[i] = img
        return out


class CachingImageLoader:
    """Wraps an ImageLoader with a byte-capped decoded-uint8 LRU keyed by
    path.  GRIP's iterative refreshes re-read the same pool files every
    iteration (reference re-opens each image per pass,
    utils/clip_pseudolabels.py:31-44); the cache turns passes 2..N into pure
    RAM reads.  ~150 KB per 224px image -> a 2 GB default cap holds a ~13k
    pool."""

    out_dtype = np.uint8

    def __init__(self, inner, cache):
        self.inner = inner
        self.cache = cache  # BoundedFeatureCache
        self.resolution = inner.resolution

    def load_all(self, filepaths: Sequence[str]) -> np.ndarray:
        R = self.resolution
        have = self.cache.get_or_fill(filepaths, self.inner.load_all)
        if not filepaths:
            return np.empty((0, R, R, 3), np.uint8)
        return np.stack([have[p] for p in filepaths])


class TransformImageLoader:
    """Per-item PIL decode + USER transform - the honored fast-path version of
    the reference's `self.transform` application in CustomDataset.__getitem__
    (reference data/dataset.py:64-79).  The transform's output feeds the model
    directly (no CLIP re-normalization), exactly as the reference's DataLoader
    stacks transform outputs into the model batch.

    Accepts transform outputs that are torch tensors / numpy arrays in CHW or
    HWC layout; output is float32 (N, R, R, 3)."""

    out_dtype = np.float32

    def __init__(self, resolution: int, transform, num_workers: int = 8):
        self.resolution = resolution
        self.transform = transform
        self.num_workers = num_workers

    def _one(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as img:
            out = self.transform(img.convert("RGB"))
        arr = np.asarray(out, np.float32)
        R = self.resolution
        if arr.ndim != 3:
            raise ValueError(
                f"custom transform returned shape {arr.shape} for {path!r}; "
                f"expected a 3D (C,{R},{R}) or ({R},{R},C) image"
            )
        if arr.shape[0] == 3 and arr.shape[1] == R and arr.shape[2] == R:
            arr = arr.transpose(1, 2, 0)  # torch CHW -> HWC
        if arr.shape != (R, R, 3):
            raise ValueError(
                f"custom transform returned shape {arr.shape} for {path!r}; "
                f"the model needs ({R},{R},3) (or (3,{R},{R})) at the "
                f"encoder's native resolution"
            )
        return arr

    def load_all(self, filepaths: Sequence[str]) -> np.ndarray:
        R = self.resolution
        if not filepaths:
            return np.empty((0, R, R, 3), np.float32)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            arrs = list(pool.map(self._one, filepaths))
        return np.stack(arrs)


def iter_image_batches(
    filepaths: Sequence[str],
    batch_size: int,
    resolution: int,
    labels: Optional[Sequence[int]] = None,
    shuffle: bool = False,
    seed: int = 0,
    cache: Optional[np.ndarray] = None,
    num_workers: int = 8,
    drop_remainder: bool = False,
) -> Iterator[Batch]:
    """Yield fixed-shape Batches; decodes with a double-buffered thread pool.

    :param cache: optional uint8 (N, R, R, 3) of pre-decoded images aligned
        with `filepaths`; when given no disk IO happens.
    """
    n = len(filepaths)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    labels_arr = (
        np.asarray(labels, np.int32) if labels is not None else np.full(n, -1, np.int32)
    )

    loader = ImageLoader(resolution, num_workers)

    def make_batch(idx: np.ndarray) -> Batch:
        if cache is not None:
            imgs = cache[idx]
        else:
            imgs = loader.load_all([filepaths[i] for i in idx])
        count = len(idx)
        return Batch(
            images=_pad_to(imgs, batch_size),
            labels=_pad_to(labels_arr[idx], batch_size, fill=-1),
            index=_pad_to(idx.astype(np.int32), batch_size, fill=-1),
            count=count,
        )

    steps: List[np.ndarray] = [
        order[s : s + batch_size] for s in range(0, n, batch_size)
    ]
    if drop_remainder and steps and len(steps[-1]) < batch_size:
        steps = steps[:-1]

    if cache is not None:
        for idx in steps:
            yield make_batch(idx)
        return

    # double-buffer disk decode behind compute
    with cf.ThreadPoolExecutor(1) as prefetcher:
        future = prefetcher.submit(make_batch, steps[0]) if steps else None
        for i in range(len(steps)):
            batch = future.result()
            future = (
                prefetcher.submit(make_batch, steps[i + 1])
                if i + 1 < len(steps)
                else None
            )
            yield batch


def num_batches(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    if drop_remainder:
        return n // batch_size
    return (n + batch_size - 1) // batch_size
