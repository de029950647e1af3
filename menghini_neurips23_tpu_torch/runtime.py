"""ClipRuntime: frozen CLIP on one device + batched tower passes.

The runtime owns what the strategies share: the frozen CLIP module on its
device, the tokenizer, and the batched frozen-tower passes over image files.
It replaces the reference's `clip.load` + per-strategy `self.clip_model`.

Image passes take uint8 images: the CLIP normalization is folded into the
patch matmul (ops/patch_embed.py), so each batch crosses to the device as one
byte per pixel.  Decoding the next batch overlaps the device's work on the
current one.

The device defaults to CUDA; `device="cpu"` must be asked for explicitly
(the tests do), and a missing card raises instead of falling back.

In a process group (parallel/) a batched pass splits every global batch
over the data group: each rank decodes and encodes its block of it, and
the blocks are gathered back in file order, so every rank returns the whole
pass.  Each rank loads the whole checkpoint and keeps the frozen model, or
under a 'model' axis (`MESH_SHAPE "d,m"`, m > 1) its model rank's shard of
the towers (parallel/tensor.py); the m ranks of a model group take the
same block of every batch.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.models import (
    build_clip,
    get_arch,
    init_clip_params,
    load_clip,
    precast_matmul_params,
)
from menghini_neurips23_tpu_torch.parallel import multihost, tensor
from menghini_neurips23_tpu_torch.parallel.mesh import check_model_axis, mesh_from_config

log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """None -> CUDA.  Raises if CUDA is asked for (explicitly or by default)
    and no card is present: nothing carries on on the CPU unless asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this package runs on the GPU by default - "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class ClipRuntime:
    """Frozen CLIP on one device + batched passes shared by all strategies."""

    def __init__(self, cfg: Config, device=None, tokenizer=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh_from_config(cfg)  # checks MESH_SHAPE against the process group
        dtype = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        if cfg.CLIP_CKPT:
            arch, state_dict = load_clip(cfg.CLIP_CKPT)
        else:
            arch = get_arch(cfg.VIS_ENCODER)
            state_dict = init_clip_params(arch, seed=0, device=self.device)
            if arch.name != "tiny-test":
                log.warning(
                    "No CLIP_CKPT given - using RANDOM %s weights (throughput "
                    "benchmarking only; supply a checkpoint for accuracy)",
                    arch.name,
                )
        self.arch = arch
        check_model_axis(self.mesh.model, arch)
        self.tp = tensor.from_layout()  # None without a 'model' axis
        self.model = build_clip(arch, state_dict, dtype, self.device, tp=self.tp)
        # not for multimodal runs, as in the JAX package (its UPT step keeps
        # fp32 weights); the zero-shot and CoOp towers take precast weights
        if (
            dtype == torch.bfloat16
            and getattr(cfg, "PRECAST_WEIGHTS", True)
            and getattr(cfg, "MODALITY", "text") != "multi"
        ):
            precast_matmul_params(self.model, dtype)
        if tokenizer is None:
            from menghini_neurips23_tpu_torch.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(cfg.BPE_PATH or None)
        self.tokenizer = tokenizer
        from menghini_neurips23_tpu_torch.ops.patch_embed import fold_normalization

        k_folded, bias = fold_normalization(
            self.model.visual.conv1_kernel.detach().cpu().numpy()
        )
        self._folded_kernel = (
            torch.from_numpy(k_folded).to(self.device),
            torch.from_numpy(bias).to(self.device),
        )
        # decoded-uint8 LRU: GRIP's refresh passes re-read the same pool
        # files; passes 2..N become RAM reads (data/loader.CachingImageLoader)
        from menghini_neurips23_tpu_torch.utils.cache import BoundedFeatureCache

        self._decode_cache = (
            BoundedFeatureCache(cfg.DECODE_CACHE_BYTES)
            if getattr(cfg, "DECODE_CACHE_BYTES", 0) > 0
            else None
        )

    def _default_loader(self):
        """The uint8 pipeline, wrapped with the decode cache when enabled."""
        from menghini_neurips23_tpu_torch.data.loader import CachingImageLoader, ImageLoader

        inner = ImageLoader(self.arch.image_resolution)
        if self._decode_cache is None:
            return inner
        return CachingImageLoader(inner, self._decode_cache)

    # ------------------------------------------------------- device passes
    def _folded_embed(self, images_u8: torch.Tensor) -> torch.Tensor:
        """vision_embed with the CLIP normalization folded into the patch
        matmul: uint8 pixels are cast on the device and go straight in."""
        from menghini_neurips23_tpu_torch.ops.patch_embed import patch_tokens

        kf, bias = self._folded_kernel
        x = patch_tokens(
            images_u8, kf, self.arch.vision_patch_size, self.compute_dtype, bias
        )
        return self.model.visual.tokens_from_patches(x)

    def _encode_images(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self.model.vision_encode_tokens(self._folded_embed(images_u8))

    def _encode_images_float(self, images_f32: torch.Tensor) -> torch.Tensor:
        """Float images already preprocessed by a USER transform: raw conv1
        matmul, no normalize folding (the transform's output feeds the tower
        directly - reference data/dataset.py:64-79)."""
        return self.model.vision_encode_tokens(self.model.vision_embed(images_f32))

    @property
    def logit_scale(self) -> float:
        return float(np.exp(self.model.logit_scale.detach().cpu().numpy()))

    # ------------------------------------------------------------- host-facing
    def encode_text(self, ids: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(C, T) ids -> (C, E) fp32 features."""
        ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            feats = self.model.encode_text(ids_t).float().cpu().numpy()
        if normalize:
            feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats

    def _batched_pass(
        self, fn, filepaths, batch_size: Optional[int] = None, cache=None, loader=None
    ):
        """Run a per-batch device fn over a file list; returns stacked np.

        The files go in global batches of `bs`.  In a process group each
        batch is split over the data group (`world` ranks; a model group's
        ranks share one block) into host-major blocks of ceil(bs / world) rows
        (`shard_filelist_for_batch`; the JAX package's
        `_batched_pass_multihost`, runtime.py:262-333): this rank decodes
        and encodes only its blocks, and every rank's rows are gathered back
        with exact unpadding, in file order, so every rank returns the whole
        pass.  Without a group the one rank's blocks are the batches.  Each
        block is padded to one shape for the device and its output unpadded;
        the next block decodes on a worker thread while the device runs the
        current one.

        :param cache: optional uint8 (N, R, R, 3) of pre-decoded images
            aligned with `filepaths` (no disk IO)
        :param loader: optional object with .load_all(files) -> (N,R,R,3)
            array and .out_dtype (e.g. TransformImageLoader for user
            transforms); default = the uint8 fast pipeline."""
        bs = batch_size or max(self.cfg.BATCH_SIZE, 32)
        if not len(filepaths):
            return np.empty((0,))
        t0 = time.perf_counter()
        loader = loader or self._default_loader()
        world, rank = multihost.data_count(), multihost.data_index()
        per = -(-bs // world)
        rows = np.arange(len(filepaths))
        blocks = [[multihost.shard_filelist_for_batch(rows[s : s + bs], per, r)
                   for s in range(0, len(rows), bs)] for r in range(world)]
        mine = [idx for idx in blocks[rank] if len(idx)]
        R = self.arch.image_resolution

        def make(idx):
            arr = (cache[np.asarray(idx)] if cache is not None
                   else loader.load_all([filepaths[i] for i in idx]))
            if arr.shape[0] < per:
                pad = np.zeros((per - arr.shape[0], R, R, 3), arr.dtype)
                arr = np.concatenate([arr, pad]) if arr.size else pad
            return arr, len(idx)

        def run(arr: np.ndarray, count: int) -> np.ndarray:
            imgs = torch.from_numpy(arr).to(self.device)
            with torch.inference_mode():
                out = fn(imgs)
            return out.float().cpu().numpy()[:count]

        outs = []
        with cf.ThreadPoolExecutor(1) as prefetcher:  # decode behind compute
            fut = prefetcher.submit(make, mine[0]) if mine else None
            for i in range(len(mine)):
                arr, count = fut.result()
                fut = prefetcher.submit(make, mine[i + 1]) if i + 1 < len(mine) else None
                outs.append(run(arr, count))
        if not outs:  # no rows on this rank: one padded block gives the rows' shape
            dtype = cache.dtype if cache is not None else loader.out_dtype
            outs.append(run(np.zeros((per, R, R, 3), dtype), 0))
        out = np.concatenate(outs)
        if multihost.is_initialized():  # at world size 1 too: the gather is exercised
            gathered = multihost.all_gather_rows(out)
            order = np.concatenate([np.asarray(idx, np.int64) for r in range(world)
                                    for idx in blocks[r]])
            out = np.empty_like(gathered)
            out[order] = gathered
        n = len(filepaths)
        if n >= 512:  # observability for the big pool passes
            dt = time.perf_counter() - t0
            log.info("batched pass: %d images in %.2fs (%.0f img/s)", n, dt, n / dt)
        return out

    def encode_images_from_files(
        self,
        filepaths: Sequence[str],
        normalize: bool = True,
        batch_size=None,
        cache=None,
        transform=None,
    ) -> np.ndarray:
        """Frozen image features for a file list: (N, E) fp32.

        :param transform: optional user transform (reference
            CustomDataset.transform) - honored via the per-item PIL path."""
        if transform is not None:
            from menghini_neurips23_tpu_torch.data.loader import TransformImageLoader

            feats = self._batched_pass(
                self._encode_images_float, filepaths, batch_size,
                loader=TransformImageLoader(self.arch.image_resolution, transform),
            )
        else:
            feats = self._batched_pass(self._encode_images, filepaths, batch_size, cache)
        if normalize and len(feats):
            feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats

    def vision_tokens_from_files(
        self, filepaths: Sequence[str], batch_size=None, cache=None, transform=None
    ) -> np.ndarray:
        """Pos-embedded CLS+patch tokens (N, 1+P, W) fp32 - the frozen,
        prompt-independent prefix of the vision tower, cached once for VPT/UPT
        training instead of recomputed every batch."""
        if transform is not None:
            from menghini_neurips23_tpu_torch.data.loader import TransformImageLoader

            return self._batched_pass(
                self.model.vision_embed, filepaths, batch_size,
                loader=TransformImageLoader(self.arch.image_resolution, transform),
            )
        return self._batched_pass(self._folded_embed, filepaths, batch_size, cache)
