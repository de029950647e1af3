"""Pseudolabel-pass traffic: whole zero-shot FPL passes over an unlabelled pool.

One unit is one pass, as every FPL, IFPL and GRIP run pays it: the classes'
zero-shot text features, the frozen vision encode of the whole pool in the
runtime's batches, K3's probabilities (`_zero_shot_probs`), then the top-K
leaderboard (`compute_pseudo_labels`, with no cache file).  The pool is
uint8 images made from the seed and served from the runtime's decoded-image
cache, as a GRIP refresh re-reads its pool.  Its work is the pool's images.

The check compares the last pass of the window: a sample of its rows
(features and probabilities) and the classes' text features against the
plain reference, and its whole selection against the frozen leaderboard on
its own probabilities.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import compare, flops as F, inputs, port
from portbench.reference import clip as rclip, leaderboard, tokenizer as rtok


class Driver:
    def __init__(self, ctx):
        self.cell, self.cfg, self.seed, self.device = ctx.cell, ctx.config, ctx.seed, ctx.device
        cell, cfg, seed = self.cell, self.cfg, self.seed
        C = cell["classes"]
        self.classes = inputs.class_names(seed, C, cell["class_words"], cell["class_letters"])
        self.label_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.n = cell["pool"]
        self.names = [f"img_{i:06d}.png" for i in range(self.n)]
        self.k = cell["pseudo_per_class"]

        from menghini_neurips23_tpu_torch.training.strategy import TrainingStrategy

        pcfg = port.port_config(cell, cfg, seed, PSEUDO_TOPK=cell["topk"])
        rt = port.runtime(pcfg, cfg, seed, self.device)
        ctx.log("runtime built")
        pool = port.images_host(seed, self.n, cfg["image_resolution"], self.device)
        self.paths = port.dataset(self.names).filepaths
        port.fill_decode_cache(rt, self.paths, pool)
        del pool
        self.strategy = TrainingStrategy(pcfg, self.label_to_idx, self.classes, self.classes,
                                         self.classes, runtime=rt)
        self.batch = max(pcfg.BATCH_SIZE, 32)  # the runtime's batch for a pass
        self.spans = []
        self._spy()
        ctx.log("strategy built")
        self.unit()  # warm-up
        ctx.log("warm-up pass done")
        self.spans.clear()

    def _spy(self):
        """Keep the last pass's image and text features for the check."""
        s, rt, kept = self.strategy, self.strategy.runtime, {}
        encode, text = rt.encode_images_from_files, s._zero_shot_text_features

        def encode_kept(*a, **kw):
            kept["img"] = encode(*a, **kw)
            return kept["img"]

        def text_kept(*a, **kw):
            kept["txt"] = text(*a, **kw)
            return kept["txt"]

        rt.encode_images_from_files, s._zero_shot_text_features = encode_kept, text_kept
        self.kept = kept

    def unit(self) -> int:
        from menghini_neurips23_tpu_torch.pseudo.engine import compute_pseudo_labels

        s = self.strategy
        ds = port.dataset(self.names)
        probs = s._zero_shot_probs(ds.filepaths, self.classes)
        t = time.perf_counter()
        compute_pseudo_labels(probs, ds, self.classes, self.label_to_idx, self.k, filename=None,
                              method=s.config.PSEUDO_TOPK, device=s.device)
        self.spans.append(time.perf_counter() - t)
        self.kept.update(probs=probs, selected=(list(ds.filepaths), list(ds.labels)))
        return self.n

    def counters(self):
        return port.launch_counters()

    def release(self):
        port.close(self.strategy)
        self.strategy = None

    # ---------------------------------------------------------------- facts
    def text_ids(self):
        return rtok.truncate(rtok.tokenize(rtok.template_prompts(self.classes)))

    def facts(self, units: int, counted: dict) -> dict:
        cfg, dt = self.cfg, self.cell["dtype"]
        C, E, N = self.cell["classes"], cfg["embed_dim"], self.n
        Tt = self.text_ids().shape[1]
        Wt, Ht, Lt = cfg["transformer_width"], cfg["transformer_heads"], cfg["transformer_layers"]
        Wv, Hv, Lv = cfg["vision_width"], cfg["vision_heads"], cfg["vision_layers"]
        p = cfg["vision_patch_size"]
        patches = (cfg["image_resolution"] // p) ** 2
        T = patches + 1
        per_pass = (F.tower_flops(C, Tt, Wt, Ht, Lt, True) + 2.0 * C * Wt * E
                    + 2.0 * N * patches * p * p * 3 * Wv
                    + F.tower_flops(N, T, Wv, Hv, Lv, False) + 2.0 * N * Wv * E
                    + F.head_flops(N, C, E))
        blocks = [min(self.batch, N - s) for s in range(0, N, self.batch)]
        k1 = [(C, Tt, Ht, Wt // Ht, True, Lt * units)]
        k1 += [(b, T, Hv, Wv // Hv, False, Lv * units) for b in blocks]
        return {"dtype": dt, "flops": per_pass * units, "images": N * units, "k1": k1, "k2": [],
                "k3": [(N, C, E, units)], "leaderboard_s": list(self.spans[-units:]),
                "counted": counted}

    # ---------------------------------------------------------------- check
    def check(self, variants=("program",)):
        """Readings of each variant against the reference in fp32: the
        program's last pass; 'control', the reference in TF32."""
        cfg, dev, kept = self.cfg, self.device, self.kept
        rows = np.sort(np.random.default_rng(inputs.sub_seed(self.seed, "check_rows")).choice(
            self.n, size=min(self.cell["check_rows"], self.n), replace=False))
        sd = inputs.clip_weights(cfg, self.seed, dev)
        imgs = inputs.images(self.seed, self.n, cfg["image_resolution"], dev)
        ids = torch.tensor(self.text_ids(), device=dev)
        scale = float(sd["logit_scale"].exp())
        rows_t = torch.tensor(rows, device=dev)

        def run(tf32):
            with rclip.precision(tf32), torch.no_grad():
                txt = rclip.normalize(rclip.text_features(sd, cfg, ids))
                img = torch.cat([
                    rclip.normalize(rclip.image_features(
                        sd, cfg, rclip.image_tokens(sd, cfg, imgs[rows_t[s : s + 32]])))
                    for s in range(0, len(rows), 32)])
                probs = (scale * img @ txt.T).softmax(-1)
            return {"img": img.cpu().numpy(), "txt": txt.cpu().numpy(),
                    "probs": probs.cpu().numpy()}

        ref = run(False)
        out = {}
        for v in variants:
            if v == "program":
                got = {"img": kept["img"][rows], "txt": kept["txt"], "probs": kept["probs"][rows]}
            else:
                got = run(True)
            r = compare.pass_gaps(got, ref)
            if v == "program":
                r["selection_diff"] = compare.selection_diff(kept["selected"], leaderboard.top_k(
                    kept["probs"], self.paths, self.k, list(range(self.cell["classes"]))))
            else:
                r["selection_diff"] = 0
            out[v] = r
        return out
