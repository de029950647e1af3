"""Training traffic: whole `TrainingStrategy.train()` calls of the whole-run
trainer, back to back, on a fixed FPL training set.

The cell file fixes the paradigm (ssl: labelled rows plus pseudolabels on
two loss groups; ul: pseudolabels only), the classes and rows per class,
the batch, the prompt and the epochs of one call.  Pseudolabels are drawn
from the seed (`pseudo_per_class` rows of each class); the port splits them
80/20 into training and pseudo-validation rows as its FPL merge does, and
every call re-runs that merge, as an IFPL/GRIP iteration does.

Set-up builds one strategy and makes its first call from the seed's
prompt: that call captures the step and epoch-end graphs (kept for the
strategy's life, as IFPL/GRIP keep them) and is the program's reading for
the check: its first `check_steps` steps (read after each replay of the
step graph), its final and best prompts and its per-epoch validation
metric.  The window's calls go on from its final prompt.  A unit is one
call; its work is epochs x training rows.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from portbench.harness import compare, flops as F, inputs, port
from portbench.reference import clip as rclip, steps as rsteps, tokenizer as rtok


class Driver:
    def __init__(self, ctx):
        self.cell, self.cfg, self.seed, self.device = ctx.cell, ctx.config, ctx.seed, ctx.device
        cell, cfg, seed = self.cell, self.cfg, self.seed
        C = cell["classes"]
        self.classes = inputs.class_names(seed, C, cell["class_words"], cell["class_letters"])
        self.label_to_idx = {c: i for i, c in enumerate(self.classes)}
        n_lab = C * cell["labelled_per_class"]
        n_val = C * cell["val_labelled_per_class"]
        n_pseudo = C * cell["pseudo_per_class"]
        self.lab_y = inputs.balanced_labels(seed, "labelled", C, cell["labelled_per_class"])
        self.val_y = inputs.balanced_labels(seed, "val", C, cell["val_labelled_per_class"])
        self.pseudo_y = inputs.balanced_labels(seed, "pseudo", C, cell["pseudo_per_class"])
        self.n_images = n_lab + n_val + n_pseudo
        names = [f"img_{i:06d}.png" for i in range(self.n_images)]
        self.lab_names = names[:n_lab]
        self.val_names = names[n_lab : n_lab + n_val]
        self.pseudo_names = names[n_lab + n_val :]
        self.epochs = cell["epochs_per_call"]
        self.wd = cell["decay"]
        self.optim_seed = inputs.sub_seed(seed, "optim", 31)
        self.n_train = int(n_pseudo * 0.8) + (n_lab if cell["paradigm"] == "ssl" else 0)
        self.modality = "text" if "textual" in cell["model"] else "image"
        width = cfg["transformer_width"] if self.modality == "text" else cfg["vision_width"]
        self.p0 = inputs.prompt_init(seed, (cell["prefix_size"], width))
        self.strategy = None
        if getattr(ctx, "reference_only", False):
            return

        from menghini_neurips23_tpu_torch.training.textual import TextualStrategy
        from menghini_neurips23_tpu_torch.training.visual import VisualStrategy

        pcfg = port.port_config(
            cell, cfg, seed, EPOCHS=self.epochs, SCHEDULER=cell["scheduler"],
            WARMUP_EPOCHS=cell["warmup_epochs"], LR=cell["lr"], DECAY=cell["decay"],
            MOMENTUM=cell["momentum"], FUSED_TRAIN=True)
        rt = port.runtime(pcfg, cfg, seed, self.device)
        ctx.log("runtime built")
        pool = port.images_host(seed, self.n_images, cfg["image_resolution"], self.device)
        lab = port.dataset(self.lab_names, [self.classes[y] for y in self.lab_y], label_id=False,
                           label_map=self.label_to_idx)
        self.val = port.dataset(self.val_names, [int(y) for y in self.val_y])
        self.pseudo = port.dataset(self.pseudo_names, [int(y) for y in self.pseudo_y])
        port.fill_decode_cache(rt, lab.filepaths + self.val.filepaths + self.pseudo.filepaths,
                               pool)
        self.lab = lab
        del pool
        cls = {"text": TextualStrategy, "image": VisualStrategy}[pcfg.MODALITY]
        self.strategy = cls(pcfg, self.label_to_idx, self.classes, self.classes, self.classes,
                            runtime=rt)
        self.strategy._fused_keep = True  # the program outlives a call, as in IFPL/GRIP
        assert pcfg.MODALITY == self.modality and pcfg.OPTIM_SEED == self.optim_seed
        self.strategy._set_prompt_tree({"prefix": self.p0})

        ctx.log("strategy built")
        self.prog = self._first_call()
        ctx.log("first call done")
        if self._last_n_train != self.n_train:
            raise RuntimeError(f"the port's FPL merge gave {self._last_n_train} training rows, "
                               f"the cell {self.n_train}")

    # ------------------------------------------------------------- the work
    def unit(self) -> int:
        s = self.strategy
        train = s._merge_pseudo(copy.deepcopy(self.lab), copy.deepcopy(self.pseudo))
        self._last_n_train = len(train.filepaths)
        self._last_out = s.train(train, copy.deepcopy(self.val), None, only_seen=False)
        return self.epochs * self._last_n_train

    def _first_call(self):
        """The first call, from the seed's prompt, through the window's own
        entry.  Read after the step graph's replays, for each epoch: its
        start prompt, its first steps' losses, the optimizer's buffer after
        its first step (with no momentum g + wd * p), its prompt after the
        first steps and at its end; and the call's own outputs: each epoch's
        validation metric as rows, the best and the final prompt."""
        first, steps = self.cell["check_steps"], math.ceil(self.n_train / self.cell["batch_size"])
        epochs = [{"losses": []} for _ in range(self.epochs)]
        epochs[0]["start"] = self.p0.astype(np.float64)
        replays = [0]

        def after(prog):
            e, j = divmod(replays[0], steps)
            replays[0] += 1
            if e >= self.epochs:
                return
            rec = epochs[e]
            if j < first:
                rec["losses"].append(float(prog.loss))
            if j == 0:
                rec["grad1"] = _host(prog.mom["prefix"]) - self.wd * rec["start"]
            if j == first - 1:
                rec["p_first"] = _host(prog.prompt["prefix"])
            if j == steps - 1:
                rec["end"] = _host(prog.prompt["prefix"])
                if e + 1 < self.epochs:
                    epochs[e + 1]["start"] = rec["end"]

        stop = port.watch_steps(self.strategy, after)
        try:
            self.unit()
        finally:
            stop()
        if replays[0] != steps * self.epochs or steps < first:
            raise RuntimeError(f"the first call ran {replays[0]} steps, the cell "
                               f"{steps} x {self.epochs} epochs (and at least {first} an epoch)")
        s, n_val = self.strategy, self._n_val()
        for rec, m in zip(epochs, s._fused_info["stats"][0]):
            rec["val_correct"] = int(round(float(m) * n_val))
            for k in ("start", "grad1", "p_first", "end"):
                rec[k] = {"prefix": rec[k]}
        return {"epochs": epochs, "best": {"prefix": np.asarray(self._last_out[1][0], np.float64)},
                "final": {"prefix": _host(s._get_prompt_tree()["prefix"])}}

    def counters(self):
        return port.launch_counters()

    def release(self):
        port.close(self.strategy)
        self.strategy = None

    # ---------------------------------------------------------------- facts
    def _shapes(self):
        """(tower, rows a step, T, width, heads, layers, causal)."""
        cell, cfg = self.cell, self.cfg
        C, L = cell["classes"], cell["prefix_size"]
        if self.modality == "text":
            return ("text", C, self._coop_ids().shape[1], cfg["transformer_width"],
                    cfg["transformer_heads"], cfg["transformer_layers"], True)
        T = 1 + L + (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2
        return ("visual", cell["batch_size"], T, cfg["vision_width"], cfg["vision_heads"],
                cfg["vision_layers"], False)

    def _n_val(self):
        n_pseudo = len(self.pseudo_names)
        return len(self.val_names) + n_pseudo - int(n_pseudo * 0.8)

    def facts(self, units: int, counted: dict) -> dict:
        """The algorithm's work in `units` calls, and the K1/K2 launches by shape."""
        cell, cfg, dt = self.cell, self.cfg, self.cell["dtype"]
        E = cfg["embed_dim"]
        C, bs = cell["classes"], cell["batch_size"]
        n, n_val = self.n_train, self._n_val()
        steps = math.ceil(self.n_train / bs)
        kind, B, T, W, H, layers, causal = self._shapes()
        D = W // H
        if kind == "text":
            step = (F.tower_flops(C, T, W, H, layers, True)
                    + F.tower_flops(C, T, W, H, layers, True, backward=True)
                    + 2 * 2.0 * C * W * E)  # projection, forward and input gradient
            logits = 2 * 2.0 * n * C * E  # per epoch over every row: forward and dgrad
            epoch_end = F.tower_flops(C, T, W, H, layers, True) + 2.0 * C * W * E \
                + 2.0 * n_val * C * E
            k1 = [(C, T, H, D, True, steps * layers + layers)]
            k2 = [(C, T, H, D, True, steps * layers)]
            per_epoch = steps * step + logits + epoch_end
        else:
            per_row = (F.tower_flops(1, T, W, H, layers, False)
                       + F.tower_flops(1, T, W, H, layers, False, backward=True)
                       + 2 * 2.0 * W * E + 2 * 2.0 * C * E)
            val_rows = 256  # the image strategies validate in chunks of this many rows
            chunks = [min(val_rows, n_val - s) for s in range(0, n_val, val_rows)]
            epoch_end = sum(F.tower_flops(r, T, W, H, layers, False) for r in chunks) \
                + n_val * (2.0 * W * E + 2.0 * C * E)
            k1 = [(B, T, H, D, False, steps * layers)] + [(r, T, H, D, False, layers)
                                                          for r in chunks]
            k2 = [(B, T, H, D, False, steps * layers)]
            per_epoch = n * per_row + epoch_end
        epochs = units * self.epochs
        k1 = [s[:5] + (s[5] * epochs,) for s in k1]
        k2 = [s[:5] + (s[5] * epochs,) for s in k2]
        return {"dtype": dt, "flops": per_epoch * epochs, "steps": steps * epochs,
                "rows": self.n_train * epochs, "k1": k1, "k2": k2, "counted": counted}

    # ---------------------------------------------------------------- check
    def _coop_ids(self):
        return rtok.truncate(rtok.tokenize(rtok.coop_prompts(self.classes,
                                                            self.cell["prefix_size"])))

    def _rows(self):
        """The first call's data as the reference reads it: each epoch's
        batches of (image, label, group), and the validation rows (image,
        label).  The FPL split is the port's merge's (numpy's global seed
        0, 80% of the pseudolabels), the permutations the strategy's
        generator's first draws, one an epoch."""
        cell = self.cell
        n_pseudo = len(self.pseudo_names)
        np.random.seed(0)  # the method's validation_seed
        tr = np.random.choice(range(n_pseudo), size=int(n_pseudo * 0.8), replace=False)
        n_lab, n_val = len(self.lab_names), len(self.val_names)
        base = n_lab + n_val
        rows = [(base + i, int(self.pseudo_y[i]), 1 if cell["paradigm"] == "ssl" else 0)
                for i in tr]
        if cell["paradigm"] == "ssl":
            rows += [(i, int(self.lab_y[i]), 0) for i in range(n_lab)]
            w0, w1 = len(tr) / n_lab, 1.0
        else:
            w0, w1 = 1.0, 0.0
        held = sorted(set(range(n_pseudo)) - set(int(i) for i in tr))
        val = [(n_lab + i, int(self.val_y[i])) for i in range(n_val)]
        val += [(base + i, int(self.pseudo_y[i])) for i in held]
        rng = np.random.default_rng(self.optim_seed)
        bs = cell["batch_size"]
        epochs = []
        for _ in range(self.epochs):
            perm = rng.permutation(len(rows))
            epochs.append([[rows[i] for i in perm[s : s + bs]] for s in range(0, len(rows), bs)])
        return epochs, val, w0, w1

    def check(self, variants=("program",)):
        """Readings of each variant, judged in fp32 stage by stage from its
        own prompts: the program's first call; 'control', the reference's
        call in TF32; 'fault_half', the reference's call leaving out half of
        every batch."""
        cell, cfg, dev = self.cell, self.cfg, self.device
        epochs, val, w0, w1 = self._rows()
        lrs = [cell["lr"] * _cosine(e, cell["warmup_epochs"], self.epochs)
               for e in range(self.epochs)]
        sd = inputs.clip_weights(cfg, self.seed, dev)
        imgs = inputs.images(self.seed, self.n_images, cfg["image_resolution"], dev)
        scale = float(sd["logit_scale"].exp())
        val_idx = torch.tensor([r[0] for r in val], device=dev)
        val_y = np.asarray([r[1] for r in val])
        first = cell["check_steps"]

        def tokens(idx):
            return rclip.image_tokens(sd, cfg, imgs[idx])

        def reference(tf32):
            """(logits fn, batch maker, validation fn) in fp32 or TF32."""
            with rclip.precision(tf32), torch.no_grad():
                if self.modality == "text":
                    feats = torch.cat([
                        rclip.normalize(rclip.image_features(sd, cfg, tokens(
                            torch.arange(s, min(s + 256, self.n_images), device=dev))))
                        for s in range(0, self.n_images, 256)])
                    fn = rsteps.coop_logits_fn(sd, cfg, torch.tensor(self._coop_ids(), device=dev),
                                               scale)
                    val_feats = feats[val_idx]

                    def make(rows):
                        return {"feats": feats[torch.tensor([r[0] for r in rows], device=dev)]}

                    def val_fn(p):
                        return fn(p, {"feats": val_feats}, slice(None))
                else:
                    ids = rtok.truncate(rtok.tokenize(rtok.template_prompts(self.classes)))
                    txt = rclip.normalize(rclip.text_features(sd, cfg, torch.tensor(ids, device=dev)))
                    fn = rsteps.vpt_logits_fn(sd, cfg, txt, scale)

                    def make(rows):
                        with torch.no_grad():
                            return {"tokens": tokens(torch.tensor([r[0] for r in rows], device=dev))}

                    def val_fn(p):
                        return torch.cat([fn(p, {"tokens": tokens(val_idx[s : s + 32])},
                                             slice(None)) for s in range(0, len(val), 32)])

            def make_batch(rows):
                return dict(make(rows), labels=torch.tensor([r[1] for r in rows], device=dev),
                            groups=torch.tensor([r[2] for r in rows], device=dev))

            return fn, make_batch, val_fn

        def call(tf32, fault=""):
            """The reference's whole call from the seed's prompt, as readings."""
            fn, make_batch, val_fn = reference(tf32)
            with rclip.precision(tf32):
                recs = rsteps.train_call(fn, make_batch, torch.tensor(self.p0, device=dev), epochs,
                                         lrs, self.wd, w0, w1, first, val_fn, fault)
            out = []
            for r in recs:
                e = {k: {"prefix": _host(r[k])} for k in ("start", "grad1", "p_first", "end")}
                e["losses"] = r["losses"]
                e["val_correct"] = int((r["val_logits"].argmax(1).cpu().numpy() == val_y).sum())
                out.append(e)
            best = out[int(np.argmax([e["val_correct"] for e in out]))]["end"]
            return {"epochs": out, "best": best, "final": out[-1]["end"]}

        fn, make_batch, val_fn = reference(False)

        def judge(got):
            """The fp32 reference from each of `got`'s epoch starts."""
            ref = {"epochs": []}
            with rclip.precision(False):
                for e, rec in enumerate(got["epochs"]):
                    start = torch.tensor(rec["start"]["prefix"], dtype=torch.float32, device=dev)
                    r = rsteps.train_call(fn, make_batch, start, [epochs[e][:first]], [lrs[e]],
                                          self.wd, w0, w1, first)[0]
                    with torch.no_grad():
                        logits = val_fn(torch.tensor(rec["end"]["prefix"], dtype=torch.float32,
                                                     device=dev))
                    correct, ambiguous = compare.val_counts(logits.double().cpu().numpy(), val_y,
                                                            cell["val_margin"])
                    ref["epochs"].append({"losses": r["losses"],
                                          "grad1": {"prefix": _host(r["grad1"])},
                                          "p_first": {"prefix": _host(r["p_first"])},
                                          "val_correct": correct, "val_ambiguous": ambiguous})
            if "final_gap" in cell["limits"]:
                ref["final"] = whole()["final"]
            return compare.training(got, ref)

        made = {}

        def whole():
            if not made:
                made.update(call(False))
            return made

        out = {}
        for v in variants:
            got = {"program": lambda: self.prog, "control": lambda: call(True),
                   "fault_half": lambda: call(False, "half")}[v]()
            out[v] = judge(got)
        return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _cosine(epoch: int, warmup: int, total: int) -> float:
    """The paper's warm-up cosine schedule's factor at `epoch`."""
    if epoch < warmup:
        return epoch / max(1.0, warmup)
    progress = (epoch - warmup) / max(1, total - warmup)
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
