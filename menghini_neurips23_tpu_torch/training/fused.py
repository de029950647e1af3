"""The whole-run trainer's program: one optimizer step and one epoch end as
functions on static device buffers, captured into CUDA graphs on the card.

The counterpart of the JAX package's `_build_fused_train`
(menghini_neurips23_tpu/training/strategy.py:768-875), where a whole run is
one `lax.scan` program.  Here a run is EPOCHS x (`steps` replays of the step
graph + 1 replay of the epoch-end graph), `steps` being the run's real
batches: the buffers may hold more (a padded slot), the replays do not.  Everything a replay reads lives in
buffers allocated once per shape key:

- the data: the training features padded to `n_slot` rows, labels, groups,
  the (epochs + 1, steps * bs) permutation matrix (-1 = a padded slot; the
  extra last row is all padding), per-epoch learning rates, the apply-flag
  cadence, the validation arrays and the loss weights;
- the carry: prompt leaves, momentum, gradient accumulator, best metric and
  best prompt;
- device counters: the epoch index and the step index.  The step reads its
  batch out of the permutation matrix at offsets computed from them, so no
  replay needs the host: nothing is uploaded and nothing is fetched between
  epochs, and the per-epoch stats land in a (3, epochs + 1) device buffer.

`step` takes the gradient with `torch.autograd.grad` and updates by hand
(`train_step`, the JAX step's SGD: weight decay, then momentum, then lr,
each gated by the apply flag), so `lr` and the apply flag are device
tensors and not constants of the capture.  `epoch_end` validates on the device (in
fixed row chunks for the image modalities), writes the epoch's stats, and
keeps the prompt when its metric is strictly greater than the best so far
(the first maximum, as np.argmax), never in a padded epoch.

On a CUDA device the two functions are warmed up on a side stream, on the
all-padding row (every valid and apply flag 0, so the carry is left as it
was), then each is captured once into a `torch.cuda.CUDAGraph`; the two share
one memory pool (they never run at once).  On the CPU, which only the tests
reach, the same two functions run eagerly: they are the plain version of the
captured program.  A failed capture raises.

Launch counts: `fused_attention.launches` and `attention_bwd.launches` (and
their `streamed_launches`, and K1's `resident_launches`) count in Python,
which a replay never passes through.  Capturing undoes what the
capture added and keeps it as the per-replay count; `run` adds captured x
replays after each replay loop.

In a process group (parallel/), at any world size, 1 included, each rank's
step takes its data group's host-major block of ceil(bs / world) rows of
the batch (world the data group's size); the
loss is normalised by the whole batch's valid rows per group, which every
rank counts from the permutation it holds, so the ranks' gradients sum to
the batch's.  The step then all-reduces one flat buffer - every gradient,
the loss and the correct count - over the data group before the update:
on the card that collective is captured into the step's graph (after the
warm-up collective that built NCCL's communicator), and a capture that
fails raises.  Under a 'model' axis (parallel/tensor.py) the step graph
also holds the towers' model-group all-reduces: 2 forward and 2 backward
per block the gradient crosses, so 4 * layers + 1 all-reduces a step
graph; the prompts' gradients leave the backward whole and equal on every
model rank, so the data group's sum counts each once.  The
epoch end's validation is replicated: the ranks hold the same prompt and
the same validation rows, so they pick the same best epoch.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
from menghini_neurips23_tpu_torch.parallel import multihost, tensor
from menghini_neurips23_tpu_torch.training.losses import masked_mean, two_group_loss

# (wrapper, counter): K1, K2, their streamed launches, the step's
# all-reduces in a process group (every group's), of those the model
# group's, and K1's resident bf16 launches (129 to 320 tokens)
_COUNTERS = ((fused_attention, "launches"), (attention_bwd, "launches"),
             (fused_attention, "streamed_launches"), (attention_bwd, "streamed_launches"),
             (multihost.all_reduce_sum_, "calls"), (tensor.model_all_reduce_, "calls"),
             (fused_attention, "resident_launches"))
_WARMUP = 2  # side-stream iterations before capture (PyTorch's advice: a few)

Tree = Dict[str, torch.Tensor]


def train_step(logits_fn: Callable, prompt: Tree, mom: Tree, gacc: Tree, ctx, feats, labels,
               group, valid, w0, w1, lr, apply, accum: int, wd: float, momentum: float,
               counts=None):
    """One step, in place on `prompt`, `mom` and `gacc` (the JAX fused
    step, strategy.py:796-825): the gradient of the two-group loss / accum
    is added to `gacc` when the batch has a valid row; where `apply` is set
    (and the batch has a valid row) `mom = momentum * mom + (gacc + wd *
    p)`, `p -= lr * mom` and `gacc = 0`.  The fused program passes `lr`,
    `apply` and the loss weights as 0-d device tensors, the per-step loop as
    Python numbers.  Returns the (undivided) loss and the correct count as
    device scalars: nothing here syncs with the host.

    `counts` (in a process group): the whole batch's valid rows of each
    group, as 0-d device tensors, of which these rows are this rank's
    block.  The loss is normalised by them, and one all-reduce (SUM) over
    the data group of a flat buffer - every gradient, the loss and the
    correct count - makes the update, the loss and the count the whole
    batch's on every rank.

    The update is twelve `torch._foreach_*` ops over all leaves at once,
    gated by 0/1 factors (x * 1 + y * 0 = x exactly for finite values)."""
    logits = logits_fn(prompt, ctx, feats)
    loss = two_group_loss(logits, labels, group, valid, w0, w1, counts)
    p = list(prompt.values())
    grads = torch.autograd.grad(loss / accum, p)
    with torch.no_grad():
        correct = ((logits.argmax(1) == labels) * valid).sum()
        if counts is None:
            has_valid = (valid.sum() > 0).float()
        else:
            flat = torch.cat([g.reshape(-1) for g in grads] +
                             [loss.detach().reshape(1), correct.reshape(1)])
            multihost.all_reduce_sum_(flat)
            grads = [x.view_as(g) for x, g in zip(flat[:-2].split([g.numel() for g in grads]),
                                                  grads)]
            loss, correct = flat[-2], flat[-1]
            has_valid = ((counts[0] + counts[1]) > 0).float()
        m, a = [mom[k] for k in prompt], [gacc[k] for k in prompt]
        do = has_valid * apply
        keep = 1.0 - do
        torch._foreach_add_(a, torch._foreach_mul(grads, has_valid))
        g2 = torch._foreach_mul(p, wd)
        torch._foreach_add_(g2, a)  # gacc + wd * p
        new_m = torch._foreach_mul(m, momentum)
        torch._foreach_add_(new_m, g2)
        torch._foreach_mul_(new_m, do)
        torch._foreach_mul_(m, keep)
        torch._foreach_add_(m, new_m)
        torch._foreach_sub_(p, torch._foreach_mul(m, lr * do))
        torch._foreach_mul_(a, keep)
    return loss.detach(), correct


def numpy_tree(tree) -> Dict[str, np.ndarray]:
    """A tree of tensors (any device) or arrays as host arrays."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in tree.items()}


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor viewing `x` (read-only memoized stacks included: the
    tensor is only ever copied from)."""
    if torch.is_tensor(x):
        return x
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)  # (which would make a 0-d array 1-d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # from_numpy of a read-only array
        return torch.from_numpy(x)


class FusedProgram:
    """Static buffers, the step and epoch-end functions and, on the card,
    their graphs, for one shape key (see the module docstring).

    :param logits_fn: the modality's functional logits hook,
        (prompt tree, class context, features) -> (B, C) fp32 logits
    :param train_logits_fn: the same, possibly wrapped for FUSED_REMAT
    :param epochs_padded: epochs including a chunked run's padding; the
        permutation matrix has one more row, all padding
    :param val_rows: validation rows per chunk (None: all at once)
    :param capture: capture CUDA graphs (False: run the functions eagerly)
    :param rank_world: (rank, world size) in a process group: the step
        takes the rank's block of each batch and all-reduces (None: one
        process, the whole batch)
    """

    def __init__(self, device, logits_fn: Callable, train_logits_fn: Callable, *, steps: int,
                 bs: int, n_slot: int, epochs_padded: int, trzsl: bool,
                 val_rows: Optional[int], accum: int, wd: float, momentum: float,
                 capture: bool, rank_world=None):
        self.device = torch.device(device)
        self.logits_fn, self.train_logits_fn = logits_fn, train_logits_fn
        self.steps, self.bs, self.n_slot = steps, bs, n_slot
        self.pad_n = steps * bs
        self.epochs_padded = epochs_padded
        self.trzsl, self.val_rows = trzsl, val_rows
        self.accum, self.wd, self.momentum = accum, wd, momentum
        self.capture_graphs = capture
        dev = self.device
        self.ei = torch.zeros(1, dtype=torch.long, device=dev)
        self.si = torch.zeros(1, dtype=torch.long, device=dev)
        self.offsets = torch.arange(bs, dtype=torch.long, device=dev)
        self.rank_world = rank_world
        if rank_world is not None:
            # the rank's block: rows lo .. lo + per - 1 of the batch, those
            # past its end padding
            rank, world = rank_world
            per = -(-bs // world)
            rows = torch.arange(per, dtype=torch.long, device=dev) + min(rank * per, bs)
            self.block = rows.clamp(max=bs - 1)
            self.in_block = rows < bs
        self.correct = torch.zeros((), device=dev)
        self.loss = torch.zeros((), device=dev)
        self.best_metric = torch.zeros(1, device=dev)
        self.stats = torch.zeros(3, epochs_padded + 1, device=dev)  # + the padding row's
        self.buf: Dict[str, torch.Tensor] = {}
        self._keys: Dict[str, object] = {}
        self.prompt: Tree = {}
        self.mom: Tree = {}
        self.gacc: Tree = {}
        self.best: Tree = {}
        self.graphs = None
        # what a replay of each graph launches: [K1, K2, K1 and K2 above 320
        # tokens, all-reduces, of which the model group's]
        self.per_step = self.per_epoch_end = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.uploads = 0  # buffers copied from the host, over the program's life

    # ---------------------------------------------------------------- buffers
    def memo_put(self, items: dict) -> None:
        """Content-keyed uploads: `items` maps a buffer name to (key, host
        array[, rows]).  A name whose key equals the last upload's is
        skipped; any other is copied INTO its buffer (allocated at the first
        upload), never rebound, since the captured graphs read the buffer's
        address.  With `rows`, the buffer has that many rows and the ones
        past the host array's are zeros."""
        for name, spec in items.items():
            key, host = spec[0], spec[1]
            if self._keys.get(name) == key:
                continue
            src = _host_tensor(host)
            rows = spec[2] if len(spec) > 2 else src.shape[0] if src.dim() else None
            buf = self.buf.get(name)
            if buf is None:
                shape = src.shape if rows is None else (rows,) + tuple(src.shape[1:])
                buf = self.buf[name] = torch.zeros(shape, dtype=src.dtype, device=self.device)
            with torch.no_grad():
                if rows is None or rows == src.shape[0]:
                    buf.copy_(src)
                else:
                    buf[: src.shape[0]].copy_(src)
                    buf[src.shape[0]:].zero_()
            self._keys[name] = key
            self.uploads += 1

    def load_carry(self, carry) -> None:
        """Copy (prompt, mom, gacc, best_metric, best_prompt) - trees of
        host or device arrays and a float - into the carry buffers."""
        prompt, mom, gacc, bm, best = carry
        if not self.prompt:
            def alloc(tree, grad=False):
                return {k: torch.zeros(tuple(v.shape), device=self.device, requires_grad=grad)
                        for k, v in tree.items()}

            self.prompt = alloc(prompt, grad=True)
            self.mom, self.gacc, self.best = alloc(mom), alloc(gacc), alloc(best)
        with torch.no_grad():
            for dst, src in ((self.prompt, prompt), (self.mom, mom), (self.gacc, gacc),
                             (self.best, best)):
                for k, v in dst.items():
                    v.copy_(_host_tensor(src[k]))
            self.best_metric.fill_(float(bm))

    def carry_numpy(self):
        """The carry as host arrays: (prompt, mom, gacc, best_metric, best)."""
        return (numpy_tree(self.prompt), numpy_tree(self.mom), numpy_tree(self.gacc),
                np.float32(self.best_metric.item()), numpy_tree(self.best))

    def fetch_stats(self, start: int, stop: int) -> np.ndarray:
        """(3, stop - start) per-epoch (metric, train accuracy, last loss):
        one device-to-host copy."""
        return self.stats[:, start:stop].cpu().numpy()

    def fetch_prompts(self):
        """(best prompt, final prompt) as host trees."""
        return numpy_tree(self.best), numpy_tree(self.prompt)

    # -------------------------------------------------------------- functions
    def step(self) -> None:
        """One optimizer step at (epoch ei, step si), then si += 1."""
        b = self.buf
        pos = (self.ei * self.pad_n + self.si * self.bs) + self.offsets
        perm = b["perms"].view(-1).index_select(0, pos)
        counts = None
        any_valid = (perm >= 0).any()
        if self.rank_world is not None:
            # the whole batch's valid rows per group, then the rank's block
            full = b["groups"].index_select(0, perm.clamp(0, self.n_slot - 1))
            counts = tuple(((perm >= 0) & (full == g)).float().sum() for g in (0, 1))
            perm = torch.where(self.in_block, perm.index_select(0, self.block), -1)
        valid = perm >= 0
        idx = perm.clamp(0, self.n_slot - 1)
        labels = torch.where(valid, b["labels"].index_select(0, idx), -1)
        loss, correct = train_step(
            self.train_logits_fn, self.prompt, self.mom, self.gacc, b["ctx_train"],
            b["feats"].index_select(0, idx), labels, b["groups"].index_select(0, idx),
            valid.float(), b["w"][0], b["w"][1], b["lrs"].index_select(0, self.ei)[0],
            b["apply_flags"].index_select(0, self.si)[0], self.accum, self.wd, self.momentum,
            counts,
        )
        with torch.no_grad():
            self.correct.add_(correct)
            # the epoch's last real batch's loss, as the per-step loop logs it
            self.loss.copy_(torch.where(any_valid, loss, self.loss))
            self.si.add_(1)

    def epoch_end(self) -> None:
        """Validation with the updated prompt, the epoch's stats into column
        ei, strictly-greater best selection (never in a padded epoch), then
        ei += 1 and the step counters reset."""
        b = self.buf
        with torch.no_grad():
            n_val = b["val_labels"].shape[0]
            rows = self.val_rows or n_val
            pred = torch.cat([
                self.logits_fn(self.prompt, b["ctx_val"], b["val_feats"][s : s + rows]).argmax(1)
                for s in range(0, n_val, rows)
            ])
            correct = (b["val_global"].index_select(0, pred) == b["val_labels"]).float()
            val_valid = (b["val_labels"] >= 0).float()  # padded rows carry label -1
            if self.trzsl:
                acc_s = masked_mean(correct, b["val_is_seen"] * val_valid)
                acc_u = masked_mean(correct, (1.0 - b["val_is_seen"]) * val_valid)
                metric = torch.where(
                    (acc_s > 0) & (acc_u > 0),
                    2.0 * acc_s * acc_u / torch.clamp(acc_s + acc_u, min=1e-12),
                    torch.zeros_like(acc_s),
                )
            else:
                metric = masked_mean(correct, val_valid)
            train_acc = self.correct / b["n_real"]
            self.stats.index_copy_(1, self.ei, torch.stack([metric, train_acc, self.loss])[:, None])
            take = (metric > self.best_metric) & (self.ei < b["n_epochs"])
            self.best_metric.copy_(torch.where(take, metric, self.best_metric))
            for k, p in self.prompt.items():
                self.best[k].copy_(torch.where(take, p, self.best[k]))
            self.ei.add_(1)
            self.si.zero_()
            self.correct.zero_()

    # -------------------------------------------------------- capture, replay
    def _park(self) -> None:
        """Point the counters at the all-padding row (its stats column is
        scratch, and it is past every real epoch)."""
        with torch.no_grad():
            self.ei.fill_(self.epochs_padded)
            self.si.zero_()
            self.correct.zero_()

    def capture(self) -> None:
        """Warm up on a side stream on the all-padding row, then capture the
        step and the epoch end.  Leaves the carry as it found it."""
        t0 = time.perf_counter()
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self._park()
                self.step()
                self.epoch_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._park()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = [getattr(w, c) for w, c in _COUNTERS]
        g_step = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_step):
            self.step()
        mid = [getattr(w, c) for w, c in _COUNTERS]
        g_end = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_end, pool=g_step.pool()):
            self.epoch_end()
        after = [getattr(w, c) for w, c in _COUNTERS]
        # a capture launches nothing: what it counted is what a replay launches
        for (w, c), n in zip(_COUNTERS, before):
            setattr(w, c, n)
        self.per_step = [m - b for m, b in zip(mid, before)]
        self.per_epoch_end = [a - m for a, m in zip(after, mid)]
        self.graphs = (g_step, g_end)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def run(self, start: int, stop: int, steps: int) -> None:
        """Epochs start .. stop - 1 of `steps` steps each: replays on the
        card (capturing first if needed), the functions themselves
        otherwise.  No host sync.  `steps` is the run's real batches,
        ceil(n / bs): the step graph does not depend on it, so a padded
        slot (the GRIP ladder) costs buffer rows, not replays."""
        if self.capture_graphs and self.graphs is None:
            self.capture()
        with torch.no_grad():
            self.ei.fill_(start)
            self.si.zero_()
            self.correct.zero_()
        if self.graphs is None:
            for _ in range(start, stop):
                for _ in range(steps):
                    self.step()
                self.epoch_end()
            return
        g_step, g_end = self.graphs
        for _ in range(start, stop):
            for _ in range(steps):
                g_step.replay()
            g_end.replay()
        epochs = stop - start
        for (w, c), s, e in zip(_COUNTERS, self.per_step, self.per_epoch_end):
            setattr(w, c, getattr(w, c) + epochs * (steps * s + e))
