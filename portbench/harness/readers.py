"""What the per-layer metric readers share: kernel names and the arithmetic.

A reader returns None where its trace holds nothing to read (no such
kernel, or launch counts that disagree with the shapes it would count), and
the harness then leaves the metric out of the line.
"""

from __future__ import annotations

from portbench.harness import flops as F
from portbench.harness.trace import Trace


def is_attention(name: str) -> bool:
    """K1 and K2: every entry point of csrc/attention_fwd.cu and attention_bwd.cu."""
    return "attention_fwd" in name or "attention_bwd" in name


def is_head(name: str) -> bool:
    """K3 (csrc/clip_head.cu)."""
    return "clip_head" in name


def is_gemm(name: str) -> bool:
    """cuBLAS/CUTLASS matrix products (the towers' linear layers)."""
    low = name.lower()
    return not is_attention(name) and any(k in low for k in ("gemm", "cutlass", "xmma", "cublas"))


def mfu(trace: Trace):
    """The algorithm's operations over the window, as % of the dtype's peak."""
    f = trace.facts
    if not f.get("flops") or trace.window_s <= 0:
        return None
    return 100.0 * f["flops"] / trace.window_s / F.PEAK_FLOPS[f["dtype"]]


def idle_share(trace: Trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def attention_roofline(trace: Trace):
    """Sum over K1/K2 launches of each one's bound, over their device time.
    None where the program's launch counters disagree with the shapes."""
    f = trace.facts
    dt = f["dtype"]
    want = {"k1": sum(s[5] for s in f["k1"]), "k2": sum(s[5] for s in f["k2"])}
    if any(f["counted"].get(k) != v for k, v in want.items()):
        return None
    bound = sum(c * F.bound_s(F.attn_fwd_flops(B, T, H, D, causal),
                              F.attn_fwd_bytes(B, T, H, D, dt), dt)
                for B, T, H, D, causal, c in f["k1"])
    bound += sum(c * F.bound_s(F.attn_bwd_flops(B, T, H, D, causal),
                               F.attn_bwd_bytes(B, T, H, D, dt), dt)
                 for B, T, H, D, causal, c in f["k2"])
    took = trace.seconds(is_attention)
    return 100.0 * bound / took if took > 0 and bound > 0 else None
