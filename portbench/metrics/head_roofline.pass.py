"""head_roofline.pass: K3 (the CLIP head) in the pass, its launches' bound
(bytes at 3.35 TB/s or operations at the peak, the larger) over its device
time, in %."""

from portbench.harness import flops as F
from portbench.harness.readers import is_head


def read(trace):
    f = trace.facts
    if f["counted"].get("k3") != sum(s[3] for s in f["k3"]):
        return None
    dt = f["dtype"]
    bound = sum(c * F.bound_s(F.head_flops(B, C, E), F.head_bytes(B, C, E, dt), dt)
                for B, C, E, c in f["k3"])
    took = trace.seconds(is_head)
    return 100.0 * bound / took if took > 0 else None
