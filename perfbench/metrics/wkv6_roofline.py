"""``wkv6``'s share of its roofline over the profiled part of the window,
in %: the least time of every call the profiler saw under ``aeg::wkv6``
(counts.wkv6_bound from its (B, T, H, K) shape; the operands are fp32)
over the device time the profiler gives that op. None where no call ran
there."""
from perfbench import counts

OP = "aeg::wkv6"


def read(rec):
    t = rec.trace
    if not t:
        return None
    ideal = dev = 0.0
    for op in t["ops"]:
        if op["name"] != OP or not op["calls"]:
            continue
        b, tt, h, k = op["shapes"][0]
        ms = counts.wkv6_bound(b, tt, h, k, "float32")[0]
        ideal += ms / 1e3 * op["calls"]
        dev += op["device_s"]
    return 100.0 * ideal / dev if dev > 0 else None
