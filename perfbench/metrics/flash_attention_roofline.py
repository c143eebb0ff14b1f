"""``flash_attention``'s share of its roofline over the profiled part of
the window, in %: the least time of every call the profiler saw under
``aeg::flash_attention`` (counts.attention_bound from its shapes, causal,
bf16) over the device time the profiler gives that op. None where no call
ran there."""
from perfbench import counts

OP = "aeg::flash_attention"


def read(rec):
    t = rec.trace
    if not t:
        return None
    ideal = dev = 0.0
    for op in t["ops"]:
        if op["name"] != OP or not op["calls"]:
            continue
        (b, s, h, d), (_, sk, hkv, _) = op["shapes"][0], op["shapes"][1]
        ms, _ = counts.attention_bound(b, s, sk, h, hkv, d, "bfloat16", True)
        ideal += ms / 1e3 * op["calls"]
        dev += op["device_s"]
    return 100.0 * ideal / dev if dev > 0 else None
