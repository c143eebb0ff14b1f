"""The whole step's share of the card's bf16 peak (989 TFLOP/s, H100 SXM,
dense): the FLOPs the window's answers need (counts.prefill_flops for
each prefill that ended in it, counts.decode_flops for each decode step
begun in it, over its live lanes) over the window's seconds times the
peak, in %. Traced runs only."""
from perfbench import counts


def read(rec):
    if not rec.prefills and not rec.decodes:
        return None
    flops = sum(counts.prefill_flops(rec.config, s)
                for _, _, s in rec.prefills)
    flops += sum(counts.decode_flops(rec.config, pos)
                 for _, pos in rec.decodes)
    return 100.0 * flops / (rec.window_s * counts.PEAK_BF16)
