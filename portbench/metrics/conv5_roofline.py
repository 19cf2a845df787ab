"""conv5's share of its roofline: the sum over the traced window's conv5
kernel records of each call's least time (``flops.conv5_bound_s`` at its
batch width) over their summed device time, in %.  conv5 runs once a train
step's forward, so the k-th record is the k-th step's; where the counts
differ there is nothing to read."""

from portbench import flops


def read(summary):
    tr, win = summary["trace"], summary["traced"]
    if tr is None or not tr["conv5_s"] or len(tr["conv5_s"]) != win["steps"]:
        return None
    bound = sum(flops.conv5_bound_s(flops.conv5_shape(summary["cfg"], w))
                for w in win["widths"])
    return 100.0 * bound / sum(tr["conv5_s"])
