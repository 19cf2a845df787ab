"""Summed device time of the traced window's kernel records over its train
steps, in ms (overlapping kernels count each)."""


def read(summary):
    tr, win = summary["trace"], summary["traced"]
    if tr is None or not win["steps"] or not tr["kernels"]:
        return None
    return 1e3 * tr["kernel_s"] / win["steps"]
