"""Device kernel records in the traced window over its train steps
(graph-replayed kernels count; copies and memsets do not)."""


def read(summary):
    tr, win = summary["trace"], summary["traced"]
    if tr is None or not win["steps"] or not tr["kernels"]:
        return None
    return tr["kernels"] / win["steps"]
