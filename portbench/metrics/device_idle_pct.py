"""Share of the traced window in which no device record ran (the union of
their intervals, not their sum), in %.  It carries the tracer's own load
on the host, which slows a host-bound step."""


def read(summary):
    tr = summary["trace"]
    if tr is None or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / summary["traced"]["window_s"])
