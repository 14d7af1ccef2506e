"""The card in the design cell: the share of the traced window (whole
design batches) in which no kernel, copy or set ran, in %."""


def read(run):
    t = run.trace
    if not t or not t.get("window_s"):
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
