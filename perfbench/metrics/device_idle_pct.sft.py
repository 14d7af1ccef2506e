"""The card in the training cell: the share of the traced window (whole
micro steps) in which no kernel, copy or set ran, in %."""


def read(run):
    t = run.trace
    if not t or not t.get("window_s"):
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
