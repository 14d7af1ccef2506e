"""Serving layer (serve.py DesignServer): the mean wall of one
GraphLM.design_molecule call, a benchmark span, over the window's
batches."""


def read(run):
    spans = run.spans.log.get("design_batch", []) if run.spans else []
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans)
