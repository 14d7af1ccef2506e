"""Phase-1 sampler (models/graphdit/api.py GraphDiT.sample): the benchmark
span around each sample call over its reverse steps, in ms."""


def read(run):
    spans = run.spans.log.get("sampler", []) if run.spans else []
    if not spans:
        return None
    return (sum(b - a for a, b in spans)
            / (len(spans) * run.shapes["reverse_steps"]) * 1e3)
