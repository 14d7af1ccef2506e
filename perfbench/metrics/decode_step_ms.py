"""LLM decode (models/gllm/model.py LLM.generate): the benchmark span
around each generate call (its prefill included) over the decode steps
the calls took, in ms."""


def read(run):
    spans = run.spans.log.get("llm_generate", []) if run.spans else []
    steps = sum(max(c["steps"] - 1, 0) for c in run.shapes.get("generate",
                                                                 []))
    if not spans or not steps:
        return None
    return sum(b - a for a, b in spans) / steps * 1e3
