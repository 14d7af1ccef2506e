"""LLM decode (models/gllm/model.py LLM.generate): the mean wall of a
decode step's stop-flag read, where the host waits for the step's device
work, in ms; program spans llm.stop_wait inside llm.step (the steps
after each call's first) of the traced batch."""

from perfbench import spans


def read(run):
    return spans.per_step(spans.snapshot(), "llm.stop_wait", "wall_ms")
