"""LLM decode (models/gllm/model.py LLM.generate): the mean device time
of a decode step's token pick (sample_token over the vocabulary, outside
the graph, and the stop bookkeeping), in ms: the stream's time from the
span's start event to its end event; program spans llm.pick inside
llm.step (the steps after each call's first) of the traced batch, CUDA
events on the card."""

from perfbench import spans


def read(run):
    return spans.per_step(spans.snapshot(), "llm.pick", "device_ms")
