"""LLM decode (models/gllm/model.py LLM.generate): the mean stream time
of a decode step's forward, in ms, from the span's start event to its
end event: the graph replay's kernels, its inputs' copies, and the
stream's wait for the replay's launch. Under the trace's CUDA activity
(CUPTI) a CUDA-graph launch takes ~11 ms of host time, and the stream
idles through it, so this reads ~30 ms where the untraced forward takes
~20: it is not the forward's kernel time, and a cheaper graph launch
moves it with nothing changed untraced. Program spans llm.forward inside
llm.step (the steps after each call's first) of the traced batch, CUDA
events on the card. The forward's kernel busy time inside these spans
needs the trace's device events, which the harness does not hand a
reader."""

from perfbench import spans


def read(run):
    return spans.per_step(spans.snapshot(), "llm.forward", "device_ms")
