"""LLM decode (models/gllm/model.py LLM.generate): the mean wall of a
call's first decode step, the eager step and the capture of the CUDA
graph later steps replay, in ms; program spans llm.first_step of the
traced batch. Under the trace's CUDA activity (CUPTI) each launch costs
more host time than untraced, so it holds the profiler's launch cost
too."""

from perfbench import spans


def read(run):
    return spans.span_mean(spans.snapshot(), "llm.first_step")
