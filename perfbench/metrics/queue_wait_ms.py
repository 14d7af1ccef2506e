"""Serving layer (serve.py DesignServer): the mean wait of a request
from its submission to the start of the batch that serves it, in ms;
program counters serve.queue_wait_s / serve.requests over every batch
the process ran, the warm-up included."""

from perfbench import spans


def read(run):
    return spans.counter_ratio(spans.snapshot(), "serve.queue_wait_s",
                               "serve.requests", 1e3)
