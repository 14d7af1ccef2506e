"""Serving layer (serve.py DesignServer): the share of the rows run that
are requests, the rest repeating the last request to fill the batch, in
%; program counters serve.rows_real / serve.rows_run over every batch
the process ran, the warm-up included."""

from perfbench import spans


def read(run):
    return spans.counter_ratio(spans.snapshot(), "serve.rows_real",
                               "serve.rows_run", 100.0)
