"""Design layer (models/composite.py): the share of designed rows whose
sample did not assemble and went to the rollback decode, in %; program
counters design.rollback_rows / design.rows over every batch the process
ran, the warm-up included."""

from perfbench import spans


def read(run):
    return spans.counter_ratio(spans.snapshot(), "design.rollback_rows",
                               "design.rows", 100.0)
