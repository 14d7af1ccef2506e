"""Input (data/collator.py SeqGraphCollator): the benchmark span around
each collator call that built a window batch, mean in ms."""


def read(run):
    spans = run.spans.log.get("collate", []) if run.spans else []
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
