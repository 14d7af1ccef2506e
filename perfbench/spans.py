"""The program's own spans and counters, for the per-layer readers:
llamole_tpu_torch.utils.profiling.snapshot(), read after the run. The
program keeps spans only while a torch profiler runs, so in a traced run
they cover the traced window (one design batch); its counters count
every batch the process ran, the warm-up included. A program without
that registry gives None, and so does each reader over it."""


def snapshot():
    """The program's snapshot(), or None where it has none."""
    from llamole_tpu_torch.utils import profiling
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def counter_ratio(snap, num: str, den: str, scale: float):
    """counters[num] / counters[den] x scale; None without the
    denominator (a counter never bumped is 0)."""
    if snap is None or not snap["counters"].get(den):
        return None
    return snap["counters"].get(num, 0) / snap["counters"][den] * scale


def span_mean(snap, name: str):
    """The mean wall of the spans `name`, in ms; None without any."""
    if snap is None:
        return None
    walls = [s["wall_ms"] for s in snap["spans"] if s["name"] == name]
    return sum(walls) / len(walls) if walls else None


def per_step(snap, name: str, key: str):
    """The sum of `key` ("wall_ms" or "device_ms") over the spans `name`
    inside an llm.step span (a decode step after its call's first), over
    the number of those steps, in ms; None without steps."""
    if snap is None:
        return None
    steps = {s["id"] for s in snap["spans"] if s["name"] == "llm.step"}
    if not steps:
        return None
    return sum(s[key] for s in snap["spans"]
               if s["name"] == name and s["parent"] in steps) / len(steps)
