"""The share of the JLN's slots that held a person, over the window's
requests: the sum of `jln.people` (valid poses answered) over the sum
of `jln.slots` (slots the JLN ran), counted on the host."""

from benchmark.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    slots, people = (w["counters"][:, spans.COUNTERS.index(k)].sum() for k in spans.COUNTERS)
    return float(people) / float(slots) if slots > 0 else None
