"""p50 over the window's requests of the service's own host time: the
`service.input`, `service.launch` and `service.decode` spans summed
(conversion and checks, the replay call, decoding the poses), from the
program's span log."""

from benchmark.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    return spans.p50(spans.child_ms(w, "service.input", "service.launch", "service.decode"))
