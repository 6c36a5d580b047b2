"""p50 over the window's requests of `device.launch_gap`: from the event
after the input's copy to the served graph's first mark, the device
waiting for the host to launch the graph."""

from benchmark.core import spans


def read(run):
    return spans.device_p50(run, "device.launch_gap")
