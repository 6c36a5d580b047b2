"""p50 over the window's requests of `device.jln`: the served graph's
mark after the HDN to its end mark (the crop sampler, the P2PNet, the
fusion)."""

from benchmark.core import spans


def read(run):
    return spans.device_p50(run, "device.jln")
