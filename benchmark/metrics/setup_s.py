"""Process start -> the first timed request: imports, the device, the
kernels (built once per checkout), weights, inputs, graph capture and
warm requests."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
