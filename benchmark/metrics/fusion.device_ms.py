"""Device ms of the model's forward (projection, HDN, JLN) on the cell's
heatmaps (the backbone's, where frames come in), captured alone in a CUDA
graph and timed with CUDA events."""


def read(run):
    return run.stage_ms.get("fusion")
