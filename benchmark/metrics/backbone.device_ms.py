"""Device ms of `images_to_heatmaps(service.backbone, ...)` on the cell's
frames, captured alone in a CUDA graph and timed with CUDA events."""


def read(run):
    return run.stage_ms.get("backbone")
