"""launches_per_step.infer (launches/step): device launches in the traced chunk over the engine's decode steps in it (steps_executed); ViT, prefill and sampling launches included.
Layer: engine. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.launches_per_step(run)
