"""mfu.infer (%): the model FLOPs of the traced chunk (ViT, prefills, decode steps) over the mean wall time
of the run's untraced chunks, which do the same work, at 989 TFLOP/s.
Layer: model step. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.mfu(run)
