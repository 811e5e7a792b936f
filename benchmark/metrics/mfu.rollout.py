"""mfu.rollout (%): the model FLOPs of the traced engine steps (prefills, decode steps) over the wall time of the
slice's work (the mean wall of the window's untraced runs of as many engine steps, each begun by an admission
as the slice is), at 989 TFLOP/s.
Layer: model step. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.mfu(run)
