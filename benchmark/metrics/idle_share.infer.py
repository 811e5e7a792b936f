"""idle_share.infer (%): the share of an untraced chunk's wall time (the mean of the run's untraced chunks)
that the traced chunk's device activity (the union of its intervals) does not cover.
Layer: device. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.idle_share(run)
