"""k3_roofline.infer (%): kernel 3's share of its roofline over the traced chunk's decode steps, at the slots' own cache lengths.
Layer: kernels. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.roofline(run, "k3")
