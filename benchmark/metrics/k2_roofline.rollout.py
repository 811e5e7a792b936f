"""k2_roofline.rollout (%): kernel 2's share of its roofline over the traced engine steps' prefills, at the prompt rows' own lengths (the groups' leaders; forks prefill nothing).
Layer: kernels. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.roofline(run, "k2")
