"""k3_roofline.rollout (%): kernel 3's share of its roofline over the traced engine steps' decode, at the 128 slots' own cache lengths (head dim 256, bf16 cache).
Layer: kernels. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.roofline(run, "k3")
