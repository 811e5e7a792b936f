"""k1_roofline.infer (%): kernel 1's share of its roofline over the traced chunk's ViT calls (2 images x 2 stages a tile, at their own window and image segments).
Layer: kernels. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.roofline(run, "k1")
