"""device_s_per_tile.infer (s/tile): the traced chunk's device busy time (the union of its intervals)
over the tiles it completed: the device's own work a tile, steady where the host's pace is not.
Layer: device. Moves tiles_per_s. Source: device_trace."""

import readers


def read(run):
    return readers.device_s_per_unit(run, "tiles")
