"""decode_steps_per_tile.infer (steps/tile): the engine's decode steps in
the window (steps_executed) over the tiles it completed.
Layer: infer pipeline. Moves tiles_per_s. Source: program_counter."""


def read(run):
    c = run.counters
    return c["decode_steps"] / c["tiles"] if c.get("tiles") else None
