"""slot_use.rollout (%): the tokens the engine's decode steps sampled in the window (decode_tokens) over its
decode steps (steps_executed) times the slots: how full the decode batch ran.
Layer: engine. Moves tiles_per_s. Source: program_counter."""


def read(run):
    c = getattr(run, "counters", None) or {}
    steps, slots = c.get("decode_steps"), c.get("slots")
    if not steps or not slots or "decode_tokens" not in c:
        return None
    return 100.0 * c["decode_tokens"] / (steps * slots)
