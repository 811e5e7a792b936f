"""group_s.rollout (s): the mean seconds of the rollout.group spans (a prompt group's first submission to its
n-th response, runtime/generate_scheduler.py) of the groups that completed in the window.
Layer: rollout scheduler. Moves tiles_per_s. Source: program_span."""


def read(run):
    spans, window = getattr(run, "spans", None), getattr(run, "window_ns", None)
    if not spans or not window:
        return None
    t0, t1 = window
    s = [(ev["end_ns"] - ev["start_ns"]) / 1e9 for ev in spans
         if ev["name"] == "rollout.group" and t0 <= ev["end_ns"] <= t1]
    return sum(s) / len(s) if s else None
