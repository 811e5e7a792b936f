"""Work records of DecodeEngine steps, read from the engine's requests and
counters around each call of `step`, and the model's widths for the count
functions (counts/)."""

from __future__ import annotations

from typing import Dict, List


def model_shape(hf: Dict, cache_bytes: int = 2) -> Dict:
    Hq = hf["num_attention_heads"]
    return {"layers": hf["num_hidden_layers"], "hidden": hf["hidden_size"], "heads": Hq,
            "kv_heads": hf["num_key_value_heads"],
            "head_dim": hf.get("head_dim") or hf["hidden_size"] // Hq,
            "intermediate": hf["intermediate_size"], "vocab": hf["vocab_size"],
            "cache_bytes": cache_bytes}


class StepRecorder:
    """Work records of engine steps from the requests' own lengths: each
    prefill's row lengths (the requests admitted in the step, as many as
    the engine's prefill_rows counter says), each decode chunk's active
    slots' cache lengths and steps."""

    def __init__(self, engine):
        self.engine = engine
        self._step = engine.step          # the engine's own, even once wrapped
        self.prefill: List[Dict] = []
        self.decode: List[Dict] = []

    def step(self):
        e = self.engine
        pre = dict(e.slot_req)
        L0 = e.lengths.copy()
        steps0, pref0 = e.steps_executed, e.prefill_rows
        outs = self._step()
        steps = e.steps_executed - steps0
        pre_ids = {r.request_id for r in pre.values()}
        # admitted this step: still in a slot, or finished within the step
        admitted = [len(r.prompt_ids) for r in e.slot_req.values()
                    if r.request_id not in pre_ids]
        admitted += [len(o.prompt_ids) for o in outs if o.request_id not in pre_ids]
        n_pref = e.prefill_rows - pref0
        if n_pref:
            self.prefill.append({"lens": admitted[:n_pref]})
        if steps:
            kv0 = [int(L0[s]) for s in pre] + admitted
            self.decode.append({"kv0": kv0, "steps": steps})
        return outs
