"""The port's host modules of the generic RLVR slice against the JAX
package's, on the same inputs: the math rule reward, the chat templates,
the dataset loader and its registry, load_socioseg on a synthetic
directory, the stratified sampler, RunningMoments, run_validation and
compute_data_metrics, and DynamicSamplingScheduler on a scripted
two-worker cluster with both filters.

Every comparison is exact (equal strings, rows, index sequences, reward
arrays, metrics), since these modules are host code over the same numpy
and Python arithmetic; RunningMoments is float64 in both packages. The
pipelines are in tests/test_torch_rlvr_pipeline.py.
"""

import csv
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from socioreasoner_tpu.configs import worker_config as j_wc
from socioreasoner_tpu.datasets import chat_template as j_chat
from socioreasoner_tpu.datasets import loader as j_loader
from socioreasoner_tpu.datasets import sampler as j_sampler
from socioreasoner_tpu.datasets import socioseg as j_seg
from socioreasoner_tpu.pipeline.rlvr import evaluation as j_eval
from socioreasoner_tpu.pipeline.rlvr.rewards import math_rule as j_math
from socioreasoner_tpu.protocol import BatchProto as JBatch
from socioreasoner_tpu.runtime import generate_scheduler as j_sched
from socioreasoner_tpu.utils import functionals as j_fn
from socioreasoner_tpu_torch.configs import worker_config as t_wc
from socioreasoner_tpu_torch.datasets import chat_template as t_chat
from socioreasoner_tpu_torch.datasets import loader as t_loader
from socioreasoner_tpu_torch.datasets import sampler as t_sampler
from socioreasoner_tpu_torch.datasets import socioseg as t_seg
from socioreasoner_tpu_torch.pipeline.rlvr import evaluation as t_eval
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import math_rule as t_math
from socioreasoner_tpu_torch.protocol import BatchProto as TBatch
from socioreasoner_tpu_torch.runtime import generate_scheduler as t_sched
from socioreasoner_tpu_torch.utils import functionals as t_fn


def _assert_same(got, want):
    """Equal dicts of arrays / floats / nested dicts."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


# ------------------------------------------------------------ math rule reward

# (response, ground truth): boxed answers, fractions and percentages, answer
# tags, the last number, and answers that are broken or absent
MATH_CASES = [
    (r"thinking... \boxed{42}", "42"),
    (r"\boxed{41}", "42"),
    (r"<think>a</think><answer>\frac{1}{2}</answer>", "0.5"),
    ("<think>a</think> <answer>1/2</answer>", r"\frac{2}{4}"),
    ("<answer>50%</answer>", "0.5"),
    ("<answer>1/3</answer>", "0.5"),
    (r"<think>ok</think><answer>\boxed{\dfrac{3}{4}}</answer>", "0.75"),
    (r"$\left( 7 \right)$ so \boxed{7.}", "7"),
    ("the answer is 12 then 13", "13"),
    (r"\boxed{\text{yes} 5}", "5"),
    ("<answer>1e-3</answer>", "0.001"),
    ("<answer>0.3333333</answer>", "1/3"),
    ("<answer>1/0</answer>", "1/0"),
    ("<answer>2/0</answer>", "1"),
    ("<answer>abc</answer>", "abd"),
    ("<think>unclosed <answer>5", "5"),
    (r"\boxed{", "1"),
    ("no answer at all", "2"),
    ("", "0"),
    (r"<think>x</think><answer>\boxed{-2}</answer>", r"\boxed{-2}"),
]


@pytest.mark.parametrize("case", range(len(MATH_CASES)))
def test_math_rule_matches_jax(case):
    text, gt = MATH_CASES[case]
    for name in ("extract_answer", "math_format_reward"):
        assert getattr(t_math, name)(text) == getattr(j_math, name)(text), name
    assert t_math.math_accuracy_reward(text, gt) == j_math.math_accuracy_reward(text, gt)
    assert t_math.answers_match(text, gt) == j_math.answers_match(text, gt)


def test_compute_math_rewards_matches_jax():
    """The whole list as one batch: scores, rewards and metrics equal, at the
    default and another format weight; the batch has right and wrong
    answers and broken formats."""
    texts = [t for t, _ in MATH_CASES]
    gts = [g for _, g in MATH_CASES]
    for weight in (0.1, 0.5):
        got = t_math.compute_math_rewards(texts, gts, format_weight=weight)
        want = j_math.compute_math_rewards(texts, gts, format_weight=weight)
        _assert_same(got, want)
    scores = got["scores"]
    assert 0 < scores.sum() < len(scores)
    assert 0 < got["metrics"]["math/format"] < 1


# ------------------------------------------------------------- chat templates

CONVERSATIONS = [
    [{"role": "user", "content": "What is 2+2?"}],
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"}],
    [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"},
     {"role": "user", "content": "c"}],
]


@pytest.mark.parametrize("name", sorted(j_chat.TEMPLATES))
def test_chat_template_matches_jax(name):
    """Every registered template on every conversation: the same prompt, or
    the same refusal (base and empty take one user turn)."""
    assert sorted(t_chat.TEMPLATES) == sorted(j_chat.TEMPLATES)
    for messages in CONVERSATIONS:
        try:
            want = j_chat.get_chat_template(name)(messages)
        except AssertionError:
            with pytest.raises(AssertionError):
                t_chat.get_chat_template(name)(messages)
            continue
        assert t_chat.get_chat_template(name)(messages) == want
    with pytest.raises(KeyError):
        t_chat.get_chat_template("no-such-template")


# ------------------------------------------------------------- loader

ROWS = [{"q": "1+1", "a": "2"}, {"q": "3*3", "a": "9"}, {"q": "x", "a": ""}]


def _write(path, ext):
    """ROWS in the file format of `ext` (HF datasets for parquet and arrow)."""
    if ext == "jsonl":
        path.write_text("\n".join(json.dumps(r) for r in ROWS) + "\n\n")
    elif ext == "json":
        path.write_text(json.dumps(ROWS))
    elif ext == "csv":
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["q", "a"])
            w.writeheader()
            w.writerows(ROWS)
    elif ext == "txt":
        path.write_text("first line\nsecond line\n")
    else:
        import datasets as hfd
        ds = hfd.Dataset.from_list(ROWS)
        if ext == "parquet":
            ds.to_parquet(str(path))
        else:
            ds.save_to_disk(str(path.parent / "saved"))
            arrow = [f for f in os.listdir(path.parent / "saved") if f.endswith(".arrow")]
            os.replace(path.parent / "saved" / arrow[0], path)


@pytest.mark.parametrize("ext", ["jsonl", "json", "csv", "parquet", "arrow", "txt"])
def test_load_rows_matches_jax(tmp_path, ext):
    path = tmp_path / f"rows.{ext}"
    _write(path, ext)
    want = j_loader.load_rows(str(path))
    assert t_loader.load_rows(str(path)) == want and len(want) in (2, 3)
    assert t_loader.load_rows(str(path), limit=2) == j_loader.load_rows(str(path), limit=2)


def test_load_dataset_any_and_registry_match_jax(tmp_path):
    """A directory of files, an explicit file, the limit, and the errors;
    get_dataset for the json types and an unknown type."""
    _write(tmp_path / "a.jsonl", "jsonl")
    _write(tmp_path / "b.json", "json")
    (tmp_path / "notes.md").write_text("skipped")
    for kw in ({"dataset_dir": str(tmp_path)}, {"file_name": str(tmp_path / "b.json")},
               {"dataset_dir": str(tmp_path), "limit": 4}):
        assert t_loader.load_dataset_any(**kw) == j_loader.load_dataset_any(**kw)
    assert len(t_loader.load_dataset_any(dataset_dir=str(tmp_path))) == 6
    with pytest.raises(ValueError, match="unsupported"):
        t_loader.load_rows("x.xyz")
    with pytest.raises(FileNotFoundError):
        t_loader.load_dataset_any(file_name=str(tmp_path / "nope.json"))
    assert sorted(t_loader.REGISTERED_DATASETS) == sorted(j_loader.REGISTERED_DATASETS)
    for key in ("json", "default", None):
        args = SimpleNamespace(dataset_type=key,
                               file_name=[str(tmp_path / "a.jsonl"), str(tmp_path / "b.json")])
        assert t_loader.get_dataset(args) == j_loader.get_dataset(args)
    with pytest.raises(ValueError, match="not found"):
        t_loader.get_dataset(SimpleNamespace(dataset_type="nope"))
    with pytest.raises(ValueError, match="already exists"):
        t_loader.register_dataset("json")(lambda paths, args: [])


def _socioseg_dir(root):
    """The builder's layout, root/{train,val}/<id>/{map,sat,mask}.png +
    question.json with a "problem"; a tile without its mask and one with a
    broken question.json, which the builder skips."""
    rng = np.random.default_rng(4)
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            d = root / split / f"tile{i}"
            d.mkdir(parents=True)
            for key in ("map", "sat", "mask"):
                Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    d / f"{key}.png")
            (d / "question.json").write_text(json.dumps({"problem": f"{split} area {i}"}))
    os.remove(root / "train" / "tile1" / "mask.png")
    (root / "val" / "tile1" / "question.json").write_text("{broken")
    return root


def test_load_socioseg_matches_jax(tmp_path, monkeypatch):
    """The local-directory branch through HF datasets (each package in its
    own cache): the same ids, problems and images, incomplete tiles skipped,
    "val" read as the validation split; and the loader's "socioseg" type."""
    import datasets as hfd
    root = _socioseg_dir(tmp_path / "socioseg")
    out = {}
    for side, mod in (("jax", j_seg), ("port", t_seg)):
        monkeypatch.setattr(hfd.config, "HF_DATASETS_CACHE", str(tmp_path / f"cache_{side}"))
        out[side] = {split: mod.load_socioseg(str(root), split) for split in ("train", "val")}
        loader = j_loader if side == "jax" else t_loader
        out[side]["registry"] = loader.get_dataset(SimpleNamespace(
            dataset_type="socioseg", file_name=None, dataset_dir=str(root), split="train"))
    for key in ("train", "val", "registry"):
        got, want = out["port"][key], out["jax"][key]
        assert len(got) == len(want) > 0 and got.features == want.features
        for g, w in zip(got, want):
            assert (g["id"], g["problem"]) == (w["id"], w["problem"])
            for img in ("map_image", "sat_image", "mask_label"):
                np.testing.assert_array_equal(np.asarray(g[img]), np.asarray(w[img]))
    assert [r["id"] for r in out["port"]["train"]] == ["tile0", "tile2"]
    assert [r["problem"] for r in out["port"]["val"]] == ["val area 0"]


# ------------------------------------------------------------- sampler

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_stratified_sampler_matches_jax(seed):
    """Three epochs of batches from one seed: the same index sequence; each
    batch holds each domain's quota."""
    rng = np.random.default_rng(seed)
    domains = rng.choice(["math", "code", "geo"], size=37, p=[0.5, 0.3, 0.2]).tolist()
    ratios = {"math": 0.5, "code": 0.3, "geo": 0.2}
    for drop_last, bs in ((True, 6), (False, 5)):
        t = t_sampler.BatchStratifiedSampler(domains, ratios, bs, seed=seed,
                                             drop_last=drop_last)
        j = j_sampler.BatchStratifiedSampler(domains, ratios, bs, seed=seed,
                                             drop_last=drop_last)
        got = [b for _ in range(3) for b in t]
        assert got == [b for _ in range(3) for b in j]
        assert len(t) == len(j) and t.quota == j.quota
        for b in got:
            counts = {d: sum(domains[i] == d for i in b) for d in ratios}
            assert counts == t.quota and len(b) == bs


# ------------------------------------------------ RunningMoments, metrics

def test_running_moments_match_jax():
    """Five batches of different sizes and scales (a single value among
    them): the batch stats each update returns and the running mean, std,
    var and count, to the bit."""
    rng = np.random.default_rng(3)
    t, j = t_fn.RunningMoments(), j_fn.RunningMoments()
    for size, scale in ((8, 1.0), (1, 3.0), (16, 0.1), (5, 10.0), (32, 1e-3)):
        xs = (rng.normal(size=size) * scale + scale).astype(np.float32)
        assert t.update(xs) == j.update(xs)
        assert (t.mean, t.std, t.var, t.count) == (j.mean, j.std, j.var, j.count)


def test_compute_data_metrics_matches_jax():
    """Seeded postprocessed masks, rewards and advantages, with and without
    the advantages and with a prefix; and a batch without response tokens."""
    rng = np.random.default_rng(5)
    B, L = 6, 20
    lens = rng.integers(8, L + 1, size=B)
    attn = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    resp = ((np.arange(L)[None] >= 5) & (attn == 1)).astype(np.int64)
    post = {"attention_mask": attn, "response_mask": resp}
    rewards = rng.normal(size=B).astype(np.float32)
    adv = rng.normal(size=(B, L - 1)).astype(np.float32)
    for kw in ({}, {"advantages": adv}, {"advantages": adv, "prefix": "val/"}):
        _assert_same(t_eval.compute_data_metrics(post, rewards, **kw),
                     j_eval.compute_data_metrics(post, rewards, **kw))
    empty = {"attention_mask": attn, "response_mask": np.zeros_like(resp)}
    _assert_same(t_eval.compute_data_metrics(empty, rewards, advantages=adv),
                 j_eval.compute_data_metrics(empty, rewards, advantages=adv))


class _EvalPipeline:
    """What run_validation asks of a pipeline: its config's
    rollout_batch_size and evaluate_batch(rows) -> gious (here read from
    the rows)."""

    def __init__(self, batch_size):
        self.pipeline_config = SimpleNamespace(rollout_batch_size=batch_size)
        self.batches = []

    def evaluate_batch(self, rows):
        self.batches.append(len(rows))
        return [r["giou"] for r in rows]


def test_run_validation_matches_jax():
    rng = np.random.default_rng(6)
    rows = [{"giou": float(g), "tag": t} for g, t in zip(
        rng.uniform(size=7), ["city_a", "city_b", "", "city_a", "city_c", "city_b", "city_a"])]
    for max_tiles in (None, 5):
        t_pipe, j_pipe = _EvalPipeline(3), _EvalPipeline(3)
        got = t_eval.run_validation(t_pipe, rows, max_tiles)
        assert got == j_eval.run_validation(j_pipe, rows, max_tiles)
        assert t_pipe.batches == j_pipe.batches
    assert t_pipe.batches == [3, 2] and got["val_iou/city_a/count"] == 2.0


# ------------------------------------------------- DynamicSamplingScheduler

N = 2
TARGET = 4
PROMPT_LEN = 24
QUESTION_RE = re.compile(r"q(\d+): (\d+)\+(\d+)")


def _tokenizer():
    from socioreasoner_tpu_torch.datasets.processor import SimpleTokenizer
    return SimpleTokenizer(vocab_size=512)


def _rows(n=10):
    return [{"prompt": f"q{i}: {i}+{2 * i}", "ground_truth": str(3 * i),
             "tag": "math" if i % 3 else "arith"} for i in range(n)]


def _collate(batch_cls):
    """A one-row left-padded batch of each package's BatchProto."""
    tok = _tokenizer()

    def collate(rows):
        ids = np.zeros((len(rows), PROMPT_LEN), np.int64)
        attn = np.zeros_like(ids)
        for i, r in enumerate(rows):
            toks = tok.encode(r["prompt"])[-PROMPT_LEN:]
            ids[i, PROMPT_LEN - len(toks):] = toks
            attn[i, PROMPT_LEN - len(toks):] = 1
        pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None],
                              (len(rows), 3, PROMPT_LEN)).copy()
        return batch_cls.from_dict(
            tensors={"input_ids": ids, "attention_mask": attn, "position_ids": pos},
            non_tensors={"ground_truth": [r["ground_truth"] for r in rows]},
            meta={"pad_token_id": 0})
    return collate


def _answer(prompt: str, j: int) -> str:
    """Sample j's answer to prompt i: right for j = 0 and, where i is a
    multiple of 4, for every sample, wrong otherwise; in the think/answer
    format for odd j, else a sentence that ends in i % 5 "!"."""
    i, a, b = (int(x) for x in QUESTION_RE.search(prompt).groups())
    ans = a + b if j == 0 or i % 4 == 0 else a + b + 1 + j
    return f"<think>{i}.{j}</think><answer>{ans}</answer>" if j % 2 else \
        f"so {ans}" + "!" * (i % 5)


class _LaggingWorker:
    """A decode worker that holds its requests and answers them, oldest
    first, on the caller's thread: one when it holds more than `lag`, and
    one at each ALIVE_CHECK. A deterministic stand-in for a
    server's thread, so that routing, flow control and the final ABORTs
    depend on requests in flight."""

    def __init__(self, lag=5):
        self.tok = _tokenizer()
        self.lag = lag
        self.held, self.log = [], []

    def start_server(self):
        pass

    def stop_server(self):
        self.log.append("stop")

    def _answer(self, n):
        for _ in range(n):
            data = self.held.pop(0)
            prompt = self.tok.decode(data["prompt_ids"])
            ids = self.tok.encode(_answer(prompt, data["request_id"][1]))
            data["callback"](SimpleNamespace(request_id=data["request_id"], output_ids=ids,
                                             finish_reason="stop"))

    def add_request(self, command, data):
        self.log.append((command.name, None if data is None else data.get("request_id")))
        if command.name == "ADD":
            self.held.append(data)
            self._answer(max(0, len(self.held) - self.lag))
        elif command.name == "ALIVE_CHECK":
            self._answer(min(1, len(self.held)))
        elif command.name == "ABORT":
            keep = [d for d in self.held if d["request_id"] != data["request_id"]]
            for d in self.held:
                if d not in keep:
                    d["callback"](SimpleNamespace(request_id=d["request_id"], output_ids=[],
                                                  finish_reason="abort"))
            self.held = keep
        return {"alive": True}


class _Cluster:
    def __init__(self, workers):
        self.workers = workers

    def start_server(self):
        for w in self.workers:
            w.start_server()

    def stop_server(self):
        for w in self.workers:
            w.stop_server()


def _run_scheduler(side, **kw):
    sched_mod, batch_cls, math, wc = ((j_sched, JBatch, j_math, j_wc) if side == "jax"
                                      else (t_sched, TBatch, t_math, t_wc))
    tok = _tokenizer()
    workers = [_LaggingWorker(), _LaggingWorker()]
    seen = []

    def query_filter(row, outs):
        """Reject the first group, and the groups where every sample is
        right (i a multiple of 4)."""
        seen.append(row["prompt"])
        return len(seen) > 1 and int(row["ground_truth"]) % 12 != 0

    def response_filter(row, out):
        return out.count(36) < 4                # fewer than four "!" (byte 33 + 3)

    def reward(texts, rows):
        return math.compute_math_rewards(texts, [r["ground_truth"] for r in rows])

    sched = sched_mod.DynamicSamplingScheduler(
        _Cluster(workers), _collate(batch_cls), reward_fns={"math": reward, "arith": reward},
        detokenize=lambda ids: tok.decode(list(ids)), query_filter=query_filter,
        response_filter=response_filter, max_running_requests=6,
        max_additional_running_prompts=3, alive_check_interval=0.0, **kw)
    args = wc.GeneratingArguments(max_new_tokens=8, num_return_sequences=N)
    batch = sched.get_batch(iter(_rows(12)), TARGET, args)
    return batch, workers, seen


@pytest.mark.parametrize("filters", [True, False])
def test_dynamic_sampling_scheduler_matches_jax(filters):
    """Two lagging workers, both filters (or none, with
    is_use_additional_prompts off), 4 groups wanted: the same batch, output
    sequences, rewards and scheduler metrics, and the same requests routed
    to each worker, ABORTs of what was in flight included."""
    out = {side: _run_scheduler(side, is_use_additional_prompts=filters)
           for side in ("jax", "port")}
    (jb, jw, jseen), (tb, tw, tseen) = out["jax"], out["port"]
    assert tseen == jseen
    for k in ("input_ids", "attention_mask", "position_ids"):
        np.testing.assert_array_equal(tb.batch[k], jb.batch[k], err_msg=k)
    assert list(tb.non_tensor["ground_truth"]) == list(jb.non_tensor["ground_truth"])
    assert sorted(tb.meta) == sorted(jb.meta)
    for k in ("output", "scores", "response_level_rewards"):
        np.testing.assert_array_equal(tb.meta[k], jb.meta[k], err_msg=k)
        assert tb.meta[k].dtype == jb.meta[k].dtype
    assert tb.meta["metrics"] == jb.meta["metrics"]
    assert [w.log for w in tw] == [w.log for w in jw]
    m = tb.meta["metrics"]
    assert m["scheduler/collect_query_count"] == TARGET and len(tb) == TARGET
    if filters:
        assert m["scheduler/query_filter_count"] >= 1
        assert m["scheduler/response_filter_count"] >= 1
        assert m["scheduler/prompt_use_count"] >= TARGET + 2
        assert any(entry[0] == "ABORT" for w in tw for entry in w.log[:-1])
        assert "scheduler/arith/score/mean" in m and "scheduler/math/score/mean" in m
    else:
        assert m["scheduler/query_filter_count"] == 0
    assert 0 < tb.meta["scores"].sum() < len(tb.meta["scores"])


class _ThreadedWorker:
    """A decode worker whose own thread answers each request after a random
    short delay, aborted ones with finish_reason "abort", as a server's
    thread does."""

    def __init__(self, seed):
        import queue
        self.tok = _tokenizer()
        self.rng = np.random.default_rng(seed)
        self.queue = queue.Queue()
        self.aborted = set()
        self.thread = None

    def start_server(self):
        import threading
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def stop_server(self):
        self.queue.put(None)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def _loop(self):
        import time
        while (data := self.queue.get()) is not None:
            time.sleep(float(self.rng.uniform(0, 2e-3)))
            rid = data["request_id"]
            if rid in self.aborted:
                data["callback"](SimpleNamespace(request_id=rid, output_ids=[],
                                                 finish_reason="abort"))
                continue
            prompt = self.tok.decode(data["prompt_ids"])
            data["callback"](SimpleNamespace(
                request_id=rid, output_ids=self.tok.encode(_answer(prompt, rid[1])),
                finish_reason="stop"))

    def add_request(self, command, data):
        if command.name == "ADD":
            self.queue.put(data)
        elif command.name == "ABORT":
            self.aborted.add(data["request_id"])
        return {"alive": True}


def test_dynamic_sampling_scheduler_under_threads():
    """Eight workers each answering on its own thread, a shortened switch
    interval, three rounds: every round returns the target groups, each
    row holds its own prompt's answer, and the counts add up (time-bounded
    by the workers' joins)."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for round_ in range(3):
            workers = [_ThreadedWorker(10 * round_ + i) for i in range(8)]
            sched = t_sched.DynamicSamplingScheduler(
                _Cluster(workers), _collate(TBatch),
                reward_fns={"math": lambda texts, rows: t_math.compute_math_rewards(
                    texts, [r["ground_truth"] for r in rows])},
                detokenize=lambda ids: _tokenizer().decode(list(ids)),
                query_filter=lambda row, outs: int(row["ground_truth"]) % 12 != 0,
                response_filter=lambda row, out: out.count(36) < 4,
                max_running_requests=4, max_additional_running_prompts=5,
                alive_check_interval=0.01)
            batch = sched.get_batch(iter(_rows(40)), 6,
                                    t_wc.GeneratingArguments(num_return_sequences=N))
            tok = _tokenizer()
            out = batch.meta["output"]
            assert out.shape[0] == 6 * N and len(batch) == 6
            for k in range(6 * N):
                prompt = tok.decode([t for t in out[k, :PROMPT_LEN] if t])
                answer = tok.decode([t for t in out[k, PROMPT_LEN:] if t])
                assert answer == _answer(prompt, k % N)
            m = batch.meta["metrics"]
            assert m["scheduler/prompt_use_count"] >= 6 + m["scheduler/query_filter_count"]
            np.testing.assert_array_equal(batch.meta["scores"], t_math.compute_math_rewards(
                [tok.decode([t for t in row if t]) for row in out[:, PROMPT_LEN:]],
                [g for g in batch.non_tensor["ground_truth"] for _ in range(N)])["scores"])
    finally:
        sys.setswitchinterval(interval)
