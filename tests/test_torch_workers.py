"""The port's worker runtime and rewards against the JAX package's.

Dispatch and Cluster (every dispatch mode, non-blocking calls, worker_cls
strings of both packages), the rule reward workers on parametrised
answers, the code sandbox (stdin and assert cases, a crash, a timeout, the
remote mode against a localhost stub of the sandbox service), the LLM
judge through a scripted generate_fn, the strategy factory, and
RLVRPipeline scoring through a `rewards:` block of worker clusters for two
steps against the JAX pipeline.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from socioreasoner_tpu.configs.worker_config import WorkerConfig as JWorkerConfig
from socioreasoner_tpu.distributed import factory as j_factory
from socioreasoner_tpu.pipeline import base_worker as j_worker
from socioreasoner_tpu.pipeline.rlvr.rewards import code_sandbox as j_code
from socioreasoner_tpu.pipeline.rlvr.rewards import general_rules as j_general
from socioreasoner_tpu.pipeline.rlvr.rewards import llm_judge as j_judge
from socioreasoner_tpu.protocol import BatchProto as JBatchProto
from socioreasoner_tpu.runtime import cluster as j_cluster
from socioreasoner_tpu.runtime import dispatch as j_dispatch
from socioreasoner_tpu.runtime.worker import Worker as JWorker
from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
from socioreasoner_tpu_torch.distributed import factory as t_factory
from socioreasoner_tpu_torch.pipeline import base_worker as t_worker
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import code_sandbox as t_code
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import general_rules as t_general
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import llm_judge as t_judge
from socioreasoner_tpu_torch.protocol import BatchProto
from socioreasoner_tpu_torch.runtime import cluster as t_cluster
from socioreasoner_tpu_torch.runtime import dispatch as t_dispatch
from socioreasoner_tpu_torch.runtime.worker import Worker


# ---------------------------------------------------------------- runtime

def _toy(worker_base, dispatch):
    """A worker class on one package's runtime: every dispatch mode, each
    method recording the rows or arguments it was given."""
    D, register = dispatch.Dispatch, dispatch.register

    class Toy(worker_base):
        @register(dispatch_mode=D.DP_MP_COMPUTE)
        def double(self, data):
            self.shared.setdefault("rows", {})[self.rank_info.rank] = \
                np.asarray(data.batch["x"]).tolist()
            return type(data).from_dict(tensors={"y": np.asarray(data.batch["x"]) * 2})

        @register(dispatch_mode=D.ONE_TO_ALL)
        def rank(self):
            return self.rank_info.rank

        @register(dispatch_mode=D.ONE_TO_ALL_ONE)
        def first_only(self, v):
            return (self.rank_info.rank, v)

        @register(dispatch_mode=D.ALL_TO_ALL)
        def pick(self, v, tag):
            return (self.rank_info.rank, v, tag)

        @register(dispatch_mode=D.DP_MP_DISPATCH_FIRST)
        def whole(self, data):
            self.shared["whole"] = self.shared.get("whole", 0) + 1
            return len(data)

        @register(dispatch_mode=D.ONE_TO_ALL, blocking=False)
        def slow(self, delay):
            time.sleep(delay)
            return self.rank_info.rank
    return Toy


JToy = _toy(JWorker, j_dispatch)
TToy = _toy(Worker, t_dispatch)


def _clusters(world_size):
    return (j_cluster.Cluster("toy", JToy, JWorkerConfig(world_size=world_size)),
            t_cluster.Cluster("toy", TToy, WorkerConfig(world_size=world_size)))


@pytest.mark.parametrize("n_rows,world_size", [(5, 3), (7, 3), (4, 2), (3, 1), (2, 4)])
def test_dp_mp_compute_pads_chunks_and_trims_like_jax(n_rows, world_size):
    """DP_MP_COMPUTE: the batch padded to a multiple of the workers, each
    worker its chunk, the results concatenated with the pad trimmed."""
    jc, tc = _clusters(world_size)
    want = jc.double(JBatchProto.from_dict(tensors={"x": np.arange(n_rows)}))
    got = tc.double(BatchProto.from_dict(tensors={"x": np.arange(n_rows)}))
    np.testing.assert_array_equal(got.batch["y"], np.arange(n_rows) * 2)
    np.testing.assert_array_equal(got.batch["y"], want.batch["y"])
    assert tc.shared["rows"] == jc.shared["rows"]
    assert len(tc.shared["rows"]) == world_size


def test_one_to_all_all_to_all_and_dispatch_first_like_jax():
    jc, tc = _clusters(4)
    assert sorted(tc.rank()) == sorted(jc.rank()) == [0, 1, 2, 3]
    assert tc.first_only(9) == jc.first_only(9) == (0, 9)
    assert tc.pick([10, 11, 12, 13], "t") == jc.pick([10, 11, 12, 13], "t")
    assert tc.pick([10, 11, 12, 13], "t")[2] == (2, 12, "t")
    data = BatchProto.from_dict(tensors={"x": np.arange(6)})
    assert tc.whole(data) == jc.whole(JBatchProto.from_dict(tensors={"x": np.arange(6)})) == 6
    assert tc.shared["whole"] == 1        # worker 0 alone ran
    for c in (jc, tc):
        assert c.execute_all("rank") == [0, 1, 2, 3]
        assert c.execute_rank_zero("first_only", 5) == (0, 5)
        assert [f.result() for f in c.execute_all_async("rank")] == [0, 1, 2, 3]
        c.shutdown()


def test_non_blocking_calls():
    """blocking=False returns a handle at once (the registered default of
    `slow`, and a DP_MP_COMPUTE call asked so), its get() the collected
    result."""
    _, tc = _clusters(2)
    t0 = time.perf_counter()
    handle = tc.slow(0.3)
    assert time.perf_counter() - t0 < 0.25 and not handle.done()
    assert handle.get() == [0, 1] and handle.done()
    assert tc.slow(0.0, blocking=True) == [0, 1]
    lazy = tc.double(BatchProto.from_dict(tensors={"x": np.arange(5)}), blocking=False)
    np.testing.assert_array_equal(lazy.get().batch["y"], np.arange(5) * 2)


@pytest.mark.parametrize("mode", list(t_dispatch.Dispatch), ids=lambda m: m.name)
def test_dispatch_args_and_collect_match_jax(mode):
    jmode = j_dispatch.Dispatch[mode.name]
    args = ([1, 2, 3], "a")
    j_calls, j_ctx = j_dispatch.dispatch_args(jmode, 3, args, {"k": 1})
    t_calls, t_ctx = t_dispatch.dispatch_args(mode, 3, args, {"k": 1})
    assert t_calls == j_calls and t_ctx == j_ctx
    results = [("r", i) for i in range(len(t_calls))]
    assert t_dispatch.collect_results(mode, results) == \
        j_dispatch.collect_results(jmode, results)


@pytest.mark.parametrize("path,want", [
    ("socioreasoner_tpu.pipeline.base_worker.MathRuleRewardWorker",
     t_worker.MathRuleRewardWorker),
    ("socioreasoner_tpu_torch.pipeline.base_worker.MathRuleRewardWorker",
     t_worker.MathRuleRewardWorker),
    ("socioreasoner_tpu.pipeline.base_worker.SocioSegRuleRewardWorker",
     t_worker.SocioSegRuleRewardWorker),
    ("socioreasoner_tpu.pipeline.base_worker.RewardWorker", t_worker.RewardWorker),
])
def test_worker_cls_strings_resolve_to_the_port(path, want):
    """A path into the JAX package (or the port) loads the port's class."""
    assert t_cluster.safe_import_class(path) is want
    cluster = t_cluster.Cluster("c", path, WorkerConfig(world_size=2))
    assert all(type(w) is want for w in cluster.workers)
    assert [w.rank_info.rank for w in cluster.workers] == [0, 1]
    assert cluster.workers[1].worker_name == "c-1"


def test_other_worker_cls_strings_import_as_written():
    import collections
    assert t_cluster.safe_import_class("collections.OrderedDict") is collections.OrderedDict
    cluster = t_cluster.Cluster("toy", "tests.test_torch_workers.TToy",
                                WorkerConfig(world_size=2))
    assert type(cluster.workers[0]).__qualname__ == "_toy.<locals>.Toy"
    assert sorted(cluster.rank()) == [0, 1]


def test_unknown_worker_cls_raises_import_error():
    for mod in (j_cluster, t_cluster):
        with pytest.raises(ImportError):
            mod.Cluster("c", "my.rewards.MathRuleRewardWorker", WorkerConfig())


# ------------------------------------------------------------ rule rewards

ANSWERS = [
    ("<think>x</think><answer>42</answer>", "42"),
    ("<think>x</think><answer>41</answer>", "42"),
    ("the answer is \\boxed{3/4}", "0.75"),
    ("<think>pick</think><answer>B</answer>", "B"),
    ("<answer>I think C, not B</answer>", "B"),
    ("<think>t</think> <answer>The Eiffel Tower</answer>", "eiffel tower"),
    ("Paris is the capital.", "Paris"),
    ("<answer></answer>", "x"),
    ("no answer at all", "7"),
    ("<answer>12.0</answer>", "12"),
]
CODE_CASES = json.dumps([{"input": "3\n", "output": "6"}, {"assert": "assert f(2) == 4"}])
CODE_ANSWERS = [
    ("```python\nimport sys\ndef f(x):\n    return 2 * x\nfor line in sys.stdin:\n"
     "    print(f(int(line)))\n```", CODE_CASES),
    ("```python\nimport sys\ndef f(x):\n    return x * 3\nfor line in sys.stdin:\n"
     "    print(f(int(line)))\n```", CODE_CASES),
    ("```python\nraise SystemExit(3)\n```", CODE_CASES),
    ("I cannot write code", CODE_CASES),
]


def _columns(pairs):
    return {"response_text": [p[0] for p in pairs], "ground_truth": [p[1] for p in pairs]}


@pytest.mark.parametrize("name,pairs", [
    ("MathRuleRewardWorker", ANSWERS), ("CrossThinkQARewardWorker", ANSWERS),
    ("CodeSandboxRewardWorker", CODE_ANSWERS)])
def test_rule_workers_match_jax(name, pairs):
    """compute_rewards through a 3-worker cluster of each package: the same
    arrays, and the same metrics (the last chunk's: the collect merges the
    chunks' meta in order)."""
    j = j_cluster.Cluster("d", getattr(j_worker, name), JWorkerConfig(world_size=3))
    t = t_cluster.Cluster("d", f"socioreasoner_tpu.pipeline.base_worker.{name}",
                          WorkerConfig(world_size=3))
    want = j.compute_rewards(JBatchProto.from_dict(non_tensors=_columns(pairs)))
    got = t.compute_rewards(BatchProto.from_dict(non_tensors=_columns(pairs)))
    assert sorted(got.batch) == sorted(want.batch) == ["response_level_rewards", "scores"]
    for k in want.batch:
        np.testing.assert_array_equal(got.batch[k], want.batch[k], err_msg=k)
    assert got.meta == want.meta
    assert len(set(got.batch["response_level_rewards"].tolist())) > 1


def test_general_val_worker_scores_its_domain():
    """The JAX worker calls compute_general_val_scores without the domains
    and raises; the port's scores every row as its cluster's domain, equal
    to the JAX function given that domain."""
    texts, gts = _columns(ANSWERS).values()
    with pytest.raises(TypeError, match="domains"):
        j_worker.GeneralValRuleRewardWorker(worker_config=JWorkerConfig()).compute_rewards(
            JBatchProto.from_dict(non_tensors=_columns(ANSWERS)))
    for domain in ("general", "math_val"):
        cluster = t_cluster.Cluster(domain, t_worker.GeneralValRuleRewardWorker,
                                    WorkerConfig(world_size=2))
        got = cluster.compute_rewards(BatchProto.from_dict(non_tensors=_columns(ANSWERS)))
        want = j_general.compute_general_val_scores(texts, gts, [domain] * len(texts))
        np.testing.assert_array_equal(got.batch["scores"], want["scores"])
        assert got.meta["metrics"] == j_general.compute_general_val_scores(
            texts[5:], gts[5:], [domain] * 5)["metrics"]    # the last chunk's


@pytest.mark.parametrize("text,gt", ANSWERS + [("A) one B) two", "A"), ("", "")])
def test_general_rules_match_jax(text, gt):
    for fn in ("normalize_text", "extract_choice", "crossthink_format"):
        assert getattr(t_general, fn)(text) == getattr(j_general, fn)(text)
    assert t_general.crossthink_accuracy(text, gt) == j_general.crossthink_accuracy(text, gt)


def test_crossthink_and_val_rewards_match_jax():
    texts, gts = _columns(ANSWERS).values()
    domains = ["math", "qa", None, "math_hard", "qa", "", "qa", "math", "x", "math"]
    for got, want in ((t_general.compute_crossthink_rewards(texts, gts, 0.2),
                       j_general.compute_crossthink_rewards(texts, gts, 0.2)),
                      (t_general.compute_general_val_scores(texts, gts, domains),
                       j_general.compute_general_val_scores(texts, gts, domains))):
        for k in ("scores", "response_level_rewards"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["metrics"] == want["metrics"]


# ------------------------------------------------------------- code sandbox

@pytest.mark.parametrize("response,cases", [
    ("```python\nprint(sum(map(int, input().split())))\n```",
     [{"input": "1 2\n", "output": "3"}, {"input": "4 5", "output": "9\n"},
      {"input": "1 1", "output": "3"}]),
    ("```py\ndef add(a, b):\n    return a + b\n```",
     [{"assert": "assert add(1, 2) == 3"}, {"assert": "assert add(1, 2) == 4"}]),
    ("```python\nimport sys\nsys.exit(1)\n```", [{"input": "", "output": ""}]),
    ("```python\nprint(1 / 0)\n```", json.dumps([{"input": "", "output": "1"}])),
    ("def f():\n    return 1\nprint(f())", [{"input": "", "output": "1"}]),
    ("no code here", [{"input": "", "output": ""}]),
    ("```python\nprint(1)\n```", "not json"),
    ("```python\nprint(1)\n```", []),
], ids=["stdin", "assert", "exit1", "crash", "bare_code", "no_code", "bad_json", "no_cases"])
def test_local_sandbox_matches_jax(response, cases):
    assert t_code.score_response(response, cases, timeout=5) == \
        j_code.score_response(response, cases, timeout=5)
    assert t_code.extract_code(response) == j_code.extract_code(response)


def _running(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_local_sandbox_timeout_kills_the_group(tmp_path):
    """A solution past its 1 s timeout scores 0, and the sleeping child it
    started dies with its process group."""
    pid_file = tmp_path / "child.pid"
    code = ("```python\nimport subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(30)'])\n"
            f"open({str(pid_file)!r}, 'w').write(str(p.pid))\n"
            "time.sleep(30)\n```")
    t0 = time.perf_counter()
    assert t_code.score_response(code, [{"input": "", "output": ""}], timeout=1) == 0.0
    assert time.perf_counter() - t0 < 5
    child = int(pid_file.read_text())
    deadline = time.monotonic() + 5
    while _running(child) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _running(child)
    assert (t_code.MEM_LIMIT_BYTES, t_code.STACK_LIMIT_BYTES, t_code.FSIZE_LIMIT_BYTES,
            t_code.NPROC_LIMIT) == (j_code.MEM_LIMIT_BYTES, j_code.STACK_LIMIT_BYTES,
                                    j_code.FSIZE_LIMIT_BYTES, j_code.NPROC_LIMIT)


def test_compute_code_rewards_matches_jax():
    responses, cases = zip(*CODE_ANSWERS)
    got = t_code.compute_code_rewards(responses, cases, timeout=5)
    want = j_code.compute_code_rewards(responses, cases, timeout=5)
    np.testing.assert_array_equal(got["scores"], want["scores"])
    assert got["metrics"] == want["metrics"]
    np.testing.assert_array_equal(got["scores"], [1.0, 0.0, 0.0, 0.0])


class _StubSandbox(BaseHTTPRequestHandler):
    """The sandbox service on localhost: runs the posted python in process
    (the tests' own code only) and answers in the service's shape."""

    fail_first_n = 0          # answer SandboxError to the first N requests
    seen = []

    def do_POST(self):
        import contextlib
        import io
        import sys
        cls = type(self)
        payload = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        cls.seen.append(payload)
        if cls.fail_first_n > 0:
            cls.fail_first_n -= 1
            body = {"status": "SandboxError", "message": "transient"}
        else:
            out, status, old_stdin = io.StringIO(), "Success", sys.stdin
            try:
                sys.stdin = io.StringIO(payload.get("stdin", ""))
                with contextlib.redirect_stdout(out):
                    exec(payload["code"], {"__name__": "__main__"})
            except Exception:
                status = "Failed"
            finally:
                sys.stdin = old_stdin
            body = {"status": status,
                    "run_result": {"stdout": out.getvalue(), "stderr": "", "return_code": 0}}
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def sandbox_url():
    _StubSandbox.seen = []
    _StubSandbox.fail_first_n = 0
    srv = HTTPServer(("127.0.0.1", 0), _StubSandbox)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}/run_code"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_remote_stdin_case_and_payload(sandbox_url):
    resp = "```python\nprint(int(input()) * 2)\n```"
    cases = [{"input": "3", "output": "6"}, {"input": "5", "output": "11"}]
    assert t_code.score_response(resp, cases, sandbox=t_code.RemoteSandbox(sandbox_url)) == 0.5
    ours = list(_StubSandbox.seen)
    _StubSandbox.seen.clear()
    assert j_code.score_response(resp, cases, sandbox=j_code.RemoteSandbox(sandbox_url)) == 0.5
    key = lambda p: json.dumps(p, sort_keys=True)   # noqa: E731
    assert sorted(map(key, ours)) == sorted(map(key, _StubSandbox.seen))
    assert {"compile_timeout", "run_timeout", "code", "language", "stdin",
            "expected_stdout"} <= set(ours[0]) and ours[0]["language"] == "python"


def test_remote_assert_case_and_retry(sandbox_url):
    """A SandboxError is retried; an assert case passes on Success."""
    _StubSandbox.fail_first_n = 1
    resp = "```python\ndef add(a, b):\n    return a + b\n```"
    cases = [{"assert": "assert add(2, 2) == 4"}, {"assert": "assert add(2, 2) == 5"}]
    out = t_code.compute_code_rewards([resp, "no code"], [cases, cases], code_url=sandbox_url)
    np.testing.assert_allclose(out["response_level_rewards"], [0.5, 0.0])
    assert len(_StubSandbox.seen) == 3 and _StubSandbox.fail_first_n == 0


def test_remote_worker_wiring(sandbox_url):
    """CodeSandboxRewardWorker runs its cases remotely when its config has
    a code_url, equal to the JAX worker's score."""
    columns = {"response_text": ["```python\nprint('ok')\n```", "```python\nprint('no')\n```"],
               "ground_truth": [json.dumps([{"input": "", "output": "ok"}])] * 2}
    cluster = t_cluster.Cluster("code", t_worker.CodeSandboxRewardWorker,
                                WorkerConfig(world_size=2, code_url=sandbox_url))
    got = cluster.compute_rewards(BatchProto.from_dict(non_tensors=columns))
    np.testing.assert_allclose(got.batch["response_level_rewards"], [1.0, 0.0])
    assert len(_StubSandbox.seen) == 2          # executed remotely, not locally
    want = j_worker.CodeSandboxRewardWorker(
        worker_config=JWorkerConfig(code_url=sandbox_url)).compute_rewards(
        JBatchProto.from_dict(non_tensors=columns))
    np.testing.assert_array_equal(got.batch["scores"], want.batch["scores"])


def test_unreachable_url_scores_zero():
    sandbox = t_code.RemoteSandbox("http://127.0.0.1:9/run_code", timeout=0.2, max_retries=1)
    assert t_code.score_response("```python\nprint(1)\n```",
                                 [{"input": "", "output": "1"}], sandbox=sandbox) == 0.0


# ----------------------------------------------------------------- judge

@pytest.mark.parametrize("text", ["SCORE: 1", "score:0.5 because", "SCORE: 0", "1", "Correct!",
                                  "the answer is correct", "0 wrong", "", "SCORE: 7"])
def test_parse_judge_score_matches_jax(text):
    assert t_judge.parse_judge_score(text) == j_judge.parse_judge_score(text)


def test_llm_judge_with_a_scripted_generate_fn():
    """The prompts the judge receives and the scores equal the JAX
    function's, with the default template and with a custom one."""
    questions, responses = ["1+1?", "capital of France?", "2*3?"], ["2", "Lyon", "6"]
    references = ["2", "Paris", "6"]
    seen = {"jax": [], "port": []}

    def judge(side):
        def generate_fn(prompts):
            seen[side].append(list(prompts))
            return ["SCORE: 1" if i % 2 == 0 else "it is wrong" for i in range(len(prompts))]
        return generate_fn
    for template in (t_judge.DEFAULT_JUDGE_TEMPLATE, "Q {question} R {reference} A {response}\n"):
        got = t_judge.compute_llm_judge_rewards(questions, responses, references,
                                                judge("port"), template)
        want = j_judge.compute_llm_judge_rewards(questions, responses, references,
                                                 judge("jax"), template)
        np.testing.assert_array_equal(got["scores"], want["scores"])
        assert got["metrics"] == want["metrics"]
    np.testing.assert_array_equal(got["scores"], [1.0, 0.0, 1.0])
    assert seen["port"] == seen["jax"]
    assert t_judge.DEFAULT_JUDGE_TEMPLATE == j_judge.DEFAULT_JUDGE_TEMPLATE


# ----------------------------------------------------------------- factory

@pytest.mark.parametrize("name", sorted({*j_factory.ALIASES, "jax_train", "jax_infer",
                                         "jax_decode", "seg_infer", "torch_train",
                                         "torch_infer", "torch_decode"}))
def test_create_strategy_for_every_name(name):
    """Each name the JAX factory takes gives the port's counterpart of its
    class (Jax* → Torch*), the port's own torch_* names likewise; the
    worker config and param store are passed on."""
    wc = WorkerConfig()
    got = t_factory.create_strategy(name, worker_config=wc)
    assert got.worker_config is wc
    jname = name.replace("torch_", "jax_")
    want = {"jax_train": "JaxTrainStrategy", "jax_infer": "JaxInferStrategy",
            "jax_decode": "JaxDecodeStrategy", "seg_infer": "SegStrategy"}[
        j_factory.ALIASES.get(jname, jname)]
    assert type(got).__name__ == want.replace("Jax", "Torch")


def test_create_strategy_unknown_name_raises():
    for mod in (j_factory, t_factory):
        with pytest.raises(ValueError, match="unknown strategy"):
            mod.create_strategy("megatron_reward")


# --------------------------------------------------- RLVR through clusters

def _multi_domain_pipe(side, out_dir):
    """RLVRPipeline (the plain route, GRPO) of one package whose rewards come
    from the config's worker clusters (math over 3 workers, crossthinkqa
    over 2), decoded through the scripted worker; the reward calls
    recorded per domain."""
    import jax
    import jax.numpy as jnp
    import torch
    from socioreasoner_tpu.datasets.processor import SocioProcessor as JProcessor
    from socioreasoner_tpu.pipeline.rlvr import rlvr_pipeline as j_rlvr
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
    from socioreasoner_tpu_torch.pipeline.rlvr import rlvr_pipeline as t_rlvr
    from tests.test_infer_pipeline_e2e import TinyTokenizer
    from tests.test_torch_engine import _port
    from tests.test_torch_pipeline import _tokenizer
    from tests.test_torch_rlvr_pipeline import (TEXT_ENGINE, ScriptedWorker, _adam_eps,
                                                _config, _weights)

    jax_side = side == "jax"
    wc = JWorkerConfig if jax_side else WorkerConfig
    base = "socioreasoner_tpu.pipeline.base_worker."
    rewards = {"math": wc(worker_cls=base + "MathRuleRewardWorker", world_size=3),
               "crossthinkqa": wc(worker_cls=base + "CrossThinkQARewardWorker", world_size=2)}
    cfg = _config(side, out_dir, prompt_length=64, max_steps=2, rewards=rewards)
    config, weights = _weights(False)
    rows = [{"prompt": f"{i}+{i + 2}=?", "ground_truth": str(2 * i + 2),
             "tag": ("math", "crossthinkqa")[i % 2]} for i in range(6)]
    engine = dict(TEXT_ENGINE)
    if jax_side:
        processor = JProcessor(TinyTokenizer(), None, image_token_id=config.image_token_id)
        tree = jax.tree.map(jnp.asarray, weights)
        engine.update(cache_dtype=jnp.float32, sampler_exact=True)
        pipe = j_rlvr.RLVRPipeline(cfg, model_config=config, policy_params=tree,
                                   reference_params=tree, processor=processor, dataset=rows,
                                   engine_kwargs=engine)
    else:
        processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), None,
                                               image_token_id=config.image_token_id)
        engine.update(cache_dtype=torch.float32)
        pipe = t_rlvr.RLVRPipeline(cfg, model_config=_port(config),
                                   policy_params=params_from_numpy(weights, "cpu"),
                                   reference_params=params_from_numpy(weights, "cpu"),
                                   processor=processor, dataset=rows, engine_kwargs=engine)
    _adam_eps(side, pipe)
    pipe.actor_infer.generate = ScriptedWorker(pipe.processor.tokenizer, config.eos_token_id,
                                               config.pad_token_id).generate
    seen = []
    for domain, fn in list(pipe.reward_fns.items()):
        def recording(texts, gts, fn=fn, domain=domain):
            out = fn(texts, gts)
            seen.append((domain, list(texts), list(gts), out))
            return out
        pipe.reward_fns[domain] = recording
    return pipe, seen


def test_rlvr_reward_clusters_match_jax(tmp_path):
    """Two steps of RLVRPipeline scoring through a `rewards:` block of worker
    clusters (the JAX package's dotted paths), against the JAX pipeline:
    the port builds its own classes; each domain's reward calls see the
    same texts and return the same arrays and metrics; the metrics of each
    step within float32 rounding; the trained weights within 1e-5 of each
    leaf's scale."""
    import jax
    from tests.test_torch_train import _assert_params_close
    out = {}
    for side in ("jax", "port"):
        pipe, seen = _multi_domain_pipe(side, str(tmp_path / side))
        out[side] = (pipe, seen, pipe.run())
    (jpipe, jseen, jm), (tpipe, tseen, tm) = out["jax"], out["port"]
    assert {d: (type(c.workers[0]).__module__, c.world_size)
            for d, c in tpipe.reward_clusters.items()} == {
        "math": ("socioreasoner_tpu_torch.pipeline.base_worker", 3),
        "crossthinkqa": ("socioreasoner_tpu_torch.pipeline.base_worker", 2)}
    assert len(tseen) == len(jseen) == 4
    for (t_dom, t_texts, t_gts, got), (j_dom, j_texts, j_gts, want) in zip(tseen, jseen):
        assert (t_dom, t_texts, t_gts) == (j_dom, j_texts, j_gts)
        assert sorted(got) == sorted(want)
        for k in ("scores", "response_level_rewards"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["metrics"] == want["metrics"]
    assert tpipe.state.step == jpipe.state.step == 2 and set(tm) == set(jm)
    assert {"math/math/accuracy", "crossthinkqa/crossthinkqa/format"} <= set(tm)
    for got, want in zip(tpipe.state.log_history, jpipe.state.log_history):
        for k in want:
            if k.startswith(("actor_train/", "critic/")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(tpipe.actor_train.params,
                         jax.tree.map(np.asarray, jpipe.actor_train.params))


# ------------------------------------------------- chip_smoke's workers phase

def test_chip_smoke_workers_phase_on_cpu(tmp_path):
    """chip_smoke's workers phase at the tiny config with the tests'
    tokenizer, cut to 4 samples a prompt and 128 new tokens (the crafted
    answers take up to 111), SFT and DPO to rows of 256 and pairs of 64:
    the yaml's four clusters are the port's classes, pass 2's crafted
    rewards equal their recomputation with sandboxed subprocesses run, the
    judge's scores parse, the reward model reads the eos index, the critic,
    SFT and DPO pass their checks, and the main tree does not move."""
    import torch
    import chip_smoke
    from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_qwen
    from tests.test_torch_engine import _port
    from tests.test_torch_pipeline import _tokenizer
    config = _port(Qwen25VLConfig.tiny(512))
    params = t_qwen.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), None,
                                           image_token_id=config.image_token_id)
    stats = chip_smoke.run_workers_path(
        config, params, str(tmp_path), torch.device("cpu"), processor=processor,
        sft_spec={"samples": 16, "min_len": 20, "max_len": 180, "row": 256, "micro": 2},
        dpo_spec={"pairs": 4, "L": 64, "prompt": 16, "beta": 0.1},
        num_return_sequences_in_group=4, response_length=128)
    rlvr = stats["rlvr"]
    assert {d: c for d, (c, _) in rlvr["clusters"].items()} == {
        d: "socioreasoner_tpu_torch.pipeline.base_worker." + cls
        for d, (cls, _) in chip_smoke.WORKER_CLUSTERS.items()}
    assert rlvr["prompt_tokens"][1] <= chip_smoke.WORKERS_CUTS["prompt_length"]
    p1, p2 = rlvr["pass1"], rlvr["pass2"]
    assert p1["cache_slots"] == chip_smoke.RLVR_SLOTS
    assert {tuple(b) for b in p1["prefill_buckets"]} <= set(chip_smoke.RLVR_PREFILL)
    assert p2["train_shapes"] == [(16, 384)] and p2["logprob_shapes"] == [(8, 384)]
    assert all(p2["recomputed_equal"].values()) and p2["sandbox"]["subprocesses"] == 8
    judge = stats["judge"]
    assert max(judge["prompt_tokens"]) == chip_smoke.JUDGE_PROMPT_TOKENS
    assert {tuple(b) for b in judge["prefill_buckets"]} <= set(chip_smoke.JUDGE_PREFILL)
    assert stats["reward_model"]["response_equals_token_at_eos"]
    assert stats["critic"]["value_head_moved"] and stats["sft"]["packed_equal_recomputed"]
    assert stats["dpo"]["steps"][0]["dpo/margin"] == 0 and stats["main_tree_unchanged"]
