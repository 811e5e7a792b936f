"""Code-execution reward: the port's own copy of
socioreasoner_tpu/pipeline/rlvr/rewards/code_sandbox.py.

Two execution modes behind one `score_response`:
  - local (the default): the solution runs in a subprocess of its own
    session under rlimits and a wall-clock timeout; on timeout the whole
    process group is killed;
  - remote: each case is POSTed to a sandbox service at `code_url` with the
    payload {compile_timeout, run_timeout, code, language, stdin,
    expected_stdout}, retried on HTTP errors and on status "SandboxError",
    and every case of a batch shares one pool of 20 threads.

Two kinds of test case in both modes: {"input", "output"} (stdin, stdout
compared line by line after stripping) and {"assert": code} (appended to
the solution; passing means exit code 0 locally, status "Success"
remotely).
"""

from __future__ import annotations

import json
import os
import re
import resource
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

CODE_BLOCK_RE = re.compile(r"```(?:python|py)?\s*\n(.*?)```", re.DOTALL)

# Resource caps of model-generated code: without them a rollout can exhaust
# the trainer host's memory; without the process-group kill a timed-out
# solution can leave grandchildren running.
MEM_LIMIT_BYTES = 2 * 1024 ** 3       # address space and data
STACK_LIMIT_BYTES = 64 * 1024 ** 2
FSIZE_LIMIT_BYTES = 16 * 1024 ** 2    # no multi-GB output files
NPROC_LIMIT = 64


def _set_rlimits():
    """preexec_fn of a sandboxed run: the limits, in the child before exec.
    `resource` is imported with the module, so that the child, forked from
    a process with many threads, takes no import lock."""
    for lim, val in (
        (resource.RLIMIT_AS, MEM_LIMIT_BYTES),
        (resource.RLIMIT_DATA, MEM_LIMIT_BYTES),
        (resource.RLIMIT_STACK, STACK_LIMIT_BYTES),
        (resource.RLIMIT_FSIZE, FSIZE_LIMIT_BYTES),
        (resource.RLIMIT_NPROC, NPROC_LIMIT),
        (resource.RLIMIT_CORE, 0),
    ):
        try:
            resource.setrlimit(lim, (val, val))
        except (ValueError, OSError):
            pass  # the container may already enforce a lower hard limit


def _run_sandboxed(argv, *, input_bytes: bytes = b"", timeout: float, cwd: str
                   ) -> Optional[subprocess.CompletedProcess]:
    """subprocess.run under the rlimits in a session of its own; on timeout
    the whole process group is killed and None returned."""
    proc = subprocess.Popen(
        argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=cwd, start_new_session=True, preexec_fn=_set_rlimits)
    try:
        out, err = proc.communicate(input=input_bytes, timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        proc.wait()
        return None
    except OSError:
        return None
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def extract_code(text: str) -> Optional[str]:
    """The last fenced python block, else the whole text when it looks like
    code, else None."""
    blocks = CODE_BLOCK_RE.findall(text)
    if blocks:
        return blocks[-1].strip()
    if "def " in text or "print(" in text:
        return text.strip()
    return None


def run_stdin_case(code: str, stdin: str, expected: str, timeout: float = 6.0) -> bool:
    """Run `code` on `stdin`; pass when it exits 0 and its stripped stdout
    lines equal `expected`'s."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sol.py")
        with open(path, "w") as f:
            f.write(code)
        proc = _run_sandboxed([sys.executable, "-E", "-I", path],
                              input_bytes=stdin.encode(), timeout=timeout, cwd=td)
        if proc is None or proc.returncode != 0:
            return False
        got = [l.rstrip() for l in proc.stdout.decode(errors="replace").strip().splitlines()]
        want = [l.rstrip() for l in expected.strip().splitlines()]
        return got == want


def run_assert_case(code: str, test_code: str, timeout: float = 6.0) -> bool:
    """Run `code` followed by the assert-style `test_code`; pass on exit 0."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sol.py")
        with open(path, "w") as f:
            f.write(code + "\n\n" + test_code + "\n")
        proc = _run_sandboxed([sys.executable, "-E", "-I", path], timeout=timeout, cwd=td)
        return proc is not None and proc.returncode == 0


class RemoteSandbox:
    """HTTP client of a remote code-execution service.

    One JSON case a POST, retried up to `max_retries` times on HTTP errors
    and on status "SandboxError"; a case passes on status "Success" and,
    for an stdin case, stripped stdout lines equal to the expected ones.
    map_cases runs cases on a pool of `concurrency` threads."""

    def __init__(self, url: str, timeout: float = 10.0, max_retries: int = 3,
                 concurrency: int = 20):
        self.url = url
        self.timeout = timeout
        self.max_retries = max_retries
        self.concurrency = concurrency

    def _post(self, payload: Dict) -> Optional[Dict]:
        body = json.dumps(payload).encode()
        for _ in range(self.max_retries):
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json", "Accept": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout + 20) as resp:
                    result = json.loads(resp.read().decode())
                if result.get("status") == "SandboxError":
                    time.sleep(min(1.0, self.timeout / 10))
                    continue
                return result
            except (urllib.error.URLError, OSError, ValueError, json.JSONDecodeError):
                time.sleep(min(1.0, self.timeout / 10))
        return None

    def run_case(self, code: str, *, stdin: str = "",
                 expected_stdout: Optional[str] = None) -> bool:
        """expected_stdout=None marks an assert case (pass on Success); a
        string, even an empty one, an stdin case whose stdout must match."""
        result = self._post({
            "compile_timeout": self.timeout, "run_timeout": self.timeout,
            "code": code, "language": "python",
            "stdin": stdin, "expected_stdout": expected_stdout or ""})
        if result is None or result.get("status") != "Success":
            return False
        if expected_stdout is None:
            return True
        got = result.get("run_result", {}).get("stdout", "")
        got_lines = [l.rstrip() for l in got.strip().splitlines()]
        want_lines = [l.rstrip() for l in expected_stdout.strip().splitlines()]
        return got_lines == want_lines

    def map_cases(self, fns: List) -> List[bool]:
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            return list(pool.map(lambda f: f(), fns))


def _prep_cases(response: str, test_cases):
    """(code, cases), or None when the response cannot be scored."""
    code = extract_code(response)
    if code is None:
        return None
    if isinstance(test_cases, str):
        try:
            test_cases = json.loads(test_cases)
        except json.JSONDecodeError:
            return None
    if not test_cases:
        return None
    return code, test_cases


def _sandbox_case_fns(code: str, test_cases, sandbox: RemoteSandbox):
    fns = []
    for case in test_cases:
        if "assert" in case:
            fns.append(lambda c=case: sandbox.run_case(code + "\n\n" + c["assert"] + "\n"))
        else:
            fns.append(lambda c=case: sandbox.run_case(
                code, stdin=c.get("input", ""), expected_stdout=c.get("output", "")))
    return fns


def score_response(response: str, test_cases, timeout: float = 6.0,
                   sandbox: Optional[RemoteSandbox] = None) -> float:
    """The fraction of `test_cases` passed (a list of {"input", "output"} or
    {"assert"} dicts, or its JSON), locally or, given `sandbox`, remotely
    with the cases in parallel."""
    prep = _prep_cases(response, test_cases)
    if prep is None:
        return 0.0
    code, test_cases = prep
    if sandbox is not None:
        results = sandbox.map_cases(_sandbox_case_fns(code, test_cases, sandbox))
        return sum(results) / len(results)
    passed = 0
    for case in test_cases:
        if "assert" in case:
            ok = run_assert_case(code, case["assert"], timeout)
        else:
            ok = run_stdin_case(code, case.get("input", ""), case.get("output", ""), timeout)
        passed += ok
    return passed / len(test_cases)


def compute_code_rewards(responses: Sequence[str], test_cases_list: Sequence,
                         timeout: float = 6.0, code_url: Optional[str] = None) -> Dict:
    if code_url:
        # one pool over every (response, case) pair, so that the slow cases
        # of different responses overlap
        sandbox = RemoteSandbox(code_url, timeout=timeout)
        flat, spans = [], []
        for r, t in zip(responses, test_cases_list):
            prep = _prep_cases(r, t)
            if prep is None:
                spans.append(None)
                continue
            fns = _sandbox_case_fns(*prep, sandbox)
            spans.append((len(flat), len(flat) + len(fns)))
            flat.extend(fns)
        results = sandbox.map_cases(flat) if flat else []
        scores = np.array([0.0 if sp is None else sum(results[sp[0]:sp[1]]) / (sp[1] - sp[0])
                           for sp in spans], np.float32)
    else:
        scores = np.array([score_response(r, t, timeout)
                           for r, t in zip(responses, test_cases_list)], np.float32)
    return {"scores": scores,
            "response_level_rewards": scores,
            "metrics": {"code/pass_rate": float(scores.mean()),
                        "code/all_passed": float((scores == 1.0).mean())}}
