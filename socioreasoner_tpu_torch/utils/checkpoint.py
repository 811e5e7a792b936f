"""Step-indexed model checkpoints with retention and asynchronous writes.

The port's counterpart of CheckpointManager in
socioreasoner_tpu/utils/checkpoint.py (orbax there) in PyTorch's idiom.
Layout: <directory>/checkpoint_<step>/{state.pt, meta.json}, where
state.pt is `torch.save` of a flat {path: value} dict (paths join the
nested dict keys and list indices with "/"; values are tensors or Python
numbers) and meta.json is the caller's meta. This is the port's own
format, not orbax's: the two packages exchange weights through HF
checkpoints (models/qwen2_5_vl/export.py and loader.py, tools/convert.py).

`save` copies every tensor to the host before it returns, so the caller may
update its tensors in place at once; with `use_async` a background thread
writes the copies. A checkpoint is written into a temporary directory and
renamed into place, so a directory named checkpoint_<step> is complete.
state.pt is unpickled with `weights_only=True`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

_DIR = re.compile(r"^checkpoint_(\d+)$")


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a nest of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        key = str(k)
        if "/" in key:
            raise ValueError(f"key {key!r} holds '/', the path separator")
        out.update(flatten(v, f"{prefix}/{key}" if prefix else key))
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    """The nest of a flat {path: leaf}: a level whose keys are all 0..n-1
    becomes a list."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


def _host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        # always a copy: the caller may update its tensor in place at once
        return leaf.detach().to("cpu", copy=True)
    return leaf


class CheckpointManager:
    """Step-indexed checkpoints with retention (keep_last_n) + async save."""

    def __init__(self, directory: str, keep_last_n: int = 3, use_async: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for d in os.listdir(self.directory)
                      if (m := _DIR.match(d)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None, wait: bool = False):
        """Checkpoint `tree` (a nest of dicts and lists of tensors and
        numbers) and `meta` (JSON) at `step`. Returns once the host copies
        are taken; the files are written by then unless use_async, and
        `wait` waits for them."""
        self.wait()
        flat = {k: _host(v) for k, v in flatten(tree).items()}
        if self.use_async:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, flat, meta), daemon=True)
            self._thread.start()
            if wait:
                self.wait()
        else:
            self._write(step, flat, meta)

    def _write_guarded(self, step, flat, meta):
        try:
            self._write(step, flat, meta)
        except Exception as e:   # re-raised by wait() in the caller's thread
            self._error = e

    def _write(self, step: int, flat: Dict[str, Any], meta: Optional[Dict]):
        final = self.step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(flat, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self.steps()[:-self.keep_last_n] if self.keep_last_n > 0 else []:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def wait(self):
        """Wait for an asynchronous write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None, like: Optional[Any] = None
                ) -> Tuple[Any, Optional[Dict]]:
        """(tree, meta) of `step` (the latest when None; (None, None) when
        there is none). With `like`, the tree has like's structure and each
        tensor like's device and dtype; without it, host tensors in the
        saved structure."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        directory = self.step_dir(step)
        flat = torch.load(os.path.join(directory, "state.pt"), map_location="cpu",
                          weights_only=True)
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        if like is None:
            return unflatten(flat), meta
        want = flatten(like)
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint {directory} does not match the template: "
                             f"missing {missing[:5]}, unexpected {extra[:5]}")
        out = {}
        for path, ref in want.items():
            value = flat[path]
            if isinstance(ref, torch.Tensor):
                if tuple(value.shape) != tuple(ref.shape):
                    raise ValueError(f"{path}: shape {tuple(value.shape)} != "
                                     f"{tuple(ref.shape)}")
                value = value.to(device=ref.device, dtype=ref.dtype)
            out[path] = value
        return _like(like, out, ""), meta

    def close(self):
        self.wait()


def _like(template: Any, flat: Dict[str, Any], prefix: str) -> Any:
    if isinstance(template, dict):
        return {k: _like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    return flat[prefix]
