"""Model resolution and checkpoint upload, the counterpart of
socioreasoner_tpu/utils/checkpoint_manager.py.

`download_model` resolves a model id to a local directory: an existing path
passes through, else each local root ($SOCIO_MODEL_ROOTS, colon-separated,
or the roots given) is searched for `<root>/<name>` and `<root>/<org--name>`.
There is no hub download: a name found nowhere raises FileNotFoundError.
`CheckpointUploader` copies finished checkpoint directories to a destination
on a thread and keeps the last n there.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import List, Optional

MODEL_ROOTS_ENV = "SOCIO_MODEL_ROOTS"   # colon-separated local search roots


def download_model(model_name_or_path: str,
                   roots: Optional[List[str]] = None) -> str:
    """A model id or path → its local directory."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    roots = roots if roots is not None else \
        [r for r in os.environ.get(MODEL_ROOTS_ENV, "").split(":") if r]
    candidates = [model_name_or_path, model_name_or_path.replace("/", "--")]
    for root in roots:
        for cand in candidates:
            path = os.path.join(root, cand)
            if os.path.isdir(path):
                return path
    raise FileNotFoundError(
        f"model {model_name_or_path!r} not found locally (searched roots "
        f"{roots}); this environment has no network egress — place the "
        f"checkpoint under one of the roots or set {MODEL_ROOTS_ENV}")


class CheckpointUploader:
    """Copies checkpoint directories to `dst_root` on a thread, keeping the
    last `keep_last_n` `checkpoint-<step>` directories there (all when 0)."""

    def __init__(self, dst_root: str, keep_last_n: int = 3,
                 remove_local: bool = False):
        self.dst_root = dst_root
        self.keep_last_n = keep_last_n
        self.remove_local = remove_local
        self._threads: List[threading.Thread] = []

    def upload(self, ckpt_dir: str, blocking: bool = False):
        t = threading.Thread(target=self._upload_one, args=(ckpt_dir,),
                             daemon=True)
        t.start()
        self._threads.append(t)
        if blocking:
            t.join()

    def _upload_one(self, ckpt_dir: str):
        name = os.path.basename(ckpt_dir.rstrip("/"))
        dst = os.path.join(self.dst_root, name)
        os.makedirs(self.dst_root, exist_ok=True)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(ckpt_dir, dst)
        if self.remove_local:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        self._retain()

    def _retain(self):
        entries = [d for d in os.listdir(self.dst_root)
                   if d.startswith("checkpoint-")]
        entries.sort(key=lambda d: int(d.split("-")[-1]))
        for old in entries[:-self.keep_last_n] if self.keep_last_n > 0 else []:
            shutil.rmtree(os.path.join(self.dst_root, old), ignore_errors=True)

    def wait(self):
        for t in self._threads:
            t.join()
