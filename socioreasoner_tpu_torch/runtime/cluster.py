"""Cluster: a typed proxy over N in-process workers of one role.

The port's copy of socioreasoner_tpu/runtime/cluster.py. The workers are
objects of this process; each call of a bound method fans out over the
cluster's thread pool with its dispatch and collect semantics
(dispatch.py). A `worker_cls` string resolves through `safe_import_class`,
which reads a path of the JAX package (the yamls name
`socioreasoner_tpu.pipeline.base_worker.*`) as the same path in this
package, so that a yaml loads the port's classes and never imports the JAX
package.

The workers of a cluster run on the pool's threads. The CPU reward workers
are meant for that; a worker that drives the GPU runs its calls there too,
on the device's default stream, which orders them with the caller's work.
"""

from __future__ import annotations

import importlib
import inspect
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional, Type

from ..configs.worker_config import WorkerConfig
from .dispatch import Dispatch, collect_results, dispatch_args

JAX_PACKAGE = "socioreasoner_tpu."
PORT_PACKAGE = "socioreasoner_tpu_torch."


def safe_import_class(path: str) -> Type:
    """The class at the dotted `path`; a path into the JAX package resolves
    to the same path in the port."""
    if path.startswith(JAX_PACKAGE):
        path = PORT_PACKAGE + path[len(JAX_PACKAGE):]
    module_name, _, cls_name = path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, cls_name)


class RankInfo:
    """A worker's logical rank: the data-parallel rank over the cluster's
    workers; tensor, pipeline and context ranks are 0 in one process."""

    def __init__(self, rank: int = 0, world_size: int = 1):
        self.rank = rank
        self.world_size = world_size
        self.dp_rank = rank
        self.dp_size = world_size
        self.tp_rank = 0
        self.tp_size = 1
        self.pp_rank = 0
        self.pp_size = 1
        self.cp_rank = 0
        self.cp_size = 1


class Cluster:
    def __init__(self, name: str, worker_cls, worker_config: WorkerConfig,
                 resource_manager=None, shared: Optional[dict] = None):
        """`world_size` workers of `worker_cls` (a class or a dotted path).
        `resource_manager` is accepted and unused, as in the JAX package
        until a resource manager is ported."""
        if isinstance(worker_cls, str):
            worker_cls = safe_import_class(worker_cls)
        self.name = name
        self.worker_config = worker_config
        self.world_size = max(worker_config.world_size, 1)
        self.resource_manager = resource_manager
        self.shared = shared or {}
        self.workers = []
        params = inspect.signature(worker_cls.__init__).parameters
        for rank in range(self.world_size):
            kwargs = {"worker_config": worker_config}
            if "rank_info" in params:
                kwargs["rank_info"] = RankInfo(rank, self.world_size)
            if "shared" in params:
                kwargs["shared"] = self.shared
            if "cluster_name" in params:
                kwargs["cluster_name"] = name
            self.workers.append(worker_cls(**kwargs))
        self._pool = ThreadPoolExecutor(max_workers=self.world_size,
                                        thread_name_prefix=f"cluster-{name}")
        self._bind_registered_methods()

    # ------------------------------------------------------------------ binding
    def _bind_registered_methods(self):
        for name, attr in inspect.getmembers(type(self.workers[0])):
            if callable(attr) and getattr(attr, "_registered", False):
                self._bind(name, attr._dispatch_mode, attr._blocking)

    def _bind(self, method_name: str, mode: Dispatch, default_blocking: bool):
        def call(*args, blocking: bool = default_blocking, **kwargs):
            per_worker, ctx = dispatch_args(mode, self.world_size, args, kwargs)
            futures = [self._pool.submit(getattr(w, method_name), *a, **kw)
                       for w, (a, kw) in zip(self.workers, per_worker)]
            if not blocking:
                return _LazyResults(futures, mode, ctx)
            return collect_results(mode, [f.result() for f in futures], ctx)

        call.__name__ = method_name
        setattr(self, method_name, call)

    # ----------------------------------------------------------------- generic
    def execute_all(self, method: str, *args, **kwargs) -> List[Any]:
        return [f.result() for f in self.execute_all_async(method, *args, **kwargs)]

    def execute_rank_zero(self, method: str, *args, **kwargs) -> Any:
        return getattr(self.workers[0], method)(*args, **kwargs)

    def execute_all_async(self, method: str, *args, **kwargs) -> List[Future]:
        return [self._pool.submit(getattr(w, method), *args, **kwargs) for w in self.workers]

    def shutdown(self):
        self._pool.shutdown(wait=True)


class _LazyResults:
    """The handle of a non-blocking call: its futures, collected by get()."""

    def __init__(self, futures: List[Future], mode: Dispatch, ctx=None):
        self.futures = futures
        self.mode = mode
        self.ctx = ctx

    def get(self):
        return collect_results(self.mode, [f.result() for f in self.futures], self.ctx)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)
