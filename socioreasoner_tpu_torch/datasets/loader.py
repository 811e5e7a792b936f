"""File-type dataset loading: the port's own copy of
socioreasoner_tpu/datasets/loader.py. Loads json/jsonl/csv/parquet/arrow/txt
files, or every such file of a directory, into row dicts (parquet and arrow
through HF `datasets`), and dispatches data_args.dataset_type through a
registry ("default"/"json" and "socioseg")."""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

FILEEXT2TYPE = {
    "arrow": "arrow", "csv": "csv", "json": "json",
    "jsonl": "json", "parquet": "parquet", "txt": "text",
}


def load_rows(path: str, limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Load a dataset file into a list of dict rows."""
    ext = path.rsplit(".", 1)[-1].lower()
    kind = FILEEXT2TYPE.get(ext)
    if kind is None:
        raise ValueError(f"unsupported dataset extension .{ext} "
                         f"(supported: {sorted(FILEEXT2TYPE)})")
    rows: List[Dict[str, Any]] = []
    if ext == "jsonl":
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
                if limit and len(rows) >= limit:
                    break
    elif ext == "json":
        with open(path) as f:
            data = json.load(f)
        rows = data if isinstance(data, list) else [data]
    elif ext == "csv":
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    elif ext in ("parquet", "arrow"):
        import datasets as hf_datasets
        ds = hf_datasets.Dataset.from_parquet(path) if ext == "parquet" \
            else hf_datasets.Dataset.from_file(path)
        rows = [dict(r) for r in ds]
    elif ext == "txt":
        with open(path) as f:
            rows = [{"text": line.rstrip("\n")} for line in f]
    return rows[:limit] if limit else rows


def load_dataset_any(file_name: Optional[str] = None,
                     dataset_dir: Optional[str] = None,
                     limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """data_args-driven loading: explicit file, or every supported file in a dir."""
    if file_name and os.path.isfile(file_name):
        return load_rows(file_name, limit)
    root = dataset_dir or file_name
    if root and os.path.isdir(root):
        rows: List[Dict[str, Any]] = []
        for entry in sorted(os.listdir(root)):
            ext = entry.rsplit(".", 1)[-1].lower()
            if ext in FILEEXT2TYPE:
                rows.extend(load_rows(os.path.join(root, entry)))
                if limit and len(rows) >= limit:
                    return rows[:limit]
        return rows
    raise FileNotFoundError(f"no dataset at file_name={file_name!r} "
                            f"dataset_dir={dataset_dir!r}")


# ----------------------------------------------------- dataset-type registry

REGISTERED_DATASETS: Dict[str, Any] = {}


def register_dataset(key: str):
    """ref roll/datasets/dataset.py:15-21."""
    def deco(fn):
        if key in REGISTERED_DATASETS:
            raise ValueError(f"Dataset type '{key}' already exists!")
        REGISTERED_DATASETS[key] = fn
        return fn
    return deco


def get_dataset(data_args) -> List[Dict[str, Any]]:
    """Dispatch by data_args.dataset_type (ref dataset.py:23-37)."""
    key = getattr(data_args, "dataset_type", None) or "default"
    if key not in REGISTERED_DATASETS:
        raise ValueError(f"Dataset type '{key}' is not found! Available "
                         f"datasets: {sorted(REGISTERED_DATASETS)}")
    paths = getattr(data_args, "file_name", None)
    if isinstance(paths, str):
        paths = [paths]
    return REGISTERED_DATASETS[key](paths or [], data_args)


@register_dataset("default")
@register_dataset("json")
def _default_json_dataset(paths: List[str], data_args) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for p in paths:
        rows.extend(load_rows(p))
    return rows


@register_dataset("socioseg")
def _socioseg_dataset(paths: List[str], data_args):
    from .socioseg import load_socioseg
    src = (paths[0] if paths
           else getattr(data_args, "dataset_dir", None) or "vvangfaye/SocioSeg")
    return load_socioseg(src, split=getattr(data_args, "split", "train"))
