"""Config/data file loading helpers.

Glob-resolved YAML/pickle loading rooted at the package directory, matching
the reference lookup convention (reference: khrylib/utils/load_save.py:7-26):
scenario files are addressed by bare name and found anywhere under
``urban_tpu/cfg/**``.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Any

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def resolve_path(pattern: str) -> str:
    """Resolve a glob pattern relative to the repo root to a unique file."""
    if not os.path.isabs(pattern):
        pattern = os.path.join(REPO_ROOT, pattern)
    files = sorted(glob.glob(pattern, recursive=True))
    if len(files) != 1:
        raise FileNotFoundError(
            f'Expected exactly one match for {pattern}, got {len(files)}.')
    return files[0]


def load_yaml(pattern: str) -> Any:
    with open(resolve_path(pattern), 'r') as f:
        return yaml.safe_load(f)


def load_pickle(pattern: str) -> Any:
    with open(resolve_path(pattern), 'rb') as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(obj, f)
