"""Versioned, validated BENCH JSON records (DESIGN.md §10).

Every benchmark artifact this repo publishes (``BENCH_PR*.json``, the CI
smoke artifacts, the ``runs/`` archive) is one *bench record*:

    {
      "schema_version": 1,
      "name":          "<suite name>",
      "created":       "2026-08-08T12:34:56Z",
      "git_sha":       "<HEAD at generation time, or 'unknown'>",
      "config":        {...echo of the knobs that produced the numbers...},
      "results":       {...the numbers...}
    }

``validate_bench_record`` is the shared contract: the writer validates
before writing, tests validate the checked-in artifacts, and any consumer
can rely on the envelope regardless of which PR's suite produced it (the
pre-schema files were PR-specific hand-built dicts — unversioned,
unparseable without reading that PR's code).

Non-finite floats are sanitized to ``null`` at write time: ``json.dump``
would otherwise emit bare ``Infinity``, which is not valid JSON.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import subprocess
from typing import Any, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

_REQUIRED: Tuple[Tuple[str, type], ...] = (
    ("schema_version", int),
    ("name", str),
    ("created", str),
    ("git_sha", str),
    ("config", dict),
    ("results", dict),
)


def git_sha(repo_dir: Optional[str] = None) -> str:
    """HEAD commit of ``repo_dir`` (default: this file's repo), or
    ``"unknown"`` outside a git checkout."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sanitize(x: Any) -> Any:
    """Replace non-finite floats with ``None``, recursively."""
    if isinstance(x, dict):
        return {k: sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [sanitize(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def bench_record(name: str, *, config: Dict[str, Any],
                 results: Dict[str, Any],
                 created: Optional[str] = None,
                 sha: Optional[str] = None) -> Dict[str, Any]:
    """Assemble a schema-conforming record (validated before return)."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "name": name,
        "created": created if created is not None else
        datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"),
        "git_sha": sha if sha is not None else git_sha(),
        "config": sanitize(config),
        "results": sanitize(results),
    }
    problems = validate_bench_record(rec)
    if problems:
        raise ValueError(f"invalid bench record: {problems}")
    return rec


def validate_bench_record(rec: Any) -> List[str]:
    """Structural validation; returns a list of problems (empty = valid)."""
    if not isinstance(rec, dict):
        return ["record is not an object"]
    problems: List[str] = []
    for key, typ in _REQUIRED:
        if key not in rec:
            problems.append(f"missing key {key!r}")
        elif not isinstance(rec[key], typ):
            problems.append(f"{key!r} is {type(rec[key]).__name__}, "
                            f"expected {typ.__name__}")
    if isinstance(rec.get("schema_version"), int) \
            and rec["schema_version"] > SCHEMA_VERSION:
        problems.append(f"schema_version {rec['schema_version']} is newer "
                        f"than this reader ({SCHEMA_VERSION})")
    problems.extend(_find_nonfinite(rec, "record"))
    return problems


def _find_nonfinite(x: Any, path: str) -> List[str]:
    if isinstance(x, dict):
        return [p for k, v in x.items()
                for p in _find_nonfinite(v, f"{path}.{k}")]
    if isinstance(x, list):
        return [p for i, v in enumerate(x)
                for p in _find_nonfinite(v, f"{path}[{i}]")]
    if isinstance(x, float) and not math.isfinite(x):
        return [f"{path}: non-finite float (sanitize() first)"]
    return []


def write_bench_record(rec: Dict[str, Any], path: str, *,
                       runs_dir: Optional[str] = "runs/bench") -> List[str]:
    """Write ``rec`` to ``path`` and a timestamped copy under ``runs_dir``.

    The canonical ``path`` is what CI uploads and the repo checks in; the
    timestamped copy is the local history (never overwritten, so a sweep
    of runs can be compared after the fact).  Returns the paths written.
    """
    problems = validate_bench_record(rec)
    if problems:
        raise ValueError(f"refusing to write invalid bench record: "
                         f"{problems}")
    paths = [path]
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")
    if runs_dir:
        os.makedirs(runs_dir, exist_ok=True)
        stamp = rec["created"].replace(":", "").replace("-", "")
        copy = os.path.join(runs_dir, f"{rec['name']}-{stamp}.json")
        with open(copy, "w") as f:
            json.dump(rec, f, indent=2, sort_keys=True)
            f.write("\n")
        paths.append(copy)
    return paths
