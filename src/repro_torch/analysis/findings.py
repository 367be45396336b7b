"""Findings and the ratchet baseline for repro-lint.

A :class:`Finding` is one invariant violation at one source location.  Its
*identity* for baseline purposes is ``(invariant, path, message)`` — line
numbers are deliberately excluded so unrelated edits that shift code do
not churn the committed baseline.

The port's baseline file (``analysis_baseline_torch.json`` at the repo
root) makes the pass ratchet-only: the lint fails on any finding not in
the baseline (*new* violations) and on any baseline entry no longer found
(*stale* entries — the fix must remove them, so the ratchet can only
tighten).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``invariant`` is the stable ID (e.g. ``REPRO-C001``), ``path`` is
    repo-relative, ``message`` states the violation, ``hint`` says how to
    fix it.  ``line`` is 1-based and informational only (not part of the
    baseline identity).
    """

    invariant: str
    path: str
    line: int
    message: str
    hint: str = ""

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.invariant, self.path, self.message)

    def render(self) -> str:
        text = f"{self.path}:{self.line}: {self.invariant} {self.message}"
        if self.hint:
            text += f"  [fix: {self.hint}]"
        return text


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.invariant,
                                           f.message))


def to_json(findings: Sequence[Finding]) -> Dict[str, object]:
    return {
        "version": BASELINE_VERSION,
        "findings": [dataclasses.asdict(f) for f in sort_findings(findings)],
    }


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    payload = to_json(findings)
    # Identity only: drop line/hint so mechanical edits don't churn it.
    for entry in payload["findings"]:  # type: ignore[union-attr]
        entry.pop("line", None)
        entry.pop("hint", None)
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def load_baseline(path: Path) -> List[Tuple[str, str, str]]:
    """Baseline identities; a missing file is an empty baseline."""
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    version = data.get("version")
    if version != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {version!r}, expected "
            f"{BASELINE_VERSION}")
    out: List[Tuple[str, str, str]] = []
    for entry in data.get("findings", []):
        out.append((entry["invariant"], entry["path"], entry["message"]))
    return out


@dataclasses.dataclass(frozen=True)
class BaselineDiff:
    """New findings (not in baseline) and stale identities (in the
    baseline but no longer found — must be removed to keep the ratchet
    tight)."""

    new: Tuple[Finding, ...]
    stale: Tuple[Tuple[str, str, str], ...]

    @property
    def clean(self) -> bool:
        return not self.new and not self.stale


def diff_baseline(findings: Sequence[Finding],
                  baseline: Sequence[Tuple[str, str, str]]) -> BaselineDiff:
    base = set(baseline)
    found = {f.key for f in findings}
    new = tuple(f for f in sort_findings(findings) if f.key not in base)
    stale = tuple(sorted(k for k in base if k not in found))
    return BaselineDiff(new=new, stale=stale)
