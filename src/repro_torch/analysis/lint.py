"""AST lint engine for the port's DSD0xx invariants (the reference's
``repro/analysis/lint.py``, with the port's rules and baseline).

Usage::

    python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py \
        [--baseline FILE] [--write-baseline] [--select DSD001,DSD003]

The engine parses every ``.py`` file under the given paths into a
:class:`Project` (module ASTs keyed by dotted module name, so rules can
resolve cross-module imports and jit-entry reachability), runs every
registered rule, and prints ``path:line:col: CODE message`` findings.

Exit status is nonzero iff any finding is not covered by the baseline
file (by default the port's own, ``lint_baseline.json`` beside this
module).  Baselines fingerprint findings by (path, rule, stripped source
line, occurrence index) so they survive unrelated line churn; regenerate
with ``--write-baseline`` after auditing, and say in the baseline's
``reasons`` why each finding stands.

This module imports neither torch nor numpy: the lint runs without the
runtime stack.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import sys
from pathlib import Path
from typing import Callable, Iterable, Iterator


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class ModuleInfo:
    path: Path
    name: str          # dotted module name relative to the scanned root
    tree: ast.Module
    source: str

    def source_line(self, lineno: int) -> str:
        lines = self.source.splitlines()
        if 1 <= lineno <= len(lines):
            return lines[lineno - 1]
        return ""


class Project:
    """All parsed modules of one lint run, indexed for cross-module lookup."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = {m.name: m for m in modules}

    def resolve_module(self, dotted: str) -> ModuleInfo | None:
        """Find a module by absolute dotted name, tolerating root prefixes.

        When the scan root is ``src`` the modules are named
        ``repro_torch.core.engine``; when a caller imports
        ``repro_torch.core.engine`` that's an exact hit.  When the scan
        root is deeper (a fixture dir, ``src/repro_torch``), fall back to
        unique-suffix matching.
        """
        if dotted in self.modules:
            return self.modules[dotted]
        hits = [m for name, m in self.modules.items()
                if name.endswith("." + dotted) or dotted.endswith("." + name)]
        if len(hits) == 1:
            return hits[0]
        return None


Rule = Callable[[Project], Iterable[Finding]]
_RULES: dict[str, Rule] = {}


def rule(code: str) -> Callable[[Rule], Rule]:
    def register(fn: Rule) -> Rule:
        if code in _RULES:
            raise ValueError(f"duplicate lint rule {code}")
        _RULES[code] = fn
        return fn
    return register


def registered_rules() -> dict[str, Rule]:
    from . import rules as _rules  # noqa: F401  (registration side effect)
    return dict(_RULES)


# ---------------------------------------------------------------------------
# project loading
# ---------------------------------------------------------------------------

def _module_name(root: Path, file: Path) -> str:
    rel = file.relative_to(root)
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else root.resolve().name


def load_project(paths: Iterable[str | Path]) -> Project:
    modules: list[ModuleInfo] = []
    seen: set[Path] = set()
    for raw in paths:
        root = Path(raw)
        files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        base = root.parent if root.is_file() else root
        for file in files:
            file = file.resolve()
            if file in seen:
                continue
            seen.add(file)
            source = file.read_text()
            try:
                tree = ast.parse(source, filename=str(file))
            except SyntaxError as exc:  # surfaced as a finding, not a crash
                tree = ast.Module(body=[], type_ignores=[])
                tree._dsd_syntax_error = exc  # type: ignore[attr-defined]
            modules.append(ModuleInfo(
                path=file, name=_module_name(base.resolve(), file),
                tree=tree, source=source))
    return Project(modules)


def display_path(path: Path) -> str:
    try:
        return str(path.relative_to(Path.cwd()))
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def _fingerprints(findings: list[Finding], project: Project) -> list[str]:
    """Stable ids: hash of (path, rule, stripped line text, occurrence #)."""
    by_path = {display_path(m.path): m for m in project.modules.values()}
    counts: dict[tuple, int] = {}
    fps = []
    for f in findings:
        mod = by_path.get(f.path)
        text = mod.source_line(f.line).strip() if mod else ""
        key = (f.path, f.rule, text)
        n = counts.get(key, 0)
        counts[key] = n + 1
        raw = f"{f.path}|{f.rule}|{text}|{n}"
        fps.append(hashlib.sha1(raw.encode()).hexdigest()[:16])
    return fps


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("fingerprints", []))


def write_baseline(path: Path, findings: list[Finding], project: Project) -> None:
    payload = {
        "version": 1,
        "comment": "dsd-lint baseline; regenerate with `python -m "
                   "repro_torch.analysis.lint src/repro_torch chip_smoke.py "
                   "--write-baseline`",
        "fingerprints": sorted(set(_fingerprints(findings, project))),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


# ---------------------------------------------------------------------------
# runner + CLI
# ---------------------------------------------------------------------------

_NOQA = "# noqa"


def _suppressed(f: Finding, project: Project) -> bool:
    """`# noqa` (any rule) or `# noqa: DSD001[,DSD002]` on the finding's
    line suppresses it."""
    for mod in project.modules.values():
        if display_path(mod.path) == f.path:
            line = mod.source_line(f.line)
            idx = line.find(_NOQA)
            if idx < 0:
                return False
            tail = line[idx + len(_NOQA):].strip()
            if not tail.startswith(":"):
                return True
            codes = {c.strip() for c in tail[1:].split(",")}
            return f.rule in codes
    return False


def run_project(project: Project, select: set[str] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules.values():
        err = getattr(mod.tree, "_dsd_syntax_error", None)
        if err is not None:
            findings.append(Finding(display_path(mod.path), err.lineno or 1,
                                    (err.offset or 1) - 1, "DSD000",
                                    f"syntax error: {err.msg}"))
    for code, fn in sorted(registered_rules().items()):
        if select and code not in select:
            continue
        findings.extend(f for f in fn(project)
                        if not _suppressed(f, project))
    return sorted(findings)


def run_paths(paths: Iterable[str | Path],
              select: set[str] | None = None) -> list[Finding]:
    return run_project(load_project(paths), select=select)


DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's repo-invariant linter (rules "
                    "DSD001..DSD005)")
    ap.add_argument("paths", nargs="+", help="files or directories to scan")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file of accepted findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the baseline and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run (default: all)")
    args = ap.parse_args(argv)

    select = set(args.select.split(",")) if args.select else None
    project = load_project(args.paths)
    findings = run_project(project, select=select)

    baseline_path = Path(args.baseline)
    if args.write_baseline:
        write_baseline(baseline_path, findings, project)
        print(f"dsd-lint: wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    fps = _fingerprints(findings, project)
    fresh = [f for f, fp in zip(findings, fps) if fp not in baseline]
    suppressed = len(findings) - len(fresh)

    for f in fresh:
        print(f.format())
    tail = f" ({suppressed} baselined)" if suppressed else ""
    print(f"dsd-lint: {len(fresh)} finding(s) in "
          f"{len(project.modules)} module(s){tail}")
    return 1 if fresh else 0


if __name__ == "__main__":
    # under `python -m repro_torch.analysis.lint` this file runs as
    # __main__; delegate to the canonical module so rules register into one
    # registry
    from repro_torch.analysis.lint import main as _main
    sys.exit(_main())
