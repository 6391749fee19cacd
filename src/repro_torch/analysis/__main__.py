"""CLI: run the op auditor + AST contract linter over the port.

``python -m repro_torch.analysis`` records every registered scenario's
tick programs on both backends on the card (``--device cpu`` on the CPU),
lints the port's source contracts, and prints every finding.  Allowlisted
findings (``rules.ALLOWLIST``) are reported with their justification but
do not fail the run; any unallowlisted finding exits nonzero.

With ``--json-path`` the per-program rows (op counts, custom launches,
host syncs, whether a program is the same at two ticks) and the per-rule
summaries are written to that file alone, as one ``analysis`` section.
``BENCH_netsim.json`` is the JAX package's ledger and is never written.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis [--audit-only | --lint-only]
      [--scenarios a,b,...] [--backends kernel,plain] [--quick]
      [--device cuda|cpu] [--json-path PATH] [--list-rules]
      [--show-allowlisted]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.analysis import rules

QUICK_SCENARIOS = ("tiny_3t", "tiny_perm4", "tiny_incast3")


def _rule_rows(findings) -> list:
    """Per-rule summary rows (``findings`` is the gated metric)."""
    by_rule: dict = {r: [0, 0] for r in rules.RULES}
    for f in findings:
        row = by_rule.setdefault(f.rule, [0, 0])
        row[0] += 1
        if f.allowlisted:
            row[1] += 1
    return [dict(name=f"rule/{rid}", rule=rid, findings=n,
                 allowlisted=n_allowed, unallowlisted=n - n_allowed,
                 description=rules.RULES.get(rid, ""))
            for rid, (n, n_allowed) in sorted(by_rule.items())]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="op auditor + AST contract linter of the PyTorch port "
                    "(DESIGN.md Sec. 10)")
    p.add_argument("--scenarios", default=None, metavar="A,B",
                   help="comma-separated scenario names (default: the "
                        "whole registry, aliases deduped)")
    p.add_argument("--backends", default="kernel,plain", metavar="B,B")
    p.add_argument("--quick", action="store_true",
                   help=f"audit only {', '.join(QUICK_SCENARIOS)}")
    p.add_argument("--device", default="cuda",
                   help="where the programs run: cuda (default) or cpu")
    p.add_argument("--audit-only", action="store_true")
    p.add_argument("--lint-only", action="store_true")
    p.add_argument("--json-path", default=None, metavar="PATH",
                   help="write the rows and rule summaries to this file "
                        "(never BENCH_netsim.json)")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--show-allowlisted", action="store_true",
                   help="print allowlisted findings too (always counted)")
    args = p.parse_args(argv)

    if args.list_rules:
        for rid, desc in sorted(rules.RULES.items()):
            print(f"{rid}  {desc}")
        return 0
    if args.json_path and Path(args.json_path).name == "BENCH_netsim.json":
        p.error("BENCH_netsim.json is the JAX package's ledger; write the "
                "rows to a file of their own")

    from repro_torch.analysis import audit, lint

    t0 = time.time()
    findings, rows = [], []

    if not args.audit_only:
        findings.extend(lint.lint_repo())

    if not args.lint_only:
        names = (args.scenarios.split(",") if args.scenarios
                 else QUICK_SCENARIOS if args.quick else None)
        backends = tuple(b for b in args.backends.split(",") if b)
        f, r = audit.audit_catalogue(
            names=names, backends=backends, device=args.device,
            progress=lambda n: print(f"# auditing {n}", flush=True))
        findings.extend(f)
        rows.extend(r)

    bad = [f for f in findings if not f.allowlisted]
    allowed = [f for f in findings if f.allowlisted]
    for f in bad:
        print(f"FAIL {f}")
    for f in allowed:
        if args.show_allowlisted:
            print(f"ok   {f}")

    if args.json_path:
        import torch
        meta = dict(torch=torch.__version__, device=args.device,
                    findings=len(findings), allowlisted=len(allowed),
                    unallowlisted=len(bad), wall_s=round(time.time() - t0, 1))
        doc = {"schema": 1, "sections": {"analysis": {
            "meta": meta, "rows": rows + _rule_rows(findings)}}}
        path = Path(args.json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=1, sort_keys=True))
        print(f"# {len(rows)} op-count rows + {len(rules.RULES)} rule rows -> {path}")

    print(f"# {len(findings)} finding(s): {len(bad)} unallowlisted, "
          f"{len(allowed)} allowlisted intentional "
          f"({time.time() - t0:.1f}s)")
    if bad:
        print("# FAILED: fix the findings above or allowlist them in "
              "src/repro_torch/analysis/rules.py with a justification")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
