"""AST contract linter: source-level invariants the op auditor cannot see
(DESIGN.md Sec. 10), the counterpart of ``repro.analysis.lint`` over the
port's sources.

Stdlib ``ast`` only — no third-party linter dependency.  Five contract
families (rule docs in ``analysis/rules.py``):

  JX101  ``kernels/*/ref.py`` vs ``kernel.py`` signature parity — the
         ``ops.py`` dispatchers assume each pair is call-compatible.
  JX102  ledger rows in ``BENCH_netsim.json`` must reference registered
         scenario names (the registry doubles as the ledger key space).
  JX103  no unseeded legacy ``np.random.*`` calls and no global-RNG torch
         calls without ``generator=``.
  JX104  no Python truthiness on device state in the tick phase modules.
  JX105  no ``torch`` in the host-side Consts-building modules (the
         device trio in ``faults.py`` is exempt).

Suppress a line-anchored finding with ``# noqa: JX1xx`` (or a bare
``# noqa``); intentional cross-file deviations go in
``rules.ALLOWLIST`` instead.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

from repro_torch.analysis.rules import Finding, finding

REPO_ROOT = Path(__file__).resolve().parents[3]

# the six-phase tick modules: everything runs on the device, truthiness
# on its values is a host sync
PHASE_MODULES = ("src/repro_torch/netsim/fabric.py",
                 "src/repro_torch/netsim/transport.py",
                 "src/repro_torch/netsim/sender.py",
                 "src/repro_torch/netsim/metrics.py")

# host-side Consts-building modules: numpy-only by design (device math
# here would run per sweep point, defeating the Consts design)
HOST_MODULES = ("src/repro_torch/netsim/topology.py",
                "src/repro_torch/netsim/units.py",
                "src/repro_torch/netsim/workloads.py",
                "src/repro_torch/netsim/collectives.py",
                "src/repro_torch/netsim/scenarios.py")
# faults.py is split: tables build on the host, but these three run per
# tick in the fabric and legitimately use torch
HOST_SPLIT_MODULES = {
    "src/repro_torch/netsim/faults.py":
        ("port_period", "fault_active", "transition_horizon"),
}

# modules where unseeded randomness would silently decorrelate runs
RANDOM_SCOPE = ("src/repro_torch",)

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?",
                      re.IGNORECASE)


def _noqa(source: str) -> dict:
    """line number -> set of suppressed rule ids ({'*'} for bare noqa)."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if m:
            codes = m.group("codes")
            out[i] = ({c.strip().upper() for c in codes.split(",")}
                      if codes else {"*"})
    return out


def _suppressed(noqa: dict, line: int, rule: str) -> bool:
    codes = noqa.get(line, ())
    return "*" in codes or rule in codes


def _parse(path: Path):
    source = path.read_text()
    return ast.parse(source, filename=str(path)), _noqa(source)


def _rel(path: Path) -> str:
    try:
        return str(path.relative_to(REPO_ROOT))
    except ValueError:
        return str(path)


# --------------------------------------------------------------------------
# JX101 — kernel trio signature parity
# --------------------------------------------------------------------------


def _public_functions(tree: ast.Module) -> dict:
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and not node.name.startswith("_")}


def _positional(fn: ast.FunctionDef) -> tuple:
    """Positional parameter names (kw-only params — block sizes, variants,
    enqueue hooks — are dispatch detail, not call contract)."""
    args = fn.args
    return tuple(a.arg for a in (args.posonlyargs + args.args))


def _pair_kernels(refs: dict, kernels: dict) -> list:
    """Match ref entry points to kernel entry points by the port's names:
    ``X_lanes_ref`` (a lane batch) with ``X``; ``X_ref`` with ``X_at``
    (one lane at a host tick) where the kernel has one, else ``X`` or
    ``X_kernel``; else the sole-public-function convention."""
    pairs = []
    for rname, rfn in refs.items():
        if rname.endswith("_lanes_ref"):
            cands = (rname[:-len("_lanes_ref")],)
        elif rname.endswith("_ref"):
            base = rname[:-4]
            cands = (base + "_at", base, base + "_kernel")
        else:
            cands = (rname, rname + "_kernel")
        for kname in cands:
            if kname in kernels:
                pairs.append((rfn, kernels[kname]))
                break
    if not pairs and len(refs) == 1 and len(kernels) == 1:
        pairs.append((next(iter(refs.values())),
                      next(iter(kernels.values()))))
    return pairs


def check_kernel_parity(kernels_dir: Path | None = None) -> list:
    """JX101 over every ``kernels/<name>/`` trio directory."""
    if kernels_dir is None:
        kernels_dir = REPO_ROOT / "src" / "repro_torch" / "kernels"
    out = []
    for kdir in sorted(p for p in kernels_dir.iterdir() if p.is_dir()):
        ref_py, kernel_py = kdir / "ref.py", kdir / "kernel.py"
        if not (ref_py.exists() and kernel_py.exists()):
            continue
        site = f"kernels/{kdir.name}"
        refs = _public_functions(_parse(ref_py)[0])
        kernels = _public_functions(_parse(kernel_py)[0])
        pairs = _pair_kernels(refs, kernels)
        if not pairs:
            out.append(finding(
                "JX101", site, "unpaired",
                "no ref/kernel entry-point pairing found "
                f"(ref: {sorted(refs)}, kernel: {sorted(kernels)})"))
            continue
        for rfn, kfn in pairs:
            rp, kp = _positional(rfn), _positional(kfn)
            kw = {a.arg for a in kfn.args.kwonlyargs}
            # contract: the pair agrees on the positional prefix; a ref's
            # trailing positionals may become kernel kw-only statics, and
            # the kernel may append defaulted positionals — either
            # direction is a call-compatible refinement, anything else is
            # drift
            shared = min(len(rp), len(kp))
            prefix_ok = rp[:shared] == kp[:shared]
            tail_ok = set(rp[shared:]) <= kw or not rp[shared:]
            if not (prefix_ok and tail_ok):
                out.append(finding(
                    "JX101", site, f"{rfn.name}|{kfn.name}",
                    f"signature drift: {rfn.name}{rp} vs "
                    f"{kfn.name}{kp} (ops.py dispatches blind)"))
    return out


# --------------------------------------------------------------------------
# JX102 — ledger keys reference registered scenarios
# --------------------------------------------------------------------------

# sections whose row names are `scenario/...` when no explicit
# ``scenario`` field is present; other sections are skipped
_NAME_PREFIX_SECTIONS = ("perf", "studies", "studies_quick", "failover",
                         "phase_profile", "study_throughput", "collectives")


def check_ledger_keys(bench_json: Path | None = None) -> list:
    """JX102: every ledger row's scenario must be in the port's registry.
    The ledger is read as data, never written."""
    from repro_torch.netsim import scenarios

    if bench_json is None:
        bench_json = REPO_ROOT / "BENCH_netsim.json"
    if not bench_json.exists():
        return []
    registered = set(scenarios.names())
    out, seen = [], set()
    data = json.loads(bench_json.read_text())
    for section, body in data.get("sections", {}).items():
        for row in body.get("rows", []):
            cand = row.get("scenario")
            if cand is None:
                if section not in _NAME_PREFIX_SECTIONS:
                    continue
                cand = str(row.get("name", "")).split("/", 1)[0]
            # strip variant ("+recovery") and algo ("scenario/algo")
            # decorations some sections fold into the scenario key
            cand = cand.split("+", 1)[0].split("/", 1)[0]
            if not cand or cand in registered or cand in seen:
                continue
            seen.add(cand)
            out.append(finding(
                "JX102", f"BENCH_netsim.json:{section}", cand,
                f"ledger section {section!r} references scenario "
                f"{cand!r}, which is not in the scenario registry"))
    return out


# --------------------------------------------------------------------------
# JX103 — unseeded randomness
# --------------------------------------------------------------------------

_SEEDED_RANDOM_OK = {"default_rng", "Generator", "SeedSequence",
                     "PCG64", "Philox"}
# torch's sampling functions (``torch.<name>``) and in-place samplers
# (``<tensor>.<name>``); seeded only through ``generator=``
_TORCH_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint",
                   "randint_like", "randperm", "normal", "bernoulli",
                   "multinomial", "poisson"}
_TENSOR_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                    "exponential_", "geometric_", "log_normal_", "cauchy_"}


def _attr_chain(node) -> list:
    """``a.b.c`` -> ["a", "b", "c"] (empty when not a pure chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def check_random(path: Path) -> list:
    """JX103 over one file."""
    tree, noqa = _parse(path)
    rel, out = _rel(path), []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _suppressed(noqa, node.lineno, "JX103"):
            continue
        chain = _attr_chain(node.func)
        seeded = any(k.arg == "generator" for k in node.keywords)
        if (len(chain) >= 3 and chain[0] in ("np", "numpy")
                and chain[1] == "random"
                and chain[2] not in _SEEDED_RANDOM_OK):
            out.append(finding(
                "JX103", f"{rel}:{node.lineno}", ".".join(chain),
                f"unseeded legacy {'.'.join(chain)}() — use a seeded "
                "np.random.default_rng(seed) generator"))
        elif not seeded and (
                (len(chain) == 2 and chain[0] == "torch" and chain[1] in _TORCH_SAMPLERS)
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_SAMPLERS)):
            name = ".".join(chain) if chain else f"<tensor>.{node.func.attr}"
            out.append(finding(
                "JX103", f"{rel}:{node.lineno}", name,
                f"{name}() draws from torch's global generator — pass a "
                "seeded generator= (torch.Generator().manual_seed(seed))"))
    return out


# --------------------------------------------------------------------------
# JX104 — truthiness on device values in phase modules
# --------------------------------------------------------------------------

# names bound to device values in phase-function signatures; ``dims`` is
# deliberately absent (static Python scalars — branching on it is the
# intended specialization mechanism)
_DEVICE_ROOTS = {"st", "state", "consts"}


def _mentions_device(expr: ast.AST) -> str | None:
    """The first device-value mention inside ``expr``, or None."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if chain and chain[0] in _DEVICE_ROOTS:
                return ".".join(chain)
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain and chain[0] == "torch":
                return ".".join(chain) + "(...)"
    return None


def check_truthiness(path: Path) -> list:
    """JX104 over one phase module."""
    tree, noqa = _parse(path)
    rel, out = _rel(path), []
    tests = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While)):
            tests.append(node.test)
        elif isinstance(node, ast.Assert):
            tests.append(node.test)
        elif isinstance(node, ast.IfExp):
            tests.append(node.test)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id == "bool" and node.args):
            tests.append(node.args[0])
    for test in tests:
        hit = _mentions_device(test)
        if hit and not _suppressed(noqa, test.lineno, "JX104"):
            out.append(finding(
                "JX104", f"{rel}:{test.lineno}", hit,
                f"Python truthiness on device value {hit} — a host sync "
                "inside the tick on the card; use torch.where / a mask"))
    return out


# --------------------------------------------------------------------------
# JX105 — host-path purity
# --------------------------------------------------------------------------


def _function_ranges(tree: ast.Module) -> list:
    """[(name, first_line, last_line)] for every top-level function."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node.lineno, node.end_lineno))
    return out


def check_host_purity(path: Path, device_functions=()) -> list:
    """JX105 over one host module; ``device_functions`` are exempt."""
    tree, noqa = _parse(path)
    rel, out = _rel(path), []
    ranges = [(n, lo, hi) for n, lo, hi in _function_ranges(tree)
              if n in device_functions]

    def on_device(line: int) -> bool:
        return any(lo <= line <= hi for _, lo, hi in ranges)

    seen_lines = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Name) and node.id == "torch"
                and isinstance(node.ctx, ast.Load)
                and not on_device(node.lineno)
                and node.lineno not in seen_lines
                and not _suppressed(noqa, node.lineno, "JX105")):
            seen_lines.add(node.lineno)
            out.append(finding(
                "JX105", f"{rel}:{node.lineno}", node.id,
                f"{node.id} used in host-side Consts-building module — "
                "these paths run per sweep point and must stay numpy"))
    return out


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def lint_repo(root: Path | None = None) -> list:
    """Run the full JX1xx contract suite over the port's sources."""
    root = Path(root) if root else REPO_ROOT
    out: list[Finding] = []
    out.extend(check_kernel_parity(root / "src" / "repro_torch" / "kernels"))
    out.extend(check_ledger_keys(root / "BENCH_netsim.json"))
    for scope in RANDOM_SCOPE:
        for path in sorted((root / scope).rglob("*.py")):
            out.extend(check_random(path))
    for mod in PHASE_MODULES:
        out.extend(check_truthiness(root / mod))
    for mod in HOST_MODULES:
        out.extend(check_host_purity(root / mod))
    for mod, device in HOST_SPLIT_MODULES.items():
        out.extend(check_host_purity(root / mod, device_functions=device))
    return out
