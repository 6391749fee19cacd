"""Rule catalogue for the port's static-analysis layer (DESIGN.md Sec. 10).

Each rule keeps the reference's id (``repro/analysis/rules.py``), so a
reader finds its counterpart; below is what it means on PyTorch.  Two
families share one :class:`Finding` currency and one allowlist:

``JX0xx`` — *program rules*, applied by ``analysis/audit.py`` to the
aten ops a tick program runs, recorded eagerly under a
``TorchDispatchMode`` (the reference traces a jaxpr; the port has no
trace, so it records one call):

  JX001  64-bit leak: an op introduces a float64/int64/uint64/complex128
         value (its output is wide, none of its inputs is), or the
         program reads a wide constant.  The simulator is an x32 program
         by contract (DESIGN.md Sec. 6); a wide dtype doubles the bytes
         the tick moves.  A value derived from a wide one is reported at
         its source.
  JX002  convert churn: a ``_to_copy`` dtype conversion whose output
         feeds only another conversion (an A->B->C chain whose middle
         dtype is never used), or one that converts a value to its own
         dtype on its own device.  Either way the card runs a useless
         pass.  A kernel launch's operands count as used.
  JX003  host sync: an op inside a tick program that makes the host wait
         for the card — ``aten._local_scalar_dense`` (``int()``,
         ``float()``, ``bool()``, ``.item()``), ``.tolist()``,
         ``.numpy()``, ``nonzero``, ``masked_select``, ``_unique2``,
         ``repeat_interleave`` without an output size, an
         ``aten.index.Tensor`` or ``index_put_`` with a bool index, a
         copy of a device tensor to the CPU.  A sync inside a phase
         serializes the tick on host round-trips, and a CUDA graph cannot
         capture it.  Recorded on the CPU too, where it would be one on
         the card.
  JX004  aliased state: two tensor leaves of a state whose storages
         overlap.  The fused kernels update the state in place, so one
         leaf aliasing another is a correctness hazard (the reference's
         aliased donation).
  JX005  scatter/gather budget: a tick phase exceeds its budgeted
         scatter/gather op count (:data:`PHASE_BUDGETS`) on the
         ``"plain"`` backend.  A silent rise is a perf regression.
  JX006  sweepability drift: the empirically Dims-changing ``SimConfig``
         fields must be rejected by ``api.apply_point`` (disjoint from
         ``api.CFG_KEYS``), every ``CFG_KEYS`` field must keep the Dims
         and the Consts leaves' shapes and dtypes (the lane batch of a
         study relies on it), and every field must be classified.

``JX1xx`` — *AST contract rules*, applied by ``analysis/lint.py`` to the
port's sources (stdlib ``ast``; suppress a line with ``# noqa: JX1xx``):

  JX101  kernel trio parity: ``kernels/*/ref.py`` and ``kernel.py``
         entry points agree on positional parameter names and order
         (``ops.py`` dispatches between them blind): ``X_ref`` with
         ``X_at`` (else ``X``), ``X_lanes_ref`` with ``X``.
  JX102  ledger key drift: a ``BENCH_netsim.json`` row references a
         scenario name that is not in the port's scenario registry.
  JX103  unseeded randomness: legacy ``np.random.*`` calls, and torch's
         global-RNG calls (``torch.rand*``, ``randn``, ``randint``,
         ``randperm``, ``normal``, ``bernoulli``, ``multinomial``,
         ``.normal_``, ``.uniform_``, ...) without ``generator=``.
  JX104  truthiness on state: Python ``if``/``while``/``assert``/
         ``bool()`` on ``st``/``state``/``consts`` values or ``torch``
         calls inside a tick phase module — on the card a host sync
         inside the tick (the reference's trace error).
  JX105  host-path purity: ``torch`` use in the host-side
         Consts-building modules (topology/units/workloads/collectives/
         scenarios and the host half of faults.py).  Those paths run per
         sweep point; device math there re-introduces the per-point
         dispatch cost the Consts design exists to avoid.

Intentional deviations are allowlisted in :data:`ALLOWLIST`, keyed
``"RULE:site:token"`` (``fnmatch`` patterns) -> one-line justification.
An allowlisted finding is reported (with its justification) but does not
fail ``python -m repro_torch.analysis``.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatch

# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``site``  where: ``scenario/backend/program`` for program rules,
              ``path:line`` for lint rules, ``kernels/<name>`` for
              kernel-parity.
    ``token`` the specific offender (a dtype at an op and its source, a
              sync, a parameter list, a scenario key) — the allowlist
              matches on it.
    """

    rule: str
    site: str
    token: str
    message: str
    allowed_by: str | None = None   # matching ALLOWLIST key, if any

    @property
    def allowlisted(self) -> bool:
        return self.allowed_by is not None

    def __str__(self) -> str:
        tag = f" [allowed: {ALLOWLIST[self.allowed_by]}]" \
            if self.allowlisted else ""
        return f"{self.rule} {self.site} :: {self.message}{tag}"


RULES = {
    "JX001": "64-bit dtype inside a recorded engine program",
    "JX002": "redundant _to_copy conversion (chain or self-convert)",
    "JX003": "host sync inside a tick program",
    "JX004": "aliased leaves in a state updated in place",
    "JX005": "per-phase scatter/gather op count over budget",
    "JX006": "SimConfig sweepability classification drift",
    "JX101": "kernel ref/kernel signature parity",
    "JX102": "ledger row references an unregistered scenario",
    "JX103": "unseeded legacy np.random or global torch RNG call",
    "JX104": "Python truthiness on device state in a phase module",
    "JX105": "torch use in a host-side Consts-building path",
}


# --------------------------------------------------------------------------
# allowlist — every entry is an *intentional* deviation with a reason
# --------------------------------------------------------------------------
#
# A JX001 token is ``dtype@op@source``: the source is the port's function
# that ran the op (``path:function`` under src/repro_torch), or
# ``consts.<leaf>`` for a wide constant the program reads.

ALLOWLIST: dict[str, str] = {
    # perm_32n_flat is built inline by benchmarks/profile_tick.py (the
    # N=32 profiling point below the smallest registered 3-tier tree).
    "JX102:*:perm_32n_flat":
        "ad-hoc profiling scenario built in benchmarks/profile_tick.py",
    # the uint32 ECMP/RED hash is computed on uint32 values held in int64:
    # PyTorch cannot shift uint32 on the CPU (netsim/hashing.py)
    "JX001:*:int64@aten._to_copy.default@netsim/hashing.py:u32":
        "uint32 hash lanes held in int64 by design (netsim/hashing.py)",
    "JX001:*:int64@consts.*_salt":
        "ECMP salts are uint32 values held in int64 by design (netsim/state.py)",
    "JX001:*:int64@aten._to_copy.default@core/reps.py:_hash_mod":
        "the entropy count as the int64 modulus of a uint32 hash, back to i32 at once",
    "JX001:*:int64@aten._to_copy.default@kernels/departures/ref.py:ecmp":
        "the ECMP up-port count as the int64 modulus of a uint32 hash, back to i32",
    "JX001:*:int64@aten._to_copy.default@kernels/departures/ref.py:red_flip":
        "the RED hash's first lane in int64: mod 2**32, the reference's i32 wrap",
    # torch.gather and argmax speak int64 indices
    "JX001:*:int64@aten.argmax.default@kernels/sends/ref.py:admission":
        "argmax returns int64: the retransmission slot, torch.gather's index",
    "JX001:*:int64@aten._to_copy.default@kernels/sends/ref.py:admission":
        "the new sequence's ring slot as torch.gather's int64 index",
    "JX001:*:int64@aten.argmin.default@kernels/enqueue_arb/ref.py:rr_pick_ref":
        "argmin returns int64: the picked slot, cast to i32 at once",
    "JX001:*:int64@aten._to_copy.default@netsim/faults.py:port_period":
        "the fault table's column as torch.gather's int64 index",
}


def allowed_by(rule: str, site: str, token: str) -> str | None:
    """The first ALLOWLIST key matching (rule, site, token), else None."""
    for key in ALLOWLIST:
        krule, ksite, ktoken = key.split(":", 2)
        if krule == rule and fnmatch(site, ksite) and fnmatch(token, ktoken):
            return key
    return None


def finding(rule: str, site: str, token: str, message: str) -> Finding:
    """Build a Finding, resolving its allowlist status."""
    return Finding(rule=rule, site=site, token=token, message=message,
                   allowed_by=allowed_by(rule, site, token))


# --------------------------------------------------------------------------
# program rule constants (aten op families, by overload packet name)
# --------------------------------------------------------------------------

WIDE_DTYPES = ("torch.float64", "torch.int64", "torch.uint64", "torch.complex128")

# ops that make the host wait for the card whatever their operands
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive")
# host reads seen at the Python level (``Tensor.<name>``), which on the
# CPU dispatch no aten op at all
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__float__", "__index__")

SCATTER_OPS = ("scatter", "scatter_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
               "index_add", "index_add_", "index_copy", "index_copy_")

GATHER_OPS = ("gather", "index", "index_select", "take_along_dim")


# --------------------------------------------------------------------------
# JX005 scatter/gather budgets
# --------------------------------------------------------------------------
#
# Budgets are per (phase, op family) *recorded op counts* on the "plain"
# backend (the op count does not depend on the shapes; only Dims branches
# change it, so the audit over every registered scenario exercises the
# widest branch set).  Measured maxima with ``audit_scenario(...,
# device="cpu", backends=("plain",))`` over the whole catalogue (one base
# RTT in) plus eqds and eqds_smartt on tiny_perm4 and incast_256x1_3t,
# bbr, swift+plb, mprdma+ecmp and spray on perm_128n_3t, corefail_128n_3t
# at t = 520 and flap_128n_3t at t = 700: departures 0/3 (the fault and
# routing table lookups), arrivals 3/11 (the credit path's adds), control
# 0/1, grants 2/2 (EQDS only), sends 0/10 (alltoall16_w4's window),
# metrics 0/0, horizon 0/4.  Each cap is the larger of the maximum + 1
# and ~25 % headroom: a breach means someone added scatters or gathers
# to a hot phase, which is exactly the regression this rule exists to
# catch.  Raise a budget deliberately, not by accident.

PHASE_BUDGETS: dict[str, dict[str, int]] = {
    "departures": {"scatter": 1, "gather": 4},
    "arrivals":   {"scatter": 4, "gather": 14},
    "control":    {"scatter": 1, "gather": 2},
    "grants":     {"scatter": 3, "gather": 3},
    "sends":      {"scatter": 1, "gather": 13},
    "metrics":    {"scatter": 1, "gather": 1},
    "horizon":    {"scatter": 1, "gather": 5},
}
