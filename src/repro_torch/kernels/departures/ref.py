"""Plain PyTorch versions of the fused departures phase (``csrc/departures.cu``).

``departures_ref`` is ``fabric.departures`` for one tick on flat operands,
with the fused kernel's exact contract.  For every fabric port:

  1. under a fault schedule, its service period at tick ``t``
     (``faults.port_period``: 1 = healthy, 0 = dead, k > 1 = serve when
     ``t % k == 0``); the port is active when it holds a packet and is
     served;
  2. its head-of-line packet, with the RED dequeue mark (:func:`red_flip`)
     ORed into its ECN bit where the port is active;
  3. the packet's next queue (:func:`route`, ``fabric.route_from_queue``);
  4. its row of the wire: the packet where the port emits (active and not
     dead), zeros otherwise, at slot ``(t + lat.core) % L`` for the
     switch-facing ports ``[0, QE)`` and ``(t + lat.edge) % L`` for the
     edge ports ``[QE, NQ)``;
  5. its head and size advanced where it is active, and the packets a dead
     port swallowed added to ``n_black``.

It updates ``q_head``, ``q_size``, the ports' rows of the two wire slots
and ``n_black`` in place (a state passed to a phase is consumed) and
returns nothing.  ``departures_lanes_ref`` is the same phase on a lane
batch (``kernels/lanes``: every operand ``[L, ...]``), the kernel's
contract: ``departures_ref`` on each live lane at its own tick, the
other lanes left as they were.  Operation for operation the reference's
``fabric.departures`` (``repro/netsim/fabric.py:106``).

``departures_by_port`` computes the same function in the kernel's own
formulation: one port at a time in Python integers, the hashes in uint32
arithmetic, ``%`` and ``//`` as C's truncating operators fixed up where an
operand can be negative, the mark probability as an f32 IEEE quotient.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import lanes
from repro_torch.netsim import faults, hashing

I32 = torch.int32
F32 = torch.float32
RED_SALT = 0xECD        # added to the run's salt for the RED flip's hash


class Flags(NamedTuple):
    """The run's constants that shape the phase (from ``Dims``)."""

    qe: int               # edge-port base: ports [qe, NQ) feed host NICs
    fk: int               # fault transition-table columns in use (0 = none)
    flapped: bool         # any port has a flap window


class Lat(NamedTuple):
    """Wire latency after a departure, in ticks (``state.Clock``)."""

    core: int             # ports [0, QE)
    edge: int             # ports [QE, NQ)


class Operands(NamedTuple):
    """The phase's tensors.  ``NQ`` ports of ``CAP`` packets (the queue
    arrays carry a write-off row ``NQ``), ``NF`` flows, a wire ring of
    ``L`` slots of ``NE`` rows (the ports' rows first)."""

    q_fields: torch.Tensor     # i32 [NQ+1, CAP, 5] flow/seq/ent/ecn/ts (read)
    q_head: torch.Tensor       # i32 [NQ+1]; [:NQ] advanced
    q_size: torch.Tensor       # i32 [NQ+1]; [:NQ] decremented
    infl: torch.Tensor         # i32 [L, NE, 7]; rows [:NQ] of two slots written
    n_black: torch.Tensor      # i32 scalar counter, added to
    kmin: torch.Tensor         # f32 scalar RED lower threshold (packets)
    kspan: torch.Tensor        # f32 scalar RED kmax - kmin
    salt: torch.Tensor         # i32 scalar, the run's hash salt
    qidx: torch.Tensor         # i32 [NQ] port iota (the plain version's)
    dst: torch.Tensor          # i32 [NF] flow destination node
    q_lo: torch.Tensor         # i32 [NQ] next switch's subtree [lo, hi)
    q_hi: torch.Tensor         # i32 [NQ]
    q_dn_base: torch.Tensor    # i32 [NQ] down port = base + d // stride
    q_dn_stride: torch.Tensor  # i32 [NQ]
    q_up_base: torch.Tensor    # i32 [NQ] first equal-cost up port
    q_up_cnt: torch.Tensor     # i32 [NQ] up-port count (0 at the top tier)
    q_salt: torch.Tensor       # i64 [NQ] next switch's ECMP salt (a uint32)
    edge_q: torch.Tensor       # bool [NQ] the port delivers to a host NIC
    ft_time: torch.Tensor      # i32 [NQ, max(FK, 1)] transition times
    ft_period: torch.Tensor    # i32 [NQ, max(FK, 1)] service periods
    fl_start: torch.Tensor     # i32 [NQ] flap window [start, end)
    fl_end: torch.Tensor       # i32 [NQ]
    fl_cycle: torch.Tensor     # i32 [NQ] flap cycle (0 = no flap)
    fl_up: torch.Tensor        # i32 [NQ] healthy ticks a cycle
    fl_period: torch.Tensor    # i32 [NQ] period while flapped down
    fault_start: torch.Tensor  # i32 scalar; table times are relative to it


def ecmp(ent, salt, cnt):
    """``hash2(ent, salt) % max(cnt, 1)`` in uint32 arithmetic, as i32."""
    h = hashing.hash2(ent, salt)
    return torch.remainder(h, cnt.clamp_min(1).to(torch.int64)).to(I32)


def red_flip(q_size, qidx, kmin, kspan, t: int, salt):
    """RED marking at dequeue (paper Sec. 2.1 / 3.5): each port's coin flip
    at tick ``t``, ``uniform01(t * 131071 + q, salt) < clamp((q_size - kmin)
    / kspan, 0, 1)``, before any activity guard.  The first hash lane wraps
    in i32 in the reference; the hash takes it mod 2**32, so computing it in
    int64 gives the same bits.  ``kmin`` and ``kspan`` are f32 device
    scalars (an IEEE quotient), ``salt`` the hash's salt lane."""
    pmark = torch.clamp((q_size.to(F32) - kmin) / kspan, 0.0, 1.0)
    return hashing.uniform01(qidx.to(torch.int64) + t * 131071, salt) < pmark


def route(o: Operands, flow, ent):
    """Next queue of the packet departing each port (``flow``/``ent`` [NQ]):
    down by the run-length table where the destination lies in the next
    switch's subtree, else up by the ECMP hash; ``-(d + 1)`` (delivery to
    node ``d``) on the edge ports."""
    d = o.dst[flow.clamp(0, o.dst.shape[0] - 1)]
    down = (d >= o.q_lo) & (d < o.q_hi)
    nxt = torch.where(
        down, o.q_dn_base + torch.div(d, o.q_dn_stride, rounding_mode="floor"),
        o.q_up_base + ecmp(ent, o.q_salt, o.q_up_cnt))
    return torch.where(o.edge_q, -(d + 1), nxt)


def port_period(t: int, fl: Flags, o: Operands):
    """[NQ] service period of every port at tick ``t`` (``faults.port_period``
    on the operands: they carry the tables under ``Consts``' names)."""
    shape = types.SimpleNamespace(FK=fl.fk, flapped=fl.flapped, NQ=o.qidx.shape[0])
    return faults.port_period(shape, o, t)


def departures_ref(t: int, lat: Lat, fl: Flags, o: Operands) -> None:
    """One tick of the departures phase (module docstring), in place."""
    NQ, CAP = o.qidx.shape[0], o.q_fields.shape[1]
    L, B = o.infl.shape[0], fl.qe
    qs = o.q_size[:NQ]
    active = qs > 0
    faulty = bool(fl.fk or fl.flapped)
    if faulty:
        per = port_period(t, fl, o)
        svc = torch.where(per > 1, torch.remainder(t, per.clamp_min(1)) == 0, True)
        active = active & svc
    head = o.q_head[:NQ]
    hf = o.q_fields[o.qidx, head]                     # [NQ, 5]
    d_flow, d_seq, d_ent, d_ecn, d_ts = hf.unbind(1)
    mark = red_flip(qs, o.qidx, o.kmin, o.kspan, t, o.salt + RED_SALT)
    d_ecn = d_ecn | (mark & active).to(I32)
    emit = active
    if faulty:
        black = (per == 0) & active                   # dead link: blackhole
        emit = active & ~black
        o.n_black.add_(torch.sum(black, dtype=I32))
    next_q = route(o, d_flow, d_ent)
    payload = torch.where(emit[:, None], torch.stack(
        [emit.to(I32), next_q, d_flow, d_seq, d_ent, d_ecn, d_ts], dim=1), 0)
    # each emitter's target slot (t + lat) % L holds nothing still live, so
    # blanket-writing zeros for the other ports is exact (the reference's
    # fabric.py:146-152)
    o.infl[(t + lat.core) % L, :B] = payload[:B]
    o.infl[(t + lat.edge) % L, B:NQ] = payload[B:]
    o.q_head[:NQ] = torch.where(active, torch.remainder(head + 1, CAP), head)
    o.q_size[:NQ] -= active.to(I32)


def departures_lanes_ref(k: lanes.Tick, lat: Lat, fl: Flags, o: Operands) -> None:
    """The phase on a lane batch, in place: :func:`departures_ref` on each
    live lane at its own tick (``k.now_h``)."""
    views = lanes.lane_views(lanes.thread_cache(__name__), o, k.n)
    for i, (t, go) in enumerate(zip(k.now_h, k.live_h)):
        if go:
            departures_ref(t, lat, fl, views[i])


# ------------------------------------------ the kernel's own formulation

_U32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    """``x`` wrapped to a two's-complement i32 value."""
    x &= _U32
    return x - (1 << 32) if x >> 31 else x


def _cmod(a: int, b: int) -> int:
    """C's ``%`` (truncating: the result takes the dividend's sign)."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def _cdiv(a: int, b: int) -> int:
    """C's ``/`` on ints (truncating toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _floor_mod(a: int, b: int) -> int:
    """``common.cuh`` ``floor_mod``: C's ``%`` fixed up to the divisor's sign."""
    r = _cmod(a, b)
    return r + b if r != 0 and (r < 0) != (b < 0) else r


def _floor_div(a: int, b: int) -> int:
    """``common.cuh`` ``floor_div``."""
    q = _cdiv(a, b)
    return q - 1 if _cmod(a, b) != 0 and (a < 0) != (b < 0) else q


def _flip(qs: int, kmin: np.float32, kspan: np.float32, t: int, q: int, salt: int) -> bool:
    """``red.cuh`` ``red_flip``: the f32 IEEE quotient, the uint32 hash,
    uint32 -> f32 rounded to nearest."""
    p = min(max((np.float32(qs) - kmin) / kspan, np.float32(0.0)), np.float32(1.0))
    h = hashing.mix32(hashing.hash2((t * 131071 + q) & _U32, salt & _U32))
    return bool(np.float32(h) * np.float32(2.0 ** -32) < p)


def departures_by_port(t: int, lat: Lat, fl: Flags, o: Operands) -> None:
    """The same function as :func:`departures_ref`, one port at a time as
    the kernel's threads compute it (in place)."""
    NQ, CAP, NF = o.qidx.shape[0], o.q_fields.shape[1], o.dst.shape[0]
    L = o.infl.shape[0]
    core, edge = _cmod(t + lat.core, L), _cmod(t + lat.edge, L)
    q_size, q_head = o.q_size.tolist(), o.q_head.tolist()
    qf, dst = o.q_fields.numpy(), o.dst.tolist()
    tab = {n: getattr(o, n).tolist() for n in (
        "q_lo", "q_hi", "q_dn_base", "q_dn_stride", "q_up_base", "q_up_cnt", "q_salt",
        "edge_q", "ft_time", "ft_period", "fl_start", "fl_end", "fl_cycle", "fl_up",
        "fl_period")}
    kmin, kspan = np.float32(o.kmin.item()), np.float32(o.kspan.item())
    salt = _i32(int(o.salt) + RED_SALT)
    tr = _i32(t - int(o.fault_start))
    black = 0
    for q in range(NQ):
        qs, head = q_size[q], q_head[q]
        active = qs > 0
        per = 1
        if fl.fk:
            cnt = sum(tr >= x for x in tab["ft_time"][q][:fl.fk])
            per = tab["ft_period"][q][max(cnt - 1, 0)]
        if fl.flapped:
            cyc = tab["fl_cycle"][q]
            ph = _floor_mod(_i32(tr - tab["fl_start"][q]), max(cyc, 1))
            in_win = cyc > 0 and tab["fl_start"][q] <= tr < tab["fl_end"][q]
            if in_win and ph >= tab["fl_up"][q]:
                per = tab["fl_period"][q]
        if per > 1:
            active = active and _cmod(t, per) == 0
        dead = per == 0 and active
        row = [0] * 7
        if active and not dead:
            flow, seq, ent, ecn, ts = (int(v) for v in qf[q, head])
            ecn |= int(_flip(qs, kmin, kspan, t, q, salt))
            d = dst[min(max(flow, 0), NF - 1)]
            if tab["edge_q"][q]:
                nxt = -(d + 1)
            elif tab["q_lo"][q] <= d < tab["q_hi"][q]:
                nxt = tab["q_dn_base"][q] + _floor_div(d, tab["q_dn_stride"][q])
            else:
                h = hashing.hash2(ent & _U32, tab["q_salt"][q] & _U32)
                nxt = tab["q_up_base"][q] + h % (max(tab["q_up_cnt"][q], 1) & _U32)
            row = [1, _i32(nxt), flow, seq, ent, ecn, ts]
        o.infl[core if q < fl.qe else edge, q] = torch.tensor(row, dtype=I32)
        if active:
            o.q_head[q] = _floor_mod(head + 1, CAP)
            o.q_size[q] = qs - 1
        black += dead
    o.n_black.copy_(torch.tensor(_i32(int(o.n_black) + black), dtype=I32))
