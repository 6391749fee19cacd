"""Phases 4-5 of the tick — the host NICs.

  4. ``grants``: EQDS receiver-side pull-credit generation (round-robin
     over demanding flows per receiver, through the ``rr_pick`` kernel;
     a no-op unless the algorithm is credit-based)
  5. ``sends``:  per-sender round-robin flow arbitration, window/credit/
     pacing admission, REPS entropy assignment, emission onto the wire,
     sent-ring bookkeeping

``sends`` runs the whole phase in one call of the backend-resolved
``kernels/sends`` callable: the fused CUDA kernel on the card, its plain
version ``sends_ref`` otherwise, or under ``SimConfig.sender_backend=
"split"`` the earlier design, ``sends_ref`` with the ``rr_pick`` kernel
in it.  The phase updates the wire's NIC rows, the sent ring, the send
cursors and sequences, the LB counters, credits and pacing budgets and
the retransmission count in place: a state passed to a phase is consumed,
as the reference's run loops consume (donate) theirs.

Both run on a lane batch (``state.LaneConsts``, ``kernels.lanes.Tick``:
every state leaf ``[L, ...]``, each lane at its own tick); the grants
show no demand for a lane that is not live, so they leave it as it was.
Static branch selectors (credit_based / paced / lb_mode / window) come
from ``Dims``.  ``horizon`` reduces the same admission/demand predicates
to "ticks until a NIC or a receiver next acts" (DESIGN.md Sec. 6.3), one
per lane.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lanes import Tick
from repro_torch.kernels.sends import ref as sends_ref
from repro_torch.netsim.state import HORIZON_INF, Consts, Dims, LaneConsts, SimState

I32 = torch.int32
F32 = torch.float32


def activated(dims: Dims, consts: Consts, st: SimState, t):
    """The activation predicate (``kernels/sends/ref.activated``), per lane
    (``t`` an i32 ``[L, 1]`` column, ``consts`` in ``LaneConsts.b`` form)."""
    return sends_ref.activated(t, consts.t_start, st.done, st.goodput,
                               consts.dep_par, consts.dep_thr)


def _grant_demand(dims: Dims, consts: Consts, st: SimState, t):
    """Flows whose receiver owes pull credit (EQDS): outstanding credit
    window above received + known-lost bytes — self-clocks, and re-grants
    for trimmed packets (the receiver sees trimmed headers) so
    retransmissions never starve."""
    return activated(dims, consts, st, t) & (
        st.granted - st.goodput.to(F32) - st.trim_seen[..., :dims.NF]
        < consts.credit_window)


def grants(dims: Dims, c: LaneConsts, st: SimState, k: Tick, *, arb, ret: int) -> SimState:
    """Phase 4: EQDS receiver credit grants (paper Sec. 2.2): each receiver
    of each live lane grants one MTU of credit to one demanding flow,
    picked round-robin by ``arb`` (the backend-resolved ``rr_pick``) over
    its ``[N, FRMAX]`` flow table, all lanes' rows in one ``[L * N, FRMAX]``
    pick.  The credit ring slot ``(t + ret) % R`` of each lane is updated
    in place."""
    if not dims.credit_based:
        return st
    NF, N, FRMAX, R = dims.NF, dims.N, dims.FRMAX, dims.R
    n, cb = c.n, c.b
    demand = _grant_demand(dims, cb, st, k.now[:, None])
    if not k.all_live:
        demand = demand & k.live[:, None]
    dm = torch.cat([demand, demand.new_zeros((n, 1))], dim=-1)[:, cb.flows_by_recv]
    has_g, sel = arb(dm.reshape(n * N, FRMAX), st.rr_recv.reshape(n * N), FRMAX)
    has_g, sel = has_g.reshape(n, N), sel.reshape(n, N)
    gflow = torch.where(has_g, cb.flows_by_recv[cb.node_ids, sel], NF)       # [L, N]
    credit = torch.where(has_g, float(dims.mtu), 0.0)
    # the grant return delay is the constant `ret`, so all of a lane's
    # grants of this tick land in one ring slot; a flow has one receiver,
    # so every real grant lands on its own column (the idle ones add 0.0
    # to column NF)
    lanes_i = torch.arange(n, dtype=I32, device=gflow.device)[:, None]
    slot = torch.remainder(k.now + ret, R)[:, None]
    st.credit_ring.view(-1).index_add_(
        0, ((lanes_i * R + slot) * (NF + 1) + gflow).reshape(-1), credit.reshape(-1))
    granted = torch.cat([st.granted, st.granted.new_zeros((n, 1))], dim=-1)
    granted.view(-1).index_add_(0, (lanes_i * (NF + 1) + gflow).reshape(-1),
                                credit.reshape(-1))
    rr_recv = torch.where(has_g, torch.remainder(sel + 1, FRMAX), st.rr_recv)
    return st._replace(granted=granted[:, :NF].contiguous(), rr_recv=rr_recv)


def flags(dims: Dims) -> sends_ref.Flags:
    """The run's constants that shape the sends phase."""
    return sends_ref.Flags(window=dims.window, credit_based=dims.credit_based,
                           paced=dims.paced, lb_mode=dims.lb_mode, mtu=dims.mtu)


def operands(consts: Consts, st: SimState) -> sends_ref.Operands:
    """The sends phase's tensors: the run's constants and the state's
    buffers (updated in place by the phase)."""
    cc, lb = st.cc, st.lb
    return sends_ref.Operands(
        src=consts.src, t_start=consts.t_start, size=consts.size, dep_par=consts.dep_par,
        dep_thr=consts.dep_thr, flows_of=consts.flows_of, slot_of=consts.slot_of,
        flow_ids=consts.flow_ids, node_ids=consts.node_ids, f_down=consts.f_down,
        f_dn_q=consts.f_dn_q, f_up_base=consts.f_up_base, f_up_cnt=consts.f_up_cnt,
        f_salt=consts.f_salt, num_entropies=consts.lb.num_entropies,
        bdp_pkts=consts.lb.bdp_pkts, done=st.done, goodput=st.goodput,
        unacked=st.unacked, cwnd=cc.cwnd, pacing_rate=cc.pacing_rate, credits=cc.credits,
        spec_budget=cc.spec_budget, pace_accum=st.pace_accum, sent=st.sent,
        next_seq=st.next_seq, rr_send=st.rr_send, next_entropy=lb.next_entropy,
        cached_entropy=lb.cached_entropy, explore_sent=lb.explore_sent,
        spray_ctr=lb.spray_ctr, plb_entropy=lb.plb_entropy, infl=st.infl,
        n_retx=st.m.n_retx)


def admission(dims: Dims, consts: Consts, st: SimState, t):
    """Send admission for every flow of every lane at its tick ``t`` (an
    i32 ``[L, 1]`` column, ``consts`` in ``LaneConsts.b`` form),
    *excluding* rate pacing (``sends`` folds in the freshly accrued pacing
    budget; the leap ``horizon`` runs only for unpaced configurations,
    where this is the full admission).  Returns ``(elig, has_retx,
    seq_emit, nsize)``."""
    return sends_ref.admission(t, flags(dims), operands(consts, st))


def sends(dims: Dims, c: LaneConsts, st: SimState, k: Tick, *,
          run, lat_send: int, fl: sends_ref.Flags) -> SimState:
    """Phase 5: one packet per NIC per tick, arbitration + admission, in
    one call of ``run`` (the backend resolved by ``kernels/sends/ops.get``)
    for every lane, which updates the state's buffers in place."""
    run(k, lat_send, fl, operands(c.l, st))
    return st


def horizon(dims: Dims, consts: Consts, st: SimState, t):
    """Ticks until phases 4-5 next do work (DESIGN.md Sec. 6.3), one per
    lane: 0 while any flow passes send admission or — for credit-based
    algorithms — any receiver owes a grant, else the nearest flow-start
    deadline (between events nothing else can flip either predicate).
    Never called for paced configurations (``Dims.leap`` is off there: the
    pacing budget accrues every tick)."""
    elig, _, _, _ = admission(dims, consts, st, t)
    inf = torch.full(elig.shape[:-1], HORIZON_INF, dtype=I32, device=elig.device)
    h = torch.where(torch.any(elig, dim=-1), 0, inf)
    if dims.credit_based:
        h = torch.minimum(h, torch.where(
            torch.any(_grant_demand(dims, consts, st, t), dim=-1), 0, inf))
    unstarted = t < consts.t_start
    h_start = torch.amin(torch.where(unstarted, consts.t_start - t, HORIZON_INF), dim=-1)
    return torch.minimum(h, h_start)
