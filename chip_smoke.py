"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --json DIR/chip_smoke.json   # also keep the record
    python3 chip_smoke.py --kernels-only               # stop after phase 3

Phases (any failure exits non-zero; nothing is caught and swallowed):

  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile src/repro_torch/csrc/*.cu (one nvcc per source, all
               in parallel) into build/repro_torch/, print the build time
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, bit for bit, at the main path's shapes plus ragged and
               edge cases; CUDA-event times of kernel and plain version,
               beside the least time the card could take (bytes moved /
               3.35 TB/s, the H100 SXM's memory rate)
  4. main path — perm_1024n_3t (the paper's 1024-node, three-tier fat
               tree) and alltoall_3t end to end through the kernels; launch
               counts reset just before each run and read just after; the
               final states equal to the plain-on-card and CPU runs
               field by field; the summaries equal to the JAX reference's

The last two lines are the ``{"kernels": [...]}`` record and the contract
line ``{"ok": true, "device": {...}}``; the card's nvidia-smi name and
power limit come on a line before them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch is missing next to this script; "
             "run it from the root of a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM peak HBM3 bandwidth

# The JAX reference's summaries of the two main-path runs (seed 0), pinned
# by tests/test_torch_engine.py against the JAX package on the CPU.
REFERENCE = {
    "perm_1024n_3t": dict(ticks=1070, n_done=1024, fct_max=1086,
                          fct_mean=265.990234375, trims=16977, retx=16977,
                          timeouts=0, acks=65513),
    "alltoall_3t": dict(ticks=401, n_done=992, fct_max=417,
                        fct_mean=221.60685483870967, trims=0, retx=0,
                        timeouts=0, acks=7877),
}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- helpers


def leaves(tree, prefix=""):
    """(name, tensor) for every leaf of a NamedTuple state."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, val in zip(tree._fields, tree):
        yield from leaves(val, f"{prefix}.{name}" if prefix else name)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def call_ms(fn, iters=200, warmup=20) -> float:
    """Mean time a call as the caller sees it (host work included): CUDA
    events around ``iters`` back-to-back calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, per_graph=50, replays=20) -> float:
    """Mean device time a call: ``per_graph`` calls captured into one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    work (Python, ctypes, allocation) is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (per_graph * replays)


def timings(kernel, plain) -> dict:
    return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                call_ms=call_ms(kernel), plain_call_ms=call_ms(plain))


# ------------------------------------------------------------ 1. device


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log(f"[device] nvidia-smi: {smi_line}")
    return name, smi_line


# ------------------------------------------------------------- 2. build


def phase_build():
    from repro_torch.kernels import build
    info = build.build(verbose=True, force=True)
    log(f"[build] {len(list(build.CSRC.glob('*.cu')))} sources -> "
        f"{info['path'].relative_to(ROOT)} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    build.library()


# ----------------------------------------------------------- 3. kernels


def kernel_checks(dev, shapes):
    """Every kernel against its plain version on the card; returns the
    per-kernel records (times at the main path's shapes)."""
    from repro_torch.kernels import cases
    from repro_torch.kernels.cc_update import kernel as CK, ref as CR
    from repro_torch.kernels.enqueue_arb import kernel as EK, ref as ER
    from repro_torch.kernels.ring_drain import kernel as DK, ref as DR

    def on(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    records = {}

    def check(name, outs_k, outs_p, what):
        errs = [max_abs_err(k, p) for k, p in zip(outs_k, outs_p)]
        torch.cuda.synchronize()
        if not all(bit_equal(k, p) for k, p in zip(outs_k, outs_p)):
            fail(f"{name} {what}: kernel differs from its plain version "
                 f"(max abs errors {errs})")
        return max(errs)

    # ---- cc_update
    nf = shapes["NF"]
    err = 0.0
    for F, seed, re in ((1, 1, 1), (7, 2, 3), (1000, 3, 1), (nf, 4, 1), (nf, 5, 2)):
        p, s, ev, now = cases.cc_update_tensors(cases.cc_update_case(F, seed, re), dev)
        k = CK.cc_update(p, s, ev, now)
        r = CR.cc_update_ref(p, s, ev, now)
        err = max(err, check("cc_update", list(k), list(r), f"F={F} seed={seed}"))
    p, s, ev, now = cases.cc_update_tensors(cases.cc_update_case(nf, 6), dev)
    records["cc_update"] = dict(
        shape=f"[{nf}]", max_abs_err=err, bytes=nf * 110,
        **timings(lambda: CK.cc_update(p, s, ev, now),
                  lambda: CR.cc_update_ref(p, s, ev, now)))

    # ---- enqueue_rank
    S, D, NQ, CAP = shapes["NSW"], shapes["DMAX"], shapes["NQ"], shapes["CAP"]
    err = 0.0
    for (s_, d_, nq, cap), seed in (((1, 1, 4, 3), 1), ((3, 5, 7, 4), 2),
                                    ((S, D, NQ, CAP), 3), ((S, D, 5, CAP), 4)):
        c = cases.enqueue_rank_case(s_, d_, nq, cap, seed)
        args = [on(c[n]) for n in ("gdst", "ghead", "gsize")]
        k = EK.enqueue_rank(*args, cap=cap, nq=nq)
        r = ER.enqueue_rank_ref(*args, cap=cap, nq=nq)
        err = max(err, check("enqueue_rank", k, r, f"[{s_}, {d_}]"))
    c = cases.enqueue_rank_case(S, D, NQ, CAP, 5)
    args = [on(c[n]) for n in ("gdst", "ghead", "gsize")]
    records["enqueue_rank"] = dict(
        shape=f"[{S}, {D}]", max_abs_err=err, bytes=S * D * 21,
        **timings(lambda: EK.enqueue_rank(*args, cap=CAP, nq=NQ),
                  lambda: ER.enqueue_rank_ref(*args, cap=CAP, nq=NQ)))

    # ---- ring_drain
    F, W, MAXW = shapes["NF"], shapes["W"], shapes["MAXW"]
    err = 0.0
    for (f_, w_, mw), seed in (((3, 32, 1), 1), ((2, 1024, 40), 2),
                               ((F, W, MAXW), 3), ((F, W, MAXW), 4)):
        c = cases.ring_drain_case(f_, w_, mw, seed)
        a = {k_: on(v) for k_, v in c.items() if k_ != "t"}
        # the loss words as the transport hands them: a row-strided view
        packed = torch.cat([torch.zeros((f_, 2), dtype=torch.int32, device=dev),
                            a["lbits"]], dim=1)
        a["lbits"] = packed[:, 2:]
        order = ("rto", "started", "has_ack", "ack_seq", "lbits", "bitmap",
                 "sent0", "sent1", "sent2")
        k = DK.ring_drain(c["t"], *[a[n] for n in order])
        r = DR.ring_drain_ref(c["t"], *[a[n] for n in order],
                              w=w_, ww=w_ // 32, maxw=mw)
        err = max(err, check("ring_drain", k, r, f"[{f_}, {w_}] maxw={mw}"))
    c = cases.ring_drain_case(F, W, MAXW, 5)
    a = [on(c[n]) for n in ("rto", "started", "has_ack", "ack_seq", "lbits",
                            "bitmap", "sent0", "sent1", "sent2")]
    records["ring_drain"] = dict(
        shape=f"[{F}, {W}]", max_abs_err=err,
        bytes=F * W * 4 * 4 + F * (W // 32 + MAXW) * 4 + F * 10 + F * 12,
        **timings(lambda: DK.ring_drain(c["t"], *a),
                  lambda: DR.ring_drain_ref(c["t"], *a, w=W, ww=W // 32, maxw=MAXW)))

    # ---- rr_pick
    N, K = shapes["N_rr"], shapes["FMAX_rr"]
    err = 0.0
    for (n_, k_), seed in (((1, 1), 1), ((5, 33), 2), ((7, 64), 3),
                           ((N, K), 4), ((N, K), 5)):
        c = cases.rr_pick_case(n_, k_, seed)
        k = EK.rr_pick(on(c["elig"]), on(c["rr"]), kmax=k_)
        r = ER.rr_pick_ref(on(c["elig"]), on(c["rr"]), kmax=k_)
        err = max(err, check("rr_pick", k, r, f"[{n_}, {k_}]"))
    c = cases.rr_pick_case(N, K, 6)
    elig, rr = on(c["elig"]), on(c["rr"])
    records["rr_pick"] = dict(
        shape=f"[{N}, {K}]", max_abs_err=err, bytes=N * K + N * 4 + N * 5,
        **timings(lambda: EK.rr_pick(elig, rr, kmax=K),
                  lambda: ER.rr_pick_ref(elig, rr, kmax=K)))

    for name, rec in records.items():
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] {name:12s} {rec['shape']:>11s}: bit-equal to plain "
            f"(max abs err {rec['max_abs_err']}); device time: kernel "
            f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, bound "
            f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bytes']} B); a call with the host's "
            f"work: kernel {rec['call_ms'] * 1e3:.1f} us, plain "
            f"{rec['plain_call_ms'] * 1e3:.1f} us")
    return records


# --------------------------------------------------------- 4. main path


def counters():
    from repro_torch.kernels.cc_update import kernel as CK
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.kernels.ring_drain import kernel as DK
    return {"cc_update": CK.cc_update, "enqueue_rank": EK.enqueue_rank,
            "ring_drain": DK.ring_drain, "rr_pick": EK.rr_pick}


def run_path(name, device, backend):
    from repro_torch.netsim import scenarios
    from repro_torch.netsim.metrics import summarize
    sc = scenarios.scenario(name, cc_backend=backend, fabric_backend=backend,
                            transport_backend=backend)
    sim = sc.build(device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0                          # just before the run
    t0 = time.perf_counter()
    st = sim.run(sc.max_ticks)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}   # just after
    summ = summarize(sim, st)
    steps = sim.stats["steps"]
    log(f"[main] {name:14s} {device:4s} {backend:6s}: {summ['ticks']} ticks "
        f"({steps} executed) in {wall:.3f} s = {summ['ticks'] / wall:.1f} ticks/s; "
        f"fct_max {summ['fct_max']} fct_mean {summ['fct_mean']} "
        f"trims {summ['trims']}; launches {launches}")
    return sim, st, summ, launches, wall


def phase_main_path():
    results = {}
    for name, on_path in (("perm_1024n_3t", ("cc_update", "enqueue_rank", "ring_drain")),
                          ("alltoall_3t", ("cc_update", "enqueue_rank", "ring_drain",
                                           "rr_pick"))):
        sim, st_k, summ, launches, wall = run_path(name, "cuda", "kernel")
        steps = sim.stats["steps"]
        if not summ["all_done"]:
            fail(f"{name}: not every flow finished in {summ['ticks']} ticks")
        for k in on_path:
            want = steps if k != "rr_pick" else None
            if launches[k] == 0 or (want is not None and launches[k] != want):
                fail(f"{name}: {k} launched {launches[k]} times over {steps} "
                     f"executed ticks")
        for key, val in REFERENCE[name].items():
            if summ[key] != val:
                fail(f"{name}: {key} = {summ[key]}, the JAX reference gives {val}")
        _, st_p, _, launches_p, wall_p = run_path(name, "cuda", "plain")
        if any(launches_p.values()):
            fail(f"{name}: the plain backend launched kernels {launches_p}")
        _, st_c, _, _, wall_c = run_path(name, "cpu", "kernel")
        for other, label in ((st_p, "plain on the card"), (st_c, "CPU")):
            bad = [n for (n, a), (_, b) in zip(leaves(st_k), leaves(other))
                   if not bit_equal(a, b)]
            if bad:
                fail(f"{name}: final state differs from the {label} run in {bad}")
        for n, a in leaves(st_k):
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{name}: non-finite values in {n}")
        log(f"[main] {name}: final state bit-equal to the plain-on-card and CPU "
            f"runs ({len(list(leaves(st_k)))} leaves); summary equals the JAX reference")
        results[name] = dict(launches=launches, steps=steps, ticks=summ["ticks"],
                             wall=wall, wall_plain=wall_p, wall_cpu=wall_c)
    return results


def phase_profile():
    """Where perm_1024n_3t's time goes on the card: each phase's wall time
    with a synchronize after it (a whole run; this scenario never leaps),
    then a torch.profiler window of 200 ticks for the device's busy share
    and its kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import scenarios
    sc = scenarios.scenario("perm_1024n_3t")
    sim = sc.build(device="cuda")
    st = sim.init()
    per = {name: 0.0 for name, _ in sim.phases}
    t = 0
    torch.cuda.synchronize()
    while t < sc.max_ticks and not bool(st.done.all()):
        clk = sim.clock0._replace(t=t)
        for name, phase in sim.phases:
            t0 = time.perf_counter()
            st = phase(sim.consts, st, clk)
            torch.cuda.synchronize()
            per[name] += time.perf_counter() - t0
        st = st._replace(now=st.now + 1)
        t += 1
    total = sum(per.values())
    log(f"[profile] perm_1024n_3t phases over {t} ticks (synchronized after "
        f"each phase): " + ", ".join(
            f"{k} {v / t * 1e3:.3f} ms/tick ({100 * v / total:.1f}%)"
            for k, v in per.items()))

    st = sim.init()
    for t in range(20):                                  # warm
        st = sim.step(st, t)
    torch.cuda.synchronize()
    ticks = 200
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(20, 20 + ticks):
            st = sim.step(st, t)
            bool(st.done.all())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    # the device's own events (kernels, copies, fills); CPU operators also
    # carry the device time of what they launched, so they are left out
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(dev_us(e) for e in events) / 1e6
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    if not busy:
        log("[profile] torch.profiler recorded no device time: busy share not measured")
    log(f"[profile] ticks 20-{20 + ticks} under torch.profiler: wall "
        f"{wall / ticks * 1e3:.3f} ms/tick, device busy {busy / ticks * 1e3:.4f} "
        f"ms/tick ({100 * busy / wall:.2f}% busy, {100 - 100 * busy / wall:.2f}% idle), "
        f"{launches / ticks:.1f} device kernels/tick")
    for e in top:
        log(f"[profile]   {dev_us(e) / ticks:9.3f} us/tick  x{e.count / ticks:5.2f}  "
            f"{e.key[:90]}")
    return dict(phase_ms_per_tick={k: v / t * 1e3 for k, v in per.items()},
                wall_ms_per_tick=wall / ticks * 1e3,
                device_busy_ms_per_tick=busy / ticks * 1e3,
                idle_share=1 - busy / wall if busy else None,
                kernels_per_tick=launches / ticks,
                top=[dict(name=e.key, us_per_tick=dev_us(e) / ticks,
                          per_tick=e.count / ticks) for e in top])


# ------------------------------------------------------------------ main


def main():
    name, smi_line = phase_device()
    t0 = time.perf_counter()
    phase_build()
    from repro_torch.netsim import scenarios
    dev = torch.device("cuda")
    perm = scenarios.scenario("perm_1024n_3t").build(device=dev)
    a2a = scenarios.scenario("alltoall_3t").build(device=dev)
    shapes = dict(NF=perm.dims.NF, NSW=perm.consts.in_tbl.shape[0],
                  DMAX=perm.consts.in_tbl.shape[1], NQ=perm.dims.NQ,
                  CAP=perm.dims.CAP, W=perm.dims.W, MAXW=perm.dims.MAXW,
                  N_rr=a2a.dims.N, FMAX_rr=a2a.dims.FMAX)
    log(f"[kernels] main-path shapes {shapes}")
    records = kernel_checks(dev, shapes)
    if "--kernels-only" in sys.argv[1:]:
        log("[done] --kernels-only: stopping before the main path (no result)")
        sys.exit(4)
    paths = phase_main_path()
    log(f"[kernels] launches: " + ", ".join(
        f"{k}: perm_1024n_3t {paths['perm_1024n_3t']['launches'][k]}, "
        f"alltoall_3t {paths['alltoall_3t']['launches'][k]}" for k in records))

    replaces = {
        "cc_update": ("src/repro_torch/csrc/cc_update.cu",
                      "src/repro/kernels/cc_update/kernel.py:60", "perm_1024n_3t"),
        "enqueue_rank": ("src/repro_torch/csrc/enqueue_rank.cu",
                         "src/repro/kernels/enqueue_arb/kernel.py:56", "perm_1024n_3t"),
        "ring_drain": ("src/repro_torch/csrc/ring_drain.cu",
                       "src/repro/kernels/ring_drain/kernel.py:56", "perm_1024n_3t"),
        "rr_pick": ("src/repro_torch/csrc/rr_pick.cu",
                    "src/repro/kernels/enqueue_arb/kernel.py:91", "alltoall_3t"),
    }
    kernels = []
    for k, rec in records.items():
        src, rep, path = replaces[k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=paths[path]["launches"][k], launches_path=path,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by="bytes", library_ms=None,
            shape=rec["shape"], call_ms=rec["call_ms"],
            plain_call_ms=rec["plain_call_ms"]))
    e2e = {k: dict(ticks=v["ticks"], executed=v["steps"],
                   ticks_per_s=v["ticks"] / v["wall"],
                   plain_ticks_per_s=v["ticks"] / v["wall_plain"],
                   cpu_ticks_per_s=v["ticks"] / v["wall_cpu"])
           for k, v in paths.items()}
    log(f"[main] end to end: {json.dumps(e2e)}")
    prof = phase_profile()
    log(f"[done] total {time.perf_counter() - t0:.1f} s")
    if "--json" in sys.argv[1:]:
        out = Path(sys.argv[sys.argv.index("--json") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(device=name, nvidia_smi=smi_line,
                                       kernels=kernels, end_to_end=e2e,
                                       profile=prof), indent=1))
    log(f"[device] {smi_line}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
