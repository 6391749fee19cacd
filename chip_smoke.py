"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --json DIR/chip_smoke.json   # also keep the record
    python3 chip_smoke.py --kernels-only               # stop after phase 3

Phases (any failure exits non-zero; nothing is caught and swallowed):

  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile src/repro_torch/csrc/*.cu (one nvcc per source, all
               in parallel) into build/repro_torch/, print the build time
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card at its paths' shapes plus ragged and edge cases: the
               simulator kernels bit for bit (the fused control kernel
               against control_ref, the fused arrivals kernel against
               arrivals_ref, the fused sends kernel against sends_ref and
               the fused departures kernel against departures_ref on
               seeded operands, every flag on and off, a ragged ring, a
               fan-in row past one warp, sender rows of 1, 31, 70 and 254
               flows, and all three on the simulator's own states:
               perm_1024n_3t, alltoall_3t, corefail_128n_3t across its
               failure and to its first timeouts, incast_256x1_3t under
               eqds; the sends kernel also on allreduce_ring_128n_3t and
               perm_128n_3t under bbr; the departures kernel on the
               start-of-tick states of perm_1024n_3t, alltoall_3t,
               corefail_128n_3t across its failure and repair,
               flap_128n_3t before its flap and in a down window,
               perm_512n_3t_degraded and incast_256x1_3t under eqds);
               flash_attention within
               2e-5 (f32, the SIMT kernel) / 2e-2 (bf16, the tensor-core
               kernel; every masking and ragged case in both dtypes, the
               launch counted on the dtype's kernel, a misaligned bf16
               view refused; a value head dim of its own, MLA's, and
               cross-attention's non-causal Sk > Sq on both kernels, a
               bf16 value head dim off 8 refused; MLA at minicpm3-4b's
               full width and cross-attention at llama-3.2-vision-90b's
               timed beside their bounds and SDPA; the tensor-core
               kernel's bf16-score variant, cfg.attn_bf16, on every bf16
               case against the plain version's bf16 scores within 2e-2,
               its launches counted, timed at qwen3-0.6b's shape beside the
               f32-score kernel, SDPA and the bound) and ssd_chunk_scan
               within 2e-4 (B/C in
               group form; bf16 on the tensor-core kernel, f32 on the
               SIMT kernel, the launch counted on the dtype's kernel, a
               misaligned bf16 view refused).
               Device times of kernel and plain version (CUDA-graph
               replay) beside the least time the card could take (bytes
               at 3.35 TB/s or operations at the peak rate of their type,
               whichever is larger) and, where one PyTorch call computes
               the same function (SDPA for flash_attention), its time;
               for flash_attention and ssd_chunk_scan also the SIMT
               kernel's time on the same bf16 inputs (variant="simt"),
               the earlier design; for the fused control kernel the split
               design's ring_drain + cc_update on the same state, for the
               fused arrivals kernel the split design's enqueue_rank, for
               the fused sends kernel (on perm_1024n_3t and alltoall_3t)
               the rr_pick kernel on alltoall_3t's rows, for the fused
               departures kernel the standalone red_mark kernel on the same queue
               sizes, and each whole phase fused against its earlier design
               (split; plain departures) (device time and launches of one
               call, captured in a CUDA graph)
  4. main path — perm_1024n_3t (the paper's 1024-node, three-tier fat
               tree), alltoall_3t and perm_512n_3t end to end through the
               kernels, the departures, arrivals, control and sends phases
               one fused launch a tick each; launch counts reset just before
               each run and read just after; the final states equal to the
               runs through the split control, arrivals and sends phases,
               the plain departures phase and the CPU port (run in a
               process of its own from the end of the build, with phase
               4c's), field by field, and to the plain versions on the card
               over the first MAIN_PLAIN_TICKS ticks; the summaries equal
               to the JAX reference's; ticks/s in turns (fused, plain departures;
               TURNS runs a way; the plain versions timed on their one
               equality run) on perm_1024n_3t and alltoall_3t
  4b. red_mark — the first 300 ticks of perm_1024n_3t on the card, the
               red_mark kernel beside every tick's departures: its marks
               equal to the flip departures applies (fabric.red_marks on
               the active queues), its admitted counts equal to what the
               arrivals phase enqueues into each queue, its trims to the
               trims the tick counts
  4c. comparison — the paper's comparison paths through the kernels:
               perm_1024n_3t under swift, mprdma and eqds (EQDS grants
               through rr_pick), incast_256x1_3t under eqds, the failover
               runs corefail_128n_3t (without and with the recovery knobs)
               and flap_128n_3t, and the collective allreduce_ring_128n_3t
               (32 512 flows behind the dependency gate).  Each runs whole
               through the kernels, the departures, arrivals, control and
               sends phases through their fused launches (SMaRTT's update inside the control
               launch for the SMaRTT runs, in PyTorch for the baselines;
               the credit path and the fault metrics inside the arrivals
               launch where the run has them), launch counts reset just before
               and read just after; the summary equal to the JAX
               reference's; the final state equal to the plain-on-card run
               and to the CPU port's (its process started with phase 4's),
               each over the prefix of ticks
               COMPARISON_RUNS states
  4d. experiment API — api.run of perm_1024n_3t and perm_512n_3t on the
               card (rows equal to the JAX reference's pinned rows,
               launches equal to phase 4's executed ticks, wall_s beside
               the whole call's wall); RunResult rows from phase 4's and
               4c's final states (no re-run) equal to their pinned rows
               (fault rows with ttr_max and dip_*, allreduce with cct; the
               eqds runs' trim_seen below 2**24, also checked in 4c); the
               4-lane perm_1024n_3t study (start_cwnd_mult 1.0 and 1.25 x
               seeds 0, 1) through the lane loop: every lane's row and
               final state equal to the standalone api.run of its point
               and seed, the base lane's row to its pinned row, launches
               of each fused kernel equal to the loop's batched ticks and
               each lane's executed ticks to its standalone run's, lanes
               a second; Sim.run_trace over perm_1024n_3t's first 300
               ticks, the card's outputs and final state equal to the CPU
               port's bit for bit
  4e. lanes — the four fused kernels on a [4, ...] batch of
               perm_1024n_3t at ticks 40, 120, 200 and 60 under four
               points' constants, the last lane not live, against their
               batched plain versions bit for bit, the idle lane untouched
               (run with the kernel checks, so --kernels-only covers it);
               a 16-lane perm_1024n_3t study (start_cwnd_mult x kmin_frac
               x fd x 2 seeds) and a 4-lane eqds study through the lane
               loop (counts reset just before, read just after: one
               launch of each kernel a batched tick), every lane's row,
               final state and executed ticks equal to its standalone
               api.run's, the base point's seed-0 row to the pinned JAX
               row; lanes a second of the 4- and 16-lane studies through
               the lane loop and one after another, in turns (median of
               3); the device's idle share of a 16-lane batched tick
               under torch.profiler; the 16-lane study's peak memory
  4g. mesh — phase 4e's 16-lane perm_1024n_3t study over meshes of the
               one card repeated, [cuda:0] * 2 and * 3 (16 lanes padded
               to 18): one lane loop a shard, each on a host thread and a
               CUDA stream of its own (counts reset just before, read just
               after); every lane's final state bit-equal to 4e's
               one-device batch, each fused kernel launched the sum of the
               shards' batched ticks; lanes a second beside the one-device
               batch (median of 3, in turns); over distinct cards where
               there are two or more, else one line saying so
  4f. bridge — collectives/bridge.py's estimate of a 4 MiB all-to-all and
               an 8 MiB all-reduce on 32 nodes at 4:1 oversubscription
               under smartt, swift and eqds on the card: every field equal
               to the CPU port's (run in a process of its own from the
               start) and to the JAX package's pinned values
  5. serving — qwen3-0.6b (28 layers) and mamba2-780m (48 layers) at full
               width from a seeded init on the card, each serving two
               requests (B=4 x 512 prompt tokens and B=2 x 300, 16 new
               tokens) through serve.generate; launch counts reset just
               before each generate and read just after (flash_attention
               28 per qwen3 prefill, ssd_chunk_scan 48 per mamba2
               prefill, all on the tensor-core kernels; neither in
               decode); TTFT in turns through the kernels, the SIMT
               kernel and the plain versions;
               prefill logits and caches and the teacher-forced logits
               and tokens against the same model served through the
               plain versions on the card; time to first token, decode
               tokens/s, peak memory and the device's idle share while
               decoding; then qwen3-0.6b's first request's prefill once
               with attn_bf16 (the flash kernel's bf16-score variant, one
               launch a layer): logits against the plain path's within
               5e-2, TTFT beside f32 scores
  5b. zoo — the other eight architectures at full width from a seeded
               init, one at a time (qwen2-0.5b, phi3-mini-3.8b, minicpm3-4b
               and musicgen-large whole; llama-3.2-vision-90b 5 layers,
               dbrx-132b and mixtral-8x22b 2, jamba-1.5-large-398b pattern
               positions 0-4: what one card holds), each serving B=4 x 512
               prompt tokens (musicgen: frame embeddings; llama-vision: a
               [4, 4096, 8192] cross feed) and 8 new tokens, through
               serve.generate or prefill + decode_step; launch counts
               reset just before and read just after (flash_attention once
               an attention, cross or MLA layer and ssd_chunk_scan once a
               Mamba-2 layer of the prefill, on the tensor cores; none in
               decode); each layer from the same input, the prefill and
               the teacher-forced logits against the plain versions on
               the card (phase 5's gates; a MoE token the two paths route
               differently, where the router did not decide, is left out);
               TTFT in turns, decode tokens/s, peak memory
  5c. train — first (with the kernel checks, so --kernels-only covers
               it) the two kernels' autograd Functions against autograd
               through the plain versions (GRAD_*_CASES: causal, window,
               cross, MLA's dv, B/C in group form, bf16 and f32, a
               microbatch at full width): one launch a forward, none in the
               backward (plain PyTorch).  Then qwen3-0.6b (28 layers) and
               mamba2-780m (48) at full width from a seeded init, one at a
               time: one 4 x 1024 microbatch's loss and every parameter's
               gradient through the kernels against the plain versions on
               the same weights (launches counted: 2 a layer, the forward
               and remat's recompute); TRAIN_STEPS AdamW steps of 8 x 1024
               tokens in 2 microbatches (counts reset just before, read
               just after: 4 a layer a step), the loss falling, every loss
               and gradient norm finite; step wall, tokens/s, a
               microbatch's forward and backward, peak memory, the
               device's busy share of a step (torch.profiler) and the
               plain versions' step time in turns.  Then the restart:
               qwen3-0.6b at full width cut to RESTART_LAYERS layers
               through train.loop for 2 steps and a checkpoint,
               resumed to 4, against 4 uninterrupted steps, under
               torch.use_deterministic_algorithms(True, warn_only=True):
               losses, final parameters and moments equal bit for bit
  6. profile — where perm_1024n_3t's tick time goes, through the fused
               launches and through each earlier design (plain departures,
               split arrivals, control, sends): each phase's ms a tick, the
               device's busy share and kernels a tick; beside them the
               departures, arrivals, control and sends phases' launches and
               device time a call (phase 3: a CUDA graph of the phase, its
               nodes counted)
  7. analysis — repro_torch.analysis on the card: lint.lint_repo() over the
               port's sources, then the op auditor's nine programs (init,
               the six phases, step, horizon; each recorded twice, at
               consecutive ticks) of tiny_3t, perm_1024n_3t under smartt
               and eqds, alltoall_3t and corefail_128n_3t past its failure
               (t = 520), through the fused launches ("kernel") and through
               the plain versions, and JX006's SimConfig classification.
               Each phase's row printed (aten ops, custom launches, host
               syncs, scatter/gather, the same op sequence at both ticks)
               beside the device kernels torch.profiler saw in one call.
               Fails on any unallowlisted finding, on a fused phase
               (departures, arrivals, control, sends; EQDS's grants) that
               is not one launch of its own kernel a call, and on a host
               sync inside the six phases; prints the phase's wall time

  5d. sharded — the train step through the sharded-training layer
               (repro_torch.sharding, launch.specs, AdamW's ZeRO-1 specs) on
               a one-rank (1, 1) DeviceMesh (nccl, a FileStore in a
               temporary directory): qwen3-0.6b (28 layers) and mamba2-780m
               (4 layers) at full width from a seeded init, the parameters
               placed by param_specs, the moments by zero1_state_specs; one
               4 x 1024 microbatch's loss and every gradient, then one AdamW
               step, against the unsharded kernel path on the same weights
               (bit for bit, else the worst leaf printed and held to phase
               5c's gates); launches counted in each run (flash_attention 2
               an attention layer, ssd_chunk_scan 2 a Mamba-2 layer, on
               their local heads shard); the step's wall in turns, sharded
               and unsharded; then SHARDED_MOE, mixtral-8x22b at full
               width cut to 1 of 56 layers (~2.9 G parameters: one path's
               weights, gradients and bf16 moments are ~35 GB, so the
               unsharded path runs first and its results wait on the
               host), with ARCH_RUN's fsdp, sequence parallelism and bf16
               moments: the
               MoE routing and dispatch in each rank's local region, the
               same checks, each path's MoE routes recorded (a token routed
               otherwise printed), flash_attention 2 launches a microbatch
               on each path, the peak memory; compressed_psum_mean over the
               one-rank group on qwen3-0.6b's flattened f32 gradient, equal
               to the same call on a CPU copy (a one-rank gloo group) bit
               for bit
  8. dry run — launch.dryrun.run_cell of DRYRUN_CELLS (qwen3-0.6b x
               train_4k, prefill_32k, decode_32k on 16x16 and 2x16x16;
               on 16x16 mamba2-780m x train_4k, mixtral-8x22b x train_4k
               at one microbatch (MoE routing and dispatch), phi3-mini-3.8b
               x prefill_32k (sequence parallelism), minicpm3-4b x
               decode_32k (MLA's decode on DTensor caches): a fake world of
               256 or 512 ranks, FakeTensorMode, the step once), in a
               process of its own started at the top (fake tensors: nothing
               is allocated on the card); each cell's state GiB a device
               (equal to the value tests/test_torch_dryrun.py pins), FLOPs
               a device and collective MiB by kind

The last two lines are the ``{"kernels": [...]}`` record and the contract
line ``{"ok": true, "device": {...}}``; the card's nvidia-smi name and
power limit come on a line before them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch is missing next to this script; "
             "run it from the root of a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM peak HBM3 bandwidth
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak
F32_FLOP_PER_S = 67e12          # H100 SXM f32 peak outside the tensor cores

# The JAX reference's summaries of the two main-path runs (seed 0), pinned
# by tests/test_torch_engine.py against the JAX package on the CPU.
REFERENCE = {
    "perm_1024n_3t": dict(ticks=1070, n_done=1024, fct_max=1086,
                          fct_mean=265.990234375, trims=16977, retx=16977,
                          timeouts=0, acks=65513),
    "alltoall_3t": dict(ticks=401, n_done=992, fct_max=417,
                        fct_mean=221.60685483870967, trims=0, retx=0,
                        timeouts=0, acks=7877),
    # the North star's scenario, pinned by tests/test_torch_pins_perm512.py
    "perm_512n_3t": dict(ticks=229, n_done=512, fct_max=245,
                         fct_mean=175.458984375, trims=6008, retx=6008,
                         timeouts=0, acks=32764),
    # the comparison runs (phase 4c), pinned by tests/test_torch_pins_*.py
    "perm_1024n_3t/swift": dict(ticks=567, n_done=1024, fct_max=583,
                                fct_mean=361.171875, trims=12536, retx=12536,
                                timeouts=0, acks=65532),
    "perm_1024n_3t/mprdma": dict(ticks=507, n_done=1024, fct_max=523,
                                 fct_mean=255.7119140625, trims=12390,
                                 retx=12390, timeouts=0, acks=65529),
    "perm_1024n_3t/eqds": dict(ticks=279, n_done=1024, fct_max=295,
                               fct_mean=197.875, trims=23850, retx=23850,
                               timeouts=0, acks=65344),
    "incast_256x1_3t/eqds": dict(ticks=2055, n_done=256, fct_max=2071,
                                 fct_mean=1677.36328125, trims=9729,
                                 retx=9729, timeouts=0, acks=2031),
    "corefail_128n_3t": dict(ticks=6000, n_done=127, fct_max=1863,
                             fct_mean=1009.1023622047244, trims=4246,
                             retx=4386, timeouts=145, acks=32660,
                             blackholed=146, delivered_bytes_fault=71446528.0),
    "corefail_128n_3t/recovery": dict(ticks=3616, n_done=128, fct_max=3632,
                                      fct_mean=1044.6953125, trims=4219,
                                      retx=4332, timeouts=113, acks=32751,
                                      blackholed=113,
                                      delivered_bytes_fault=71888896.0),
    "flap_128n_3t": dict(ticks=4363, n_done=128, fct_max=4379,
                         fct_mean=1071.4609375, trims=4226, retx=4479,
                         timeouts=253, acks=32767, blackholed=253,
                         delivered_bytes_fault=39952384.0),
    "allreduce_ring_128n_3t": dict(ticks=3877, n_done=32512, fct_max=3893,
                                   fct_mean=1961.375, trims=0, retx=0,
                                   timeouts=0, acks=258888, cct=3893),
}

# The JAX reference's RunResult.row() (no wall_s) for every run of phases 4,
# 4c and 4d, pinned by tests/test_torch_pins_*.py and
# tests/test_torch_run_large.py against the JAX package on the CPU.
REFERENCE_ROWS = {
    "perm_1024n_3t": dict(name="perm_1024n_3t/smartt+reps[base]/s0",
             scenario="perm_1024n_3t", algo="smartt", lb="reps", point={}, seed=0,
             max_ticks=60000, ticks=1070, n_flows=1024, n_done=1024, all_done=True,
             completion=1086, fct_mean=265.99, fct_p99=970.93, jain=0.660425,
             slowdown_mean=2.657969, slowdown_p99=9.426505, trims=16977, drops=0,
             blackholed=0, timeouts=0, retx=16977, spurious_frac=0.0,
             delivered_bytes=268435456.0, q_mean=0.880381, q_max=40),
    "alltoall_3t": dict(name="alltoall_3t/smartt+reps[base]/s0", scenario="alltoall_3t",
             algo="smartt", lb="reps", point={}, seed=0, max_ticks=200000, ticks=401,
             n_flows=992, n_done=992, all_done=True, completion=417, fct_mean=221.607,
             fct_p99=401.72, jain=0.82689, slowdown_mean=4.808364, slowdown_p99=10.102564,
             trims=0, drops=0, blackholed=0, timeouts=0, retx=0, spurious_frac=0.0,
             delivered_bytes=32505856.0, q_mean=0.11175, q_max=19),
    "perm_512n_3t": dict(name="perm_512n_3t/smartt+reps[base]/s0", scenario="perm_512n_3t",
             algo="smartt", lb="reps", point={}, seed=0, max_ticks=60000, ticks=229,
             n_flows=512, n_done=512, all_done=True, completion=245, fct_mean=175.459,
             fct_p99=209.89, jain=0.988135, slowdown_mean=1.770908, slowdown_p99=2.156737,
             trims=6008, drops=0, blackholed=0, timeouts=0, retx=6008, spurious_frac=0.0,
             delivered_bytes=134217728.0, q_mean=3.338349, q_max=40),
    "perm_1024n_3t/swift": dict(name="perm_1024n_3t/swift+reps[base]/s0",
             scenario="perm_1024n_3t", algo="swift", lb="reps", point={}, seed=0,
             max_ticks=60000, ticks=567, n_flows=1024, n_done=1024, all_done=True,
             completion=583, fct_mean=361.172, fct_p99=548.77, jain=0.882657,
             slowdown_mean=3.630991, slowdown_p99=5.327864, trims=12536, drops=0,
             blackholed=0, timeouts=0, retx=12536, spurious_frac=0.0,
             delivered_bytes=268435456.0, q_mean=1.395322, q_max=40),
    "perm_1024n_3t/mprdma": dict(name="perm_1024n_3t/mprdma+reps[base]/s0",
             scenario="perm_1024n_3t", algo="mprdma", lb="reps", point={}, seed=0,
             max_ticks=60000, ticks=507, n_flows=1024, n_done=1024, all_done=True,
             completion=523, fct_mean=255.712, fct_p99=482.54, jain=0.845326,
             slowdown_mean=2.560971, slowdown_p99=4.684854, trims=12390, drops=0,
             blackholed=0, timeouts=0, retx=12390, spurious_frac=0.0,
             delivered_bytes=268435456.0, q_mean=1.57375, q_max=40),
    "perm_1024n_3t/eqds": dict(name="perm_1024n_3t/eqds+reps[base]/s0",
             scenario="perm_1024n_3t", algo="eqds", lb="reps", point={}, seed=0,
             max_ticks=60000, ticks=279, n_flows=1024, n_done=1024, all_done=True,
             completion=295, fct_mean=197.875, fct_p99=290.0, jain=0.937152,
             slowdown_mean=1.992788, slowdown_p99=2.815534, trims=23850, drops=0,
             blackholed=0, timeouts=0, retx=23850, spurious_frac=0.0,
             delivered_bytes=268435456.0, q_mean=4.792205, q_max=40),
    "incast_256x1_3t/eqds": dict(name="incast_256x1_3t/eqds+reps[base]/s0",
             scenario="incast_256x1_3t", algo="eqds", lb="reps", point={}, seed=0,
             max_ticks=60000, ticks=2055, n_flows=256, n_done=256, all_done=True,
             completion=2071, fct_mean=1677.363, fct_p99=2068.45, jain=0.915552,
             slowdown_mean=35.973094, slowdown_p99=44.009574, trims=9729, drops=0,
             blackholed=0, timeouts=0, retx=9729, spurious_frac=0.0,
             delivered_bytes=8388608.0, q_mean=0.143369, q_max=40),
    "corefail_128n_3t": dict(name="corefail_128n_3t/smartt+reps[base]/s0",
             scenario="corefail_128n_3t", algo="smartt", lb="reps", point={}, seed=0,
             max_ticks=6000, ticks=6000, n_flows=128, n_done=127, all_done=False,
             completion=1863, fct_mean=1009.102, fct_p99=1705.76, jain=0.97134,
             slowdown_mean=3.490022, slowdown_p99=5.782237, trims=4246, drops=0,
             blackholed=146, timeouts=145, retx=4386, spurious_frac=0.0,
             delivered_bytes=133775360.0, q_mean=0.387615, q_max=40, fault_ticks=5490,
             delivered_fault_frac=0.534078, ttr_max=-1, dip_depth=1.0, dip_ticks=5120),
    "corefail_128n_3t/recovery": dict(name="corefail_128n_3t/smartt+reps[base]/s0",
             scenario="corefail_128n_3t", algo="smartt", lb="reps", point={}, seed=0,
             max_ticks=6000, ticks=3616, n_flows=128, n_done=128, all_done=True,
             completion=3632, fct_mean=1044.695, fct_p99=2414.07, jain=0.91199,
             slowdown_mean=3.610135, slowdown_p99=8.183288, trims=4219, drops=0,
             blackholed=113, timeouts=113, retx=4332, spurious_frac=0.0,
             delivered_bytes=134217728.0, q_mean=0.636472, q_max=40, fault_ticks=3116,
             delivered_fault_frac=0.535614, ttr_max=-1, dip_depth=1.0, dip_ticks=2880),
    "flap_128n_3t": dict(name="flap_128n_3t/smartt+reps[base]/s0", scenario="flap_128n_3t",
             algo="smartt", lb="reps", point={}, seed=0, max_ticks=8000, ticks=4363,
             n_flows=128, n_done=128, all_done=True, completion=4379, fct_mean=1071.461,
             fct_p99=3409.08, jain=0.840136, slowdown_mean=3.700866, slowdown_p99=11.556203,
             trims=4226, drops=0, blackholed=253, timeouts=253, retx=4479,
             spurious_frac=0.0, delivered_bytes=134217728.0, q_mean=0.534012, q_max=40,
             fault_ticks=1500, delivered_fault_frac=0.297668, ttr_max=-1, dip_depth=0.9994,
             dip_ticks=3520),
    "allreduce_ring_128n_3t": dict(name="allreduce_ring_128n_3t/smartt+reps[base]/s0",
             scenario="allreduce_ring_128n_3t", algo="smartt", lb="reps", point={}, seed=0,
             max_ticks=120000, ticks=3877, n_flows=32512, n_done=32512, all_done=True,
             completion=3893, fct_mean=1961.375, fct_p99=3857.0, jain=0.754707,
             slowdown_mean=61.375684, slowdown_p99=124.225806, trims=0, drops=0,
             blackholed=0, timeouts=0, retx=0, spurious_frac=0.0,
             delivered_bytes=1065353216.0, q_mean=0.393087, q_max=1, cct=3893,
             n_collectives=1),
}

# The comparison runs: (key in REFERENCE, scenario, overrides, kernels on
# the path, plain-on-card prefix, CPU prefix).  Every run goes whole
# through the kernels, its control phase through the fused launch (with
# SMaRTT's update inside it where the run is SMaRTT's: "control:smartt");
# its final state is held to the plain-on-card run over the whole run
# (prefix None) or its first `prefix` ticks, and to the CPU port over its
# first `cpu prefix` ticks (the CPU is 2-20x slower).  The fault prefixes
# cross the first failure (corefail: t = 500; flap: its first down
# stretch starts at t = 500).
RECOVERY = dict(rto_backoff_max=2, evict_on_timeout=True)   # benchmarks/failover.py
TICK = ("departures", "control", "arrivals", "sends")
SMARTT_TICK = TICK + ("control:smartt",)
COMPARISON_RUNS = (
    ("perm_1024n_3t/swift", "perm_1024n_3t", dict(algo="swift"), TICK, 150, 150),
    ("perm_1024n_3t/mprdma", "perm_1024n_3t", dict(algo="mprdma"), TICK, 150, 150),
    ("perm_1024n_3t/eqds", "perm_1024n_3t", dict(algo="eqds"),
     TICK + ("rr_pick",), 150, 150),
    ("incast_256x1_3t/eqds", "incast_256x1_3t", dict(algo="eqds"),
     TICK + ("rr_pick",), 300, 300),
    ("corefail_128n_3t", "corefail_128n_3t", {}, SMARTT_TICK, 540, 540),
    ("corefail_128n_3t/recovery", "corefail_128n_3t", RECOVERY, SMARTT_TICK, 540, 540),
    ("flap_128n_3t", "flap_128n_3t", {}, SMARTT_TICK, 540, 540),
    ("allreduce_ring_128n_3t", "allreduce_ring_128n_3t", {}, SMARTT_TICK, 100, 100),
)
# phase 4: the main path's runs (all SMaRTT), and the ways timed in turns
MAIN_RUNS = (("perm_1024n_3t", SMARTT_TICK), ("alltoall_3t", SMARTT_TICK),
             ("perm_512n_3t", SMARTT_TICK))
# the ways a run goes: the backends of SimConfig, and the kernels each way
# launches in place of the fused path's (split-control: the control phase
# as the earlier ring_drain + cc_update kernels; split-arrivals: the
# arrivals phase as the earlier enqueue_rank kernel with PyTorch glue;
# split-sends: the sends phase as the earlier rr_pick kernel with PyTorch
# glue, which launches it only where a sender holds several flows;
# plain-departures: the departures phase as its earlier design, PyTorch
# with the RED flip inline, which launches no kernel of ours)
_FUSED = dict(cc_backend="kernel", departures_backend="kernel", fabric_backend="kernel",
              transport_backend="kernel", sender_backend="kernel")
WAYS = {
    "kernel": _FUSED,
    "split-control": {**_FUSED, "transport_backend": "split"},
    "split-arrivals": {**_FUSED, "fabric_backend": "split"},
    "split-sends": {**_FUSED, "sender_backend": "split"},
    "plain-departures": {**_FUSED, "departures_backend": "plain"},
    "plain": dict(cc_backend="plain", departures_backend="plain", fabric_backend="plain",
                  transport_backend="plain", sender_backend="plain"),
}
SPLIT_KERNELS = {"split-control": {"control": ("cc_update", "ring_drain"),
                                   "control:smartt": ()},
                 "split-arrivals": {"arrivals": ("enqueue_rank",)},
                 "split-sends": {"sends": ("rr_pick",)},
                 "plain-departures": {"departures": ()}}
# runs a way, in turns: fused, plain departures; the plain versions are
# timed on their one equality run (few turns keep the script inside its
# time limit on a slower host)
TURNS = 3
MAIN_PLAIN_TICKS = 300    # the plain versions on the card: a prefix of each main run
TURN_WAYS = ("kernel", "plain-departures")
TURN_RUNS = ("perm_1024n_3t", "alltoall_3t")
# phase 3's fused control kernel against control_ref: seeded operands
# ((NF, N, W, MAXW, R), seed, flags): one flow, a ragged ring (W = 1024,
# 13 flows), perm_1024n_3t's shapes with the backoff on, every flag
# flipped, sixteen flows a receiver ...
CONTROL_CASES = (
    ((1, 1, 32, 1, 3), 2, {}),
    ((13, 5, 1024, 40, 9), 2, dict(smartt=False, credit_based=True)),
    ((1024, 1024, 64, 2, 40), 3, dict(rto_backoff_max=3)),
    ((1024, 1024, 64, 2, 40), 4, dict(trimming=False, credit_based=True,
                                      rto_backoff_max=2, smartt=False)),
    ((512, 32, 64, 1, 40), 5, dict(credit_based=True)),
)
# phase 3's fused arrivals kernel against arrivals_ref: the seeded
# kernels/cases.py ARRIVALS_CASES ...
# ... and the simulator's own states, driven phase by phase on the card:
# (scenario, overrides, control ticks, arrivals ticks, sends ticks, the
# work the checked ticks must hold).  alltoall_3t never trims;
# corefail_128n_3t trims until t = 282, its core uplinks die at t = 500 and
# its first timeouts fire at t = 670; incast_256x1_3t under eqds trims (and
# its receivers see the trims) from t = INCAST_TRIMS on, and resends on
# credits from t = 35; allreduce_ring_128n_3t's senders hold 254 flows
# behind its dependency gate; perm_128n_3t under bbr paces every flow and
# resends from t = 34.  The fused control, arrivals and sends kernels are
# timed on perm_1024n_3t's state at TIMED (trims and QuickAdapt under
# way); the sends kernel also on alltoall_3t's at SENDS_TIMED (31 flows a
# sender, window 4), beside the rr_pick kernel on the same rows.
INCAST_TRIMS = 14
ARRIVALS_WORK = ("deliveries", "enqueued", "rejects")
SENDS_WORK = ("emits", "picks")
TICK_STATES = (
    ("perm_1024n_3t", {}, (100, 300, 700), (100, 300, 700), (100, 300, 700),
     ARRIVALS_WORK + ("emits", "resends")),
    ("alltoall_3t", {}, (60, 200), (60, 200), (60, 100, 200),
     ("deliveries", "enqueued") + SENDS_WORK),
    ("corefail_128n_3t", {}, tuple(range(665, 690)), (260, 270, 499, 500, 501, 520, 680),
     (520, 680), ARRIVALS_WORK + ("fault_bytes", "emits")),
    ("incast_256x1_3t", dict(algo="eqds"), (),
     tuple(range(INCAST_TRIMS, INCAST_TRIMS + 60, 4)), tuple(range(36, 72, 4)),
     ARRIVALS_WORK + ("trim_seen", "emits", "resends", "credits")),
    ("allreduce_ring_128n_3t", {}, (), (), (100, 120, 240, 460), SENDS_WORK),
    ("perm_128n_3t", dict(algo="bbr"), (), (), (20, 40, 70, 120),
     ("emits", "resends", "paced")),
)
TIMED = ("perm_1024n_3t", 300)
SENDS_TIMED = ("alltoall_3t", 200)
# phase 3's fused departures kernel against departures_ref on the
# simulator's start-of-tick states: (scenario, overrides, ticks, the work
# the checked ticks must hold).  Each run goes to the next checked tick as
# Sim.run goes (leaping where it leaps).  corefail_128n_3t's core uplinks
# die at t = 500 and come back at 5990; flap_128n_3t's port flaps from
# t = 200 (healthy to 499, down 500-799); perm_512n_3t_degraded has a dead
# port and a half-rate one (served on even ticks) from t = 0.  The kernel
# is timed on perm_1024n_3t's state at DEPARTURES_TIMED, beside the
# standalone red_mark kernel on the same queue sizes.
DEPARTURES_STATES = (
    ("perm_1024n_3t", {}, (100, 300, 700), ("emits", "marks", "deliveries", "wraps")),
    ("alltoall_3t", {}, (60, 200), ("emits", "deliveries")),
    ("corefail_128n_3t", {}, (499, 500, 501, 520, 680, 5989, 5990, 5991),
     ("emits", "marks", "black")),
    ("flap_128n_3t", {}, (150, 199, 200, 499, 500, 501, 650), ("emits", "black")),
    ("perm_512n_3t_degraded", {}, (20, 21, 40, 41, 100), ("emits", "black", "held")),
    ("incast_256x1_3t", dict(algo="eqds"), (20, 60, 200), ("emits", "deliveries")),
)
DEPARTURES_TIMED = ("perm_1024n_3t", 300)
DEPARTURES_WORK = ("emits", "marks", "deliveries", "black", "held", "wraps")
RED_MARK_TICKS = 300      # phase 4b: queues load and trims begin by then
# phase 4d: the experiment API at full width.  api.run of API_RUNS; a study
# of STUDY_SCENARIO over STUDY_POINTS x STUDY_SEEDS (its base-config lane is
# the point start_cwnd_mult=1.25, SimConfig's default); Sim.run_trace over
# TRACE_TICKS ticks, the card's trace against the CPU port's.
API_RUNS = ("perm_1024n_3t", "perm_512n_3t")
STUDY_SCENARIO = "perm_1024n_3t"
STUDY_POINTS = ({"start_cwnd_mult": 1.0}, {"start_cwnd_mult": 1.25})
STUDY_SEEDS = (0, 1)
TRACE_TICKS = 300
PROFILE_TICKS = 400       # phase 6's host time a phase (tick.<phase> spans)
# phase 4e: lanes on the card.  The 16-lane study sweeps an axis that each
# reaches another place: the initial state, departures.cu's RED
# thresholds, control.cu's SMaRTT update
LANES_POINTS = tuple({"start_cwnd_mult": a, "kmin_frac": k, "fd": f}
                     for a in (1.0, 1.25) for k in (0.2, 0.3) for f in (0.8, 0.6))
LANES_SEEDS = (0, 1)
LANES_BASE = {"start_cwnd_mult": 1.25, "kmin_frac": 0.2, "fd": 0.8}
EQDS_POINTS = ({}, {"credit_window_mult": 1.5})      # the 4-lane eqds study
LANE_TURNS = 3            # timed turns: batched and one after another
# the batched kernels' check: four lanes of perm_1024n_3t under their own
# constants, driven to their own ticks; the last is not live
CHECK_POINTS = ({"kmin_frac": 0.3, "fd": 0.6}, {"start_cwnd_mult": 1.0},
                {"kmin_frac": 0.3, "num_entropies": 64, "rto_mult": 4.0}, {})
CHECK_TICKS = (40, 120, 200, 60)
CHECK_STEPS = 5
LANE_PROFILE_TICKS = 100
MESH_SIZES = (2, 3)       # phase 4g: 4e's 16-lane study over [cuda:0] * k
MESH_TURNS = 3
# phase 8: the dry run's cells (arch, shape, multi-pod, ARCH_RUN overrides,
# the analytic state bytes a device, pinned by tests/test_torch_dryrun.py
# against the port's launch.dryrun.state_bytes and the JAX package's
# per_device_bytes).  mixtral-8x22b trains at micro=1 (one microbatch of
# the global 256 x 4096 instead of 16: the state bytes are the same, and
# the fake step of 56 layers stays behind phases 3-7)
DRYRUN_CELLS = (
    ("qwen3-0.6b", "train_4k", False, {}, 93437956),
    ("qwen3-0.6b", "train_4k", True, {}, 84107268),
    ("qwen3-0.6b", "prefill_32k", False, {}, 74776576),
    ("qwen3-0.6b", "prefill_32k", True, {}, 74776576),
    ("qwen3-0.6b", "decode_32k", False, {}, 1953824768),
    ("qwen3-0.6b", "decode_32k", True, {}, 1014300672),
    ("mamba2-780m", "train_4k", False, {}, 166956868),
    ("mixtral-8x22b", "train_4k", False, {"micro": 1}, 3310585348),
    ("phi3-mini-3.8b", "prefill_32k", False, {}, 478556160),
    ("minicpm3-4b", "decode_32k", False, {}, 2104043520),
)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- helpers


def leaves(tree, prefix=""):
    """(name, tensor) for every leaf of a NamedTuple state (None skipped)."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, val in zip(tree._fields, tree):
        yield from leaves(val, f"{prefix}.{name}" if prefix else name)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (f32 by its words), compared where ``a`` lives."""
    a, b = a.detach(), b.detach().to(a.device)
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


def graph_launches(fn):
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches: the nodes of a CUDA graph that captures it, counted by
    ``cuGraphGetNodes``.  None where this PyTorch cannot keep the
    captured graph."""
    import ctypes
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        fail(f"cuGraphGetNodes returned {rc}")
    return n.value


def timings(kernel, plain, iters=200, plain_per_graph=50) -> dict:
    return dict(ms=device_ms(kernel), plain_ms=device_ms(plain, per_graph=plain_per_graph),
                call_ms=call_ms(kernel, iters), plain_call_ms=call_ms(plain, iters))


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
        if any(w in line for w in ("registers", "spill", "Compiling entry")) \
                or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    build.library()


# ----------------------------------------------------------- 3. kernels


def kernel_checks(dev, shapes):
    """Every kernel against its plain version on the card; returns the
    per-kernel records (times at the main path's shapes)."""
    from repro_torch.kernels import cases
    from repro_torch.kernels.cc_update import kernel as CK, ref as CR
    from repro_torch.kernels.enqueue_arb import kernel as EK, ref as ER
    from repro_torch.kernels.red_mark import kernel as RK, ref as RR
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

    # ---- red_mark (the thresholds as device scalars for the plain
    # version: CUDA divides by a Python scalar as a multiply by its
    # reciprocal; the kernel takes them by value)
    Q = shapes["NQ"]
    kmin, kmax = cases.RED_KMIN, cases.RED_KMAX
    kmin_d, kmax_d = (torch.tensor(v, dtype=torch.float32, device=dev)
                      for v in (kmin, kmax))
    err = 0.0
    for (q_, tick, salt, lo, hi), seed in (
            ((1, 0, 0xECD, kmin, kmax), 1), ((5, 17, 0xECD, kmin, kmax), 2),
            ((130, 65535, -7, 5.2, 20.8), 3), ((Q, 120000, 0xECD, kmin, kmax), 4),
            ((Q, 2 ** 24 + 1, 2 ** 24 + 3, kmin, kmax), 5),
            ((Q, 99, 0xECD, 20.0, 20.0), 6)):
        c = cases.red_mark_case(q_, seed)
        qs, ar = on(c["q_size"]), on(c["arrivals"])
        lo_d, hi_d = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (lo, hi))
        k = RK.red_mark(qs, ar, cap=c["cap"], kmin=lo, kmax=hi, tick=tick, salt=salt)
        r = RR.red_mark_ref(qs, ar, c["cap"], lo_d, hi_d, tick, salt)
        err = max(err, check("red_mark", k, r, f"[{q_}] tick={tick}"))
    c = cases.red_mark_case(Q, 7)
    qs, ar, cap = on(c["q_size"]), on(c["arrivals"]), c["cap"]
    records["red_mark"] = dict(
        shape=f"[{Q}]", max_abs_err=err, bytes=Q * 17,
        **timings(lambda: RK.red_mark(qs, ar, cap=cap, kmin=kmin, kmax=kmax, tick=77,
                                      salt=0xECD),
                  lambda: RR.red_mark_ref(qs, ar, cap, kmin_d, kmax_d, 77, 0xECD)))

    for name, rec in records.items():
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] {name:12s} {rec['shape']:>11s}: bit-equal to plain "
            f"(max abs err {rec['max_abs_err']}); device time: kernel "
            f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, bound "
            f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bytes']} B); a call with the host's "
            f"work: kernel {rec['call_ms'] * 1e3:.1f} us, plain "
            f"{rec['plain_call_ms'] * 1e3:.1f} us")
    return records


def one_lane(sim, t):
    """``call(fn, st)``: a phase of a lane batch, ``fn(LaneConsts, SimState,
    Tick) -> SimState``, on a single-lane state ``st`` at host tick ``t``.
    The state's one-lane views are made once a leaf (one caller a state),
    so the kernels' blocks see the same operands each call."""
    from repro_torch.kernels import lanes
    views, c1, k = {}, sim.lanes_of(None, 1), lanes.tick_at(t, sim.device)

    def call(fn, st):
        return fn(c1, lanes.one_lane(views, st), k)
    return call


def clone_tree(tree):
    """A copy of every tensor of a NamedTuple state (the fused control
    phase updates its operands in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone_tree(x) for x in tree))


def control_pair(t, fl, ok, orf, what):
    """The fused kernel on ``ok`` and ``control_ref`` on ``orf`` (two copies
    of the same operands): events and operands bit for bit."""
    from repro_torch.kernels.control import kernel as XK, ref as XR
    evk = XK.control_at(t, fl, ok)
    evr = XR.control_ref(t, fl, orf)
    torch.cuda.synchronize()
    bad = [f"event.{n}" for n, a, b in zip(evk._fields, evk, evr) if not bit_equal(a, b)]
    bad += [n for (n, a), (_, b) in zip(leaves(ok), leaves(orf)) if not bit_equal(a, b)]
    if bad:
        fail(f"control {what}: the fused kernel differs from control_ref in {bad}")
    return evk


def control_bytes(sim, st, t, ev) -> int:
    """Bytes the control phase must move at this state: each input read
    once, each output written once, counting what this tick's data needs
    (the send ticks of outstanding slots, the sequence of ACKed and
    timed-out slots, a dedupe word a timeout)."""
    d = sim.dims
    nf, w, n = d.NF, d.W, d.N
    i = 4
    timeouts = int(ev.n_timeouts.sum())
    out = 2 * n * 6 * i                                     # ACK slot: read, zeroed
    out += nf * (4 * i + 1)                                 # dst size t_start rto done
    out += 2 * nf * w * i                                   # sent state plane r/w
    out += int((st.sent[0, :nf] == 1).sum()) * i            # send ticks, live slots
    out += (timeouts + int(ev.has_ack.sum())) * 2 * i       # seqs; dedupe words
    if d.trimming:
        out += (2 * nf + 1) * (2 + d.WW) * i                # trim slot r/w
    if d.credit_based:
        out += (2 * nf + 1) * i
    if d.rto_backoff_max:
        out += 2 * nf * i
    out += nf * i                                           # unacked
    out += nf * (9 * i + 2)                                 # the event buffer
    out += 2 * nf * 34 + 3 * nf * i                         # SMaRTT planes r/w, brtt trtt mi
    out += 2 * (64 + 3) * i                                 # the counters
    return out


def control_cases(dev):
    """The fused control kernel against control_ref on the card on the
    seeded CONTROL_CASES."""
    from repro_torch.kernels import cases
    for shape, seed, flags in CONTROL_CASES:
        c = cases.control_case(*shape, seed, **flags)
        t, fl, ok = cases.control_operands(c, dev)
        _, _, orf = cases.control_operands(c, dev)
        ev = control_pair(t, fl, ok, orf, f"{shape} {flags}")
        s = t % shape[4]
        if ok.ack_ring[s].any() or ok.trim_ring[s].any() or ok.credit_ring[s].any():
            fail(f"control {shape} {flags}: a ring slot is not zero after the call")
        log(f"[kernels] control {str(shape):26s} {str(flags):70s}: bit-equal to "
            f"control_ref ({int(ev.has_ack.sum())} ACKs, {int(ev.n_timeouts.sum())} "
            f"timeouts, {int(ev.n_trims.sum())} trims)")


def arrivals_pair(t, s, fl, ok, orf, what):
    """The fused kernel on ``ok`` and ``arrivals_ref`` on ``orf`` (two copies
    of the same operands): every operand bit for bit."""
    from repro_torch.kernels.arrivals import kernel as AK, ref as AR
    AK.arrivals_at(t, s, fl, ok)
    AR.arrivals_ref(t, s, fl, orf)
    torch.cuda.synchronize()
    bad = [n for (n, a), (_, b) in zip(leaves(ok), leaves(orf)) if not bit_equal(a, b)]
    if bad:
        fail(f"arrivals {what}: the fused kernel differs from arrivals_ref in {bad}")


def arrivals_cases(dev):
    """The fused arrivals kernel against arrivals_ref on the card on the
    seeded ARRIVALS_CASES."""
    from repro_torch.kernels import cases
    for shape, seed, flags in cases.ARRIVALS_CASES:
        c = cases.arrivals_case(*shape, seed, **flags)
        t, s, fl, ok = cases.arrivals_operands(c, dev)
        _, _, _, orf = cases.arrivals_operands(c, dev)
        _, _, _, o0 = cases.arrivals_operands(c, dev)
        arrivals_pair(t, s, fl, ok, orf, f"{shape} {flags}")
        if ok.infl[s.wire].any() or ok.q_fields[-1].any():
            fail(f"arrivals {shape} {flags}: the wire slot or the write-off row is not "
                 f"zero after the call")
        log(f"[kernels] arrivals {str(shape):27s} {str(flags):60s}: bit-equal to "
            f"arrivals_ref ({int(ok.delivered_pkts - o0.delivered_pkts)} deliveries, "
            f"{int(ok.n_trim + ok.n_drop - o0.n_trim - o0.n_drop)} rejects, "
            f"{int((ok.q_size - o0.q_size).sum())} enqueued)")


def sends_pair(t, wire, fl, ok, orf, what):
    """The fused kernel on ``ok`` and ``sends_ref`` on ``orf`` (two copies
    of the same operands): every operand bit for bit."""
    from repro_torch.kernels.sends import kernel as SK, ref as SR
    SK.sends_at(t, wire, fl, ok)
    SR.sends_ref(t, wire, fl, orf)
    torch.cuda.synchronize()
    bad = [n for n, a, b in zip(ok._fields, ok, orf) if not bit_equal(a, b)]
    if bad:
        fail(f"sends {what}: the fused kernel differs from sends_ref in {bad}")


def sends_work(o, o0, wire):
    """What one call of the sends phase did: NICs that emitted, resends,
    cursors moved, credit or budget paid, pacing budgets changed."""
    n = o.flows_of.shape[0]
    return dict(emits=int(o.infl[wire, -n:, 0].sum()), resends=int(o.n_retx - o0.n_retx),
                picks=int((o.rr_send != o0.rr_send).sum()),
                credits=int((o.credits != o0.credits).sum()
                            + (o.spec_budget != o0.spec_budget).sum()),
                paced=int((o.pace_accum != o0.pace_accum).sum()))


def sends_cases(dev):
    """The fused sends kernel against sends_ref on the card on the seeded
    SENDS_CASES."""
    from repro_torch.kernels import cases
    for shape, seed, flags in cases.SENDS_CASES:
        c = cases.sends_case(*shape, seed, **flags)
        t, wire, fl, ok = cases.sends_operands(c, dev)
        _, _, _, orf = cases.sends_operands(c, dev)
        _, _, _, o0 = cases.sends_operands(c, dev)
        sends_pair(t, wire, fl, ok, orf, f"{shape} {flags}")
        log(f"[kernels] sends {str(shape):26s} {str(flags):45s}: bit-equal to sends_ref "
            f"{sends_work(ok, o0, wire)}")


def state_checks(dev):
    """Drive TICK_STATES phase by phase on the card; at the chosen ticks,
    the fused arrivals kernel against arrivals_ref (after departures), the
    fused control kernel against control_ref (after arrivals) and the
    fused sends kernel against sends_ref (after grants), each on two clones
    of the state.  Returns the states at TIMED (and SENDS_TIMED), before
    the phase timed."""
    from repro_torch.netsim import fabric, faults, scenarios, sender, transport
    from repro_torch.kernels.arrivals import ref as AR
    timed = {}
    for name, ov, ctl_ticks, arr_ticks, send_ticks, needs in TICK_STATES:
        sc = scenarios.scenario(name, **ov)
        sim = sc.build(device=dev)
        d, c = sim.dims, sim.consts
        cfl = transport.flags(sc.cfg, d)
        afl = fabric.flags(d, c, sim.clock0)
        sfl = sender.flags(d)
        phases = dict(sim.phases)
        st = sim.init()
        seen = dict(acks=0, timeouts=0, trims=0, deliveries=0, rejects=0, enqueued=0,
                    trim_seen=0, fault_bytes=0, emits=0, resends=0, picks=0, credits=0,
                    paced=0)
        for t in range(max(ctl_ticks + arr_ticks + send_ticks) + 1):
            clk = sim.clock0._replace(t=t)
            st = phases["departures"](c, st, clk)
            if t in arr_ticks:
                if (name, t) == TIMED:
                    timed["arrivals"] = (sim, afl, t, clone_tree(st))
                slots = AR.Slots(wire=t % d.L, ack=(t + clk.ret) % d.R,
                                 trim=(t + clk.trim_delay) % d.R)
                active = faults.fault_active(d, c, t) if afl.faulty else None
                a, b = clone_tree(st), clone_tree(st)
                arrivals_pair(t, slots, afl, fabric.operands(c, a, active),
                              fabric.operands(c, b, active), f"{name} t={t}")
                seen["deliveries"] += int(a.m.delivered_pkts - st.m.delivered_pkts)
                seen["rejects"] += int(a.m.n_trim + a.m.n_drop - st.m.n_trim - st.m.n_drop)
                seen["enqueued"] += int((a.q_size - st.q_size).clamp_min(0).sum())
                seen["trim_seen"] += int((a.trim_seen != st.trim_seen).sum())
                seen["fault_bytes"] += int(a.m.delivered_bytes_fault
                                           > st.m.delivered_bytes_fault)
            st = phases["arrivals"](c, st, clk)
            if t in ctl_ticks:
                if (name, t) == TIMED:
                    timed["control"] = (sim, cfl, t, clone_tree(st))
                ev = control_pair(t, cfl, transport.operands(c, clone_tree(st)),
                                  transport.operands(c, clone_tree(st)), f"{name} t={t}")
                seen["acks"] += int(ev.has_ack.sum())
                seen["timeouts"] += int(ev.n_timeouts.sum())
                seen["trims"] += int(ev.n_trims.sum())
            for p in ("control", "grants"):
                st = phases[p](c, st, clk)
            if t in send_ticks:
                if (name, t) in (TIMED, SENDS_TIMED):
                    timed[f"sends {name}"] = (sim, sfl, t, clone_tree(st))
                wire = (t + clk.lat_send) % d.L
                a = sender.operands(c, clone_tree(st))
                sends_pair(t, wire, sfl, a, sender.operands(c, clone_tree(st)),
                           f"{name} t={t}")
                for k, v in sends_work(a, sender.operands(c, st), wire).items():
                    seen[k] += v
            for p in ("sends", "metrics"):
                st = phases[p](c, st, clk)
            st = st._replace(now=st.now + 1)
        if ctl_ticks and (not seen["acks"] or (name.startswith("corefail")
                                               and not seen["timeouts"])):
            fail(f"control {name}: the checked ticks hold no ACKs or no timeouts {seen}")
        if not all(seen[k] for k in needs):
            fail(f"{name}: the checked ticks miss a kind of work {seen}, needed {needs}")
        log(f"[kernels] control, arrivals and sends on {name} {ov or ''}: control at "
            f"ticks {ctl_ticks[:1]}..{ctl_ticks[-1:]} ({len(ctl_ticks)}), arrivals at "
            f"{arr_ticks}, sends at {send_ticks} bit-equal to their plain versions on "
            f"the simulator's states {seen}")
    return timed


def restoring(saved, st, fn):
    """``fn`` after restoring what the arrivals phase consumes (the wire
    slot landing at ``saved.now``, the queue sizes, the dedupe bitmap) from
    ``saved``, so that every timed call lands the same packets; beside it
    the restore alone."""
    w = int(saved.now) % saved.infl.shape[0]

    def restore():
        st.infl[w].copy_(saved.infl[w])
        st.q_size.copy_(saved.q_size)
        st.bitmap.copy_(saved.bitmap)

    def both():
        restore()
        fn()
    return both, restore


def arrivals_bytes(sim, fl, slots, t, st) -> int:
    """Bytes the arrivals phase must move at this state, counting what this
    tick's data needs: the wire slot and the fan-in tables read whole; a
    touched queue's size and head read once; a delivered packet's flow
    words (dst, size, dedupe word, goodput, done) and a rejected packet's
    flow size read; each word the phase changes written once, and read too
    where the phase adds to it (trim ledger, trim_seen, counters).  A word
    left as it was (a wire or ACK row already zero, a rejected packet's
    cell) is not counted as written."""
    from repro_torch.kernels.arrivals import ref as AR
    from repro_torch.netsim import fabric, faults
    d, c = sim.dims, sim.consts
    i = 4
    after = clone_tree(st)
    active = faults.fault_active(d, c, t) if fl.faulty else None
    AR.arrivals_ref(t, slots, fl, fabric.operands(c, after, active))

    def changed(a, b):
        return int((a != b).sum()) * a.element_size()
    written = ((st.infl[slots.wire], after.infl[slots.wire]), (st.q_fields, after.q_fields),
               (st.q_size, after.q_size), (st.ack_ring[slots.ack], after.ack_ring[slots.ack]),
               (st.bitmap, after.bitmap), (st.goodput, after.goodput),
               (st.done, after.done), (st.fct, after.fct))
    added = ((st.trim_ring[slots.trim], after.trim_ring[slots.trim]),
             (st.trim_seen, after.trim_seen)) + tuple(
        (getattr(st.m, k), getattr(after.m, k)) for k in (
            "delivered_pkts", "n_trim", "n_drop", "delivered_bytes", "goodput_hist",
            "delivered_bytes_fault"))
    out = sum(changed(a, b) for a, b in written) + 2 * sum(changed(a, b) for a, b in added)
    arr = st.infl[slots.wire]
    out += (arr.numel() + c.in_tbl.numel() + c.enq_ids.numel()) * i
    earr = arr[c.enq_ids]
    live = (earr[:, 0] == 1) & (earr[:, 1] >= 0)
    out += int(torch.unique(earr[live, 1]).numel()) * 2 * i      # q_size, q_head
    darr = arr[d.QE:d.QE + d.N]
    out += int(((darr[:, 0] == 1) & (darr[:, 1] < 0)).sum()) * (4 * i + 1)
    rejects = (after.m.n_trim + after.m.n_drop - st.m.n_trim - st.m.n_drop).item()
    out += int(rejects) * i                                     # the flow's size
    return out


def control_timing(timed):
    """The fused control kernel at TIMED's state: against its bound, its
    plain version, the split design's two kernels (ring_drain + cc_update)
    on the same state, and the whole phase against the split design's."""
    from repro_torch.core import registry
    from repro_torch.kernels.cc_update import kernel as CK
    from repro_torch.kernels.control import kernel as XK, ops as XO, ref as XR
    from repro_torch.kernels.ring_drain import kernel as DK, ops as DO
    from repro_torch.netsim import transport
    sim, fl, t, base = timed["control"]
    d, c = sim.dims, sim.consts
    ev = XR.control_ref(t, fl, transport.operands(c, clone_tree(base)))
    nbytes = control_bytes(sim, base, t, ev)
    o_k = transport.operands(c, clone_tree(base))
    o_p = transport.operands(c, clone_tree(base))
    rec = dict(shape=f"[{d.NF}, {d.W}] ({TIMED[0]} t={t})", max_abs_err=0.0,
               **timings(lambda: XK.control_at(t, fl, o_k), lambda: XR.control_ref(t, fl, o_p),
                         plain_per_graph=10),
               **bound(nbytes))
    # the split design's two kernels on the same state, as control_split
    # hands them over
    sb = clone_tree(base)
    cand = sb.ack_ring[t % d.R][c.dst]
    has = (cand[:, 0] == 1) & (cand[:, 1] == c.flow_ids)
    ack_seq = torch.where(has, cand[:, 2], 0).contiguous()
    rto = transport.effective_rto(d, c, sb)
    started = (t >= c.t_start) & ~sb.done
    lbits = sb.trim_ring[t % d.R][:d.NF, 2:]
    drain_args = (rto, started, has, ack_seq, lbits, sb.bitmap[:d.NF],
                  sb.sent[0, :d.NF], sb.sent[1, :d.NF], sb.sent[2, :d.NF])
    p_flow = c.cc._replace(**{n: getattr(c.cc, n).to(torch.float32).expand(d.NF).contiguous()
                              for n in ("brtt", "trtt", "mi")})
    ev_split = ev._replace(**{k: v.clone() for k, v in ev._asdict().items()})
    rec["ring_drain_ms"] = device_ms(lambda: DK.ring_drain(t, *drain_args))
    rec["cc_update_ms"] = device_ms(lambda: CK.cc_update(p_flow, sb.cc, ev_split, t))
    rec["split_ms"] = rec["ring_drain_ms"] + rec["cc_update_ms"]
    # the whole phase: the fused launch + ACK fill + REPS against the split glue
    cc_k = registry.get("smartt", "kernel")
    run_k, drain_k = XO.get("kernel"), DO.ring_drain
    clk = sim.clock0._replace(t=t)
    st_f, st_s = clone_tree(base), clone_tree(base)
    on_f, on_s = one_lane(sim, t), one_lane(sim, t)
    fused_phase = lambda: on_f(lambda cl, s, k: transport.control(  # noqa: E731
        d, cl, cc_k, s, k, run=run_k, fl=fl), st_f)
    split_phase = lambda: on_s(lambda cl, s, k: transport.control_split(  # noqa: E731
        d, cl, cc_k, s, k, drain=drain_k), st_s)
    rec["phase_ms"] = device_ms(fused_phase, per_graph=10)
    rec["split_phase_ms"] = device_ms(split_phase, per_graph=10)
    rec["phase_launches"] = graph_launches(fused_phase)
    rec["split_phase_launches"] = graph_launches(split_phase)
    rec["phase_call_ms"] = call_ms(fused_phase, 100)
    rec["split_phase_call_ms"] = call_ms(split_phase, 100)
    log(f"[kernels] control         {rec['shape']}: device time: fused kernel "
        f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, "
        f"bound {rec['bound_ms'] * 1e3:.4f} us ({nbytes} B); the split pair on the same "
        f"state: ring_drain {rec['ring_drain_ms'] * 1e3:.3f} us + cc_update "
        f"{rec['cc_update_ms'] * 1e3:.3f} us = {rec['split_ms'] * 1e3:.3f} us; the whole "
        f"phase (device): fused {rec['phase_ms'] * 1e3:.2f} us in "
        f"{rec['phase_launches']} launches, split {rec['split_phase_ms'] * 1e3:.2f} us in "
        f"{rec['split_phase_launches']} launches; a call with the host's work: kernel "
        f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_call_ms'] * 1e3:.1f} us, phase "
        f"fused {rec['phase_call_ms'] * 1e3:.1f} us, split "
        f"{rec['split_phase_call_ms'] * 1e3:.1f} us")
    return rec


def arrivals_timing(timed):
    """The fused arrivals kernel at TIMED's state: against its bound, its
    plain version and the split design's enqueue_rank on the same state,
    and the whole phase against the split design's.  Every timed call
    first restores the wire slot, the queue sizes and the bitmap, so it
    lands the same packets; the restore alone is timed too and taken off."""
    from repro_torch.kernels.arrivals import kernel as AK, ops as AO, ref as AR
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.netsim import fabric
    sim, fl, t, base = timed["arrivals"]
    d, c = sim.dims, sim.consts
    clk = sim.clock0._replace(t=t)
    slots = AR.Slots(wire=t % d.L, ack=(t + clk.ret) % d.R, trim=(t + clk.trim_delay) % d.R)
    nbytes = arrivals_bytes(sim, fl, slots, t, base)

    def timed_pair(fn, st, per_graph=50, iters=200):
        both, restore = restoring(base, st, fn)
        return dict(ms=device_ms(both, per_graph) - device_ms(restore, per_graph),
                    call_ms=call_ms(both, iters) - call_ms(restore, iters),
                    restore_ms=device_ms(restore, per_graph))

    st_k, st_p = clone_tree(base), clone_tree(base)
    o_k, o_p = fabric.operands(c, st_k, None), fabric.operands(c, st_p, None)
    k = timed_pair(lambda: AK.arrivals_at(t, slots, fl, o_k), st_k)
    p = timed_pair(lambda: AR.arrivals_ref(t, slots, fl, o_p), st_p, per_graph=10, iters=50)
    rec = dict(shape=f"[{c.in_tbl.shape[0]}, {c.in_tbl.shape[1]}] rows, {d.N} nodes "
                     f"({TIMED[0]} t={t})",
               max_abs_err=0.0, ms=k["ms"], call_ms=k["call_ms"], restore_ms=k["restore_ms"],
               plain_ms=p["ms"], plain_call_ms=p["call_ms"], library_ms=None, **bound(nbytes))
    # the split design's kernel on the same state, as enqueue_arb's
    # enqueue_rank hands it the fan-in group rows
    earr = base.infl[slots.wire][c.enq_ids]
    edst = torch.where((earr[:, 0] == 1) & (earr[:, 1] >= 0), earr[:, 1], d.NQ)
    gdst = torch.cat([edst, edst.new_full((1,), d.NQ)])[c.in_tbl]
    ghead, gsize = base.q_head[gdst], base.q_size[gdst]
    rec["enqueue_rank_ms"] = device_ms(lambda: EK.enqueue_rank(gdst, ghead, gsize,
                                                               cap=d.CAP, nq=d.NQ))
    # the whole phase: fused against the split design's glue
    run_k, run_s = AO.get("kernel"), AO.get("split")
    st_f, st_s = clone_tree(base), clone_tree(base)
    on_f, on_s = one_lane(sim, t), one_lane(sim, t)
    phases = {"fused": lambda: on_f(lambda cl, s, k: fabric.arrivals(
                  d, cl, s, k, run=run_k, trim_delay=clk.trim_delay, fl=fl), st_f),
              "split": lambda: on_s(lambda cl, s, k: fabric.arrivals(
                  d, cl, s, k, run=run_s, trim_delay=clk.trim_delay, fl=fl), st_s)}
    for way, st in (("fused", st_f), ("split", st_s)):
        both, restore = restoring(base, st, phases[way])
        pre = "" if way == "fused" else "split_"
        rec[f"{pre}phase_ms"] = (device_ms(both, per_graph=10)
                                 - device_ms(restore, per_graph=10))
        rec[f"{pre}phase_launches"] = graph_launches(both) - graph_launches(restore)
        rec[f"{pre}phase_call_ms"] = call_ms(both, 100) - call_ms(restore, 100)
    log(f"[kernels] arrivals        {rec['shape']}: device time: fused kernel "
        f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, "
        f"bound {rec['bound_ms'] * 1e3:.4f} us ({nbytes} B); the split design's "
        f"enqueue_rank on the same state {rec['enqueue_rank_ms'] * 1e3:.3f} us; the whole "
        f"phase (device): fused {rec['phase_ms'] * 1e3:.2f} us in "
        f"{rec['phase_launches']} launches, split {rec['split_phase_ms'] * 1e3:.2f} us in "
        f"{rec['split_phase_launches']} launches; a call with the host's work: kernel "
        f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_call_ms'] * 1e3:.1f} us, phase "
        f"fused {rec['phase_call_ms'] * 1e3:.1f} us, split "
        f"{rec['split_phase_call_ms'] * 1e3:.1f} us (each less the restore: "
        f"{rec['restore_ms'] * 1e3:.2f} us of device time)")
    return rec


def sends_restoring(saved, o, fl, fn):
    """``fn`` after restoring, from the operands ``saved``, what the sends
    phase changes that its next call reads (the sent ring, sequences,
    cursors, LB counters, credits and pacing budgets, as the flags make
    the phase write them), so every timed call sends the same packets;
    beside it the restore alone."""
    from repro_torch.core import reps
    names = ["sent", "next_seq", "rr_send"]
    names += {reps.LB_REPS: ["next_entropy", "explore_sent"],
              reps.LB_SPRAY: ["spray_ctr"]}.get(fl.lb_mode, [])
    names += ["credits", "spec_budget"] if fl.credit_based else []
    names += ["pace_accum"] if fl.paced else []

    def restore():
        for n in names:
            getattr(o, n).copy_(getattr(saved, n))

    def both():
        restore()
        fn()
    return both, restore


def sends_bytes(sim, fl, t, wire, st) -> int:
    """Bytes the sends phase must move at this state, counting what this
    tick's data needs: every sender's row of flows_of and cursor; every
    flow's start tick and done flag; the dependency columns of a flow past
    its start; for a flow that passes activation and the window, its
    ring's state plane (the retransmission scan), next sequence, size,
    unacked and cwnd (and credits or pacing budget where they gate); for a
    sending flow its resent sequence, first-hop tables and LB words; and
    each word the phase changes written once (a NIC row already zero, a
    cursor left where it was, is not counted)."""
    from repro_torch.kernels.sends import ref as SR
    from repro_torch.netsim import sender
    d, c = sim.dims, sim.consts
    i = 4
    o = sender.operands(c, st)
    after = sender.operands(c, clone_tree(st))
    SR.sends_ref(t, wire, fl, after)
    by_time = (t >= o.t_start) & ~o.done
    act = SR.activated(t, o.t_start, o.done, o.goodput, o.dep_par, o.dep_thr)
    if fl.window < d.FMAX:
        done_p = torch.cat([o.done, o.done.new_ones(1)])
        unfin = ~done_p[o.flows_of] & (o.flows_of < d.NF)
        prior = torch.cumsum(unfin, dim=1, dtype=torch.int32) - unfin.to(torch.int32)
        act &= prior[o.src, o.slot_of] < fl.window
    n_act, n_emit = int(act.sum()), int(after.infl[wire, d.NQ:, 0].sum())
    out = (o.flows_of.numel() + d.N) * i + d.NF * (i + 1)
    out += int(by_time.sum()) * d.D * 3 * i
    out += n_act * (d.W + 4 + 2 * fl.credit_based) * i
    out += d.NF * 2 * i * fl.paced
    out += n_emit * (8 * i + 9) + 2 * i
    for n in ("infl", "sent", "next_seq", "rr_send", "pace_accum", "credits",
              "spec_budget", "next_entropy", "explore_sent", "spray_ctr", "n_retx"):
        a, b = getattr(o, n), getattr(after, n)
        if n == "infl":
            a, b = a[wire, d.NQ:], b[wire, d.NQ:]
        out += int((a != b).sum()) * a.element_size()
    return out


def sends_timing(timed):
    """The fused sends kernel at TIMED's and SENDS_TIMED's states: against
    its bound and its plain version, the rr_pick kernel on the same rows where
    senders hold several flows, and the whole phase against the split
    design's.  Every timed call first restores what the phase changed
    (sends_restoring); the restore alone is timed too and taken off."""
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.kernels.sends import kernel as SK, ops as SO, ref as SR
    from repro_torch.netsim import sender
    recs = {}
    for run in (TIMED[0], SENDS_TIMED[0]):
        sim, fl, t, base = timed[f"sends {run}"]
        d, c = sim.dims, sim.consts
        clk = sim.clock0._replace(t=t)
        wire = (t + clk.lat_send) % d.L
        nbytes = sends_bytes(sim, fl, t, wire, base)
        saved = sender.operands(c, base)

        def timed_pair(fn, o, per_graph=50, iters=200):
            both, restore = sends_restoring(saved, o, fl, fn)
            return dict(ms=device_ms(both, per_graph) - device_ms(restore, per_graph),
                        call_ms=call_ms(both, iters) - call_ms(restore, iters),
                        restore_ms=device_ms(restore, per_graph))

        o_k, o_p = sender.operands(c, clone_tree(base)), sender.operands(c, clone_tree(base))
        k = timed_pair(lambda: SK.sends_at(t, wire, fl, o_k), o_k)
        p = timed_pair(lambda: SR.sends_ref(t, wire, fl, o_p), o_p, per_graph=10, iters=50)
        rec = dict(shape=f"[{d.N}, {d.FMAX}] rows, {d.NF} flows, W = {d.W} ({run} t={t})",
                   max_abs_err=0.0, ms=k["ms"], call_ms=k["call_ms"],
                   restore_ms=k["restore_ms"], plain_ms=p["ms"], plain_call_ms=p["call_ms"],
                   library_ms=None, **bound(nbytes))
        if d.FMAX > 1:
            # the rr_pick kernel on the same rows, as the split design hands them
            elig, _, _, _ = SR.admission(t, fl, saved)
            rows = torch.cat([elig, elig.new_zeros(1)])[c.flows_of]
            rec["rr_pick_ms"] = device_ms(lambda: EK.rr_pick(rows, base.rr_send, kmax=d.FMAX))
        run_k, run_s = SO.get("kernel"), SO.get("split")
        st_f, st_s = clone_tree(base), clone_tree(base)
        for way, st, go in (("fused", st_f, run_k), ("split", st_s, run_s)):
            on = one_lane(sim, t)
            both, restore = sends_restoring(
                saved, sender.operands(c, st), fl,
                lambda st=st, go=go, on=on: on(lambda cl, s, k: sender.sends(
                    d, cl, s, k, run=go, lat_send=clk.lat_send, fl=fl), st))
            pre = "" if way == "fused" else "split_"
            rec[f"{pre}phase_ms"] = (device_ms(both, per_graph=10)
                                     - device_ms(restore, per_graph=10))
            rec[f"{pre}phase_launches"] = graph_launches(both) - graph_launches(restore)
            rec[f"{pre}phase_call_ms"] = call_ms(both, 100) - call_ms(restore, 100)
        rr = (f"the rr_pick kernel on the same rows {rec['rr_pick_ms'] * 1e3:.3f} us; "
              if "rr_pick_ms" in rec else "")
        log(f"[kernels] sends           {rec['shape']}: device time: fused kernel "
            f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, bound "
            f"{rec['bound_ms'] * 1e3:.4f} us ({nbytes} B); {rr}the whole phase (device): "
            f"fused {rec['phase_ms'] * 1e3:.2f} us in {rec['phase_launches']} launches, "
            f"split {rec['split_phase_ms'] * 1e3:.2f} us in {rec['split_phase_launches']} "
            f"launches; a call with the host's work: kernel {rec['call_ms'] * 1e3:.1f} us, "
            f"plain {rec['plain_call_ms'] * 1e3:.1f} us, phase fused "
            f"{rec['phase_call_ms'] * 1e3:.1f} us, split "
            f"{rec['split_phase_call_ms'] * 1e3:.1f} us (each less the restore: "
            f"{rec['restore_ms'] * 1e3:.2f} us of device time)")
        recs[run] = rec
    rec = recs[TIMED[0]]
    rec.update({f"a2a_{k}": v for k, v in recs[SENDS_TIMED[0]].items()
                if k not in ("max_abs_err", "library_ms", "bf16_flops", "f32_flops",
                             "tf32_flops")})
    return rec


def departures_pair(t, lat, fl, ok, orf, what):
    """The fused kernel on ``ok`` and ``departures_ref`` on ``orf`` (two
    copies of the same operands): every operand bit for bit."""
    from repro_torch.kernels.departures import kernel as PK, ref as PR
    PK.departures_at(t, lat, fl, ok)
    PR.departures_ref(t, lat, fl, orf)
    torch.cuda.synchronize()
    bad = [n for n, a, b in zip(ok._fields, ok, orf) if not bit_equal(a, b)]
    if bad:
        fail(f"departures {what}: the fused kernel differs from departures_ref in {bad}")


def departures_work(t, lat, fl, o, o0):
    """What one call of the departures phase did (``o0`` before, ``o``
    after): packets emitted, RED marks it set, deliveries to a node,
    packets blackholed, busy ports a fault period held, heads that wrapped."""
    nq, L = o.qidx.shape[0], o.infl.shape[0]
    rows = torch.cat([o.infl[(t + lat.core) % L, :fl.qe], o.infl[(t + lat.edge) % L, fl.qe:nq]])
    emitted = rows[:, 0] == 1
    hol = o0.q_fields[o0.qidx, o0.q_head[:nq]]
    busy = o0.q_size[:nq] > 0
    return dict(emits=int(emitted.sum()),
                marks=int((emitted & (rows[:, 5] == 1) & (hol[:, 3] == 0)).sum()),
                deliveries=int((emitted & (rows[:, 1] < 0)).sum()),
                black=int(o.n_black - o0.n_black),
                held=int((busy & (o.q_size[:nq] == o0.q_size[:nq])).sum()),
                wraps=int((busy & (o.q_head[:nq] < o0.q_head[:nq])).sum()))


def departures_cases(dev):
    """The fused departures kernel against departures_ref on the card on the
    seeded DEPARTURES_CASES."""
    from repro_torch.kernels import cases
    for shape, seed, flags in cases.DEPARTURES_CASES:
        c = cases.departures_case(*shape, seed, **flags)
        t, lat, fl, ok = cases.departures_operands(c, dev)
        _, _, _, orf = cases.departures_operands(c, dev)
        _, _, _, o0 = cases.departures_operands(c, dev)
        departures_pair(t, lat, fl, ok, orf, f"{shape} {flags}")
        log(f"[kernels] departures {str(shape):27s} {str(flags):42s}: bit-equal to "
            f"departures_ref {departures_work(t, lat, fl, ok, o0)}")


def departures_states(dev):
    """The fused departures kernel against departures_ref on the card on the
    simulator's start-of-tick states (DEPARTURES_STATES), each run driven to
    its next checked tick as Sim.run drives it; returns the state at
    DEPARTURES_TIMED."""
    from repro_torch.kernels.departures import ref as PR
    from repro_torch.netsim import engine, fabric, scenarios
    timed = None
    for name, ov, ticks, needs in DEPARTURES_STATES:
        sim = scenarios.scenario(name, **ov).build(device=dev)
        c, fl = sim.consts, fabric.departures_flags(sim.dims)
        st = sim.init()
        seen = dict.fromkeys(DEPARTURES_WORK, 0)
        for t in ticks:
            st = engine._run_until_done(sim, st, t)
            if int(st.now) != t:
                fail(f"departures {name}: the run stopped at t = {int(st.now)}, before {t}")
            clk = sim.clock0._replace(t=t)
            lat = PR.Lat(core=clk.lat_core, edge=clk.lat_edge)
            if (name, t) == DEPARTURES_TIMED:
                timed = (sim, fl, t, clone_tree(st))
            a = fabric.departures_operands(c, clone_tree(st))
            departures_pair(t, lat, fl, a, fabric.departures_operands(c, clone_tree(st)),
                            f"{name} t={t}")
            for k, v in departures_work(t, lat, fl, a,
                                        fabric.departures_operands(c, st)).items():
                seen[k] += v
        if not all(seen[k] for k in needs):
            fail(f"departures {name}: the checked ticks miss a kind of work {seen}, "
                 f"needed {needs}")
        log(f"[kernels] departures on {name} {ov or ''} at ticks {ticks}: bit-equal to "
            f"departures_ref on the simulator's states {seen}")
    return timed


def departures_bytes(sim, fl, t, lat, st) -> int:
    """Bytes the departures phase must move at this state, counting what
    this tick's data needs: every port's size; a busy port's fault tables
    (under a schedule); an active port's head; an emitting port's
    head-of-line row, its flow's destination and the routing words its
    branch reads (edge flag; subtree bounds; the down table or the up
    ports and salt); the four device scalars; and each word the phase
    changes written once (a wire row already zero is not counted), the
    blackholed count read too where it changes."""
    from repro_torch.kernels.departures import ref as PR
    from repro_torch.netsim import fabric
    d, c = sim.dims, sim.consts
    i, nq = 4, d.NQ
    o = fabric.departures_operands(c, st)
    after = fabric.departures_operands(c, clone_tree(st))
    PR.departures_ref(t, lat, fl, after)
    L = o.infl.shape[0]
    core, edge = (t + lat.core) % L, (t + lat.edge) % L
    rows = torch.cat([after.infl[core, :fl.qe], after.infl[edge, fl.qe:nq]])
    emitted = rows[:, 0] == 1
    busy = o.q_size[:nq] > 0
    active = after.q_size[:nq] != o.q_size[:nq]
    flow = rows[:, 2].clamp(0, d.NF - 1)
    dn = o.dst[flow]
    down = (dn >= o.q_lo) & (dn < o.q_hi)
    inner = emitted & ~o.edge_q
    out = nq * i + 4 * i
    if fl.fk or fl.flapped:
        out += int(busy.sum()) * ((fl.fk + 1) * i * bool(fl.fk) + 5 * i * fl.flapped)
    out += int(active.sum()) * i
    out += int(emitted.sum()) * (5 * i + i + 1)
    out += int(inner.sum()) * 2 * i + int((inner & down).sum()) * 2 * i
    out += int((inner & ~down).sum()) * (2 * i + 8)
    for a, b in ((o.infl[core, :fl.qe], after.infl[core, :fl.qe]),
                 (o.infl[edge, fl.qe:nq], after.infl[edge, fl.qe:nq]),
                 (o.q_head, after.q_head), (o.q_size, after.q_size)):
        out += int((a != b).sum()) * i
    out += 2 * i * int(after.n_black != o.n_black)
    return out


def departures_timing(timed):
    """The fused departures kernel at DEPARTURES_TIMED's state: against its
    bound and its plain version, the standalone red_mark kernel on the same queue
    sizes, and the whole phase against its earlier design (the plain
    version in PyTorch).  Every timed call first restores what the phase
    changed that it reads (heads, sizes, the blackholed count), so it
    departs the same packets; the restore alone is timed too and taken off."""
    from repro_torch.kernels.departures import kernel as PK, ops as PO, ref as PR
    from repro_torch.kernels.red_mark import kernel as RK
    from repro_torch.netsim import fabric
    sim, fl, t, base = timed
    d, c = sim.dims, sim.consts
    clk = sim.clock0._replace(t=t)
    lat = PR.Lat(core=clk.lat_core, edge=clk.lat_edge)
    nbytes = departures_bytes(sim, fl, t, lat, base)
    saved = fabric.departures_operands(c, base)

    def restoring_dep(o, fn):
        def restore():
            for n in ("q_head", "q_size", "n_black"):
                getattr(o, n).copy_(getattr(saved, n))

        def both():
            restore()
            fn()
        return both, restore

    def timed_pair(fn, o, per_graph=50, iters=200):
        both, restore = restoring_dep(o, fn)
        return dict(ms=device_ms(both, per_graph) - device_ms(restore, per_graph),
                    call_ms=call_ms(both, iters) - call_ms(restore, iters),
                    restore_ms=device_ms(restore, per_graph))

    o_k = fabric.departures_operands(c, clone_tree(base))
    o_p = fabric.departures_operands(c, clone_tree(base))
    k = timed_pair(lambda: PK.departures_at(t, lat, fl, o_k), o_k)
    p = timed_pair(lambda: PR.departures_ref(t, lat, fl, o_p), o_p, per_graph=10, iters=50)
    rec = dict(shape=f"[{d.NQ}] ports of {d.CAP}, {d.NF} flows ({DEPARTURES_TIMED[0]} t={t})",
               max_abs_err=0.0, ms=k["ms"], call_ms=k["call_ms"], restore_ms=k["restore_ms"],
               plain_ms=p["ms"], plain_call_ms=p["call_ms"], library_ms=None, **bound(nbytes))
    # the standalone red_mark kernel on the same queue sizes, as phase 4b calls it
    q = base.q_size[:d.NQ]
    zeros = torch.zeros_like(q)
    kmin, kmax, salt = float(c.kmin), float(c.kmin + c.kspan), int(base.salt) + 0xECD
    rec["red_mark_ms"] = device_ms(lambda: RK.red_mark(q, zeros, cap=d.CAP, kmin=kmin,
                                                       kmax=kmax, tick=t, salt=salt))
    # the whole phase: the fused launch against the earlier design
    for way in ("kernel", "plain"):
        st = clone_tree(base)
        run = PO.get(way)
        on = one_lane(sim, t)
        both, restore = restoring_dep(
            fabric.departures_operands(c, st),
            lambda st=st, run=run, on=on: on(lambda cl, s, k: fabric.departures(
                d, cl, s, k, run=run, lat=lat, fl=fl), st))
        pre = "" if way == "kernel" else "plain_"
        rec[f"{pre}phase_ms"] = (device_ms(both, per_graph=10)
                                 - device_ms(restore, per_graph=10))
        rec[f"{pre}phase_launches"] = graph_launches(both) - graph_launches(restore)
        rec[f"{pre}phase_call_ms"] = call_ms(both, 100) - call_ms(restore, 100)
    log(f"[kernels] departures      {rec['shape']}: device time: fused kernel "
        f"{rec['ms'] * 1e3:.3f} us, plain {rec['plain_ms'] * 1e3:.3f} us, bound "
        f"{rec['bound_ms'] * 1e3:.4f} us ({nbytes} B); the red_mark kernel on the same "
        f"queue sizes {rec['red_mark_ms'] * 1e3:.3f} us; the whole phase (device): fused "
        f"{rec['phase_ms'] * 1e3:.2f} us in {rec['phase_launches']} launches, plain "
        f"departures {rec['plain_phase_ms'] * 1e3:.2f} us in "
        f"{rec['plain_phase_launches']} launches; a call with the host's work: kernel "
        f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_call_ms'] * 1e3:.1f} us, "
        f"phase fused {rec['phase_call_ms'] * 1e3:.1f} us, plain departures "
        f"{rec['plain_phase_call_ms'] * 1e3:.1f} us (each less the restore: "
        f"{rec['restore_ms'] * 1e3:.2f} us of device time)")
    return rec


# --------------------------------------------------------- 4. main path


def counters():
    from repro_torch.kernels.arrivals import kernel as AK
    from repro_torch.kernels.cc_update import kernel as CK
    from repro_torch.kernels.control import kernel as XK
    from repro_torch.kernels.departures import kernel as PK
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.kernels.red_mark import kernel as RK
    from repro_torch.kernels.ring_drain import kernel as DK
    from repro_torch.kernels.sends import kernel as SK
    return {"departures": PK.departures, "control": XK.control, "arrivals": AK.arrivals,
            "sends": SK.sends,
            "cc_update": CK.cc_update, "enqueue_rank": EK.enqueue_rank,
            "ring_drain": DK.ring_drain, "rr_pick": EK.rr_pick, "red_mark": RK.red_mark}


def run_path(name, device, backend, max_ticks=None, tag=None, **overrides):
    """Run a scenario (with config ``overrides``) on ``device`` one of the
    WAYS (``backend``: "kernel", "plain", "split-control", "split-arrivals",
    "split-sends" or "plain-departures"), to completion or ``max_ticks``;
    launch counts reset just before the run and read just after."""
    from repro_torch.netsim import scenarios
    from repro_torch.netsim.metrics import summarize
    sc = scenarios.scenario(name, **WAYS[backend], **overrides)
    sim = sc.build(device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    reset_counts()                               # just before the run
    t0 = time.perf_counter()
    st = sim.run(sc.max_ticks if max_ticks is None else max_ticks)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                                      # just after
    summ = summarize(sim, st)
    steps = sim.stats["steps"]
    log(f"[main] {tag or name:14s} {device:4s} {backend:14s}: {summ['ticks']} ticks "
        f"({steps} executed) in {wall:.3f} s = {summ['ticks'] / wall:.1f} ticks/s; "
        f"fct_max {summ['fct_max']} fct_mean {summ['fct_mean']} "
        f"trims {summ['trims']}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return sim, st, summ, launches, wall


# The CPU port's runs that phases 4 and 4c hold the card's states to: (tag,
# scenario, config overrides, ticks; None: to completion).  They run in a
# process of their own from the end of the build, beside the card's phases.
CPU_RUNS = tuple((name, name, {}, None) for name, _ in MAIN_RUNS) + tuple(
    (key, name, ov, cpu_prefix) for key, name, ov, _, _, cpu_prefix in COMPARISON_RUNS)
CPU_CHILD = """
import sys
sys.path.insert(0, ".")
import torch
torch.set_num_threads(2)
import chip_smoke
chip_smoke.cpu_runs(sys.argv[1])
"""


def cpu_runs(out):
    """Run CPU_RUNS through the CPU port (the plain versions) and save each
    run's final state (its leaves by name), wall time and ticks to ``out``."""
    res = {}
    for tag, name, ov, ticks in CPU_RUNS:
        _, st, summ, _, wall = run_path(name, "cpu", "kernel", max_ticks=ticks, tag=tag, **ov)
        res[tag] = dict(state=dict(leaves(st)), wall=wall, ticks=summ["ticks"])
    torch.save(res, out)


class CpuRuns:
    """CPU_RUNS in a child process (cpu_runs); ``get(tag)`` waits for it
    the first time and then returns that run's record."""

    def __init__(self, directory):
        self.path = Path(directory) / "cpu_runs.pt"
        self.child = subprocess.Popen([sys.executable, "-c", CPU_CHILD, str(self.path)],
                                      cwd=ROOT, stdout=subprocess.PIPE, text=True)
        self.started = time.perf_counter()
        self.runs = None

    def get(self, tag):
        if self.runs is None:
            t0 = time.perf_counter()
            out, _ = self.child.communicate(timeout=1200)
            for line in out.splitlines():
                log(f"[cpu] {line}")
            if self.child.returncode != 0:
                fail(f"the CPU port's runs exited {self.child.returncode}")
            self.runs = torch.load(self.path)
            log(f"[cpu] {len(self.runs)} CPU runs in their own process, done "
                f"{time.perf_counter() - self.started:.1f} s after it started "
                f"(waited {time.perf_counter() - t0:.1f} s)")
        return self.runs[tag]


def cpu_differ(st, cpu):
    """Leaves of ``st`` that differ from a CPU run's saved leaves."""
    return [n for n, a in leaves(st) if not bit_equal(a, cpu["state"][n])]


def way_kernels(on_path, way, sim):
    """The kernels a run of ``way`` launches where the fused path launches
    ``on_path`` (SPLIT_KERNELS; the split sends phase launches rr_pick only
    where a sender holds several flows)."""
    swap = SPLIT_KERNELS.get(way, {})
    out = tuple(k_ for k in on_path for k_ in swap.get(k, (k,)))
    if way == "split-sends" and sim.dims.FMAX == 1:
        out = tuple(k for k in out if k != "rr_pick")
    return out


def expect_launches(what, launches, on_path, steps):
    """Each kernel of ``on_path`` launched once an executed tick, every
    other kernel never."""
    want = {k: (steps if k in on_path else 0) for k in launches}
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want} over {steps} executed ticks")


def states_differ(a, b):
    return [n for (n, x), (_, y) in zip(leaves(a), leaves(b)) if not bit_equal(x, y)]


def quartiles(xs):
    q = np.percentile(np.asarray(xs, np.float64), [25, 50, 75])
    return dict(q1=float(q[0]), median=float(q[1]), q3=float(q[2]), n=len(xs))


def phase_main_path(finals, cpu):
    """The main path's runs (MAIN_RUNS) through the fused departures,
    arrivals, control and sends launches: launches, the JAX reference's
    summary, the final state against the runs through each split design,
    the plain departures, the plain versions on the card and the CPU
    (``cpu``: CpuRuns); then ticks/s in turns (TURN_WAYS) on TURN_RUNS.
    Each run's (sim, final state) goes into ``finals`` for phase 4d."""
    results = {}
    for name, on_path in MAIN_RUNS:
        sim, st_k, summ, launches, wall = run_path(name, "cuda", "kernel")
        steps = sim.stats["steps"]
        if not summ["all_done"]:
            fail(f"{name}: not every flow finished in {summ['ticks']} ticks")
        expect_launches(name, launches, on_path, steps)
        for key, val in REFERENCE[name].items():
            if summ[key] != val:
                fail(f"{name}: {key} = {summ[key]}, the JAX reference gives {val}")
        by_way = {"kernel": launches}
        walls = {"kernel": wall}
        others = []
        for way in ("split-control", "split-arrivals", "split-sends", "plain-departures"):
            _, st_w, _, by_way[way], walls[way] = run_path(name, "cuda", way)
            expect_launches(f"{name} {way}", by_way[way], way_kernels(on_path, way, sim),
                            steps)
            others.append((st_w, f"{way} on the card"))
        for other, label in others:
            bad = states_differ(st_k, other)
            if bad:
                fail(f"{name}: final state differs from the {label} run in {bad}")
        # the plain versions on the card over a prefix (the CPU run, the same
        # plain versions, goes the whole way)
        ticks = {w: summ["ticks"] for w in walls}
        ticks["plain"] = min(MAIN_PLAIN_TICKS, summ["ticks"])
        st_kp = st_k if ticks["plain"] == summ["ticks"] else run_path(
            name, "cuda", "kernel", max_ticks=ticks["plain"],
            tag=f"{name}[:{ticks['plain']}]")[1]
        _, st_p, _, by_way["plain"], walls["plain"] = run_path(
            name, "cuda", "plain", max_ticks=ticks["plain"])
        expect_launches(f"{name} plain", by_way["plain"], (), steps)
        bad = states_differ(st_kp, st_p)
        if bad:
            fail(f"{name}: state at tick {ticks['plain']} differs from the plain on the card "
                 f"run in {bad}")
        for n, a in leaves(st_k):
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{name}: non-finite values in {n}")
        log(f"[main] {name}: final state bit-equal to the split-control, split-arrivals, "
            f"split-sends and plain-departures runs, and to the plain-on-card run over "
            f"its first {ticks['plain']} ticks ({len(list(leaves(st_k)))} leaves); "
            f"summary equals the JAX reference")
        results[name] = dict(launches=launches, launches_by_way=by_way, steps=steps,
                             ticks=summ["ticks"], wall=wall, walls=walls,
                             ticks_by_way=ticks,
                             turns={w: [summ["ticks"] / walls[w]] for w in TURN_WAYS})
        finals[name] = (sim, st_k)
    for name in TURN_RUNS:
        r = results[name]
        for _ in range(TURNS - 1):
            for way in TURN_WAYS:
                _, _, summ, _, w = run_path(name, "cuda", way, tag=f"{name} turn")
                r["turns"][way].append(summ["ticks"] / w)
        r["ticks_per_s"] = {way: quartiles(v) for way, v in r["turns"].items()}
        log(f"[main] {name} ticks/s in turns ({TURNS} a way; q1 / median / q3): " + ", ".join(
            f"{way} {q['q1']:.2f} / {q['median']:.2f} / {q['q3']:.2f}"
            for way, q in r["ticks_per_s"].items()))
    # the CPU port's runs last: their process runs beside this phase
    for name, r in results.items():
        on_cpu = cpu.get(name)
        r["walls"]["cpu"], r["ticks_by_way"]["cpu"] = on_cpu["wall"], on_cpu["ticks"]
        bad = cpu_differ(finals[name][1], on_cpu)
        if bad:
            fail(f"{name}: final state differs from the CPU run in {bad}")
        log(f"[main] {name}: final state bit-equal to the CPU port's")
    return results


# ------------------------------------------------------- 4b. red_mark


def phase_red_mark(dev):
    """perm_1024n_3t's first RED_MARK_TICKS ticks on the card, phase by
    phase, with the red_mark kernel beside each tick's departures and
    arrivals: its mark must equal the flip departures applies
    (``fabric.red_marks`` on the active queues), its admitted counts the
    packets arrivals enqueues into each queue, its trims the tick's trims.
    Counts reset just before the drive and read just after."""
    from repro_torch.kernels.red_mark.ops import red_mark_op
    from repro_torch.netsim import fabric, scenarios
    sc = scenarios.scenario("perm_1024n_3t")
    sim = sc.build(device=dev)
    d, c = sim.dims, sim.consts
    NQ, L = d.NQ, d.L
    kmax = c.kmin + c.kspan
    if float(c.kspan) != max(float(kmax) - float(c.kmin), 1e-6):
        fail("red_mark: kspan differs from the kernel's max(kmax - kmin, 1e-6)")
    st = sim.init()
    marked = trimmed = 0
    torch.cuda.synchronize()
    reset_counts()                                           # just before
    t0 = time.perf_counter()
    for t in range(RED_MARK_TICKS):
        clk = sim.clock0._replace(t=t)
        for name, phase in sim.phases:
            if name == "departures":
                # the flip and the kernel read q_size before the departures
                # phase (which updates it in place) is launched: the compare
                # below waits for both
                q = st.q_size[:NQ]
                flip = fabric.red_marks(d, c, st, t) & (q > 0)
                mark, _, _ = red_mark_op(q, torch.zeros_like(q), cap=d.CAP, kmin=c.kmin,
                                         kmax=kmax, tick=t, salt=0xECD + st.salt)
                if not torch.equal(mark, flip):
                    fail(f"red_mark: marks differ from departures' flip at tick {t} "
                         f"({int((mark != flip).sum())} queues)")
                marked += int(mark.sum())
            if name == "arrivals":
                # this tick's enqueue attempts per queue, after departures
                earr = st.infl[t % L][c.enq_ids]
                dq = earr[:, 1][(earr[:, 0] == 1) & (earr[:, 1] >= 0)]
                arr_q = torch.bincount(dq.long(), minlength=NQ)[:NQ].to(torch.int32)
                q1, n_trim = st.q_size[:NQ].clone(), int(st.m.n_trim)
                _, admit, trim = red_mark_op(q1, arr_q, cap=d.CAP, kmin=c.kmin, kmax=kmax,
                                             tick=t, salt=0xECD + st.salt)
            st = phase(c, st, clk)
            if name == "arrivals":
                if not torch.equal(admit, st.q_size[:NQ] - q1) or \
                        int(trim.sum()) != int(st.m.n_trim) - n_trim:
                    fail(f"red_mark: admitted / trimmed counts differ from the "
                         f"arrivals phase at tick {t}")
                trimmed += int(trim.sum())
        st = st._replace(now=st.now + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["red_mark"]                     # just after
    if launches != 2 * RED_MARK_TICKS or not marked or not trimmed:
        fail(f"red_mark: {launches} launches, {marked} marks, {trimmed} trims "
             f"over {RED_MARK_TICKS} ticks")
    log(f"[red_mark] perm_1024n_3t ticks 0-{RED_MARK_TICKS - 1} on the card: the "
        f"kernel's marks equal departures' flip on every queue of every tick "
        f"({marked} marks), its admitted and trimmed counts equal the arrivals "
        f"phase's ({trimmed} trims); {launches} launches; {wall:.2f} s")
    return dict(launches=launches, marks=marked, trims=trimmed, wall=wall)


# ----------------------------------------------------- 4c. comparison runs


def phase_comparison(smartt_ticks_per_s, finals, cpu):
    """The paper's comparison paths (COMPARISON_RUNS), each whole through
    the kernels on the card (the control phase through the fused launch),
    held to the JAX reference's summary and, over the stated prefixes, to
    the plain-on-card run and the CPU port (``cpu``: CpuRuns).  Each run's
    (sim, final state) goes into ``finals`` for phase 4d."""
    results = {}
    for key, name, ov, on_path, prefix, cpu_prefix in COMPARISON_RUNS:
        sim, st_k, summ, launches, wall = run_path(name, "cuda", "kernel", tag=key, **ov)
        steps = sim.stats["steps"]
        expect_launches(key, launches, on_path, steps)
        ref = REFERENCE[key]
        if "cct" in ref:
            fin = torch.as_tensor(sim.wl.t_start, dtype=torch.int64) + \
                torch.from_numpy(summ["fct_ticks"]).long()
            summ["cct"] = int(fin.max()) - int(sim.wl.t_start.min())
        for k, v in ref.items():
            if summ[k] != v:
                fail(f"{key}: {k} = {summ[k]}, the JAX reference gives {v}")
        for n, a in leaves(st_k):
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{key}: non-finite values in {n}")
        if sim.dims.credit_based:
            # the port stages a flow's rejected bytes in integers before one
            # f32 add to trim_seen; the reference adds each packet in f32,
            # and the two agree only below 2**24
            from repro_torch.netsim.api import TRIM_SEEN_LIMIT
            worst = float(st_k.trim_seen.max())
            if worst >= TRIM_SEEN_LIMIT:
                fail(f"{key}: trim_seen reached {worst:.0f} >= 2**24")
            log(f"[compare] {key}: the largest trim_seen is {worst:.0f} bytes, "
                f"below 2**24 = {TRIM_SEEN_LIMIT}")
        # the same run through the plain versions on the card, and the CPU
        # port, each against a kernel run to the same tick
        kern = {None: st_k}
        for p in {prefix, cpu_prefix}:
            if p not in kern:
                kern[p] = run_path(name, "cuda", "kernel", max_ticks=p,
                                   tag=f"{key}[:{p}]", **ov)[1]
        _, st_p, summ_p, launches_p, wall_p = run_path(
            name, "cuda", "plain", max_ticks=prefix, tag=key, **ov)
        if any(launches_p.values()):
            fail(f"{key}: the plain backend launched kernels {launches_p}")
        bad = states_differ(kern[prefix], st_p)
        if bad:
            fail(f"{key}: state at tick {int(st_p.now)} differs from the plain on the card "
                 f"run in {bad}")
        on_cpu = cpu.get(key)
        wall_c = on_cpu["wall"]
        bad = cpu_differ(kern[cpu_prefix], on_cpu)
        if bad:
            fail(f"{key}: state at tick {int(on_cpu['state']['now'])} differs from the CPU "
                 f"run in {bad}")
        plain_ticks = summ_p["ticks"]
        rate = summ["ticks"] / wall
        log(f"[compare] {key}: summary equals the JAX reference; final state "
            f"bit-equal to the plain-on-card run ({'whole' if prefix is None else f'first {prefix} ticks'}) "
            f"and the CPU port (first {cpu_prefix} ticks); {rate:.1f} ticks/s through "
            f"the kernels (SMaRTT perm_1024n_3t {smartt_ticks_per_s:.1f}), plain "
            f"{plain_ticks / wall_p:.1f}; launches {launches}")
        finals[key] = (sim, st_k)
        results[key] = dict(launches=launches, steps=steps, ticks=summ["ticks"],
                            wall=wall, ticks_per_s=rate,
                            plain_ticks=plain_ticks, plain_ticks_per_s=plain_ticks / wall_p,
                            cpu_ticks=cpu_prefix, cpu_ticks_per_s=cpu_prefix / wall_c,
                            blackholed=summ["blackholed"],
                            delivered_bytes_fault=summ["delivered_bytes_fault"])
    return results


# ---------------------------------------------------- 4d. experiment API


def row_of(res):
    """A RunResult's row without its wall time (the pinned rows' keys)."""
    return {k: v for k, v in res.row().items() if k != "wall_s"}


def api_launches(what, on_path=SMARTT_TICK):
    """Launches since the last reset: each kernel of ``on_path`` the same
    number of times (one an executed tick), every other kernel never."""
    launches = read_counts()
    steps = launches[on_path[0]]
    if not steps:
        fail(f"{what}: no kernel of the path launched ({launches})")
    expect_launches(what, launches, on_path, steps)
    return steps


def phase_api(paths, finals):
    """The experiment API at full width on the card: ``api.run`` of
    API_RUNS (each row equal to its pinned row, its launches to phase 4's
    executed ticks, its ``wall_s`` beside the whole call's wall);
    ``RunResult`` rows from phase 4's and 4c's final states (``finals``,
    no re-run) equal to their pinned rows; the STUDY_SCENARIO study (every
    lane's row and final state equal to the standalone ``api.run`` of its
    point and seed, the base-config seed-0 lane's row to its pinned row,
    lanes a second); ``Sim.run_trace`` over TRACE_TICKS ticks, the card's
    outputs and final state equal to the CPU port's bit for bit."""
    from repro_torch.netsim import api, cache, scenarios
    rec = {"runs": {}, "from_state": {}}
    for name in API_RUNS:
        torch.cuda.synchronize()
        reset_counts()                                           # just before
        t0 = time.perf_counter()
        res = api.run(name)
        call = time.perf_counter() - t0
        steps = api_launches(f"api.run {name}")                  # just after
        if steps != paths[name]["steps"]:
            fail(f"api.run {name}: {steps} executed ticks, phase 4's run {paths[name]['steps']}")
        if row_of(res) != REFERENCE_ROWS[name]:
            fail(f"api.run {name}: row {row_of(res)}, the JAX reference gives "
                 f"{REFERENCE_ROWS[name]}")
        rec["runs"][name] = dict(ticks=res.ticks, executed=steps, wall_s=res.wall_s,
                                 call_s=call, sim_run_wall_phase4=paths[name]["wall"])
        log(f"[api] api.run({name!r}) on the card: row equals the JAX reference's; "
            f"{steps} launches of each fused kernel = the executed ticks; wall_s "
            f"(Sim.run) {res.wall_s:.4f} s, the whole call {call:.4f} s (build, run, "
            f"RunResult), phase 4's Sim.run {paths[name]['wall']:.4f} s")
    # RunResult from phases 4's and 4c's final states, no re-run
    for key, (sim, st) in finals.items():
        name = key.split("/")[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.RunResult.from_state(sim, st, scenario=name,
                                       max_ticks=scenarios.scenario(name).max_ticks)
        rec["from_state"][key] = time.perf_counter() - t0
        if row_of(res) != REFERENCE_ROWS[key]:
            fail(f"RunResult {key}: row {row_of(res)}, the JAX reference gives "
                 f"{REFERENCE_ROWS[key]}")
    log(f"[api] RunResult rows of the {len(finals)} phase 4 and 4c runs equal the JAX "
        f"reference's (fault rows with ttr_max and dip_*, allreduce with cct); "
        f"from_state (one host copy of the state + numpy) " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in rec["from_state"].items()))
    # the study, lane by lane, against standalone api.run of each lane
    plan = api.study(STUDY_SCENARIO, points=STUDY_POINTS, seeds=STUDY_SEEDS)
    torch.cuda.synchronize()
    reset_counts()                                               # just before
    res = plan.run()
    study_steps = api_launches(f"study {STUDY_SCENARIO}")        # just after
    lane_steps = list(plan.sim.stats["lanes"]["steps"])
    batch_ticks = plan.sim.stats["lanes"]["batch_ticks"]
    walls = []
    for pi, pt in enumerate(STUDY_POINTS):
        for si, seed in enumerate(STUDY_SEEDS):
            reset_counts()
            one = api.run(STUDY_SCENARIO, seed=seed, **pt)
            steps = api_launches(f"api.run {STUDY_SCENARIO} {pt} s{seed}")
            if lane_steps[pi * len(STUDY_SEEDS) + si] != steps:
                fail(f"study lane {pi * len(STUDY_SEEDS) + si}: "
                     f"{lane_steps[pi * len(STUDY_SEEDS) + si]} executed ticks, the "
                     f"standalone run {steps}")
            walls.append(one.wall_s)
            lane = res.lane(pi, si)
            skip = ("name", "point")
            if {k: v for k, v in row_of(lane).items() if k not in skip} != \
                    {k: v for k, v in row_of(one).items() if k not in skip}:
                fail(f"study lane {lane.name}: row differs from the standalone api.run")
            if cache.state_digest(lane.state) != cache.state_digest(one.state):
                fail(f"study lane {lane.name}: final state differs from the standalone run")
            if pt == {"start_cwnd_mult": 1.25} and seed == 0:
                want = dict(REFERENCE_ROWS[STUDY_SCENARIO],
                            name=f"{STUDY_SCENARIO}/smartt+reps[start_cwnd_mult=1.25]/s0",
                            point={"start_cwnd_mult": 1.25})
                if row_of(lane) != want:
                    fail(f"study lane {lane.name}: row {row_of(lane)}, pinned {want}")
    if study_steps != batch_ticks:
        fail(f"study: {study_steps} launches of each fused kernel, the lane loop's "
             f"batched ticks {batch_ticks}")
    rate = plan.n_lanes / res.wall_s
    rec["study"] = dict(lanes=plan.n_lanes, wall_s=res.wall_s, lanes_per_s=rate,
                        executed=study_steps, lane_steps=lane_steps,
                        standalone_wall_s=walls)
    log(f"[api] study {STUDY_SCENARIO} {len(STUDY_POINTS)} points x {len(STUDY_SEEDS)} "
        f"seeds through the lane loop: every lane's row and final state equal the "
        f"standalone api.run's, the base lane's row the JAX reference's; {plan.n_lanes} "
        f"lanes in {res.wall_s:.3f} s = {rate:.3f} lanes/s (standalone Sim.run walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s); {study_steps} launches of each fused "
        f"kernel = the batched ticks; each lane's executed ticks {lane_steps} = its "
        f"standalone run's")
    # Sim.run_trace on the card against the CPU port
    sc = scenarios.scenario(STUDY_SCENARIO)
    sim = sc.build(device="cuda")
    torch.cuda.synchronize()
    reset_counts()                                               # just before
    t0 = time.perf_counter()
    st_g, ys_g = sim.run_trace(TRACE_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = api_launches(f"run_trace {STUDY_SCENARIO}")          # just after
    if steps != TRACE_TICKS:
        fail(f"run_trace: {steps} launches of each fused kernel over {TRACE_TICKS} ticks")
    cpu = sc.build(device="cpu")
    t0 = time.perf_counter()
    st_c, ys_c = cpu.run_trace(TRACE_TICKS)
    wall_c = time.perf_counter() - t0
    for k, v in ys_g.items():
        if v.shape[0] != TRACE_TICKS or not bit_equal(v, ys_c[k]):
            fail(f"run_trace: {k} differs from the CPU port's trace")
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"run_trace: non-finite values in {k}")
    bad = states_differ(st_g, st_c)
    if bad:
        fail(f"run_trace: final state differs from the CPU port's in {bad}")
    rec["trace"] = dict(ticks=TRACE_TICKS, wall_s=wall, cpu_wall_s=wall_c,
                        ticks_per_s=TRACE_TICKS / wall)
    log(f"[api] run_trace({STUDY_SCENARIO}, {TRACE_TICKS}) on the card: outputs "
        f"{ {k: tuple(v.shape) for k, v in ys_g.items()} } and final state bit-equal to "
        f"the CPU port's; {TRACE_TICKS / wall:.1f} ticks/s (CPU {TRACE_TICKS / wall_c:.1f})")
    return rec


# ------------------------------------------------ 4e. lanes on the card


def standalone(name, pt, seed, **ov):
    """``api.run`` of one lane's (point, seed): the scenario under the
    config the study gives that point."""
    from repro_torch.netsim import api, scenarios
    sc = scenarios.scenario(name, **ov)
    return api.run(dataclasses.replace(sc, cfg=api.apply_point(sc.cfg, pt)), seed=seed)


def lane_study(what, name, points, seeds, on_path, pin=None, **ov):
    """A study through the lane loop (counts set to 0 just before, read just
    after): launches of each kernel of ``on_path`` = the batched ticks, every
    lane's row and final state equal to the standalone ``api.run`` of its
    (point, seed), its executed ticks to that run's; ``pin``: (point, the
    JAX reference's row of its seed-0 lane).  Returns the plan, a record and
    the study's result."""
    from repro_torch.netsim import api, cache
    plan = api.study(name, points=points, seeds=seeds, **ov)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                               # just before
    res = plan.run()
    launches = read_counts()                                     # just after
    peak = torch.cuda.max_memory_allocated()
    lanes = dict(plan.sim.stats["lanes"])
    expect_launches(what, launches, on_path, lanes["batch_ticks"])
    for lane in range(plan.n_lanes):
        pt, seed = plan.lane_point_seed(lane)
        reset_counts()
        one = standalone(name, dict(pt), seed, **ov)
        steps = api_launches(f"{what} lane {lane} standalone", on_path)
        got = res[lane]
        if lanes["steps"][lane] != steps:
            fail(f"{what} lane {got.name}: {lanes['steps'][lane]} executed ticks, the "
                 f"standalone run {steps}")
        skip = ("name", "point")
        if {k: v for k, v in row_of(got).items() if k not in skip} != \
                {k: v for k, v in row_of(one).items() if k not in skip}:
            fail(f"{what} lane {got.name}: row differs from the standalone api.run")
        if cache.state_digest(got.state) != cache.state_digest(one.state):
            fail(f"{what} lane {got.name}: final state differs from the standalone run")
    if pin is not None:
        pt, want = pin
        got = res.lane(plan.points.index(api._norm_point(pt)), 0)
        want = dict(want, name=got.name, point=dict(api._norm_point(pt)))
        if row_of(got) != want:
            fail(f"{what} lane {got.name}: row {row_of(got)}, the JAX reference's {want}")
    rec = dict(lanes=plan.n_lanes, wall_s=res.wall_s, batch_ticks=lanes["batch_ticks"],
               lane_steps=lanes["steps"], lane_ticks=lanes["ticks"],
               launches_per_batch_tick={k: launches[k] / lanes["batch_ticks"]
                                        for k in on_path},
               mem_before_bytes=base_mem, max_memory_allocated_bytes=peak)
    log(f"[lanes] {what}: {plan.n_lanes} lanes through the lane loop, every lane's row "
        f"and final state equal to its standalone api.run's" +
        (", the base point's seed-0 row the JAX reference's" if pin else "") +
        f"; {lanes['batch_ticks']} batched ticks, launches a batched tick "
        f"{rec['launches_per_batch_tick']}; each lane's executed ticks {lanes['steps']} = "
        f"its standalone run's; wall {res.wall_s:.3f} s")
    return plan, rec, res


def lanes_timing(plans):
    """Lanes a second, in turns (median of LANE_TURNS): each study through the
    lane loop (``run_states``) and its lanes one after another on pre-built
    simulators (``Sim.run`` and the host copy, the earlier executor)."""
    from repro_torch.netsim import api, engine, state
    sims = {label: [engine.build(api.apply_point(plan.scenario.cfg, dict(pt)),
                                 plan.scenario.wl, device="cuda") for pt in plan.points]
            for label, plan in plans.items()}
    walls = {label: {"lanes": [], "alone": []} for label in plans}
    for _ in range(LANE_TURNS):
        for label, plan in plans.items():
            mt = plan._max_ticks(None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.run_states(mt)
            torch.cuda.synchronize()
            walls[label]["lanes"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for lane in range(plan.n_lanes):
                sim = sims[label][lane // plan.n_seeds]
                state.to_numpy(sim.run(mt, seed=plan.salts[lane]))
            torch.cuda.synchronize()
            walls[label]["alone"].append(time.perf_counter() - t0)
    out = {}
    for label, plan in plans.items():
        med = {k: float(np.median(v)) for k, v in walls[label].items()}
        out[label] = dict(lanes=plan.n_lanes, walls=walls[label], median_s=med,
                          lanes_per_s=plan.n_lanes / med["lanes"],
                          alone_lanes_per_s=plan.n_lanes / med["alone"])
        log(f"[lanes] {label}: {out[label]['lanes_per_s']:.3f} lanes/s through the lane "
            f"loop, {out[label]['alone_lanes_per_s']:.3f} lanes/s one after another "
            f"(median of {LANE_TURNS} turns: {med['lanes']:.3f} s against "
            f"{med['alone']:.3f} s for {plan.n_lanes} lanes)")
    return out


def lanes_profile(plan):
    """The lane loop of ``plan``'s batch under torch.profiler for
    LANE_PROFILE_TICKS batched ticks (after 20 warm ones): the device's busy
    and idle share of a batched tick."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import shard
    st = plan.init()
    cb, ax = plan.consts_b, plan.axes
    st = shard._run_lanes(plan.sim, cb, ax, st, 20)              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = shard._run_lanes(plan.sim, cb, ax, st, 20 + LANE_PROFILE_TICKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = plan.sim.stats["lanes"]["batch_ticks"]
    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6
    rec = dict(batch_ticks=ticks, lanes=plan.n_lanes, wall_ms_per_tick=wall / ticks * 1e3,
               device_busy_ms_per_tick=busy / ticks * 1e3,
               idle_share=1 - busy / wall if busy else None,
               kernels_per_tick=sum(e.count for e in events) / ticks)
    if not busy:
        log("[lanes] torch.profiler recorded no device time: idle share not measured")
    else:
        log(f"[lanes] a batched tick of {plan.n_lanes} lanes under torch.profiler "
            f"({ticks} ticks): wall {rec['wall_ms_per_tick']:.3f} ms, device busy "
            f"{rec['device_busy_ms_per_tick']:.4f} ms ({100 * busy / wall:.2f}% busy, "
            f"{100 * rec['idle_share']:.2f}% idle), {rec['kernels_per_tick']:.1f} device "
            f"kernels a tick")
    return rec


def lanes_kernel_checks():
    """The four fused kernels against their batched plain versions on the
    card, on one ``[4, ...]`` tick state of perm_1024n_3t: four lanes under
    their own constants (CHECK_POINTS), each driven to its own tick
    (CHECK_TICKS), the last not live; CHECK_STEPS batched ticks, each phase
    on two clones of the state, bit for bit, the idle lane left as it was."""
    from repro_torch.kernels.arrivals import kernel as AK, ref as AR
    from repro_torch.kernels.control import kernel as XK, ref as XR
    from repro_torch.kernels.departures import kernel as PK, ref as PR
    from repro_torch.kernels.lanes import Tick
    from repro_torch.kernels.sends import kernel as SK, ref as SR
    from repro_torch.netsim import api, fabric, sender, shard, state, transport
    plan = api.study(STUDY_SCENARIO, points=CHECK_POINTS, seeds=(0,))
    sim, n = plan.sim, plan.n_lanes
    d, clk = sim.dims, sim.clock0
    parts = [shard._run_lanes(sim, plan._consts_subset([i]), plan.axes, plan.init([i]), t)
             for i, t in enumerate(CHECK_TICKS)]
    st = state.tree_map(lambda *xs: torch.cat(xs), *parts)
    c = sim.lanes_of(plan.consts_b, n, plan.axes)
    lat = PR.Lat(core=clk.lat_core, edge=clk.lat_edge)
    dfl, afl = fabric.departures_flags(d), fabric.flags(d, sim.consts, clk)
    cfl, sfl = transport.flags(sim.cfg, d), sender.flags(d)
    live_h = tuple(i < n - 1 for i in range(n))
    live = torch.tensor(live_h, device="cuda")
    now_h = tuple(CHECK_TICKS)
    if st.now.tolist() != list(now_h):
        fail(f"lanes check: ticks {st.now.tolist()}, expected {now_h}")
    phases = dict(sim.lane_phases)
    seen = dict(emits=0, deliveries=0, acks=0)

    def pair(what, kernel, plain, make, k):
        a, b = clone_tree(st), clone_tree(st)
        out_k = kernel(k, make(a))
        out_p = plain(k, make(b))
        bad = states_differ(a, b)
        if bad:
            fail(f"lanes check {what} (ticks {k.now_h}): the kernel differs from its "
                 f"batched plain version in {bad}")
        idle = states_differ(state.lane(a, n - 1), state.lane(st, n - 1))
        if idle:
            fail(f"lanes check {what}: the kernel wrote the lane that is not live ({idle})")
        return a, out_k, out_p

    for step in range(CHECK_STEPS):
        k = Tick(st.now, live, now_h, live_h)
        a, _, _ = pair("departures", lambda k, o: PK.departures(k, lat, dfl, o),
                       lambda k, o: PR.departures_lanes_ref(k, lat, dfl, o),
                       lambda s: fabric.departures_operands(c.l, s), k)
        seen["emits"] += int((a.q_size != st.q_size).sum())
        st = phases["departures"](c, st, k)
        a, _, _ = pair("arrivals",
                       lambda k, o: AK.arrivals(k, clk.trim_delay, afl, o, c.l.goodput_bin),
                       lambda k, o: AR.arrivals_lanes_ref(k, clk.trim_delay, afl, o,
                                                          c.l.goodput_bin),
                       lambda s: fabric.operands(c.l, s, None), k)
        seen["deliveries"] += int((a.m.delivered_pkts - st.m.delivered_pkts).sum())
        st = phases["arrivals"](c, st, k)
        _, ev_k, ev_p = pair("control", lambda k, o: XK.control(k, cfl, o),
                             lambda k, o: XR.control_lanes_ref(k, cfl, o),
                             lambda s: transport.operands(c.l, s), k)
        for f in ev_k._fields:
            if not bit_equal(getattr(ev_k, f)[:n - 1], getattr(ev_p, f)[:n - 1]):
                fail(f"lanes check control: event field {f} differs")
        seen["acks"] += int(ev_k.has_ack[:n - 1].sum())
        for p in ("control", "grants"):
            st = phases[p](c, st, k)
        pair("sends", lambda k, o: SK.sends(k, clk.lat_send, sfl, o),
             lambda k, o: SR.sends_lanes_ref(k, clk.lat_send, sfl, o),
             lambda s: sender.operands(c.l, s), k)
        for p in ("sends", "metrics"):
            st = phases[p](c, st, k)
        st = st._replace(now=st.now + live)
        now_h = tuple(t + g for t, g in zip(now_h, live_h))
    if not all(seen.values()):
        fail(f"lanes check: the checked ticks miss a kind of work {seen}")
    log(f"[lanes] departures, arrivals, control and sends kernels on a [{n}, ...] batch of "
        f"perm_1024n_3t (lanes at ticks {CHECK_TICKS}, the last not live, swept "
        f"{[dict(p) for p in plan.points]}), {CHECK_STEPS} batched ticks: bit-equal to "
        f"their batched plain versions, the idle lane untouched {seen}")
    return dict(lanes=n, ticks=CHECK_TICKS, steps=CHECK_STEPS, max_abs_err=0.0, work=seen)


def phase_lanes(checked):
    """Lanes on the card at the paper's scale (the batched kernels against
    their batched plain versions, ``checked``, ran with the kernels'
    checks): the 16-lane perm_1024n_3t study and the
    4-lane eqds study against their standalone runs; lanes a second through
    the lane loop and one after another, in turns; the idle share of a
    batched tick; the 16-lane study's peak device memory.  Returns the
    record, the 16-lane plan and its final states (phase 4g's gate)."""
    rec = {"kernels": checked}
    plan16, rec["study16"], res16 = lane_study(
        f"study {STUDY_SCENARIO} x16", STUDY_SCENARIO, LANES_POINTS, LANES_SEEDS,
        SMARTT_TICK, pin=(LANES_BASE, REFERENCE_ROWS[STUDY_SCENARIO]))
    log(f"[lanes] torch.cuda.max_memory_allocated() of the 16-lane study: "
        f"{rec['study16']['max_memory_allocated_bytes']} bytes "
        f"({rec['study16']['mem_before_bytes']} allocated before it)")
    _, rec["eqds4"], _ = lane_study(f"study {STUDY_SCENARIO} eqds x4", STUDY_SCENARIO,
                                 EQDS_POINTS, STUDY_SEEDS, TICK + ("rr_pick",), algo="eqds")
    from repro_torch.netsim import api
    plan4 = api.study(STUDY_SCENARIO, points=STUDY_POINTS, seeds=STUDY_SEEDS)
    rec["timing"] = lanes_timing({"study4": plan4, "study16": plan16})
    rec["profile"] = lanes_profile(plan16)
    return rec, plan16, res16.states


def mesh_run(what, plan, mesh, want, want_steps):
    """``plan.run_states(mesh=)`` (counts set to 0 just before, read just
    after): every lane's final state bit-equal to ``want`` (the one-device
    batch's), each lane's executed ticks to ``want_steps``, each fused
    kernel launched once a batched tick of each shard (their sum).
    Returns the lane counts and the run's wall time."""
    from repro_torch.netsim import state
    torch.cuda.synchronize()
    reset_counts()                                               # just before
    t0 = time.perf_counter()
    got = plan.run_states(mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                                     # just after
    lanes = dict(plan.sim.stats["lanes"])
    if sum(lanes["shard_ticks"]) != lanes["batch_ticks"] or \
            len(lanes["shard_ticks"]) != len(mesh):
        fail(f"{what}: shard ticks {lanes['shard_ticks']}, batched ticks "
             f"{lanes['batch_ticks']}, mesh of {len(mesh)}")
    expect_launches(what, launches, SMARTT_TICK, lanes["batch_ticks"])
    if lanes["steps"] != want_steps:
        fail(f"{what}: lanes' executed ticks {lanes['steps']}, the one-device batch's "
             f"{want_steps}")
    bad = [i for i, (a, b) in enumerate(zip(state.tree_leaves(got), state.tree_leaves(want)))
           if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes()]
    if bad or len(state.tree_leaves(got)) != len(state.tree_leaves(want)):
        fail(f"{what}: final state differs from the one-device batch in leaves {bad}")
    return lanes, wall


def phase_mesh(plan, want, lanes16):
    """Phase 4g: phase 4e's 16-lane study over meshes of the card repeated
    (MESH_SIZES: [cuda:0] * 2 and * 3, the second padding 16 lanes to 18),
    one lane loop a shard on a thread and stream of its own; every lane's
    final state bit-equal to 4e's one-device batch, launches equal to the
    sum of the shards' batched ticks (checked on the first turn); lanes a
    second, median of MESH_TURNS in turns with the one-device batch; the
    same over distinct cards where there are two or more."""
    dev = torch.device("cuda", torch.cuda.current_device())
    meshes = {f"[{dev}] * {k}": [dev] * k for k in MESH_SIZES}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshes[f"{n_cards} cards"] = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        log(f"[mesh] only one card ({n_cards}): lanes over distinct cards not run")
    rec = {"one_card_repeated": n_cards < 2}
    walls = {label: [] for label in ("one device", *meshes)}
    for turn in range(MESH_TURNS):
        for label in walls:
            mesh = meshes.get(label)
            if turn or mesh is None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.run_states(mesh=mesh)
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
                continue
            lanes, wall = mesh_run(f"mesh {label}", plan, mesh, want, lanes16["lane_steps"])
            walls[label].append(wall)
            rec[label] = dict(shard_ticks=lanes["shard_ticks"],
                              batch_ticks=lanes["batch_ticks"], lanes=plan.n_lanes,
                              padded=-plan.n_lanes % len(mesh))
            log(f"[mesh] {STUDY_SCENARIO} x{plan.n_lanes} over {label}: every lane's final "
                f"state bit-equal to phase 4e's one-device batch, each lane's executed "
                f"ticks too; shards' batched ticks {lanes['shard_ticks']} (one-device "
                f"batch {lanes16['batch_ticks']}), each fused kernel launched their sum "
                f"{lanes['batch_ticks']} times; {rec[label]['padded']} pad lanes")
    rate = {label: plan.n_lanes / float(np.median(w)) for label, w in walls.items()}
    for label, w in walls.items():
        rec.setdefault(label, {}).update(walls=w, lanes_per_s=rate[label])
    log(f"[mesh] lanes a second, median of {MESH_TURNS} in turns: " + ", ".join(
        f"{label} {r:.3f}" for label, r in rate.items()))
    return rec


# ------------------------------------------- 3b. kernels of the serving path

# (b, hq, hkv, sq, sk, d, causal, window, dtype); the first is timed:
# qwen3-0.6b's prefill at B=4, S=512 (GQA 16/8, head_dim 128, bf16).
# bf16 goes to the tensor-core kernel (flash_attn_tc.cu), f32 to the SIMT
# kernel (flash_attn.cu); every masking and ragged case runs in both.
FLASH_CASES = (
    (4, 16, 8, 512, 512, 128, True, 0, torch.bfloat16),
    (2, 16, 8, 300, 300, 128, True, 0, torch.bfloat16),    # ragged prompt
    (1, 2, 1, 100, 300, 64, True, 0, torch.bfloat16),       # Sq != Sk
    (1, 2, 2, 130, 70, 32, True, 0, torch.bfloat16),        # rows with no key
    (2, 4, 2, 1, 77, 16, True, 0, torch.bfloat16),          # one query row
    (1, 2, 1, 300, 300, 64, True, 50, torch.bfloat16),      # sliding window
    (1, 2, 2, 90, 200, 48, False, 40, torch.bfloat16),
    (2, 4, 2, 200, 200, 96, True, 0, torch.bfloat16),       # D = 96, padded to 128
    (4, 16, 8, 512, 512, 128, True, 0, torch.float32),
    (1, 2, 1, 100, 300, 64, True, 0, torch.float32),        # Sq != Sk
    (1, 2, 2, 130, 70, 32, True, 0, torch.float32),         # rows with no key
    (2, 4, 2, 1, 77, 16, True, 0, torch.float32),           # one query row
    (1, 2, 1, 300, 300, 64, True, 50, torch.float32),       # sliding window
    (1, 2, 2, 90, 200, 48, False, 40, torch.float32),
)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the tensor-core kernel's bf16-score variant (cfg.attn_bf16) against the
# plain version's bf16 scores, on every bf16 row of FLASH_CASES and DV_CASES
FLASH_BF16S_TOL = 2e-2
# flash_attention with a value head dim of its own, and cross-attention's
# non-causal Sk != Sq: (b, hq, hkv, sq, sk, d, dv, causal, dtype).  The
# first two are timed: MLA at minicpm3-4b's full width (q/k 96 = 64 nope +
# 32 rope, v 64, v read as the model reads it, a slice of the expanded
# [B, S, H, 128] latents) and cross-attention at llama-3.2-vision-90b's
# (64 query heads onto 8 kv heads of the 4096-row patch feed).
DV_CASES = (
    (4, 40, 40, 512, 512, 96, 64, True, torch.bfloat16),
    (4, 64, 8, 512, 4096, 128, 128, False, torch.bfloat16),
    (2, 5, 5, 37, 37, 24, 16, True, torch.bfloat16),        # reduced minicpm3-4b
    (1, 4, 2, 70, 130, 64, 32, False, torch.bfloat16),
    (1, 2, 1, 100, 300, 48, 24, True, torch.float32),       # ragged, the SIMT kernel
    (2, 5, 5, 37, 37, 24, 16, True, torch.float32),
    (2, 4, 2, 90, 333, 32, 8, False, torch.float32),
)
DV_TIMED = {"mla": DV_CASES[0], "cross": DV_CASES[1]}
# (BH, BG, L, P, N, chunk, B/C dtype): B/C [BG, L, N] in group form (head
# row bh reads group row bh // (BH // BG)).  bf16 goes to the tensor-core
# kernel (ssd_scan_tc.cu), f32 to the SIMT kernel (ssd_scan.cu).  The first
# is timed: mamba2-780m's prefill operands at B=4, S=512 (48 heads of one
# group, head_dim 64, d_state 128, chunk 128).
SSD_CASES = (
    (192, 4, 512, 64, 128, 128, torch.bfloat16),
    (96, 2, 384, 64, 128, 128, torch.bfloat16),  # B=2, S=300 padded to 384
    (12, 4, 256, 64, 128, 128, torch.bfloat16),  # (G, rep) = (2, 3), B=2
    (8, 2, 192, 32, 64, 64, torch.bfloat16),     # chunk 64: a smaller triangle
    (16, 16, 256, 64, 128, 128, torch.bfloat16),  # one row a head (the JAX layout)
    (4, 4, 100, 64, 128, 100, torch.float32),    # chunk < 128
    (3, 3, 96, 8, 16, 48, torch.float32),
    (2, 2, 64, 16, 32, 16, torch.float32),
    (12, 4, 96, 16, 32, 48, torch.float32),      # group form on the SIMT kernel
)
SSD_TOL = 2e-4


def attn_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs the mask lets through: the products this call's
    data needs."""
    n = 0
    for i in range(sq):
        p = i + sk - sq
        lo = max(0, p - window + 1) if window > 0 else 0
        hi = min(p, sk - 1) if causal else sk - 1
        n += max(0, hi - lo + 1)
    return n


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0, tf32_flops=0.0):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    b = nbytes / HBM_BYTES_PER_S
    o = (bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S
         + tf32_flops / TF32_FLOP_PER_S)
    return dict(bytes=nbytes, bf16_flops=bf16_flops, f32_flops=f32_flops,
                tf32_flops=tf32_flops, bound_ms=max(b, o) * 1e3,
                bound_by="bytes" if b >= o else "operations")


def serve_kernel_checks(dev):
    """flash_attention and ssd_chunk_scan against their plain versions on
    the card; returns their records (times at the serving path's shapes)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as FK, ref as FR
    from repro_torch.kernels.ssd_scan import kernel as SK, ref as SR

    records = {}
    g = torch.Generator(device=dev).manual_seed(0)

    def flash_inputs(b, hq, hkv, sq, sk, d, dt):
        # the model's layout: [B, S, H, D] storage read through [B, H, S, D] views
        q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dt).transpose(1, 2)
        k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dt).transpose(1, 2)
        v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dt).transpose(1, 2)
        return q, k, v

    errs = {}
    bf16s_errs = []
    for case in FLASH_CASES:
        b, hq, hkv, sq, sk, d, causal, win, dt = case
        q, k, v = flash_inputs(b, hq, hkv, sq, sk, d, dt)
        if dt == torch.bfloat16:
            bf16s_errs.append(flash_bf16s_check(case, q, k, v, causal, win))
        kind = "tc" if dt == torch.bfloat16 else "simt"
        before = (FK.flash_attention.launches_tc, FK.flash_attention.launches_simt)
        out = FK.flash_attention(q, k, v, causal=causal, window=win)
        moved = (FK.flash_attention.launches_tc - before[0],
                 FK.flash_attention.launches_simt - before[1])
        if moved != ((1, 0) if kind == "tc" else (0, 1)):
            fail(f"flash_attention {case[:8]} {dt}: launches (tc, simt) moved by "
                 f"{moved}, expected one {kind} launch")
        ref = FR.flash_attention_ref(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dt:
            fail(f"flash_attention {case}: {tuple(out.shape)} {out.dtype}")
        err = max_abs_err(out, ref)
        if not err <= FLASH_TOL[dt]:
            fail(f"flash_attention {case[:8]} {dt}: max abs error {err} against its "
                 f"plain version (tolerance {FLASH_TOL[dt]}, {kind} kernel)")
        errs[dt] = max(errs.get(dt, 0.0), err)
    # a view the tensor-core kernel does not take is refused, not rerouted
    q, k, v = flash_inputs(1, 2, 2, 64, 64, 72, torch.bfloat16)
    n0 = FK.flash_attention.launches
    try:
        FK.flash_attention(q[..., 1:65], k[..., :64], v[..., :64])
    except ValueError as e:
        log(f"[kernels] flash_attention refuses a misaligned bf16 view: {e}")
    else:
        fail("flash_attention took a bf16 view whose rows are not 16-byte aligned")
    if FK.flash_attention.launches != n0:
        fail("flash_attention launched on a misaligned bf16 view")
    b, hq, hkv, s, _, d, causal, win, dt = FLASH_CASES[0]
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, dt)
    simt = FK.flash_attention(q, k, v, causal=True, variant="simt")
    simt_err = max_abs_err(simt, FR.flash_attention_ref(q, k, v, causal=True))
    if not simt_err <= FLASH_TOL[dt]:
        fail(f"flash_attention (simt) {FLASH_CASES[0][:8]} {dt}: max abs error "
             f"{simt_err} (tolerance {FLASH_TOL[dt]})")
    rec = dict(shape=f"q [{b}, {hq}, {s}, {d}], kv [{b}, {hkv}, {s}, {d}] bf16",
               max_abs_err=errs[torch.bfloat16], max_abs_err_f32=errs[torch.float32],
               **timings(lambda: FK.flash_attention(q, k, v, causal=True),
                         lambda: FR.flash_attention_ref(q, k, v, causal=True),
                         iters=20, plain_per_graph=2),
               simt_ms=device_ms(lambda: FK.flash_attention(q, k, v, causal=True,
                                                            variant="simt"), per_graph=10),
               simt_max_abs_err=simt_err,
               library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)),
               **bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                       bf16_flops=4 * d * attn_pairs(s, s, True, 0) * b * hq))
    records["flash_attention"] = rec
    dv_rec, dv_bf16s_errs = flash_dv_checks(dev, g)
    rec.update(dv_rec)
    bf16s_errs += dv_bf16s_errs
    rec["bf16s_max_abs_err"] = max(bf16s_errs)
    rec["bf16s_cases"] = len(bf16s_errs)
    rec.update({f"bf16s_{k_}": v_ for k_, v_ in timings(
        lambda: FK.flash_attention(q, k, v, causal=True, score_dtype=torch.bfloat16),
        lambda: FR.flash_attention_ref(q, k, v, causal=True, score_dtype=torch.bfloat16),
        iters=20, plain_per_graph=2).items()})
    rec.update(bf16s_library_ms=rec["library_ms"], bf16s_bound_ms=rec["bound_ms"],
               bf16s_bound_by=rec["bound_by"])
    log(f"[kernels] flash_attention  bf16 scores (attn_bf16, flash_attn_tc.cu's variant) "
        f"on {len(bf16s_errs)} bf16 cases: max abs err {rec['bf16s_max_abs_err']} against "
        f"the plain version's bf16 scores (tolerance {FLASH_BF16S_TOL}); at {rec['shape']}: "
        f"device time {rec['bf16s_ms'] * 1e3:.1f} us beside the f32-score kernel's "
        f"{rec['ms'] * 1e3:.1f} us, plain {rec['bf16s_plain_ms'] * 1e3:.1f} us, library "
        f"(SDPA) {rec['library_ms'] * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.2f} us by "
        f"{rec['bound_by']}")

    errs = {}
    for case in SSD_CASES:
        bh, bg, L, P, N, chunk, dt = case
        x, loga, B, C = ssd_inputs(g, dev, bh, bg, L, P, N, dt)
        kind = "tc" if dt == torch.bfloat16 else "simt"
        before = (SK.ssd_chunk_scan.launches_tc, SK.ssd_chunk_scan.launches_simt)
        got = SK.ssd_chunk_scan(x, loga, B, C, chunk=chunk)
        moved = (SK.ssd_chunk_scan.launches_tc - before[0],
                 SK.ssd_chunk_scan.launches_simt - before[1])
        if moved != ((1, 0) if kind == "tc" else (0, 1)):
            fail(f"ssd_chunk_scan {case[:6]} {dt}: launches (tc, simt) moved by {moved}, "
                 f"expected one {kind} launch")
        want = SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk)
        torch.cuda.synchronize()
        for name, a, r in zip(("y", "s", "t"), got, want):
            e = max_abs_err(a, r)
            if a.shape != r.shape or not e <= SSD_TOL:
                fail(f"ssd_chunk_scan {case[:6]} {dt} {name}: max abs error {e} "
                     f"(tolerance {SSD_TOL}, {kind} kernel), shapes {tuple(a.shape)} "
                     f"{tuple(r.shape)}")
            errs[dt] = max(errs.get(dt, 0.0), e)
    # a view the tensor-core kernel does not take is refused, not rerouted
    bh, bg, L, P, N, chunk, dt = SSD_CASES[2]
    x, loga, B, C = ssd_inputs(g, dev, bh, bg, L, P, N, dt)
    shifted = torch.empty(B.numel() + 8, dtype=dt, device=dev)[1:B.numel() + 1].view(B.shape)
    shifted.copy_(B)
    n0 = SK.ssd_chunk_scan.launches
    try:
        SK.ssd_chunk_scan(x, loga, shifted, C, chunk=chunk)
    except ValueError as e:
        log(f"[kernels] ssd_chunk_scan refuses a misaligned bf16 view: {e}")
    else:
        fail("ssd_chunk_scan took a bf16 B whose rows are not 16-byte aligned")
    if SK.ssd_chunk_scan.launches != n0:
        fail("ssd_chunk_scan launched on a misaligned bf16 view")
    bh, bg, L, P, N, chunk, dt = SSD_CASES[0]
    x, loga, B, C = ssd_inputs(g, dev, bh, bg, L, P, N, dt)
    simt = SK.ssd_chunk_scan(x, loga, B, C, chunk=chunk, variant="simt")
    simt_err = max(max_abs_err(a, r) for a, r in
                   zip(simt, SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk)))
    if not simt_err <= SSD_TOL:
        fail(f"ssd_chunk_scan (simt) {SSD_CASES[0][:6]}: max abs error {simt_err} "
             f"(tolerance {SSD_TOL})")
    nc, pairs = L // chunk, chunk * (chunk + 1) // 2
    out_bytes = 4 * (bh * L * P + bh * nc * N * P + bh * nc)
    in_bytes = 4 * x.numel() + 4 * loga.numel()
    records["ssd_chunk_scan"] = dict(
        shape=f"x [{bh}, {L}, {P}] f32, B/C [{bg}, {L}, {N}] bf16, chunk {chunk}",
        max_abs_err=errs[torch.bfloat16], max_abs_err_f32=errs[torch.float32],
        **timings(lambda: SK.ssd_chunk_scan(x, loga, B, C, chunk=chunk),
                  lambda: SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk),
                  iters=20, plain_per_graph=5),
        simt_ms=device_ms(lambda: SK.ssd_chunk_scan(x, loga, B, C, chunk=chunk,
                                                    variant="simt"), per_graph=10),
        simt_max_abs_err=simt_err,
        library_ms=None,
        # group-form B/C read once; C B^T once a (group, chunk) over the
        # causal pairs; y = G x (over the causal pairs) and S = (B o dec)^T x
        # in split TF32, three products each
        **bound(in_bytes + 2 * (B.numel() + C.numel()) + out_bytes,
                bf16_flops=2 * N * pairs * bg * nc,
                tf32_flops=3 * (2 * P * pairs + 2 * chunk * N * P) * bh * nc),
        # the SIMT kernel's bound in the expanded layout it was written for: B/C
        # [BH, L, N] and every product in f32 on the CUDA cores
        simt_bound_ms=bound(in_bytes + 2 * 2 * bh * L * N + out_bytes,
                            bf16_flops=2 * N * pairs * bh * nc,
                            f32_flops=(2 * P * pairs + 2 * chunk * N * P) * bh * nc)["bound_ms"])

    for name, rec in records.items():
        lib = f"{rec['library_ms'] * 1e3:.1f} us" if rec["library_ms"] else "none"
        log(f"[kernels] {name:15s} {rec['shape']}: max abs err {rec['max_abs_err']} "
            f"against its plain version; device time: kernel {rec['ms'] * 1e3:.1f} us, "
            f"plain {rec['plain_ms'] * 1e3:.1f} us, library {lib}, bound "
            f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} ({rec['bytes']} B, "
            f"{rec['bf16_flops']:.4g} bf16 + {rec['f32_flops']:.4g} f32 + "
            f"{rec['tf32_flops']:.4g} tf32 FLOP); a call "
            f"with the host's work: kernel {rec['call_ms'] * 1e3:.1f} us, plain "
            f"{rec['plain_call_ms'] * 1e3:.1f} us")
    log(f"[kernels] flash_attention  the SIMT kernel (flash_attn.cu) on the same bf16 "
        f"inputs: {records['flash_attention']['simt_ms'] * 1e3:.1f} us, max abs err "
        f"{records['flash_attention']['simt_max_abs_err']}")
    log(f"[kernels] ssd_chunk_scan   the SIMT kernel (ssd_scan.cu) on the same bf16 "
        f"inputs: {records['ssd_chunk_scan']['simt_ms'] * 1e3:.1f} us, max abs err "
        f"{records['ssd_chunk_scan']['simt_max_abs_err']}; its bound in the expanded "
        f"layout {records['ssd_chunk_scan']['simt_bound_ms'] * 1e3:.2f} us")
    return records


def flash_bf16s_check(case, q, k, v, causal, window) -> float:
    """The tensor-core kernel's bf16-score variant on one bf16 case: one
    launch (counted as tc and as bf16s), held to ``flash_attention_ref(
    score_dtype=bf16)`` within FLASH_BF16S_TOL.  Returns its max abs error."""
    from repro_torch.kernels.flash_attn import kernel as FK, ref as FR
    fa = FK.flash_attention
    before = (fa.launches_tc, fa.launches_bf16s)
    out = FK.flash_attention(q, k, v, causal=causal, window=window,
                             score_dtype=torch.bfloat16)
    if (fa.launches_tc - before[0], fa.launches_bf16s - before[1]) != (1, 1):
        fail(f"flash_attention {case[:-1]} bf16 scores: launches (tc, bf16s) moved by "
             f"{(fa.launches_tc - before[0], fa.launches_bf16s - before[1])}, expected one "
             f"of each")
    ref = FR.flash_attention_ref(q, k, v, causal=causal, window=window,
                                 score_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    if out.shape != ref.shape or not err <= FLASH_BF16S_TOL:
        fail(f"flash_attention {case[:-1]} bf16 scores: max abs error {err} against the "
             f"plain version's bf16 scores (tolerance {FLASH_BF16S_TOL}), shapes "
             f"{tuple(out.shape)} {tuple(ref.shape)}")
    return err


def flash_dv_checks(dev, g):
    """flash_attention with v's own head dim (MLA) and non-causal Sk > Sq
    (cross-attention) against the plain version on both kernels (the bf16
    cases with bf16 scores too); a bf16 Dv that is not a multiple of 8
    refused with no launch; the MLA and cross shapes timed beside their
    bounds and SDPA.  Returns the timed cases' numbers as ``mla_*`` and
    ``cross_*`` keys, and the bf16-score cases' errors."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as FK, ref as FR

    def inputs(b, hq, hkv, sq, sk, d, dv, dt):
        q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dt).transpose(1, 2)
        k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dt).transpose(1, 2)
        if dv == d:
            v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dt)
            return q, k, v.transpose(1, 2)
        # v as MLA's prefill hands it over: the last dv columns of a wider row
        kv = torch.randn((b, sk, hkv, 64 + dv), generator=g, device=dev).to(dt)
        return q, k, kv[..., 64:].transpose(1, 2)

    out_rec, errs, bf16s_errs = {}, {}, []
    for case in DV_CASES:
        b, hq, hkv, sq, sk, d, dv, causal, dt = case
        q, k, v = inputs(b, hq, hkv, sq, sk, d, dv, dt)
        if dt == torch.bfloat16:
            bf16s_errs.append(flash_bf16s_check(case, q, k, v, causal, 0))
        kind = "tc" if dt == torch.bfloat16 else "simt"
        n0 = getattr(FK.flash_attention, f"launches_{kind}")
        out = FK.flash_attention(q, k, v, causal=causal)
        if getattr(FK.flash_attention, f"launches_{kind}") != n0 + 1:
            fail(f"flash_attention {case}: no {kind} launch counted")
        ref = FR.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if out.shape != (b, hq, sq, dv) or out.shape != ref.shape:
            fail(f"flash_attention {case}: output {tuple(out.shape)}, plain {tuple(ref.shape)}")
        err = max_abs_err(out, ref)
        if not err <= FLASH_TOL[dt]:
            fail(f"flash_attention {case[:8]} {dt}: max abs error {err} against its plain "
                 f"version (tolerance {FLASH_TOL[dt]}, {kind} kernel)")
        errs[dt] = max(errs.get(dt, 0.0), err)
    log(f"[kernels] flash_attention  Dv < D and non-causal Sk > Sq, {len(DV_CASES)} cases: "
        f"max abs err bf16 {errs[torch.bfloat16]}, f32 {errs[torch.float32]}")
    q, k, v = inputs(1, 2, 2, 64, 64, 96, 60, torch.bfloat16)
    n0 = FK.flash_attention.launches
    try:
        FK.flash_attention(q, k, v[..., :60])
    except ValueError as e:
        log(f"[kernels] flash_attention refuses a bf16 value head dim of 60: {e}")
    else:
        fail("flash_attention took a bf16 value head dim that is not a multiple of 8")
    if FK.flash_attention.launches != n0:
        fail("flash_attention launched on a bf16 value head dim of 60")
    for what, (b, hq, hkv, sq, sk, d, dv, causal, dt) in DV_TIMED.items():
        q, k, v = inputs(b, hq, hkv, sq, sk, d, dv, dt)
        pairs = attn_pairs(sq, sk, causal, 0) * b * hq
        t = timings(lambda: FK.flash_attention(q, k, v, causal=causal),
                    lambda: FR.flash_attention_ref(q, k, v, causal=causal),
                    iters=20, plain_per_graph=2)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        bnd = bound(2 * (q.numel() + k.numel() + v.numel() + b * hq * sq * dv),
                    bf16_flops=2 * (d + dv) * pairs)
        shape = (f"q [{b}, {hq}, {sq}, {d}], k [{b}, {hkv}, {sk}, {d}], v [{b}, {hkv}, "
                 f"{sk}, {dv}] bf16, {'causal' if causal else 'non-causal'}")
        out_rec.update({f"{what}_shape": shape, f"{what}_ms": t["ms"],
                        f"{what}_plain_ms": t["plain_ms"], f"{what}_call_ms": t["call_ms"],
                        f"{what}_library_ms": sdpa, f"{what}_bound_ms": bnd["bound_ms"],
                        f"{what}_bound_by": bnd["bound_by"], f"{what}_bytes": bnd["bytes"],
                        f"{what}_bf16_flops": bnd["bf16_flops"]})
        log(f"[kernels] flash_attention  {what} {shape}: device time kernel "
            f"{t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us, library (SDPA) "
            f"{sdpa * 1e3:.1f} us, bound {bnd['bound_ms'] * 1e3:.2f} us by {bnd['bound_by']} "
            f"({bnd['bytes']} B, {bnd['bf16_flops']:.4g} bf16 FLOP)")
    return out_rec, bf16s_errs


def ssd_inputs(g, dev, bh, bg, L, P, N, dt):
    """x, loga (f32) and group-form B/C in ``dt``, from the generator."""
    x = torch.randn((bh, L, P), generator=g, device=dev) * 0.5
    loga = -torch.randn((bh, L), generator=g, device=dev).abs() * 0.3
    B = (torch.randn((bg, L, N), generator=g, device=dev) * 0.3).to(dt)
    C = (torch.randn((bg, L, N), generator=g, device=dev) * 0.3).to(dt)
    return x, loga, B, C


# --------------------------------------------------------- 5. serving

SERVE_MODELS = (("qwen3-0.6b", "flash_attention"), ("mamba2-780m", "ssd_chunk_scan"))
SERVE_REQUESTS = ((4, 512, 16), (2, 300, 16))    # (batch, prompt tokens, new tokens)
TTFT_REPEATS = 7
TTFT_BF16S_REPEATS = 7          # attn_bf16's prefill, in turns with f32 scores
# Kernel against plain on the card, same weights.  The kernels sum in
# another order than the plain versions, so now and then a bf16 activation
# rounds the other way (one bf16 ULP, 2^-8 relative).
# - Layer by layer, from the same input (the plain path's residual
#   stream): each layer's output and caches within 2e-2 of the largest
#   value, as the CPU tests hold each layer against the JAX package.
#   This is the check of the kernels inside the model.
# - Whole depth: the residual stream carries every flip through every
#   later layer, and this random-init model amplifies them (on an H100
#   the two paths' caches drift ~1 % apart over qwen3-0.6b's 28 layers,
#   ~3 % over mamba2-780m's 48; PERF.md).  The prefill and teacher-forced logits are held to
#   max |d| / max |ref| <= 5e-2, the bound the JAX package allows between
#   its own two serving paths (tests/test_models.py::
#   test_decode_matches_forward), and a token counts as decided where the
#   top-1 minus top-2 margin exceeds that bound.  The caches' whole-depth
#   errors are printed beside them.
SERVE_LAYER_TOL = 2e-2
# the SIMT kernels that take bf16 when the card's checks name variant="simt"
SIMT_SOURCES = {"flash_attention": "src/repro_torch/csrc/flash_attn.cu",
                "ssd_chunk_scan": "src/repro_torch/csrc/ssd_scan.cu"}
SERVE_MAX_TOL = 5e-2


def rel_err(want, got) -> float:
    want, got = want.float(), got.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def rel_l2(want, got) -> float:
    want, got = want.double(), got.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@contextlib.contextmanager
def recording_routes(calls):
    """Append every MoE routing decision, ``moe.route``'s (probs, gate
    values, expert ids), to ``calls`` while the block runs."""
    from repro_torch.models import moe
    fn = moe.route

    def rec(p, cfg, x2):
        out = fn(p, cfg, x2)
        calls.append(out)
        return out
    moe.route = rec
    try:
        yield calls
    finally:
        moe.route = fn


def kept_experts(cfg, idx):
    """The experts that keep a token's choices (``[B, S, E]`` bool) under
    the one-hot einsum dispatch, the zoo's: capacity per batch row, a
    choice's buffer position its rank in a cumsum over tokens, then
    choices (``models/moe.py`` ``moe_apply``)."""
    import torch.nn.functional as F
    if cfg.moe_sorted or cfg.moe_local_chunks:
        fail(f"{cfg.name}: kept_experts follows the einsum dispatch only")
    b, s, k = idx.shape
    e = cfg.n_experts
    cap = max(1, -(-int(cfg.capacity_factor * s * k) // e))
    oh = F.one_hot(idx.long(), e)
    pos = (oh.reshape(b, s * k, e).cumsum(dim=1).reshape(b, s, k, e) - oh)
    return ((pos < cap) & (oh > 0)).any(dim=2)


def route_flips(got, want, what, cfg):
    """Tokens whose MoE output may differ between two runs (``got``,
    ``want``: their ``recording_routes`` lists, call by call): a bool mask
    of each call's token shape, one a call.  A token is flagged where the
    two runs chose another set of experts (a flip), or kept its choices in
    another set (its expert's capacity was taken by an earlier flip in
    its row).  A flip is legitimate only where ``want``'s k-th minus
    (k+1)-th probability is within twice the largest difference between
    the two runs' router probabilities in that call (the routing was not
    decided there); a kept set that differs needs a flip at or before it
    in its row.  Anything else fails."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} MoE routings against {len(want)}")
    masks, stats = [], dict(flips=0, dropped_otherwise=0, decisions=0, worst_margin=0.0)
    for (pg, _, ig), (pw, _, iw) in zip(got, want):
        k = ig.shape[-1]
        flip = (ig.sort(dim=-1).values != iw.sort(dim=-1).values).any(dim=-1)
        kept = (kept_experts(cfg, ig) != kept_experts(cfg, iw)).any(dim=-1) & ~flip
        if bool((kept & ~(flip.cumsum(dim=1) > 0)).any()):
            fail(f"{what}: a token kept in other experts with no routing flip before it "
                 f"in its row")
        top = pw.topk(min(k + 1, pw.shape[-1]), dim=-1).values
        margin = top[..., k - 1] - top[..., k] if top.shape[-1] > k else top[..., -1]
        noise = float((pg - pw).abs().max())
        if bool(flip.any()):
            worst = float(margin[flip].max())
            if not worst <= 2 * noise:
                fail(f"{what}: a token routed differently at a probability margin of "
                     f"{worst}, above twice the runs' router difference {noise}")
            stats["worst_margin"] = max(stats["worst_margin"], worst)
        stats["flips"] += int(flip.sum())
        stats["dropped_otherwise"] += int(kept.sum())
        stats["decisions"] += flip.numel()
        masks.append(flip | kept)
    return masks, stats


def any_flip(masks):
    """The tokens routed differently in any of the calls (one shape)."""
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def per_layer_errors(model, batch, max_len):
    """Every layer through the kernels and through the plain versions from
    the same input (the plain path's residual stream); the worst error of
    each output over the layers (max |d| / max |ref|).  ``batch``: a
    prefill's batch dict, or its tokens.  A MoE layer's output is compared
    on the tokens both paths routed alike (``route_flips``); the caches
    come before the FFN."""
    from repro_torch.models import lm
    x, positions, cross = lm.prefill_inputs(model, batch)
    worst, flips = {}, dict(flips=0, decisions=0, worst_margin=0.0)
    for i, layer in enumerate(model.layers):
        model.backend = "kernel"
        with recording_routes([]) as rk:
            xk, ck = lm.prefill_layer(model, layer, x, positions, max_len, cross)
        model.backend = "plain"
        with recording_routes([]) as rp:
            x, cp = lm.prefill_layer(model, layer, x, positions, max_len, cross)
        same = slice(None)
        if rp:
            flip, st = route_flips(rk, rp, f"{model.cfg.name} layer {i}", model.cfg)
            same = ~any_flip(flip)
            flips = {k: max(flips.get(k, 0), v) if k == "worst_margin" else
                     flips.get(k, 0) + v for k, v in st.items()}
        for name, e in [("x", rel_err(x[same], xk[same]))] + \
                [(f"cache.{n}", rel_err(cp[n], ck[n])) for n in cp]:
            worst[name] = max(worst.get(name, 0.0), e)
    if flips["decisions"]:
        worst["moe_flips"] = flips
    return worst


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def ssd_variant(variant):
    """Route the model's ssd_chunk_scan calls (the ``"kernel"`` backend)
    to one kernel, ``"tc"`` or ``"simt"``; ``None`` leaves the choice to
    the dtype."""
    from repro_torch.kernels.ssd_scan import kernel as SK, ops as SO
    fn = SO.ssd_chunk_scan

    def routed(x, loga, B, C, *, chunk, backend="kernel"):
        if backend != "kernel":
            fail(f"ssd_variant({variant!r}) routes the kernel backend only")
        return SK.ssd_chunk_scan(x, loga, B, C, chunk=chunk, variant=variant)
    if variant is not None:
        SO.ssd_chunk_scan = routed
    try:
        yield
    finally:
        SO.ssd_chunk_scan = fn


@contextlib.contextmanager
def attention_variant(variant):
    """Route the model's flash_attention calls (the ``"kernel"`` backend)
    to one kernel, ``"tc"`` or ``"simt"``; ``None`` leaves the choice to
    the dtype."""
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    fn = FO.flash_attention

    def routed(q, k, v, *, causal=True, window=0, backend="kernel",
               score_dtype=torch.float32):
        if backend != "kernel" or score_dtype != torch.float32:
            fail(f"attention_variant({variant!r}) routes the kernel backend's f32 "
                 f"scores only")
        return FK.flash_attention(q, k, v, causal=causal, window=window, variant=variant)
    if variant is not None:
        FO.flash_attention = routed
    try:
        yield
    finally:
        FO.flash_attention = fn


def all_counters():
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {**counters(), "flash_attention": FK.flash_attention,
            "ssd_chunk_scan": SK.ssd_chunk_scan}


def reset_counts():
    from repro_torch.kernels.control import kernel as XK
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK
    for fn in all_counters().values():
        fn.launches = 0
    XK.control.launches_smartt = 0
    FK.reset_launches()
    SK.reset_launches()


def read_counts():
    """Launches by kernel; the fused control kernel's with SMaRTT's update
    inside ("control:smartt"); flash_attention's and ssd_chunk_scan's by
    variant ("tc" bf16, "simt" f32), and flash_attention's with bf16
    scores ("bf16s", tensor-core ones)."""
    from repro_torch.kernels.control import kernel as XK
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK
    fa, ss = FK.flash_attention, SK.ssd_chunk_scan
    return {**{k: fn.launches for k, fn in all_counters().items()},
            "control:smartt": XK.control.launches_smartt,
            "flash_attention:tc": fa.launches_tc, "flash_attention:simt": fa.launches_simt,
            "flash_attention:bf16s": fa.launches_bf16s,
            "ssd_chunk_scan:tc": ss.launches_tc, "ssd_chunk_scan:simt": ss.launches_simt}


def prefill_busy_ms(model, prompt, max_len):
    """Device time of one prefill (the sum of its kernels' device time
    under torch.profiler) and its wall time, after a warm-up prefill: the
    device's share of the time to first token."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    lm.prefill(model, prompt, max_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.prefill(model, prompt, max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    busy = sum(dev_us(e) for e in device_events(prof))
    return dict(busy_ms=busy / 1e3, wall_ms=wall * 1e3)


def decode_idle_share(model, prompt, max_len, steps=8):
    """torch.profiler over ``steps`` greedy decode steps after a prefill:
    wall time a step, device busy time a step, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    vocab = model.cfg.vocab
    logits, caches, cl = lm.prefill(model, prompt, max_len)
    tok = logits[:, -1, :vocab].argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cl = cl + 1
            logits, caches = lm.decode_step(model, tok, caches, cl)
            tok = logits[:, -1, :vocab].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return dict(wall_ms_per_step=wall / steps * 1e3,
                busy_ms_per_step=busy / steps * 1e3,
                idle_share=1 - busy / wall if busy else None,
                kernels_per_step=sum(e.count for e in events) / steps,
                top=[dict(name=e.key, us_per_step=dev_us(e) / steps,
                          per_step=e.count / steps) for e in top])


def serve_request(model, kname, b, s, new, dev):
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = model.cfg
    tag = f"{cfg.name} B={b} S={s} +{new}"
    max_len = s + new + 1
    prompt = torch.randint(0, cfg.vocab, (b, s), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(1000 * b + s))

    # prefill through the kernels and through the plain versions
    model.backend = "kernel"
    lk, ck, _ = lm.prefill(model, prompt, max_len)
    model.backend = "plain"
    lp, cp, _ = lm.prefill(model, prompt, max_len)
    if lk.shape != (b, 1, cfg.padded_vocab) or not bool(torch.isfinite(lk).all()):
        fail(f"{tag}: prefill logits {tuple(lk.shape)}, finite {bool(torch.isfinite(lk).all())}")
    errs = {"logits.max": rel_err(lp, lk), "logits.l2": rel_l2(lp, lk)}
    for name in ck[0]:
        want = torch.stack([p[name] for p in cp])
        got = torch.stack([k[name] for k in ck])
        errs[f"cache.{name}.l2"] = rel_l2(want, got)
        errs[f"cache.{name}.max"] = rel_err(want, got)
    layer_errs = per_layer_errors(model, prompt, max_len)
    log(f"[serve] {tag}: prefill, kernel against plain: whole depth {errs}; "
        f"worst layer from the same input {layer_errs}")
    bad = {k: v for k, v in layer_errs.items() if not v <= SERVE_LAYER_TOL}
    if not errs["logits.max"] <= SERVE_MAX_TOL:
        bad["logits.max"] = errs["logits.max"]
    if bad:
        fail(f"{tag}: prefill through the kernels differs from the plain versions "
             f"{bad} (tolerance {SERVE_LAYER_TOL} a layer, {SERVE_MAX_TOL} for the "
             f"logits)")

    # time to first token: prefill + argmax, the median of TTFT_REPEATS,
    # the backends in turns, and through the model's kernel's SIMT version
    # (the earlier design), so the two kernels' TTFT share one call's host
    # (host-bound: its spread is wider than the launches' difference, so
    # the samples are many and interleaved)
    ways = ("kernel", "plain", "simt")
    route = attention_variant if kname == "flash_attention" else ssd_variant
    ts = {w: [] for w in ways}
    for _ in range(TTFT_REPEATS):
        for w in ways:
            model.backend = "plain" if w == "plain" else "kernel"
            with route("simt" if w == "simt" else None):
                ts[w].append(timed(lambda: lm.prefill(model, prompt, max_len)[0]
                                   [:, -1, :cfg.vocab].argmax(-1))[1])
    ts = {w: sorted(v) for w, v in ts.items()}
    ttft = {w: v[len(v) // 2] for w, v in ts.items()}
    busy = {}
    for w in ways:                              # the device's share of a prefill
        model.backend = "plain" if w == "plain" else "kernel"
        with route("simt" if w == "simt" else None):
            busy[w] = prefill_busy_ms(model, prompt, max_len)
    log(f"[serve] {tag}: one prefill under torch.profiler, device busy / wall (ms): " +
        ", ".join(f"{w} {v['busy_ms']:.2f} / {v['wall_ms']:.2f}" for w, v in busy.items()))
    quart = {w: (round(v[len(v) // 4] * 1e3, 2), round(v[(3 * len(v)) // 4] * 1e3, 2))
             for w, v in ts.items()}

    # the path: generate through the kernels, counts at 0 just before
    model.backend = "kernel"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    toks, gen_s = timed(lambda: engine.generate(model, prompt, max_new=new, max_len=max_len))
    launches = read_counts()                                   # just after
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want[kname] = cfg.n_layers
    want[f"{kname}:tc"] = cfg.n_layers          # bf16: every launch on the tensor cores
    if launches != want:
        fail(f"{tag}: generate launched {launches}, expected {want} (one "
             f"{kname} a layer in the prefill, none in decode)")
    if toks.shape != (b, new) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        fail(f"{tag}: generated tokens {tuple(toks.shape)} outside [0, {cfg.vocab})")
    reset_counts()
    lm.decode_step(model, toks[:, :1], ck, torch.full((b,), s + 1, dtype=torch.int32,
                                                      device=dev))
    if any(read_counts().values()):
        fail(f"{tag}: a decode step launched {read_counts()}")

    model.backend = "plain"
    reset_counts()
    toks_p, gen_p = timed(lambda: engine.generate(model, prompt, max_new=new, max_len=max_len))
    if any(read_counts().values()):
        fail(f"{tag}: the plain backend launched kernels {read_counts()}")

    # teacher-forced: both fed the kernel run's tokens
    model.backend = "kernel"
    fk = engine.teacher_forced_logits(model, prompt, toks, max_len=max_len)
    model.backend = "plain"
    fp = engine.teacher_forced_logits(model, prompt, toks, max_len=max_len)
    errs["forced_logits.l2"] = rel_l2(fp, fk)
    errs["forced_logits.max"] = rel_err(fp, fk)
    top2 = fp.float().topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > SERVE_MAX_TOL * float(fp.float().abs().max())
    agree_k = bool((fk.argmax(-1)[decided] == toks[decided]).all())
    agree_p = bool((fp.argmax(-1)[decided] == toks[decided]).all())
    if not (errs["forced_logits.max"] <= SERVE_MAX_TOL and agree_k and agree_p
            and bool(decided.any())):
        fail(f"{tag}: teacher-forced logits error {errs['forced_logits.max']} (tolerance "
             f"{SERVE_MAX_TOL}); tokens agree where the margin decides: kernel "
             f"{agree_k}, plain {agree_p} ({int(decided.sum())} of {decided.numel()} "
             f"decided)")
    same = int((toks_p == toks).all(dim=1).sum())
    rate = {k: b * new / (g - ttft[k]) for k, g in (("kernel", gen_s), ("plain", gen_p))}
    log(f"[serve] {tag}: launches {kname} {launches[kname]} (tensor-core "
        f"{launches[f'{kname}:tc']}), 0 in decode; TTFT kernel {ttft['kernel'] * 1e3:.2f} "
        f"ms ({kname} on the SIMT kernel {ttft['simt'] * 1e3:.2f} ms), plain "
        f"{ttft['plain'] * 1e3:.2f} ms (quartiles, ms: {quart}); decode "
        f"kernel {rate['kernel']:.1f} tok/s, plain {rate['plain']:.1f} tok/s; generate "
        f"{gen_s:.3f} s (plain {gen_p:.3f} s); peak memory {peak / 2**30:.3f} GiB; "
        f"errors vs plain {errs}; {int(decided.sum())}/{decided.numel()} tokens decided "
        f"by the margin, all agree; {same}/{b} rows of greedy tokens identical")
    return dict(launches=launches[kname], ttft_ms=ttft["kernel"] * 1e3,
                ttft_plain_ms=ttft["plain"] * 1e3,
                ttft_simt_ms=ttft["simt"] * 1e3, prefill_busy=busy,
                ttft_quartiles_ms=quart,
                decode_tok_s=rate["kernel"],
                decode_tok_s_plain=rate["plain"], generate_s=gen_s,
                generate_plain_s=gen_p, peak_bytes=peak, errors=errs,
                decided=int(decided.sum()), tokens=decided.numel(),
                rows_identical=same), prompt, max_len


def serve_bf16_scores(model, dev):
    """The first request's prefill with ``cfg.attn_bf16`` (the flash kernel's
    bf16-score variant): one launch a layer, counted as bf16 scores; its
    logits held to the plain path's (bf16 scores too) within SERVE_MAX_TOL;
    TTFT, the median of TTFT_BF16S_REPEATS in turns with f32 scores."""
    from repro_torch.models import lm
    cfg = model.cfg
    b, s, new = SERVE_REQUESTS[0]
    tag = f"{cfg.name} attn_bf16 B={b} S={s}"
    max_len = s + new + 1
    prompt = torch.randint(0, cfg.vocab, (b, s), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(1000 * b + s))
    bf16 = dataclasses.replace(cfg, attn_bf16=True)
    try:
        model.cfg, model.backend = bf16, "kernel"
        reset_counts()
        lk = lm.prefill(model, prompt, max_len)[0]
        launches = read_counts()                               # just after
        want = {k: 0 for k in launches}
        want["flash_attention"] = want["flash_attention:tc"] = \
            want["flash_attention:bf16s"] = cfg.n_layers
        if launches != want:
            fail(f"{tag}: the prefill launched {launches}, expected {want}")
        model.backend = "plain"
        lp = lm.prefill(model, prompt, max_len)[0]
        if not bool(torch.isfinite(lk).all()):
            fail(f"{tag}: prefill logits not finite")
        errs = {"logits.max": rel_err(lp, lk), "logits.l2": rel_l2(lp, lk)}
        if not errs["logits.max"] <= SERVE_MAX_TOL:
            fail(f"{tag}: prefill logits through the kernel differ from the plain path's "
                 f"{errs} (tolerance {SERVE_MAX_TOL})")
        model.backend = "kernel"
        ts = {"bf16": [], "f32": []}
        for _ in range(TTFT_BF16S_REPEATS):
            for w, c in (("bf16", bf16), ("f32", cfg)):
                model.cfg = c
                ts[w].append(timed(lambda: lm.prefill(model, prompt, max_len)[0]
                                   [:, -1, :cfg.vocab].argmax(-1))[1])
    finally:
        model.cfg, model.backend = cfg, "kernel"
    ttft = {w: sorted(v)[len(v) // 2] * 1e3 for w, v in ts.items()}
    log(f"[serve] {tag}: prefill through flash_attn_tc.cu's bf16-score variant "
        f"({launches['flash_attention:bf16s']} launches), logits against the plain "
        f"path's bf16 scores {errs}; TTFT {ttft['bf16']:.2f} ms, f32 scores "
        f"{ttft['f32']:.2f} ms (median of {TTFT_BF16S_REPEATS}, in turns)")
    return dict(launches=launches["flash_attention:bf16s"], errors=errs,
                ttft_ms=ttft["bf16"], ttft_f32_scores_ms=ttft["f32"])


def phase_serving(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    results = {}
    for arch, kname in SERVE_MODELS:
        cfg = get_config(arch)
        model, init_s = timed(lambda: lm.LM(
            cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
        n = sum(p.numel() for p in model.parameters())
        log(f"[serve] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n / 1e6:.1f} M parameters, seeded init on the card in {init_s:.2f} s")
        for b, s, new in SERVE_REQUESTS:
            rec, prompt, max_len = serve_request(model, kname, b, s, new, dev)
            results[f"{arch} B={b} S={s}"] = rec
            if (b, s, new) == SERVE_REQUESTS[0]:
                model.backend = "kernel"
                prof = decode_idle_share(model, prompt, max_len, steps=min(8, new))
                rec["decode_profile"] = prof
                log(f"[serve] {arch} B={b}: decode under torch.profiler: "
                    f"{prof['wall_ms_per_step']:.2f} ms a step, device busy "
                    f"{prof['busy_ms_per_step']:.3f} ms a step, idle share "
                    f"{prof['idle_share']}, {prof['kernels_per_step']:.0f} device "
                    f"kernels a step")
                for e in prof["top"]:
                    log(f"[serve]   {e['us_per_step']:9.1f} us/step  x{e['per_step']:6.1f}  "
                        f"{e['name'][:90]}")
        if kname == "flash_attention":
            results[f"{arch} attn_bf16 B={SERVE_REQUESTS[0][0]} S={SERVE_REQUESTS[0][1]}"] = \
                serve_bf16_scores(model, dev)
        del model
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------- 5b. the zoo

# The other eight architectures at full width from a seeded init, one at a
# time: (arch, layers on the card; None: the whole depth).  Depth is cut
# where one 80 GB card cannot hold the model: llama-3.2-vision-90b one
# pattern of 5 (the cross layer included), dbrx-132b and mixtral-8x22b 2
# layers, jamba-1.5-large-398b pattern positions 0-4 (Mamba+dense,
# Mamba+MoE, Mamba+dense, Mamba+MoE, attention+dense).
ZOO = (("qwen2-0.5b", None), ("phi3-mini-3.8b", None), ("minicpm3-4b", None),
       ("musicgen-large", None), ("llama-3.2-vision-90b", 5), ("dbrx-132b", 2),
       ("mixtral-8x22b", 2), ("jamba-1.5-large-398b", 5))
ZOO_REQUEST = (4, 512, 8)       # (batch, prompt tokens or frames, new tokens)
ZOO_TTFT_REPEATS = 3


def zoo_config(arch, layers):
    """The full config of ``arch``, its depth cut to ``layers`` (the
    pattern's first ``layers`` positions when that is less than one
    pattern)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, pattern=cfg.pattern[:layers], n_layers=layers)


def serve_loop(model, batch, new, max_len, frames=None, forced=None):
    """``lm.prefill`` then ``new`` decode steps, as ``serve.generate`` runs
    them, for any batch (a cross feed, embeddings): each step is fed the
    argmax token, ``forced[:, i]``, or the frame ``frames[:, i]``.  Returns
    (tokens ``[B, new]``, or None when fed frames; the logits ``[B, new,
    vocab]`` that chose each step's input, the last step's discarded)."""
    from repro_torch.models import lm
    vocab = model.cfg.vocab
    logits, caches, cl = lm.prefill(model, batch, max_len)
    steps, toks = [logits[:, -1, :vocab]], []
    for i in range(new):
        if frames is not None:
            nxt = {"embeds": frames[:, i:i + 1]}
        else:
            tok = (forced[:, i] if forced is not None
                   else steps[-1].argmax(dim=-1)).to(torch.int32)
            toks.append(tok)
            nxt = {"tokens": tok[:, None]}
        cl = cl + 1
        logits, caches = lm.decode_step(model, nxt, caches, cl)
        if i + 1 < new:
            steps.append(logits[:, -1, :vocab])
    return (torch.stack(toks, dim=1) if toks else None), torch.stack(steps, dim=1)


def zoo_request(model, layers_by_kernel, dev):
    """One request of ZOO_REQUEST through the kernels against the plain
    versions on the card, phase 5's gates: each layer from the same input
    within SERVE_LAYER_TOL, the prefill and teacher-forced logits within
    SERVE_MAX_TOL, every token the margin decides equal; a MoE token that
    the two paths route differently (route_flips) is left out of its
    layer's output and of the logits of its row's position."""
    from repro_torch.models import lm
    from repro_torch.models.config import MIXER_CROSS
    from repro_torch.serve import engine
    cfg = model.cfg
    b, s, new = ZOO_REQUEST
    tag = f"{cfg.name} ({cfg.n_layers} layers) B={b} S={s} +{new}"
    max_len = s + new + 1
    g = torch.Generator(device=dev).manual_seed(7 * b + s)
    batch, frames = {}, None
    if cfg.frontend == "tokens":
        batch["tokens"] = torch.randint(0, cfg.vocab, (b, s), device=dev, dtype=torch.int32,
                                        generator=g)
    else:       # seeded frame embeddings for the prompt and each decode step
        batch["embeds"] = torch.randn((b, s, cfg.d_model), generator=g,
                                      device=dev).to(torch.bfloat16)
        frames = torch.randn((b, new, cfg.d_model), generator=g,
                             device=dev).to(torch.bfloat16)
    if any(sp.mixer == MIXER_CROSS for sp in cfg.pattern):
        batch["cross"] = torch.randn((b, cfg.cross_kv_len, cfg.d_model), generator=g,
                                     device=dev).to(torch.bfloat16)
    by_generate = "tokens" in batch and "cross" not in batch

    # prefill through the kernels and through the plain versions
    model.backend = "kernel"
    with recording_routes([]) as rk:
        lk, ck, _ = lm.prefill(model, batch, max_len)
    model.backend = "plain"
    with recording_routes([]) as rp:
        lp, cp, _ = lm.prefill(model, batch, max_len)
    if lk.shape != (b, 1, cfg.padded_vocab) or not bool(torch.isfinite(lk).all()):
        fail(f"{tag}: prefill logits {tuple(lk.shape)}, finite {bool(torch.isfinite(lk).all())}")
    rows = torch.ones(b, dtype=torch.bool, device=dev)
    flips = None
    if rp:          # rows whose last position was routed alike in every layer
        flip, flips = route_flips(rk, rp, f"{tag} prefill", cfg)
        rows = ~any_flip(flip)[:, -1]
    errs = {"logits.max": rel_err(lp[rows], lk[rows]), "logits.l2": rel_l2(lp, lk)}
    for name in set().union(*(c.keys() for c in ck)):
        have = [i for i, c in enumerate(ck) if name in c]
        want = torch.cat([cp[i][name].float().flatten() for i in have])
        got = torch.cat([ck[i][name].float().flatten() for i in have])
        errs[f"cache.{name}.l2"] = rel_l2(want, got)
        errs[f"cache.{name}.max"] = rel_err(want, got)
    layer_errs = per_layer_errors(model, batch, max_len)
    layer_flips = layer_errs.pop("moe_flips", None)
    log(f"[zoo] {tag}: prefill, kernel against plain: whole depth {errs}; worst layer "
        f"from the same input {layer_errs}; MoE tokens routed differently: whole depth "
        f"{flips}, layer by layer {layer_flips}")
    bad = {k: v for k, v in layer_errs.items() if not v <= SERVE_LAYER_TOL}
    if not errs["logits.max"] <= SERVE_MAX_TOL:
        bad["logits.max"] = errs["logits.max"]
    if bad or not bool(rows.any()):
        fail(f"{tag}: prefill through the kernels differs from the plain versions {bad} "
             f"(tolerance {SERVE_LAYER_TOL} a layer, {SERVE_MAX_TOL} for the logits; "
             f"{int(rows.sum())} rows compared)")

    # time to first token, the median of ZOO_TTFT_REPEATS in turns
    ts = {"kernel": [], "plain": []}
    for _ in range(ZOO_TTFT_REPEATS):
        for w in ts:
            model.backend = w
            ts[w].append(timed(lambda: lm.prefill(model, batch, max_len)[0]
                               [:, -1, :cfg.vocab].argmax(-1))[1])
    ttft = {w: sorted(v)[len(v) // 2] for w, v in ts.items()}

    # the path: counts at 0 just before, read just after (after one untimed
    # request, so that the decode steps' first calls are not timed)
    def serve(fn):
        return fn() if by_generate else serve_loop(model, batch, new, max_len, frames)[0]
    model.backend = "kernel"
    serve(lambda: engine.generate(model, batch["tokens"], max_new=new, max_len=max_len))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    toks, gen_s = timed(lambda: serve(lambda: engine.generate(
        model, batch["tokens"], max_new=new, max_len=max_len)))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    for kname, n in layers_by_kernel.items():
        want[kname] = want[f"{kname}:tc"] = n
    if launches != want:
        fail(f"{tag}: the request launched {launches}, expected {want} (one a layer of "
             f"the prefill, on the tensor cores; none in decode)")
    if toks is not None and (toks.shape != (b, new) or int(toks.min()) < 0
                             or int(toks.max()) >= cfg.vocab):
        fail(f"{tag}: generated tokens {tuple(toks.shape)} outside [0, {cfg.vocab})")
    reset_counts()
    nxt = {"tokens": toks[:, :1]} if toks is not None else {"embeds": frames[:, :1]}
    lm.decode_step(model, nxt, ck, torch.full((b,), s + 1, dtype=torch.int32, device=dev))
    if any(read_counts().values()):
        fail(f"{tag}: a decode step launched {read_counts()}")
    model.backend = "plain"
    _, gen_p = timed(lambda: serve(lambda: engine.generate(
        model, batch["tokens"], max_new=new, max_len=max_len)))

    # teacher-forced: both fed the kernel run's tokens (or the same frames)
    def forced(w):
        model.backend = w
        with recording_routes([]) as r:
            if by_generate:
                out = engine.teacher_forced_logits(model, batch["tokens"], toks,
                                                   max_len=max_len)
            else:
                out = serve_loop(model, batch, new, max_len, frames, forced=toks)[1]
        return out, r
    (fk, rfk), (fp, rfp) = forced("kernel"), forced("plain")
    keep = torch.ones(fk.shape[:2], dtype=torch.bool, device=dev)
    if rfp:         # a step whose input was routed differently in some layer
        flip, _ = route_flips(rfk, rfp, f"{tag} teacher-forced", cfg)
        n_moe = sum(f.shape[1] == s for f in flip)      # the prefill's calls
        keep[:, 0] = ~any_flip(flip[:n_moe])[:, -1]
        for i in range(1, new):                         # decode step i - 1
            keep[:, i] = ~any_flip(flip[n_moe * i:n_moe * (i + 1)])[:, 0]
    errs["forced_logits.l2"] = rel_l2(fp, fk)
    errs["forced_logits.max"] = rel_err(fp[keep], fk[keep])
    top2 = fp.float().topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > SERVE_MAX_TOL * float(fp.float().abs().max())) \
        & keep
    ref_tok = toks if toks is not None else fp.argmax(-1)
    agree_k = bool((fk.argmax(-1)[decided] == ref_tok[decided]).all())
    agree_p = bool((fp.argmax(-1)[decided] == ref_tok[decided]).all())
    if not (errs["forced_logits.max"] <= SERVE_MAX_TOL and agree_k and agree_p
            and bool(decided.any())):
        fail(f"{tag}: teacher-forced logits error {errs['forced_logits.max']} (tolerance "
             f"{SERVE_MAX_TOL}); tokens agree where the margin decides: kernel {agree_k}, "
             f"plain {agree_p} ({int(decided.sum())} of {decided.numel()} decided)")
    rate = {"kernel": b * new / (gen_s - ttft["kernel"]), "plain": b * new / (gen_p - ttft["plain"])}
    log(f"[zoo] {tag}: launches {dict((k, v) for k, v in launches.items() if v)}, 0 in "
        f"decode; TTFT kernel {ttft['kernel'] * 1e3:.2f} ms, plain {ttft['plain'] * 1e3:.2f} "
        f"ms (median of {ZOO_TTFT_REPEATS} in turns); decode kernel {rate['kernel']:.1f} "
        f"tok/s, plain {rate['plain']:.1f} tok/s; {'generate' if by_generate else 'prefill + decode_step'} "
        f"{gen_s:.3f} s (plain {gen_p:.3f} s); peak memory {peak / 2**30:.3f} GiB; "
        f"teacher-forced errors {errs['forced_logits.max']:.4g} max, "
        f"{int(decided.sum())}/{decided.numel()} steps decided by the margin, all agree; "
        f"{int((~keep).sum())} steps left out for a MoE routing flip")
    return dict(launches={k: v for k, v in launches.items() if v}, ttft_ms=ttft["kernel"] * 1e3,
                ttft_plain_ms=ttft["plain"] * 1e3, decode_tok_s=rate["kernel"],
                decode_tok_s_plain=rate["plain"], generate_s=gen_s, generate_plain_s=gen_p,
                peak_bytes=peak, errors=errs, layer_errors=layer_errs, moe_flips=flips,
                moe_layer_flips=layer_flips, decided=int(decided.sum()),
                steps=decided.numel(), path="generate" if by_generate else "prefill+decode_step")


def phase_zoo(dev):
    """Each ZOO arch at full width (depth cut as ZOO says) from a seeded
    init on the card, one at a time, serving ZOO_REQUEST (zoo_request)."""
    from repro_torch.models import lm
    from repro_torch.models.config import MIXER_MAMBA
    results = {}
    for arch, layers in ZOO:
        cfg = zoo_config(arch, layers)
        torch.cuda.reset_peak_memory_stats()
        model, init_s = timed(lambda: lm.LM(
            cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
        n = sum(p.numel() for p in model.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        mixers = [cfg.pattern[i % len(cfg.pattern)].mixer for i in range(cfg.n_layers)]
        by_kernel = {"flash_attention": sum(m != MIXER_MAMBA for m in mixers),
                     "ssd_chunk_scan": sum(m == MIXER_MAMBA for m in mixers)}
        log(f"[zoo] {arch}: {cfg.n_layers} layers{' (cut)' if layers else ''}, d_model "
            f"{cfg.d_model}, {n / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} GB), seeded init "
            f"on the card in {init_s:.2f} s")
        rec = zoo_request(model, {k: v for k, v in by_kernel.items() if v}, dev)
        rec.update(layers=cfg.n_layers, params=n, param_bytes=nbytes, init_s=init_s)
        results[arch] = rec
        del model
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------- 5c. training

# The kernels' autograd Functions on the card: (b, hq, hkv, sq, sk, d, dv,
# causal, window, dtype) through models/attention.py's gqa ([B, S, H, D]
# storage read through [B, H, S, D] views, v a slice of a wider tensor
# where dv < d, as MLA's) and (BH, BG, L, P, N, chunk, B/C dtype) through
# ssd_ops.ssd_chunk_scan, against autograd through the plain versions.
# The first of each is a training microbatch at full width: qwen3-0.6b's
# attention and mamba2-780m's SSD operands at B=4, S=1024.
GRAD_FLASH_CASES = (
    (4, 16, 8, 1024, 1024, 128, 128, True, 0, torch.bfloat16),
    (2, 4, 2, 300, 300, 64, 64, True, 0, torch.float32),
    (1, 4, 2, 256, 256, 64, 64, True, 64, torch.bfloat16),      # sliding window
    (2, 8, 2, 128, 512, 128, 128, False, 0, torch.bfloat16),    # cross: Sk > Sq
    (2, 8, 8, 256, 256, 96, 64, True, 0, torch.bfloat16),       # MLA: dv < d
    (1, 4, 4, 200, 200, 96, 64, True, 0, torch.float32),
)
GRAD_SSD_CASES = (
    (192, 4, 1024, 64, 128, 128, torch.bfloat16),
    (12, 4, 256, 64, 128, 128, torch.bfloat16),      # (G, rep) = (2, 3)
    (12, 4, 96, 16, 32, 48, torch.float32),
)
# output and gradients, max |d| / max |ref|: the backward is the plain
# version's on both sides (the dense oracle against autograd through the
# tiled version: f32 sums in another order), so the gradients differ by
# their one bf16 rounding; the outputs by the kernels' FLASH_TOL / SSD_TOL
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TRAIN_MODELS = (("qwen3-0.6b", "flash_attention"), ("mamba2-780m", "ssd_chunk_scan"))
TRAIN_KERNEL = dict(TRAIN_MODELS)
TRAIN_BATCH = (8, 1024, 2)      # global batch, sequence, microbatches: 8192 tokens a step
TRAIN_STEPS = 4
TRAIN_ADAM = dict(lr=3e-4, warmup_steps=2)
TRAIN_PLAIN_TURNS = 1           # steps a backend, in turns (kernels, plain), for the plain step time
# kernels against plain at full width, one 4 x 1024 microbatch from the
# same weights: the loss within TRAIN_LOSS_REL (relative) and each
# parameter's gradient within TRAIN_GRAD_REL_L2 (relative L2).  Both
# backwards are the plain versions'; the forwards round otherwise (P in
# bf16 before P.V, split TF32), and bf16 weights and activations carry
# that through 28 / 48 layers and back.  The spread of the kernels' path
# with itself, the same microbatch as four of one row (other GEMM shapes,
# the same function), measures that noise, and this phase prints it
# beside the gate: on mamba2-780m it is about half of the kernels'
# distance from the plain versions, which is ~4.5 % of the whole gradient,
# its worst leaves A_log (48 per-head sums over 4096 tokens that cancel)
# up to ~10 %.  So each leaf is held to 5e-2 on qwen3-0.6b and 0.15 on
# mamba2-780m, and the whole gradient to TRAIN_FLOOR_FACTOR times the spread
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = {"qwen3-0.6b": 5e-2, "mamba2-780m": 0.15}
TRAIN_FLOOR_FACTOR = 3.0
RESTART = (4, 2)                # steps, the checkpoint's step
RESTART_LAYERS = 4              # qwen3-0.6b's depth in the restart (the checkpoint's size)


def grad_rel(want, got) -> float:
    want, got = want.detach(), got.detach()
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def flash_grad_errors(case, dev, seed=0):
    """One GRAD_FLASH_CASES case through gqa with the kernel backend
    (FlashAttention: the kernel forward, the plain backward) and the plain
    one, the same seeded inputs and output weights: each of out, dq, dk, dv
    as max |d| / max |ref|, and the kernel's launches (forward, backward)."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import attention as A
    b, hq, hkv, sq, sk, d, dv, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dt)
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dt)
    kv = torch.randn((b, sk, hkv, d + dv), generator=g, device=dev).to(dt)
    w = torch.randn((b, sq, hq, dv), generator=g, device=dev)
    res, launches = {}, []
    for backend in ("plain", "kernel"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, kv)]
        FK.reset_launches()
        out = A.gqa(leaves[0], leaves[1], leaves[2][..., d:], causal=causal, window=window,
                    backend=backend)
        fwd = FK.flash_attention.launches
        grads = torch.autograd.grad((out.float() * w).sum(), leaves)
        launches.append((fwd, FK.flash_attention.launches - fwd))
        res[backend] = (out, *grads)
    torch.cuda.synchronize()
    errs = {n: grad_rel(a, b_) for n, a, b_ in zip(("out", "dq", "dk", "dkv"),
                                                  res["plain"], res["kernel"])}
    if launches[0] != (0, 0):
        fail(f"flash_attention {case}: the plain backend launched {launches[0]}")
    return errs, launches[1]


def ssd_grad_errors(case, dev, seed=0):
    """One GRAD_SSD_CASES case through ssd_ops.ssd_chunk_scan with the
    kernel backend (SSDChunkScan) and the plain one: each output and each
    input's gradient (B/C in group form) as max |d| / max |ref|, and the
    kernel's launches (forward, backward)."""
    from repro_torch.kernels.ssd_scan import kernel as SK, ops as SO
    bh, bg, L, P, N, chunk, dt = case
    g = torch.Generator(device=dev).manual_seed(seed)
    ins = [torch.randn((bh, L, P), generator=g, device=dev),
           -torch.rand((bh, L), generator=g, device=dev) * 0.5,
           (torch.randn((bg, L, N), generator=g, device=dev) * 0.3).to(dt),
           (torch.randn((bg, L, N), generator=g, device=dev) * 0.3).to(dt)]
    ws = None
    res, launches = {}, []
    for backend in ("plain", "kernel"):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        SK.reset_launches()
        outs = SO.ssd_chunk_scan(*leaves, chunk=chunk, backend=backend)
        fwd = SK.ssd_chunk_scan.launches
        if ws is None:
            ws = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
        grads = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, ws)), leaves)
        launches.append((fwd, SK.ssd_chunk_scan.launches - fwd))
        res[backend] = (*outs, *grads)
    torch.cuda.synchronize()
    names = ("y", "s", "t", "dx", "dloga", "dB", "dC")
    errs = {n: grad_rel(a, b_) for n, a, b_ in zip(names, res["plain"], res["kernel"])}
    if launches[0] != (0, 0):
        fail(f"ssd_chunk_scan {case}: the plain backend launched {launches[0]}")
    return errs, launches[1]


def grad_tolerance(name, dt):
    """The bound of one output or gradient of a GRAD_*_CASES case."""
    if name == "out":
        return FLASH_TOL[dt]
    if name in ("y", "s", "t"):
        return SSD_TOL
    return GRAD_TOL[dt]


def train_function_checks(dev):
    """The autograd Functions of flash_attention and ssd_chunk_scan on the
    card (GRAD_*_CASES): output and gradients against autograd through the
    plain versions; one kernel launch a forward, none in the backward."""
    out = {}
    for what, cases, fn in (("flash_attention", GRAD_FLASH_CASES, flash_grad_errors),
                            ("ssd_chunk_scan", GRAD_SSD_CASES, ssd_grad_errors)):
        worst = {}
        for case in cases:
            errs, launches = fn(case, dev)
            if launches != (1, 0):
                fail(f"{what} {case}: launches (forward, backward) {launches}, "
                     f"expected (1, 0)")
            for name, e in errs.items():
                tol = grad_tolerance(name, case[-1])
                if not e <= tol:
                    fail(f"{what} {case}: {name} {e} of the largest against the plain "
                         f"version's (tolerance {tol})")
                key = f"{name} {str(case[-1]).split('.')[-1]}"
                worst[key] = max(worst.get(key, 0.0), e)
        log(f"[train] {what} autograd Function against autograd through the plain version "
            f"({len(cases)} cases, worst max |d| / max |ref|): " + ", ".join(
                f"{k} {v:.3g}" for k, v in sorted(worst.items())))
        out[what] = worst
    return out


def train_batch(cfg, dev, b, s, seed=0):
    """A batch of the port's SyntheticLM (tokens, labels) on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.step import to_device
    return to_device(next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s,
                                                 global_batch=b, seed=seed))), dev)


def train_grads(model, batch):
    """(loss, metrics, gradients) of one microbatch through loss_fn, remat on."""
    from repro_torch.models import lm
    loss, met = lm.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), met, grads


def step_busy(step, model, opt, batch):
    """torch.profiler over one train step: its wall, the device's busy time
    (its kernels' sum) and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                kernels=sum(e.count for e in events),
                top=[dict(name=e.key, ms=dev_us(e) / 1e3, count=e.count) for e in top])


def train_model(arch, kname, dev):
    """One TRAIN_MODELS arch at full width from a seeded init: the loss and
    every gradient through the kernels against the plain versions, then
    TRAIN_STEPS steps of AdamW through the kernels, then the plain step
    time in turns."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step, to_device
    cfg = get_config(arch)
    gb, seq, micro = TRAIN_BATCH
    model, init_s = timed(lambda: lm.init_params(cfg, 0, device=dev))
    n = sum(p.numel() for p in model.parameters())
    layers = cfg.n_layers
    log(f"[train] {arch}: {layers} layers, d_model {cfg.d_model}, {n / 1e6:.1f} M "
        f"parameters, vocab {cfg.padded_vocab}; seeded init on the card in {init_s:.2f} s")
    rec = dict(params=n, layers=layers)

    # 1. kernels against plain: one microbatch, the same weights
    batch = train_batch(cfg, dev, gb // micro, seq)
    res = {}
    for backend in ("kernel", "plain"):
        model.backend = backend
        reset_counts()
        (loss, met, grads), sec = timed(lambda: train_grads(model, batch))
        res[backend] = (loss, grads, read_counts(), sec)
    model.backend = "kernel"
    want_launches = 2 * layers          # the forward's and remat's recompute
    counts = res["kernel"][2]
    if counts[kname] != want_launches or counts[f"{kname}:tc"] != want_launches:
        fail(f"{arch}: {kname} launched {counts[kname]} times ({counts[f'{kname}:tc']} on "
             f"the tensor cores) in a microbatch's forward and backward, expected "
             f"{want_launches} (each layer, and again in its remat recompute)")
    other = "ssd_chunk_scan" if kname == "flash_attention" else "flash_attention"
    if counts[other] or res["plain"][2][kname] or res["plain"][2][other]:
        fail(f"{arch}: unexpected launches {counts}, plain {res['plain'][2]}")
    loss_err = abs(float(res["kernel"][0]) - float(res["plain"][0])) / abs(
        float(res["plain"][0]))
    if not loss_err <= TRAIN_LOSS_REL:
        fail(f"{arch}: loss {float(res['kernel'][0])} through the kernels, "
             f"{float(res['plain'][0])} through the plain versions ({loss_err} apart, "
             f"tolerance {TRAIN_LOSS_REL})")
    names = [nm for nm, _ in model.named_parameters()]
    errs = {nm: rel_l2(p, k) for nm, k, p in zip(names, res["kernel"][1], res["plain"][1])}
    worst = max(errs, key=errs.get)
    tol = TRAIN_GRAD_REL_L2[arch]
    if not errs[worst] <= tol:
        fail(f"{arch}: gradient of {worst} {errs[worst]} (relative L2) through the kernels "
             f"against the plain versions (tolerance {tol})")
    if not all(bool(torch.isfinite(g).all()) for g in res["kernel"][1]):
        fail(f"{arch}: a gradient through the kernels is not finite")
    # the noise: the same microbatch through the kernels as four of one row
    rows = [train_grads(model, {k: v[i:i + 1] for k, v in batch.items()})[2]
            for i in range(gb // micro)]
    split = [sum(r[j].float() for r in rows) / len(rows) for j in range(len(names))]
    whole = lambda a, b_: rel_l2(torch.cat([t.flatten().float() for t in a]),  # noqa: E731
                                 torch.cat([t.flatten().float() for t in b_]))
    floor = whole(res["kernel"][1], split)
    apart = whole(res["plain"][1], res["kernel"][1])
    if not apart <= TRAIN_FLOOR_FACTOR * floor:
        fail(f"{arch}: the whole gradient {apart} (relative L2) through the kernels against "
             f"the plain versions, above {TRAIN_FLOOR_FACTOR} times the spread of the "
             f"kernels' own gradient when the microbatch is split in rows ({floor})")
    above = sorted((nm for nm, e in errs.items() if e > 5e-2), key=errs.get, reverse=True)
    rec["grads"] = dict(loss_kernel=float(res["kernel"][0]), loss_plain=float(res["plain"][0]),
                        loss_rel=loss_err, worst_leaf=worst, worst_rel_l2=errs[worst],
                        median_rel_l2=float(np.median(list(errs.values()))),
                        whole_rel_l2=apart, floor_rel_l2=floor, leaves=len(errs),
                        leaves_above_5e_2=len(above), tolerance=tol,
                        worst8={nm: errs[nm] for nm in sorted(errs, key=errs.get)[-8:]},
                        launches=counts[kname], microbatch_s=res["kernel"][3],
                        microbatch_plain_s=res["plain"][3])
    log(f"[train] {arch} B={gb // micro} x {seq}: loss {float(res['kernel'][0]):.5f} through "
        f"the kernels, {float(res['plain'][0]):.5f} plain ({loss_err:.2e} apart); "
        f"{len(errs)} gradients, worst {worst} {errs[worst]:.4f} relative L2 (tolerance "
        f"{tol}), median {rec['grads']['median_rel_l2']:.4f}, {len(above)} above 5e-2; the "
        f"whole gradient {apart:.4f} apart, the kernels' own spread over a row split "
        f"{floor:.4f}; {kname} {counts[kname]} launches (forward + remat recompute), "
        f"forward + backward {res['kernel'][3]:.3f} s (plain {res['plain'][3]:.3f} s)")
    del res, grads, rows, split

    # 2. steps through the kernels
    tcfg = TrainConfig(adam=adamw.AdamWConfig(**TRAIN_ADAM), microbatches=micro)
    opt = adamw.init(tcfg.adam, model)
    step = make_train_step(cfg, tcfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        b = to_device(next(data), dev)
        stats, sec = timed(lambda: step(model, opt, b))
        losses.append(float(stats["loss"]))
        gnorms.append(float(stats["grad_norm"]))
        walls.append(sec)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = counts[kname] / TRAIN_STEPS
    if per_step != 2 * micro * layers:
        fail(f"{arch}: {kname} {per_step} launches a step, expected {2 * micro * layers}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"{arch}: a loss or gradient norm is not finite: {losses}, {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{arch}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_s = float(np.median(walls[1:]))
    tokens = gb * seq
    # forward and backward of one microbatch, apart
    model.backend = "kernel"
    mb = to_device({k: v[: gb // micro] for k, v in next(data).items()}, dev)
    (loss_met), fwd_s = timed(lambda: lm.loss_fn(model, mb))
    _, bwd_s = timed(lambda: torch.autograd.grad(loss_met[0], list(model.parameters())))
    del loss_met
    prof = step_busy(step, model, opt, to_device(next(data), dev))
    # the plain versions' step time, in turns with the kernels'
    turns = {"kernel": [], "plain": []}
    for _ in range(TRAIN_PLAIN_TURNS):
        for backend in ("kernel", "plain"):
            model.backend = backend
            b = to_device(next(data), dev)
            turns[backend].append(timed(lambda: step(model, opt, b))[1])
    model.backend = "kernel"
    rec["steps"] = dict(losses=losses, grad_norms=gnorms, walls_s=walls, step_s=step_s,
                        tokens_per_step=tokens, tokens_per_s=tokens / step_s,
                        launches_per_step=per_step, peak_bytes=peak,
                        microbatch_forward_s=fwd_s, microbatch_backward_s=bwd_s,
                        profile=prof, turns_s=turns,
                        kernel_step_s_turns=float(np.median(turns["kernel"])),
                        plain_step_s_turns=float(np.median(turns["plain"])))
    log(f"[train] {arch}: {TRAIN_STEPS} steps of {gb} x {seq} tokens in {micro} microbatches "
        f"(AdamW lr {TRAIN_ADAM['lr']}, warmup {TRAIN_ADAM['warmup_steps']}): loss "
        + " ".join(f"{x:.4f}" for x in losses) + "; grad norm "
        + " ".join(f"{x:.3f}" for x in gnorms))
    log(f"[train] {arch}: step {step_s:.4f} s (median of steps 2-{TRAIN_STEPS}; first "
        f"{walls[0]:.3f} s), {tokens / step_s:,.0f} tokens/s; a microbatch's forward "
        f"{fwd_s:.4f} s, backward {bwd_s:.4f} s; peak memory {peak / 2**30:.3f} GiB; "
        f"{kname} {per_step:.0f} launches a step; device busy {prof['busy_share'] * 100:.1f} % "
        f"of a {prof['wall_s']:.4f} s step ({prof['kernels']} kernels); in turns: kernels "
        f"{rec['steps']['kernel_step_s_turns']:.4f} s a step, plain "
        f"{rec['steps']['plain_step_s_turns']:.4f} s")
    for e in prof["top"]:
        log(f"[train]   {e['ms']:9.2f} ms  x{e['count']:5d}  {e['name'][:90]}")
    del model, opt, step
    torch.cuda.empty_cache()
    return rec


def train_restart(dev, directory):
    """qwen3-0.6b through the training loop: RESTART[1] steps with a
    checkpoint at the end, a restart from it to RESTART[0], and an
    uninterrupted run of RESTART[0] steps, in one process under
    torch.use_deterministic_algorithms(True): the resumed losses, final
    parameters and optimizer state equal the uninterrupted run's bit for
    bit.  ``warn_only``: an operation with no deterministic version warns
    (cuBLAS among them, whose workspace setting the script leaves as it
    is: one stream), and the bit-for-bit gate is the test."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainConfig
    cfg = zoo_config("qwen3-0.6b", RESTART_LAYERS)
    gb, seq, micro = TRAIN_BATCH
    tcfg = TrainConfig(adam=adamw.AdamWConfig(**TRAIN_ADAM), microbatches=micro)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=2)
    steps, at = RESTART
    quiet = dict(device=dev, log=lambda *_: None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (_, _, first), s1 = timed(lambda: train(cfg, tcfg, LoopConfig(
            steps=at, ckpt_dir=directory, ckpt_every=at), dcfg, **quiet))
        (m2, o2, rest), s2 = timed(lambda: train(cfg, tcfg, LoopConfig(
            steps=steps, ckpt_dir=directory, ckpt_every=steps * 10), dcfg, **quiet))
        resumed = {k: v.detach().clone() for k, v in m2.state_dict().items()}
        opt2 = {f"{kind}.{n}": t for kind in ("mu", "nu") for n, t in getattr(o2, kind).items()}
        del m2
        (m3, o3, whole), s3 = timed(lambda: train(cfg, tcfg, LoopConfig(steps=steps), dcfg,
                                                  **quiet))
    finally:
        torch.use_deterministic_algorithms(False)
    if len(rest) != steps - at or first + rest != whole:
        fail(f"restart: losses {first} + {rest} resumed, {whole} uninterrupted")
    differ = [k for k, v in m3.state_dict().items() if not bit_equal(v, resumed[k])]
    differ += [k for k, t in opt2.items()
               if not bit_equal(t, getattr(o3, k.split(".")[0])[k.split(".", 1)[1]])]
    if differ or int(o2.step) != int(o3.step):
        fail(f"restart: {len(differ)} leaves differ from the uninterrupted run's "
             f"(first: {differ[:3]}); steps {int(o2.step)}, {int(o3.step)}")
    nbytes = sum(f.stat().st_size for f in Path(directory).rglob("*") if f.is_file())
    log(f"[train] restart: qwen3-0.6b ({cfg.n_layers} layers) {at} steps and a checkpoint "
        f"({nbytes / 1e9:.2f} GB) "
        f"in {s1:.1f} s, resumed to step {steps} in {s2:.1f} s, uninterrupted {steps} steps "
        f"in {s3:.1f} s; losses {whole} equal, parameters and moments equal bit for bit "
        f"(deterministic algorithms on)")
    del m3, o3
    torch.cuda.empty_cache()
    return dict(losses=whole, checkpoint_bytes=nbytes, first_s=s1, resumed_s=s2,
                whole_s=s3, deterministic=True, bit_equal=True)


def phase_train(dev):
    """5c: TRAIN_MODELS at full width, one at a time (train_model), then
    the restart (train_restart)."""
    import tempfile
    results = {}
    for arch, kname in TRAIN_MODELS:
        results[arch] = train_model(arch, kname, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        results["restart"] = train_restart(dev, d)
    return results


# --------------------------------------------------------- 5d. sharded

# The train step through the sharded-training layer on a one-rank (1, 1)
# mesh: (arch, kernel, layers on the card; None: the whole depth).  A 1 x 1
# mesh moves no data, so the sharded step is held to the unsharded kernel
# path bit for bit, and where it is not, to phase 5c's gates.
SHARDED_MODELS = (("qwen3-0.6b", "flash_attention", None),
                  ("mamba2-780m", "ssd_chunk_scan", 4))
SHARDED_BATCH = (4, 1024)       # one microbatch: batch, sequence
# the MoE arch of phase 5d at full width, cut in depth to 1 layer of 56
# (one layer is ~2.9 G parameters with the embedding and head: bf16
# weights and gradients, f32 gradient sums and ARCH_RUN's two bf16
# moments are ~35 GB a path before the update's f32 temporaries, so the
# two paths run one after another, the unsharded one's results kept on
# the host), under ARCH_RUN's fsdp and sequence parallelism
SHARDED_MOE = ("mixtral-8x22b", "flash_attention", 1)
SHARDED_TURNS = 2               # timed turns of each path: (unsharded, sharded), then reversed


def tensor_of(t):
    """A DTensor's local tensor (on a one-rank mesh: the whole tensor)."""
    return t.to_local() if hasattr(t, "to_local") else t


def compare_trees(arch, what, want: dict, got: dict, tol):
    """(leaves bit-equal, the worst leaf, its relative L2) of two
    ``{name: tensor}``; fails past ``tol``."""
    equal, worst, worst_e = 0, None, 0.0
    for name, w in want.items():
        g = tensor_of(got[name]).detach()
        w = w.detach().to(g.device)
        if g.dtype == w.dtype and bit_equal(g, w):
            equal += 1
            continue
        e = rel_l2(w.float(), g.float())
        if worst is None or e > worst_e:
            worst, worst_e = name, e
    if worst is not None and not worst_e <= tol:
        fail(f"[sharded] {arch} {what}: {worst} {worst_e} relative L2 from the unsharded "
             f"path (tolerance {tol})")
    return equal, worst, worst_e


def sharded_model(arch, kname, layers, dev, sh):
    """(cfg, the unsharded model from the seeded init, the same weights
    placed as DTensors by param_specs, their specs)."""
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    cfg = zoo_config(arch, layers)
    plain = lm.LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    placed = lm.LM(cfg, device=dev)
    placed.load_state_dict(plain.state_dict())
    specs = S.param_specs(cfg, sh, placed)
    return cfg, plain, S.distribute_model(placed, sh, specs), specs


def sharded_train(arch, kname, layers, dev, sh):
    """One SHARDED_MODELS arch: a microbatch's loss and every gradient,
    then one AdamW step (ZeRO-1 moments), through the sharded path against
    the unsharded kernel path on the same weights; launches counted in
    each run; the step's wall in turns."""
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.models.config import MIXER_MAMBA
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg, plain, placed, specs = sharded_model(arch, kname, layers, dev, sh)
    n_kernel = sum((cfg.pattern[i % len(cfg.pattern)].mixer == MIXER_MAMBA)
                   == (kname == "ssd_chunk_scan") for i in range(cfg.n_layers))
    want = {kname: 2 * n_kernel, ("ssd_chunk_scan" if kname == "flash_attention"
                                  else "flash_attention"): 0}
    batch = train_batch(cfg, dev, *SHARDED_BATCH)
    bspecs = S.batch_specs(cfg, sh, batch)
    placed_batch = {k: sh.distribute(v, bspecs[k]) for k, v in batch.items()}
    names = [n for n, _ in plain.named_parameters()]

    def counted(fn):
        reset_counts()
        out, sec = timed(fn)
        counts = read_counts()
        for k, n in want.items():
            if counts[k] != n:
                fail(f"[sharded] {arch}: {k} launched {counts[k]} times, expected {n} "
                     f"(2 a layer that runs it: the forward and remat's recompute)")
        return out, sec

    (loss_u, _, grads_u), sec_u = counted(lambda: train_grads(plain, batch))

    def sharded_grads():
        loss, _ = lm.loss_fn(placed, placed_batch, sh)
        return loss.detach(), torch.autograd.grad(loss, list(placed.parameters()))
    (loss_s, grads_s), sec_s = counted(sharded_grads)
    lu, ls = float(loss_u), float(tensor_of(loss_s))
    loss_equal = bit_equal(tensor_of(loss_s), loss_u)
    loss_rel = abs(ls - lu) / abs(lu)
    if not loss_rel <= TRAIN_LOSS_REL:
        fail(f"[sharded] {arch}: loss {ls} sharded, {lu} unsharded ({loss_rel} apart)")
    g_equal, g_worst, g_e = compare_trees(arch, "gradients", dict(zip(names, grads_u)),
                                          dict(zip(names, grads_s)), TRAIN_GRAD_REL_L2[arch])
    placements = {n: str(p.placements) for n, p in placed.named_parameters()}
    del grads_u, grads_s

    # one AdamW step, ZeRO-1 moments (on a 1 x 1 mesh the data axis splits nothing)
    acfg = adamw.AdamWConfig(**TRAIN_ADAM)
    tcfg = TrainConfig(adam=acfg, microbatches=1)
    opt_u = adamw.init(acfg, plain)
    shapes = {k: v for k, v in plain.named_parameters()}
    opt_s = S.distribute_opt_state(adamw.init(acfg, plain), sh,
                                   adamw.zero1_state_specs(acfg, specs, shapes, sh))
    step_u = make_train_step(cfg, tcfg, device=dev)
    step_s = make_train_step(cfg, tcfg, sh, device=dev)
    stats_u, wall_u = counted(lambda: step_u(plain, opt_u, batch))
    stats_s, wall_s = counted(lambda: step_s(placed, opt_s, batch))
    p_equal, p_worst, p_e = compare_trees(arch, "parameters after a step",
                                          dict(plain.named_parameters()),
                                          dict(placed.named_parameters()),
                                          TRAIN_GRAD_REL_L2[arch])
    m_equal, m_worst, m_e = compare_trees(arch, "first moments after a step", opt_u.mu,
                                          opt_s.mu, TRAIN_GRAD_REL_L2[arch])
    v_equal, v_worst, v_e = compare_trees(arch, "second moments after a step", opt_u.nu,
                                          opt_s.nu, TRAIN_GRAD_REL_L2[arch])
    gnorm_equal = bit_equal(tensor_of(stats_s["grad_norm"]), stats_u["grad_norm"])
    # the step's wall in turns (the two models stay on the same weights)
    turns = {"unsharded": [], "sharded": []}
    for t in range(SHARDED_TURNS):
        order = (("unsharded", step_u, plain, opt_u), ("sharded", step_s, placed, opt_s))
        for way, step, model, opt in (order if t % 2 == 0 else order[::-1]):
            turns[way].append(timed(lambda: step(model, opt, batch))[1])
    n = len(names)
    rec = dict(layers=cfg.n_layers, launches=want[kname], loss_unsharded=lu, loss_sharded=ls,
               loss_bit_equal=loss_equal, loss_rel=loss_rel,
               grads_bit_equal=g_equal, grads=n, grad_worst=g_worst, grad_worst_rel_l2=g_e,
               params_bit_equal=p_equal, param_worst=p_worst, param_worst_rel_l2=p_e,
               mu_bit_equal=m_equal, mu_worst=m_worst, nu_bit_equal=v_equal, nu_worst=v_worst,
               moment_worst_rel_l2=max(m_e, v_e), grad_norm_bit_equal=gnorm_equal,
               microbatch_s=dict(unsharded=sec_u, sharded=sec_s),
               first_step_s=dict(unsharded=wall_u, sharded=wall_s), turns_s=turns,
               step_s=dict(unsharded=float(np.median(turns["unsharded"])),
                           sharded=float(np.median(turns["sharded"]))),
               placements=dict(list(placements.items())[:6]))
    log(f"[sharded] {arch} ({cfg.n_layers} layers, B={SHARDED_BATCH[0]} x "
        f"{SHARDED_BATCH[1]}) on the 1 x 1 mesh: loss {ls:.6f} sharded, {lu:.6f} "
        f"unsharded ({'bit-equal' if loss_equal else f'{loss_rel:.2e} apart'}); "
        f"gradients bit-equal {g_equal}/{n}" + (f" (worst {g_worst} {g_e:.2e})" if g_worst
                                                else "")
        + f"; after one AdamW step parameters {p_equal}/{n}, mu {m_equal}/{n}, nu {v_equal}/{n} "
        f"bit-equal" + (f" (worst {p_worst or m_worst or v_worst}, {max(p_e, m_e, v_e):.2e})"
                        if (p_worst or m_worst or v_worst) else "")
        + f", grad norm {'bit-equal' if gnorm_equal else 'differs'}; {kname} "
        f"{want[kname]} launches a microbatch on each path (forward + remat recompute)")
    log(f"[sharded] {arch}: forward + backward {sec_u:.3f} s unsharded, {sec_s:.3f} s sharded "
        f"(first calls); a step in turns (median of {SHARDED_TURNS}): unsharded "
        f"{rec['step_s']['unsharded']:.3f} s, sharded {rec['step_s']['sharded']:.3f} s "
        f"(turns {turns})")
    del plain, placed, opt_u, opt_s
    torch.cuda.empty_cache()
    return rec


def route_calls_differ(want, got):
    """Tokens a MoE route call of one path sent to another set of experts
    than the same call of the other path (recording_routes' records)."""
    return [int((w[2].sort(-1).values != g[2].sort(-1).values).any(-1).sum())
            for w, g in zip(want, got)]


def sharded_train_moe(arch, kname, layers, dev, sh):
    """SHARDED_MOE: one microbatch's loss and every gradient, then one
    AdamW step (ZeRO-1 moments), through the sharded path (the MoE routing
    and dispatch in each rank's local region) against the unsharded
    kernel path on the same seeded weights, bit for bit, else the worst
    leaf held to phase 5c's qwen3-0.6b gate; the moments in ARCH_RUN's
    dtype (bf16 for the MoE archs); the unsharded path first,
    its gradients, parameters and moments copied to the host; each path's
    routes recorded (a token routed otherwise is counted and printed);
    launches counted in each run; the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch.dryrun import ARCH_RUN
    from repro_torch.models import lm
    from repro_torch.models.config import MIXER_ATTN
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = zoo_config(arch, layers)
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)].mixer == MIXER_ATTN
                 for i in range(cfg.n_layers))
    want = {kname: 2 * n_attn, "ssd_chunk_scan": 0}
    tol = TRAIN_GRAD_REL_L2["qwen3-0.6b"]
    run = ARCH_RUN[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = train_batch(cfg, dev, *SHARDED_BATCH)
    acfg = adamw.AdamWConfig(**TRAIN_ADAM, moment_dtype=run["adam"])
    tcfg = TrainConfig(adam=acfg, microbatches=1)

    def seeded():
        return lm.LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    def counted(fn):
        reset_counts()
        out, sec = timed(fn)
        counts = read_counts()
        for k, n in want.items():
            if counts[k] != n:
                fail(f"[sharded] {arch}: {k} launched {counts[k]} times, expected {n}")
        return out, sec

    # the unsharded kernel path, its results to the host
    plain = seeded()
    names = [n for n, _ in plain.named_parameters()]
    with recording_routes([]) as routes_u:
        (loss_u, _, grads_u), sec_u = counted(lambda: train_grads(plain, batch))
    host_grads = {n: g.cpu() for n, g in zip(names, grads_u)}
    del grads_u
    opt_u = adamw.init(acfg, plain)
    stats_u, wall_u = counted(lambda: make_train_step(cfg, tcfg, device=dev)(plain, opt_u,
                                                                             batch))
    host = {"params": {n: p.detach().cpu() for n, p in plain.named_parameters()},
            "mu": {n: t.cpu() for n, t in opt_u.mu.items()},
            "nu": {n: t.cpu() for n, t in opt_u.nu.items()}}
    gnorm_u = stats_u["grad_norm"].cpu()
    del plain, opt_u, stats_u
    peak_u = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the sharded path on the same seeded weights (its moments made before
    # the placed copies replace the weights, which then go)
    placed = seeded()
    specs = S.param_specs(cfg, sh, placed, fsdp=run["fsdp"])
    shapes = {k: v.detach() for k, v in placed.named_parameters()}
    S.distribute_model(placed, sh, specs)
    opt_s = S.distribute_opt_state(adamw.init(acfg, shapes), sh,
                                   adamw.zero1_state_specs(acfg, specs, shapes, sh))
    del shapes
    bspecs = S.batch_specs(cfg, sh, batch)
    placed_batch = {k: sh.distribute(v, bspecs[k]) for k, v in batch.items()}

    def sharded_grads():
        loss, _ = lm.loss_fn(placed, placed_batch, sh)
        return loss.detach(), torch.autograd.grad(loss, list(placed.parameters()))
    with recording_routes([]) as routes_s:
        (loss_s, grads_s), sec_s = counted(sharded_grads)
    n_calls = len(routes_u) // 2          # the forward's calls (remat repeats them)
    flips = route_calls_differ(routes_u[:n_calls], routes_s[:n_calls])
    del routes_u[:], routes_s[:]
    lu, ls = float(loss_u), float(tensor_of(loss_s))
    loss_equal = bit_equal(tensor_of(loss_s), loss_u)
    loss_rel = abs(ls - lu) / abs(lu)
    if not loss_rel <= TRAIN_LOSS_REL:
        fail(f"[sharded] {arch}: loss {ls} sharded, {lu} unsharded ({loss_rel} apart)")
    g_equal, g_worst, g_e = compare_trees(arch, "gradients", host_grads,
                                          dict(zip(names, grads_s)), tol)
    placements = {n: str(p.placements) for n, p in placed.named_parameters()}
    del grads_s, host_grads
    stats_s, wall_s = counted(lambda: make_train_step(cfg, tcfg, sh, device=dev)(
        placed, opt_s, batch))
    p_equal, p_worst, p_e = compare_trees(arch, "parameters after a step", host["params"],
                                          dict(placed.named_parameters()), tol)
    m_equal, m_worst, m_e = compare_trees(arch, "first moments after a step", host["mu"],
                                          opt_s.mu, tol)
    v_equal, v_worst, v_e = compare_trees(arch, "second moments after a step", host["nu"],
                                          opt_s.nu, tol)
    gnorm_equal = bit_equal(tensor_of(stats_s["grad_norm"]), gnorm_u)
    peak = dict(unsharded=peak_u, sharded=torch.cuda.max_memory_allocated())
    n = len(names)
    rec = dict(layers=cfg.n_layers, launches=want[kname], loss_unsharded=lu, loss_sharded=ls,
               loss_bit_equal=loss_equal, loss_rel=loss_rel, route_flips=flips,
               grads_bit_equal=g_equal, grads=n, grad_worst=g_worst, grad_worst_rel_l2=g_e,
               params_bit_equal=p_equal, param_worst=p_worst, param_worst_rel_l2=p_e,
               mu_bit_equal=m_equal, mu_worst=m_worst, nu_bit_equal=v_equal, nu_worst=v_worst,
               moment_worst_rel_l2=max(m_e, v_e), grad_norm_bit_equal=gnorm_equal,
               microbatch_s=dict(unsharded=sec_u, sharded=sec_s),
               first_step_s=dict(unsharded=wall_u, sharded=wall_s), peak_bytes=peak,
               params=sum(host["params"][k].numel() for k in names),
               placements={k: v for k, v in placements.items() if ".ffn." in k})
    log(f"[sharded] {arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers, "
        f"{rec['params'] / 1e9:.3f} G parameters, B={SHARDED_BATCH[0]} x "
        f"{SHARDED_BATCH[1]}, fsdp {run['fsdp']}, sequence parallel {run['sp']}) on the "
        f"1 x 1 mesh: loss {ls:.6f} sharded, {lu:.6f} unsharded "
        f"({'bit-equal' if loss_equal else f'{loss_rel:.2e} apart'}); MoE tokens routed "
        f"otherwise {flips}; gradients bit-equal {g_equal}/{n}"
        + (f" (worst {g_worst} {g_e:.2e})" if g_worst else "")
        + f"; after one AdamW step parameters {p_equal}/{n}, mu {m_equal}/{n}, nu "
        f"{v_equal}/{n} bit-equal" + (f" (worst {p_worst or m_worst or v_worst}, "
                                      f"{max(p_e, m_e, v_e):.2e})"
                                      if (p_worst or m_worst or v_worst) else "")
        + f", grad norm {'bit-equal' if gnorm_equal else 'differs'}; {kname} "
        f"{want[kname]} launches a microbatch on each path; forward + backward "
        f"{sec_u:.3f} s unsharded, {sec_s:.3f} s sharded; a step {wall_u:.3f} / "
        f"{wall_s:.3f} s (first calls); peak {peak['unsharded'] / 2**30:.2f} GiB "
        f"unsharded, {peak['sharded'] / 2**30:.2f} GiB sharded")
    del placed, opt_s, host
    torch.cuda.empty_cache()
    return rec


def sharded_compression(dev):
    """compressed_psum_mean over the one-rank group on qwen3-0.6b's
    flattened f32 gradient, on the card and on a CPU copy (a one-rank gloo
    group): codes, scales, mean and new error equal bit for bit."""
    import torch.distributed as dist

    from repro_torch.models import lm
    from repro_torch.train import compression as C
    cfg = zoo_config("qwen3-0.6b", None)
    model = lm.LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    _, _, grads = train_grads(model, train_batch(cfg, dev, *SHARDED_BATCH))
    g = torch.cat([x.float().flatten() for x in grads])
    del model, grads
    g = torch.nn.functional.pad(g, (0, (-g.numel()) % C.BLOCK))
    err = torch.zeros_like(g)
    cpu_group = dist.new_group(backend="gloo")
    (out, err2), wall = timed(lambda: C.compressed_psum_mean(g, err))
    (out_c, err_c) = C.compressed_psum_mean(g.cpu(), err.cpu(), cpu_group)
    q, s = C.quantize(g + err)
    q_c, s_c = C.quantize(g.cpu() + err.cpu())
    for name, a, b_ in (("codes", q, q_c), ("scales", s, s_c), ("mean", out, out_c),
                        ("error", err2, err_c)):
        if not bit_equal(a.cpu(), b_):
            fail(f"[sharded] compressed_psum_mean {name}: the card's differ from the CPU's "
                 f"(max |d| {float((a.cpu().double() - b_.double()).abs().max())})")
    dist.destroy_process_group(cpu_group)
    rel = float((out - g).abs().max() / g.abs().max())
    log(f"[sharded] compressed_psum_mean over the one-rank group: {g.numel()} f32 gradient "
        f"elements of qwen3-0.6b, {wall * 1e3:.2f} ms on the card; codes, scales, mean and "
        f"error equal to the CPU's bit for bit; mean within {rel:.2e} of the gradient")
    return dict(elements=g.numel(), wall_s=wall, bit_equal=True, max_rel=rel)


def phase_sharded(dev):
    """5d: a process group of one rank (nccl, a FileStore in a temporary
    directory), make_host_mesh, then SHARDED_MODELS through the sharded
    path and compressed_psum_mean; the group is destroyed at the end."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.dryrun import ARCH_RUN
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import Shardings
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as d:
        dist.init_process_group("nccl", store=dist.FileStore(f"{d}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh("cuda")
            sh = Shardings(mesh)
            results = {arch: sharded_train(arch, kname, layers, dev, sh)
                       for arch, kname, layers in SHARDED_MODELS}
            arch, kname, layers = SHARDED_MOE
            results[arch] = sharded_train_moe(
                arch, kname, layers, dev, Shardings(mesh, seq_shard=ARCH_RUN[arch]["sp"]))
            results["compression"] = sharded_compression(dev)
        finally:
            dist.destroy_process_group()
    return results


# ------------------------------------------------------------ 8. dry run

# the dry run's cells, in a process of their own started before the build
# (one torch thread; fake tensors: nothing is allocated, on the card or the
# host); phase 8 reads them
DRYRUN_CHILD = """
import json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
out = [dryrun.run_cell(arch, shape, multi_pod=mp, device="cpu", verbose=False,
                      run_overrides=ov)
       for arch, shape, mp, ov in json.loads(sys.argv[1])]
print(json.dumps(out))
"""


def start_dryrun():
    cells = [(arch, shape, mp, ov) for arch, shape, mp, ov, _ in DRYRUN_CELLS]
    return subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, json.dumps(cells)],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)


def phase_dryrun(child, started):
    """8: the dry run's DRYRUN_CELLS (run_cell: a fake world of 256 or 512
    ranks, the production mesh, the state placed by the specs under
    FakeTensorMode, the step once): each cell's state bytes a device equal
    to the pinned value, its FLOPs and collective bytes a device printed."""
    out, _ = child.communicate(timeout=1200)
    if child.returncode != 0:
        fail(f"the dry run's process exited {child.returncode}")
    results = json.loads(out)
    wall = time.perf_counter() - started
    for (arch, shape, mp, ov, pinned), res in zip(DRYRUN_CELLS, results):
        if not res["ok"] or res["state_bytes_per_device"] != pinned:
            fail(f"[dryrun] {arch} x {shape} x {res['mesh']}: ok {res['ok']}, state bytes "
                 f"{res['state_bytes_per_device']}, pinned {pinned}")
        coll = res["collectives"]
        log(f"[dryrun] {arch} x {shape} x {res['mesh']}{f' {ov}' if ov else ''}: state "
            f"{res['state_bytes_per_device'] / 2**30:.4f} GiB/device (pinned), "
            f"{res['flops']:.4e} FLOPs/device, fake step {res['step_s']:.1f} s; collectives "
            + ", ".join(f"{k} {coll[k] / 2**20:.1f} MiB x{coll['counts'][k]}"
                        for k in COLLECTIVE_KINDS))
    log(f"[dryrun] {len(results)} cells in their own process, done "
        f"{wall:.1f} s after it started")
    return dict(cells=results, wall_s=wall)


COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def dev_us(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


class DeviceEvent(NamedTuple):
    key: str                    # the kernel's (copy's, fill's) name
    count: int
    device_time_total: float    # us


def device_events(prof):
    """The device's own events (kernels, copies, fills) by name, summed from
    the profiler's raw records: the same counts and times as its
    key_averages(), whose per-operator event tree takes seconds for every
    ten thousand kernels."""
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            n, us = agg.get(e.name(), (0, 0.0))
            agg[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return [DeviceEvent(k, n, us) for k, (n, us) in agg.items()]


def profile_way(backend):
    """perm_1024n_3t one of the WAYS ("kernel": the fused departures,
    arrivals, control and sends launches; "split-arrivals", "split-control",
    "split-sends": that phase as the earlier design, its kernel with PyTorch
    glue; on this run's one flow a sender the split sends phase launches no
    kernel at all; "plain-departures": the departures phase in PyTorch):
    the host's time issuing each phase, its ``tick.<phase>`` spans over the
    first PROFILE_TICKS ticks (the queues load and trims start within them;
    this scenario never leaps; the tick's exit test is its one host read),
    then a torch.profiler window of 100 ticks for the device's busy share
    and its kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.trace_guard import recording
    from repro_torch.kernels.lanes import Tick
    from repro_torch.netsim import scenarios, state
    acts = [ProfilerActivity.CUDA]
    sc = scenarios.scenario("perm_1024n_3t", **WAYS[backend])
    sim = sc.build(device="cuda")
    c1 = sim.lanes_of(None, 1)                  # the run as a batch of one lane
    live = torch.ones((1,), dtype=torch.bool, device="cuda")
    st = state.init_lanes(sim.dims, sim.consts, None, [0])
    t = 0
    torch.cuda.synchronize()
    with recording() as rec:
        while t < PROFILE_TICKS and not bool(st.done.all()):
            st = sim.tick(c1, st, Tick(st.now, live, (t,), (True,)))
            t += 1
    per = {name: 0 for name, _ in sim.lane_phases}
    for sp in rec.spans:
        per[sp.name.removeprefix("tick.")] += sp.end - sp.start
    per_tick = {k: v / t / 1e6 for k, v in per.items()}
    total = sum(per_tick.values())
    log(f"[profile] perm_1024n_3t {backend}: host time a phase over {t} ticks (its "
        f"tick.<phase> spans, no synchronize): " + ", ".join(
            f"{k} {v:.3f} ms/tick ({100 * v / total:.1f}%)" for k, v in per_tick.items()))

    st = state.init_lanes(sim.dims, sim.consts, None, [0])
    for t in range(20):                                  # warm
        st = sim.tick(c1, st, Tick(st.now, live, (t,), (True,)))
    torch.cuda.synchronize()
    ticks = 100
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(20, 20 + ticks):
            st = sim.tick(c1, st, Tick(st.now, live, (t,), (True,)))
            bool(st.done.all())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    if not busy:
        log("[profile] torch.profiler recorded no device time: busy share not measured")
    log(f"[profile] perm_1024n_3t {backend}: ticks 20-{20 + ticks} under torch.profiler: "
        f"wall {wall / ticks * 1e3:.3f} ms/tick, device busy {busy / ticks * 1e3:.4f} "
        f"ms/tick ({100 * busy / wall:.2f}% busy, {100 - 100 * busy / wall:.2f}% idle), "
        f"{launches / ticks:.1f} device kernels/tick")
    for e in top:
        log(f"[profile]   {dev_us(e) / ticks:9.3f} us/tick  x{e.count / ticks:5.2f}  "
            f"{e.key[:90]}")
    return dict(phase_host_ms_per_tick=per_tick,
                **{f"{k}_host_share": per_tick[k] / total
                   for k in ("departures", "control", "arrivals", "sends")},
                wall_ms_per_tick=wall / ticks * 1e3,
                device_busy_ms_per_tick=busy / ticks * 1e3,
                idle_share=1 - busy / wall if busy else None,
                kernels_per_tick=launches / ticks,
                top=[dict(name=e.key, us_per_tick=dev_us(e) / ticks,
                          per_tick=e.count / ticks) for e in top])


def phase_profile():
    """Where perm_1024n_3t's tick time goes, through the fused launches and
    through each earlier design (profile_way)."""
    return {way: profile_way(way) for way in (
        "kernel", "plain-departures", "split-arrivals", "split-control", "split-sends")}


# ------------------------------------------------------- 7. analysis

# (scenario, config overrides, ticks run before the programs are recorded;
# None: one base RTT and two)
ANALYSIS_AUDITS = (("tiny_3t", {}, None), ("perm_1024n_3t", {}, None),
                   ("perm_1024n_3t", {"algo": "eqds"}, None), ("alltoall_3t", {}, None),
                   ("corefail_128n_3t", {}, 520))
# the phases that are one launch of their own kernel a call (and EQDS's
# grants, one rr_pick)
FUSED_PHASES = ("departures", "arrivals", "control", "sends")

# the audits of phase 7, run in a process of their own: its torch.profiler
# sessions are the first of their process (a session after a long one, as
# phase 6's, was seen to lose device records)
ANALYSIS_AUDIT = """
import dataclasses, json, sys, time
sys.path.insert(0, "src")
from repro_torch.analysis import audit
from repro_torch.netsim import scenarios
out = []
for name, ov, ticks in json.loads(sys.argv[1]):
    sc = scenarios.scenario(name, **ov)
    if ov:
        sc = sc.with_(name=f"{name}+{ov['algo']}")
    t1 = time.perf_counter()
    f, r = audit.audit_scenario(sc, backends=("kernel", "plain"), device="cuda",
                                ticks=ticks, profile=True)
    out.append(dict(name=sc.name, algo=sc.cfg.algo, wall_s=time.perf_counter() - t1,
                    findings=[dataclasses.asdict(x) for x in f], rows=r))
print(json.dumps(out))
"""


def run_analysis_audits(audits):
    """audit_scenario of each of ``audits`` on the card, through the fused
    launches and the plain versions, profiled, in a fresh process."""
    torch.cuda.empty_cache()
    child = subprocess.Popen([sys.executable, "-c", ANALYSIS_AUDIT, json.dumps(audits)],
                             cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        out, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        fail(f"analysis: the audit process exited {child.returncode}")
    return json.loads(out)


def phase_analysis():
    """The static-analysis layer on the card: the linter, then the op
    auditor over ANALYSIS_AUDITS through the fused launches and the plain
    versions, with torch.profiler's device kernels of one call of each
    program beside its row."""
    from repro_torch.analysis import audit, lint
    from repro_torch.analysis.rules import Finding
    t0 = time.perf_counter()
    findings = list(lint.lint_repo())
    log(f"[analysis] lint_repo: {len(findings)} finding(s), "
        f"{sum(not f.allowlisted for f in findings)} unallowlisted")
    rows = []
    for sc in run_analysis_audits(ANALYSIS_AUDITS):
        f = [Finding(**x) for x in sc["findings"]]
        r = sc["rows"]
        findings.extend(f)
        rows.extend(r)
        log(f"[analysis] {sc['name']}: {len(f)} finding(s) ({sum(x.allowlisted for x in f)} "
            f"allowlisted), {sc['wall_s']:.1f} s")
        for row in r:
            log(f"[analysis]   {row['backend']:6s} {row['program']:10s} t={row['tick']}: "
                f"{row['aten_ops']:5d} aten ops, launches {row['launches_by_kernel'] or 0}, "
                f"{row['host_syncs']} host syncs, scatter/gather {row['scatter_ops']}/"
                f"{row['gather_ops']}, same at two ticks {row['static']}; torch.profiler: "
                + ("not profiled" if "profiler_kernels_raw" not in row else
                   f"{row['profiler_kernels']} device kernels a call (sessions "
                   f"{row['profiler_kernels_raw']})" if row["profiler_kernels"] is not None
                   else f"not measured (sessions {row['profiler_kernels_raw']})"))
        want = {p: p for p in FUSED_PHASES}
        if sc["algo"] in ("eqds", "eqds_smartt"):
            want["grants"] = "rr_pick"
        for row in r:
            if row["backend"] == "kernel" and row["program"] in want \
                    and row["launches_by_kernel"] != {want[row["program"]]: 1}:
                fail(f"analysis: {row['name']} launched {row['launches_by_kernel']}, "
                     f"expected one {want[row['program']]} launch a call")
    findings.extend(audit.classify_config())
    bad = [x for x in findings if not x.allowlisted]
    for x in bad:
        log(f"[analysis] FAIL {x}")
    if bad:
        fail(f"analysis: {len(bad)} unallowlisted finding(s); host syncs (JX003) at "
             f"{sorted({x.site for x in bad if x.rule == 'JX003'})}")
    wall = time.perf_counter() - t0
    log(f"[analysis] {len(findings)} finding(s), all allowlisted ("
        + ", ".join(sorted({x.allowed_by.split(':')[0] for x in findings})) + f"); "
        f"every fused phase one launch of its kernel a call; "
        f"{sum(x.rule == 'JX003' for x in findings)} host sync finding(s); {sum(r.get('profiler_kernels') is None for r in rows if 'profiler_kernels_raw' in r)}"
        f" profiled row(s) not measured; phase wall {wall:.1f} s")
    return dict(rows=rows, findings=len(findings), wall_s=wall)


# ------------------------------------------------------- 4f. the bridge

# collectives/bridge.py's estimate of the collectives of examples/
# torch_collective_estimate.py (a jamba-398b cross-pod gradient all-reduce,
# a dbrx expert-parallel all-to-all) under each transport, on 32 nodes of
# a 4:1 oversubscribed two-rack fabric.  The JAX package's values, pinned
# by tests/test_torch_bridge.py, as dataclasses.astuple(CollectiveEstimate):
BRIDGE_KW = dict(nodes=32, oversub=4)
BRIDGE_REFERENCE = {
    ("all-to-all", 4 << 20, "smartt"): ("all-to-all", "smartt", 32, 2097152, 1946, 506, 1.0,
                                        1.1353711790393013, 0, 0.8534152042834456),
    ("all-to-all", 4 << 20, "swift"): ("all-to-all", "swift", 32, 2097152, 1946, 506, 1.0,
                                       1.1353711790393013, 0, 0.8534152042834456),
    ("all-to-all", 4 << 20, "eqds"): ("all-to-all", "eqds", 32, 2097152, 1946, 506, 1.0,
                                      1.1353711790393013, 0, 0.8534152042834456),
    ("all-reduce", 8 << 20, "smartt"): ("all-reduce", "smartt", 32, 2097152, 2074, 2187,
                                        0.9483310470964792, 0.4540806420296421, 647,
                                        0.9893013307345078),
    ("all-reduce", 8 << 20, "swift"): ("all-reduce", "swift", 32, 2097152, 2074, 2214,
                                       0.9367660343270099, 0.7994065090475115, 459,
                                       0.9622939865978168),
    ("all-reduce", 8 << 20, "eqds"): ("all-reduce", "eqds", 32, 2097152, 2074, 2200,
                                      0.9427272727272727, 0.8629342475036375, 23544,
                                      0.9278546135238712),
}
# the CPU port's estimates, in a process of their own started before the
# build (one torch thread); phase 4f reads them
BRIDGE_CPU = """
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(1)
from repro_torch.collectives.bridge import estimate
cases = json.loads(sys.argv[1])
out = [dataclasses.astuple(estimate(kind, nbytes, algo=algo, device="cpu", **kw))
       for kind, nbytes, algo, kw in cases]
print(json.dumps(out))
"""


def start_bridge_cpu():
    cases = [(kind, nbytes, algo, BRIDGE_KW) for kind, nbytes, algo in BRIDGE_REFERENCE]
    return subprocess.Popen([sys.executable, "-c", BRIDGE_CPU, json.dumps(cases)],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)


def phase_bridge(bridge_cpu):
    """bridge.estimate of every BRIDGE_REFERENCE case on the card: every
    field equal to the pinned JAX values and to the CPU port's result."""
    from repro_torch.collectives.bridge import estimate
    out, _ = bridge_cpu.communicate(timeout=900)
    if bridge_cpu.returncode != 0:
        fail(f"the CPU port's bridge estimates exited {bridge_cpu.returncode}")
    cpu = [tuple(r) for r in json.loads(out)]
    rec = {}
    for (key, want), on_cpu in zip(BRIDGE_REFERENCE.items(), cpu):
        kind, nbytes, algo = key
        est, wall = timed(lambda: estimate(kind, nbytes, algo=algo, **BRIDGE_KW))
        got = dataclasses.astuple(est)
        if got != want or on_cpu != want:
            fail(f"bridge {key}: card {got}, CPU port {on_cpu}, JAX (pinned) {want}")
        rec[f"{kind} {nbytes} {algo}"] = dict(dataclasses.asdict(est), wall_s=wall)
        log(f"[bridge] {kind} {nbytes >> 20} MiB {algo}: efficiency {est.efficiency}, "
            f"straggler spread {est.straggler_spread}, trims {est.trims}, fairness "
            f"{est.fairness}, {est.achieved_ticks} ticks; every field equal to the CPU "
            f"port's and the JAX package's; {wall:.3f} s on the card")
    return rec


# ------------------------------------------------------------------ main


def main():
    import tempfile
    name, smi_line = phase_device()
    bridge_cpu = start_bridge_cpu()
    dryrun_child = None
    later = []                  # children run() starts (the CPU runs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        try:
            if "--kernels-only" not in sys.argv[1:]:
                dryrun_child = (start_dryrun(), time.perf_counter())
            run(name, smi_line, bridge_cpu, dryrun_child, scratch, later)
        finally:
            for child in (bridge_cpu, dryrun_child and dryrun_child[0], *later):
                if child is not None:
                    if child.poll() is None:
                        child.kill()
                    child.wait()


def run(name, smi_line, bridge_cpu, dryrun_child, scratch, later):
    # f32 products and convolutions in full f32 (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    cpu = None
    if "--kernels-only" not in sys.argv[1:]:
        cpu = CpuRuns(scratch)
        later.append(cpu.child)
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
    control_cases(dev)
    arrivals_cases(dev)
    sends_cases(dev)
    departures_cases(dev)
    timed_states = state_checks(dev)
    timed_departures = departures_states(dev)
    records["control"] = control_timing(timed_states)
    records["arrivals"] = arrivals_timing(timed_states)
    records["sends"] = sends_timing(timed_states)
    records["departures"] = departures_timing(timed_departures)
    lanes_checked = lanes_kernel_checks()
    records.update(serve_kernel_checks(dev))
    function_checks = train_function_checks(dev)
    if "--kernels-only" in sys.argv[1:]:
        log("[done] --kernels-only: stopping before the main path (no result)")
        sys.exit(4)
    spent = {"build+kernels": time.perf_counter() - t0}

    def timed_phase(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        spent[name] = time.perf_counter() - t1
        return out

    finals = {}
    paths = timed_phase("main", phase_main_path, finals, cpu)
    ways = ("kernel", "split-arrivals", "split-control", "split-sends", "plain-departures")
    log(f"[kernels] launches ({'; '.join(ways)}): " + ", ".join(
        f"{k}: " + ", ".join(f"{n} " + "; ".join(
            str(paths[n]["launches_by_way"][w][k]) for w in ways)
            for n in ("perm_1024n_3t", "alltoall_3t")) for k in counters()))
    red = timed_phase("red_mark", phase_red_mark, dev)
    smartt_rate = paths["perm_1024n_3t"]["ticks"] / paths["perm_1024n_3t"]["wall"]
    comparison = timed_phase("comparison", phase_comparison, smartt_rate, finals, cpu)
    experiment_api = timed_phase("api", phase_api, paths, finals)
    lanes_rec, plan16, states16 = timed_phase("lanes", phase_lanes, lanes_checked)
    lanes_rec["mesh"] = timed_phase("mesh", phase_mesh, plan16, states16,
                                    lanes_rec["study16"])
    del plan16, states16
    bridge = timed_phase("bridge", phase_bridge, bridge_cpu)
    with torch.no_grad():
        serving = timed_phase("serving", phase_serving, dev)
        zoo = timed_phase("zoo", phase_zoo, dev)
    train_rec = timed_phase("train", phase_train, dev)
    train_rec["functions"] = function_checks
    sharded = timed_phase("sharded", phase_sharded, dev)
    first = f"B={SERVE_REQUESTS[0][0]} S={SERVE_REQUESTS[0][1]}"

    # (source, the TPU kernel it replaces, the path whose launches it reports);
    # cc_update and ring_drain run on the split control phase's path since
    # the control phase became one fused launch, enqueue_rank on the split
    # arrivals phase's since the arrivals phase did, rr_pick's sends call
    # site on the split sends phase's since the sends phase did (its grants
    # call site, EQDS's, stays on the fused path: phase 4c)
    replaces = {
        "cc_update": ("src/repro_torch/csrc/cc_update.cu",
                      "src/repro/kernels/cc_update/kernel.py:60",
                      "perm_1024n_3t split-control"),
        "enqueue_rank": ("src/repro_torch/csrc/enqueue_rank.cu",
                         "src/repro/kernels/enqueue_arb/kernel.py:56",
                         "perm_1024n_3t split-arrivals"),
        "ring_drain": ("src/repro_torch/csrc/ring_drain.cu",
                       "src/repro/kernels/ring_drain/kernel.py:56",
                       "perm_1024n_3t split-control"),
        "control": ("src/repro_torch/csrc/control.cu",
                    "src/repro/kernels/cc_update/kernel.py:60 + "
                    "src/repro/kernels/ring_drain/kernel.py:56", "perm_1024n_3t"),
        "arrivals": ("src/repro_torch/csrc/arrivals.cu",
                     "src/repro/kernels/enqueue_arb/kernel.py:56", "perm_1024n_3t"),
        "rr_pick": ("src/repro_torch/csrc/rr_pick.cu",
                    "src/repro/kernels/enqueue_arb/kernel.py:91", "alltoall_3t split-sends"),
        "sends": ("src/repro_torch/csrc/sends.cu",
                  "src/repro/kernels/enqueue_arb/kernel.py:91", "perm_1024n_3t"),
        "departures": ("src/repro_torch/csrc/departures.cu",
                       "src/repro/kernels/red_mark/kernel.py:42", "perm_1024n_3t"),
        "red_mark": ("src/repro_torch/csrc/red_mark.cu",
                     "src/repro/kernels/red_mark/kernel.py:42",
                     f"red_mark check (perm_1024n_3t, ticks 0-{RED_MARK_TICKS - 1})"),
        "flash_attention": ("src/repro_torch/csrc/flash_attn_tc.cu",
                            "src/repro/kernels/flash_attn/kernel.py:65",
                            f"serve qwen3-0.6b {first}"),
        "ssd_chunk_scan": ("src/repro_torch/csrc/ssd_scan_tc.cu",
                           "src/repro/kernels/ssd_scan/kernel.py:51",
                           f"serve mamba2-780m {first}"),
    }
    kernels = []
    for k, rec in records.items():
        src, rep, path = replaces[k]
        run, _, way = path.partition(" ")
        launches = (serving[path[len("serve "):]]["launches"] if path.startswith("serve ")
                    else red["launches"] if k == "red_mark"
                    else paths[run]["launches_by_way"][way or "kernel"][k])
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=launches, launches_path=path,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec.get("bound_by", "bytes"),
            library_ms=rec.get("library_ms"),
            shape=rec["shape"], call_ms=rec["call_ms"],
            plain_call_ms=rec["plain_call_ms"],
            **({"simt_ms": rec["simt_ms"], "simt_source": SIMT_SOURCES[k]}
               if "simt_ms" in rec else {}),
            **({"simt_bound_ms": rec["simt_bound_ms"]} if "simt_bound_ms" in rec else {}),
            **{k_: v for k_, v in rec.items() if k_ in (
                "split_ms", "ring_drain_ms", "cc_update_ms", "enqueue_rank_ms",
                "rr_pick_ms", "red_mark_ms", "restore_ms", "phase_ms", "split_phase_ms",
                "plain_phase_ms", "phase_call_ms", "split_phase_call_ms",
                "plain_phase_call_ms", "phase_launches", "split_phase_launches",
                "plain_phase_launches")
               or k_.startswith(("a2a_", "mla_", "cross_", "bf16s_"))},
            **({"launches_zoo": {a: r["launches"].get(k, 0) for a, r in zoo.items()}}
               if k in ("flash_attention", "ssd_chunk_scan") else {}),
            **({"launches_train_step": {a: r["steps"]["launches_per_step"]
                                        for a, r in train_rec.items()
                                        if TRAIN_KERNEL.get(a) == k},
                "launches_train_path": f"train {TRAIN_BATCH[0]} x {TRAIN_BATCH[1]} tokens "
                                       f"in {TRAIN_BATCH[2]} microbatches, remat",
                "launches_sharded": {a: sharded[a]["launches"]
                                     for a, kn, _ in (*SHARDED_MODELS, SHARDED_MOE)
                                     if kn == k}}
               if k in ("flash_attention", "ssd_chunk_scan") else {})))
    e2e = {k: dict(ticks=v["ticks"], executed=v["steps"],
                   **{f"{w.replace('-', '_') + '_' if w != 'kernel' else ''}ticks_per_s":
                      v["ticks_by_way"][w] / wall for w, wall in v["walls"].items()},
                   plain_over_ticks=v["ticks_by_way"]["plain"],
                   **({"turns": v["ticks_per_s"]} if "ticks_per_s" in v else {}))
           for k, v in paths.items()}
    for k, v in comparison.items():
        e2e[k] = dict(ticks=v["ticks"], executed=v["steps"], ticks_per_s=v["ticks_per_s"],
                      plain_ticks_per_s=v["plain_ticks_per_s"],
                      plain_over_ticks=v["plain_ticks"],
                      cpu_ticks_per_s=v["cpu_ticks_per_s"], cpu_over_ticks=v["cpu_ticks"])
    log(f"[main] end to end: {json.dumps(e2e)}")
    prof = timed_phase("profile", phase_profile)
    for phase, split, pre in (("departures", "plain-departures", "plain_"),
                              ("control", "split-control", "split_"),
                              ("arrivals", "split-arrivals", "split_"),
                              ("sends", "split-sends", "split_")):
        rec = records[phase]
        log(f"[profile] perm_1024n_3t {phase} phase: fused "
            f"{prof['kernel']['phase_host_ms_per_tick'][phase]:.3f} ms of host time a tick "
            f"({100 * prof['kernel'][f'{phase}_host_share']:.1f}%), {rec['phase_launches']} "
            f"launches and {rec['phase_ms'] * 1e3:.2f} us of device time a call; {split} "
            f"{prof[split]['phase_host_ms_per_tick'][phase]:.3f} ms of host time a tick "
            f"({100 * prof[split][f'{phase}_host_share']:.1f}%), {rec[f'{pre}phase_launches']} "
            f"launches and {rec[f'{pre}phase_ms'] * 1e3:.2f} us; device kernels a tick "
            f"{prof['kernel']['kernels_per_tick']:.1f} fused, "
            f"{prof[split]['kernels_per_tick']:.1f} {split}")
    analysis = timed_phase("analysis", phase_analysis)
    dryrun = timed_phase("dryrun", phase_dryrun, *dryrun_child)
    log(f"[done] total {time.perf_counter() - t0:.1f} s; by phase " + ", ".join(
        f"{k} {v:.1f} s" for k, v in spent.items()))
    if "--json" in sys.argv[1:]:
        out = Path(sys.argv[sys.argv.index("--json") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(device=name, nvidia_smi=smi_line,
                                       kernels=kernels, end_to_end=e2e,
                                       red_mark_check=red, comparison=comparison,
                                       experiment_api=experiment_api,
                                       lanes=lanes_rec, bridge=bridge, zoo=zoo,
                                       serving=serving, train=train_rec, profile=prof,
                                       analysis=analysis, sharded=sharded,
                                       dryrun=dryrun),
                                  indent=1))
    log(f"[device] {smi_line}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
