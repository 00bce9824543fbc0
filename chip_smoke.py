#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero, printing no result, without them. Phases, one line
each, every mismatch fatal:

1. build     — the three CUDA libraries (rowops, pim_matmul, flash_attn),
               one nvcc per source, all started together;
2. kernels   — the latency of one dependent float32 add (one thread, a
               chain of 2^20 ``__fadd_rn``: SM cycles from clock64 and ns
               from CUDA events), which bounds ``meter_fold``; then each row
               kernel against its plain torch version on the card, bit for
               bit, at the executor's shapes; device times (a CUDA graph of
               20 launches, replayed 20 times, median) beside the plain
               version's, the bound (``meter_fold``: its m adds in order at
               that latency) and the time of one call with the host's
               launch (CUDA events, median of 20); then the executor's row
               entries, ``bitwise_rows`` and ``shift_rows``, on (1 and
               64, 16, 2,048) slot states: bit for bit against their plain
               versions at every alias (a destination that is a source, a
               shift in place) and shift length, one launch per call, and
               each segment timed in place and out of place beside the old
               lowering of the same segment (the out-of-place kernel plus
               its gathers, copies and glue, in one CUDA graph);
3. subarray  — recorded programs through ``execute()`` at the paper's
               512 x 2,048 geometry, held exactly against the port's eager
               ISA on the card and ``execute()`` on the CPU;
4. device    — ``schedule()`` on ``paper_device(32, subarrays=2)`` (64
               slots, 256 MiB of rows on the card): heterogeneous programs,
               host writes and reads, a cross-bank COPY drain, two async
               steps (the second also refreshed), held exactly against the
               CPU run; then (4b) ``refresh_events`` on the card at refresh
               cycles of 0.6, 0.78 and 0.95 of the interval (once refused
               there), eagerly and replayed from a CUDA graph, against the
               CPU's loop, three refreshed ``schedule()`` steps at 0.6
               (eager, capture, replay) against the CPU, and tRFC = tREFI
               refused;
5. launches  — kernel launches over the PIM path of phases 3-4 (counts
               reset just before, read just after); each kernel must run,
               the old out-of-place entries not at all; then the card's
               operations per run in the profiler window (execute() of
               shift_workload(1000) and ambit_xor, one schedule() step,
               each phase-10 routine), the row entries' launches held to
               one per fused segment and residual SHIFT/TRA/NOT row of the
               programs run, beside the torch ops the executor dispatched
               before the row entries (printed after phase 10; the three
               routines that have that count must halve it);
6. lm kernels — pim_matmul (M 4 and 512, K x N 2560 x 9728 and 9728 x
               2560, both modes, 4 and 8 bits; each row names the route,
               ``swap_ab`` at M 4 and ``tensor_core`` at M 512, that
               ``ops.route`` gives it; the M 4 rows cycle over four weight
               copies, 100 MB, so each call finds its weights outside the
               50 MB L2 as a decode step does, and also time the
               ``cuda_core`` route) and flash_attn (each row names its route,
               ``tensor_core``, ``tiled`` or ``split_kv``: Qwen3-4B's heads
               at prefill and decode, that decode over 8,192 slots, MLA's
               decode at dk 576 / dv 512 (over 2,048 slots and over the
               144 of phase 16's deepseek path), recurrentgemma-2b's
               decode on a 2,048-slot ring under its window, MLA's
               prefill at dk 192 /
               dv 128, Qwen3-4B's heads at a 2,048-token prompt,
               recurrentgemma-2b's heads, dk = dv = 256, at decode over
               phase 18's 144-slot ring and at a 128-token prefill;
               pim_matmul w4 shift_add also at recurrentgemma-2b's GeGLU
               shapes, (4, 2560) @ (2560, 7680) and (4, 7680) @ (7680,
               2560) on ``swap_ab``, (512, 2560) @ (2560, 7680) and (512,
               7680) @ (7680, 2560) on ``tensor_core``) against
               their plain versions on the card (flash in float32, on the
               tiled route, and bf16), with device and per-call times,
               bound and the time of one PyTorch library call (the
               tensor-core rows also time the tiled route); then the three
               pim_matmul routes at M 4, 8, 16 and 64 (``swap_ab`` up to
               16) and the three flash routes at 4 to 256 rows per pair
               (the route thresholds), the tensor-core kernel's K splits at
               M 512, the swapped kernel's at M 4 and the flash split
               route's key splits at its decode shapes, each timed; the
               ``ptxas`` report (registers, shared memory, spills) of the
               pim_matmul tensor-core kernels and of flash's (the run fails
               if a swapped instance or flash's tensor-core instance at 128
               / 128, 192 / 128 or 256 / 256 spills), and the ``HMMA``
               count (``cuobjdump -sass``) of every tensor-core kernel,
               which must be above 0 in every instance, with the swapped
               kernel's integer instructions per weight code;
7. serve     — the LM serving path: ``greedy_generate`` on Qwen3-4B
               (pim_w4, shift_add) at full width and depth, weights from a
               seed, batch 4, prompt 128, 16 new tokens, each call one
               CUDA-graph replay: the first call (warm-up, capture, replay)
               timed apart from the replayed calls (median of 3) and the
               graph alone (CUDA events); launch counts and DECODE_STATS
               reset just before a replayed call and read just after it
               (1,728 pim_matmul and 576 flash_attn launches, prefill's
               108 pim_matmul calls on the tensor cores and decode's 1,620
               on the swapped operands, none on the CUDA cores, prefill's
               36 flash_attn calls on the tensor cores and decode's 540
               split over the keys; one dispatch, none for zero tokens;
               the first call adds its warm-up's eager prefill and decode
               step); every token the argmax of the eager loop's logits,
               teacher-forced on the card's tokens, bit for bit; one
               ``cudaGraphLaunch`` and no kernel launch per replayed call
               in the profiler; the graph pool's bytes; beside them the
               eager ms of prefill, per decode token and of the whole loop,
               GB on the card, decode against prefill, the busy share of a
               replayed call, one prefill and one decode step, and the
               kernel ms of prefill and of a decode step with pim_matmul's
               and flash's shares; the memory left once the model and its
               graphs are freed;
8. lm parity — the same model at 2 layers: greedy_generate on the card (one
               replay, its tokens the card's argmax chain), logits
               teacher-forced on the card (kernels) and on the CPU (plain
               versions) compared step by step, and the CPU's greedy
               tokens (the argmax of its teacher-forced logits), which
               must equal the card's wherever the card's top-2 margin
               exceeds twice the bound;
9. ripple    — ``ripple_add`` against its plain version at (512, 2,048) for
               every width dividing 32 and at ragged shapes, bit for bit,
               with device times, the plain version's, the bound and one
               library call where one computes the same function
               (``torch.bitwise_xor`` at w 1, ``torch.add`` on the rows
               viewed as uint8/int16/int32 at w 8/16/32); then the kernel
               bench's path, ripple_add's own (launch counts reset just
               before, read just after, ripple_add must run): the fused
               adder against the 30-launch composition of
               ``bitwise``/``shift_cols`` at w 8;
10. bitplane — the bit-plane layer at the crypto case study's full-row
               sizes (launch counts reset just before, read just after,
               each kernel must run; the VM records PIM commands and never
               calls ripple_add): ``PimVM`` routines on 8 KB rows, each
               equal to its numpy oracle, and the fused adder on the VM's
               own operand rows equal to ``add_ripple`` (that launch
               counted apart); RS(12,8) on 32
               banks of full rows equal to the oracle and to one wide
               subarray; the async pipeline's identities (equal bits and
               energy, sync wall - async wall = hidden host time); one
               ``run_pipeline`` and one ``run_workload`` equal to the same
               steps flushed one by one;
11. bitplane parity — phase 10 again on the CPU: reads, counts and every
               float32 meter identical;
12. fold sweep — ``meter_fold`` at m = 64, 4,001 and the largest table the
               card's PIM and bit-plane runs of phases 3-4 and 10 folded,
               each onto 1 and 64 slots: bit for bit against its plain
               version, device time beside the chain bound;
13. gates    — ``execute()`` (phase 3's programs), ``schedule()`` (phase
               4's steps) and ``schedule_pipeline()`` with ``verify=True``
               bit for bit against ``verify=False`` on the card; the pim104
               lint fixture refused (LintError, PIM104) at its own 16 x 2
               geometry and moved to the paper's; the static tools' host ms
               per program, cold, and on the reference tests' 100k-op
               streams;
14. front    — ``PimServeFront`` on ``paper_device(32, subarrays=2)``:
               eight tenants of four banks, 16 steps each (six on
               ``benchmarks/serve_bench.py``'s stream, write a row, a 40-hop
               shift chain, read back; two on ``ambit_xor_program`` after
               host writes), each slot's data private and seeded; a ninth
               tenant (pim104 at full width) refused by the admission lint,
               a tenth refused as over-subscribing; each tenant's reads,
               slot states, float32 meters and busy/energy equal to its own
               ``schedule()`` on a private slice of the card, and the whole
               front equal to the same front on the CPU (reads, states,
               reports, ``reconcile()``); steps/s cold and warm, dispatches
               per step, coalescing, p50/p99 step ``wall_ns``, admission
               lint ms, a ``profile front`` line and ``kernels front``
               (launch counts reset just before the measured run, read just
               after; each row entry and ``meter_fold`` must run);
15. tables   — ``shift_failure_rate`` on the card at 0, 5, 10 and 20 %
               variation, 100,000 trials, within the reference test's bounds
               of the paper's Table 4; the area model's Table 5;
16. families — the MLA and frontend families at their published
               widths with phase 7's traffic, weights from a seed, each
               ``greedy_generate`` call one CUDA-graph replay with phase
               7's checks (launches by route from the config, reset just
               before a replayed call and read just after it; the first
               call adds its warm-up's two passes; DECODE_STATS 1; the
               tokens the eager argmax chain bit for bit; one
               ``cudaGraphLaunch`` and no kernel launch per replayed call;
               decode against prefill, held to the bound without MoE,
               measured with the last token's routing flips reported with
               it): deepseek-v2-lite-16b pim_w4
               shift_add at its full 27 layers (MLA: flash's
               ``tensor_core`` route at prefill, ``split_kv`` at decode;
               the dense layer's and the shared experts' linears on
               ``pim_matmul``'s ``tensor_core`` and ``swap_ab`` routes,
               every one of the four routes must run) and
               llava-next-mistral-7b pim_w4 at 4 of 32 layers behind 576
               seeded patch embeddings (a static input of the graph);
               qwen3-moe-30b-a3b and musicgen-medium serve their defaults
               at full depth in phase 28;
17. families parity — deepseek, llava, qwen3-moe-30b-a3b and
               musicgen-medium at full width, 2 layers, as phase 8
               (musicgen: seeded frames teacher-forced on both sides); a
               MoE model's router choices recorded on both sides, a request
               held until the first routing flip that reaches it, each
               flip reported and held inside the rounding (a reference
               margin within 2e-2 of the k-th probability);
18. recurrent — falcon-mamba-7b (bf16, all 64 layers) and recurrentgemma-2b
               (pim_w4 shift_add, all 26 layers: 8 (rec, rec, attn)
               blocks and a 2-layer rec tail) at their published widths
               with phase 7's traffic and checks, each ``greedy_generate``
               call one CUDA-graph replay that holds the recurrent states'
               prefill and in-place decode writes: launches by route from
               the config (falcon-mamba none of either LM kernel, as the
               reference's Mamba block runs plain matmuls; recurrentgemma
               1,248 pim_matmul, 78 ``tensor_core`` and 1,170 ``swap_ab``,
               and 128 flash_attn, 8 ``tensor_core`` and 120 ``split_kv``
               over the 144-slot ring; pim_matmul's launches also by
               (route, K, N), each shape's from the config), decode against
               prefill measured, the scan's share of prefill's kernels (its
               addcmul loop, beside the loop's byte bound, and the decays'
               exp);
19. recurrent parity — each at full width and a cut depth (falcon-mamba 2
               layers, recurrentgemma 5: one block and the tail) as phase
               8, and decode against prefill on the card and on the CPU
               within the reference's 3e-2;
20. train    — Qwen3-4B pim_w4 shift_add at full width and depth (36
               layers, d_model 2,560, remat) with the reference CLI's
               training defaults (batch 8 x 256 seeded next-token data,
               AdamW lr 1e-3, warmup_cosine over 100 steps with 10 of
               warm-up): one forward and one backward pass counted apart
               (pim_matmul 108 forward; 324 backward: the recompute's 108,
               dx on the transposed codes and the dscales accumulator;
               flash 36 and 36, each with its log-sum-exp; all on the
               tensor cores, by (K, N) from the config), then TRAIN_STEPS
               steps, each with its loss, grad norm, skipped flag, ms on
               CUDA events, peak memory and launches (another count fails
               the run; so do a non-finite loss, a skipped step and a loss
               at the last step not below the first), then one step with
               microbatches 2 against one with 1 from the same state
               (loss 5e-3, params 5e-2, the reference test's bounds); then
               the trained model served: ``greedy_generate`` one replay,
               its tokens the eager argmax chain, ``head_f32`` refreshed,
               and a model rebuilt through ``convert`` from the trained
               params giving the same logits bit for bit;
21. train parity — full width, 2 layers, 2 x 64 tokens: one training
               pass's loss and every gradient leaf on the card against the
               port on the CPU, within 2e-2 of max |CPU|;
22. train-loop — the training CLI (``repro_torch.launch.train.main``)
               in-process at full width and depth (Qwen3-4B pim_w4, 36
               layers, batch 8 x 256 of the synthetic stream, 4 steps, no
               checkpoints): its lines, each step's ms from the loop's
               history, the losses, and the launches per step held to
               phase 20's (another count fails the run); then the loop's
               resume at full width with 2 layers: 4 uninterrupted steps
               against 2 steps and a resume to 4, in temporary
               directories, every trainable leaf, moment and the step
               counter bit for bit (else the run fails), with the
               checkpoint's bytes and its save and restore ms;
23. examples — each ``examples/*_torch.py`` example's ``main`` on the
               card, the launch counts reset just before it and read just
               after it: the PIM examples' lines equal to their CPU run's
               (a row kernel of their path not launched fails the run),
               ``serve_lm_torch``'s two calls equal, ``train_lm_torch`` at
               its defaults (200 steps, checkpoints every 50) to its "loss
               decreased";
24. sharded  — the sharded path, every process group in processes of its
               own: ``psum_compressed`` over NCCL (a rank per card) and
               over gloo (4 ranks, on the card's tensors where gloo takes
               them), each rank's total and residual bit for bit against
               numpy's computation of the reference's formula, µs per
               call; phase 22's checkpoint restored onto
               ``make_host_mesh()`` with ``param_shardings``' placements,
               every array gathered bit for bit; the dry-run's production
               cells (qwen3-4b train_4k, prefill_32k, decode_32k,
               deepseek-v2-lite-16b train_4k on the (16, 16) mesh of a
               fake process group), each ``status ok``, and phase 20's
               cell on a 1 x 1 mesh, its roofline terms beside phase 20's
               measured step (reported, not held);
25. dense    — the dense configurations at their published widths and
               depths with phase 7's traffic and checks, each
               ``greedy_generate`` call one CUDA-graph replay, one model on
               the card at a time: yi-34b (60 layers, 56 query heads on 8
               kv heads, G 7), qwen2.5-32b (64 layers, G 5, QKV bias, a
               152,064-token vocabulary) and starcoder2-7b (32 layers, G 9,
               LayerNorm, a GELU MLP with biases, its 4,096 window), all
               pim_w4 shift_add (both pim_matmul routes and both flash
               routes must run in each call); then Qwen3-4B in pim_w4
               dequant, pim_w8 shift_add and pim_w8 dequant, cut to
               QWEN3_DEPTH layers; pim_matmul's launches by route, by (K,
               N) and by the (mode, bits) its kernel was given, each held
               to the config; decode against prefill measured, not held;
26. dense parity — each at full width, 2 layers, as phase 8;
27. ring     — starcoder2-7b at full depth past its window: one request of
               4,352 tokens, 16 new, its cache a 4,096-slot ring that every
               decode step reads wrapped (prefill keeps the last 4,096
               positions at slot pos % 4,096), with phase 7's checks; then
               at 2 layers the same traffic, the card's kernels against
               their plain versions run on the card (the CPU is too slow
               at 4,352 tokens) step by step within 2e-2, and the ring's
               slots after the last step;
28. defaults — each configuration's own default (bf16, ``quant=None``)
               at published width and full depth, one model on the card at
               a time: first the serving CLI
               (``repro_torch.launch.serve.main(["--arch", id])``) in
               this process at its defaults (4 x 32 tokens, 32 new; its
               ``req`` lines, one greedy_generate replay); then the same
               weights built again, with phase 7's traffic and checks (no
               eager timing): Qwen3-4B (36 layers), starcoder2-7b (32,
               under its 4,096 window), deepseek-v2-lite-16b (27, MLA and
               MoE, einsum), llava-next-mistral-7b (32, behind 576 seeded
               patches), recurrentgemma-2b (26), qwen3-moe-30b-a3b (48,
               einsum, then gather on the same weights), each call one
               replay with no ``pim_matmul`` launch and both flash routes,
               decode against prefill measured (a MoE model's flips
               reported), and the CLI's tokens the eager argmax chain
               teacher-forced on its prompts, bit for bit;
               musicgen-medium at 48 layers through ``prefill`` and 15
               teacher-forced ``decode_step`` calls on seeded frames, its
               ``greedy_generate`` and the CLI raising, as the
               reference's do;
29. defaults parity — the five that had never run bf16 at width
               (Qwen3-4B, starcoder2-7b, deepseek, llava at 2 layers;
               recurrentgemma-2b at 3, one (rec, rec, attn) block) card
               against CPU as phase 8;
30. long     — Qwen3-4B bf16 at 36 layers on one request of 32,752
               tokens and 16 new (32,768 positions: prefill_32k's
               sequence, decode_32k's cache, batch 1) with phase 7's
               checks; then at 2 layers the same traffic, the card's
               kernels against their plain versions on the card (the
               attention over 1,024 queries a call) step by step within
               2e-2.

Phase 6 also holds the training shapes: pim_matmul w4 shift_add at (2048,
2560) @ (2560, 9728) and (2048, 9728) @ (9728, 2560), and flash_attn at
Qwen3-4B's heads over 8 x 256 tokens with the log-sum-exp
(``flash_attn[prefill,lse]``, the log-sum-exp within FLASH_LSE_ABS of the
plain version's); and phases 25-27's: pim_matmul w4 shift_add at the
dense configurations' FFN shapes (PIM_SHAPES_DENSE, M 4 on ``swap_ab``
and 512 on ``tensor_core``), flash_attn at their heads (G 7, 5 and 9) at
prefill and over 144 slots, and at starcoder2-7b's 4,352-token prefill
under its window and its decode over the wrapped 4,096-slot ring; and
phase 30's: flash_attn at Qwen3-4B's heads over 32,752 causal tokens and
at decode over a 32,768-slot cache, the prefill's plain version on its
first and last 1,024 query rows (every flash row's bf16 output held to
1e-2 of max |plain| over each query row). The front of phase 14 runs on the 64-slot device,
where
the step's energy sum follows XLA's order (``compile.xla_sum``), card
against CPU bit for bit.

Then the kernel table as JSON (each pim_matmul row with the launches at
its own (route, K, N) on its path, MLA's two flash rows with their
launches on phase 16's deepseek path, recurrentgemma-2b's six rows with
theirs on phase 18's path, the training rows with theirs over phase 20's
measured steps, the dense configurations' rows with theirs on phases
25 and 27's paths, the 32k rows with theirs on phase 30's), the card's
name and power limit, and the result
line. Nanoseconds and nanojoules of the DDR3 meter are outputs of
the simulated DRAM's model; milliseconds and microseconds are times of the
card. Everything measured is also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA's data sheet (SXM)
H100_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense
# int32 integer and logic instructions outside the tensor cores: 64 INT32
# lanes per SM (Hopper architecture white paper) x 132 SMs x 1.98 GHz boost
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
SOURCES = {
    "rowops": "src/repro_torch/kernels/rowops/csrc/rowops.cu",
    "pim_matmul": "src/repro_torch/kernels/pim_matmul/csrc/pim_matmul.cu",
    "flash_attn": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
}
REPLACES = {
    "shift_cols": "src/repro/kernels/rowops/rowops.py:137",
    "shift_rows": "src/repro/kernels/rowops/rowops.py:137",
    "bitwise": "src/repro/kernels/rowops/rowops.py:120",
    "bitwise_rows": "src/repro/kernels/rowops/rowops.py:120",
    "meter_fold": "src/repro/core/pim/compile.py:247",
    "pim_matmul": "src/repro/kernels/pim_matmul/pim_matmul.py:61",
    "flash_attn": "src/repro/kernels/flash_attn/flash_attn.py:75",
    "ripple_add": "src/repro/kernels/rowops/rowops.py:151",
}
# Tolerances of the LM phases. pim_matmul: the kernel and its plain version
# compute the same float32 function (exact products, sums over K <= 9,728
# in another order), so max |kernel - plain| <= 1e-4 of max |plain|.
# flash_attn: abs 2e-5 for float32 (the reference tests' bound; float32
# stays on the CUDA cores' float32 products, the tiled and split routes);
# for bf16 tensors 1e-2 of max |plain| (phase 6's flash rows and the 32k
# card tests: of max |plain| over each query row, its heads and widths,
# since a causal row over 32k keys averages outputs ~sqrt(e / 32k) ~ 0.009
# against row 0's ~3): both sides take the same bf16 inputs, sum in float32
# and round the output to bf16, so they differ by at most about one bf16
# ulp of the largest output, which is at most 2^-7 of it; the tensor-core
# route also rounds each softmax weight p to bf16 before P V, a relative
# error of at most 2^-9 per weight whose signs differ, so an output moves
# by about 2^-9 sqrt(sum p^2 v^2) / sum p, 2^-9 of the size of its row's
# outputs (at most 2^-9 max |v|, which random weights do not reach). The
# model's logits, card
# against CPU and decode against prefill: 2e-2 of max |logit|, the bound
# the port's CPU tests hold the bf16 model to against the reference (bf16
# rounds in other places on either side).
PIM_REL = 1e-4
FLASH_BF16_REL = 1e-2
FLASH_F32_ABS = 2e-5
LOGITS_REL = 2e-2
# The log-sum-exp the flash forward returns for training: float32 on both
# sides from the same bf16 q, k (the tensor-core route's scores in log2
# units, m ln 2 + log l), about 1e-6 of |lse| apart; held at 1e-3 absolute
FLASH_LSE_ABS = 1e-3
# Phase 20: the reference CLI's training defaults (launch/train.py: batch
# 8, 256 tokens, lr 1e-3, warmup_cosine over --steps 100 with steps // 10
# of warm-up), TRAIN_STEPS steps, then one with microbatches 2 against one
# with 1 from the same state, held to the reference test's bounds
# (tests/test_train_and_ckpt.py: loss 5e-3, params 5e-2)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 256, 4, 1e-3
TRAIN_SCHEDULE = {"warmup_steps": 10, "total_steps": 100}
TRAIN_MB_LOSS, TRAIN_MB_PARAMS = 5e-3, 5e-2
# Phase 21: card against CPU at full width with 2 layers on 2 x 64 tokens
# (the CPU's plain bit-plane products keep it to seconds); loss and each
# gradient leaf within 2e-2 of max |CPU|, the bf16 model's bound
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
GRAD_REL = 2e-2
# Phase 22: the loop's resume at full width with this many layers (a
# checkpoint is mostly the 389 M-parameter embedding and the float32
# moments: about 4.4 GB at 2 layers, 13.3 GB at 36), this many steps
# uninterrupted against half of them and a resume
RESUME_LAYERS, RESUME_STEPS = 2, 4
# Phase 24: the sharded path. psum_compressed on one Qwen3-4B FFN
# gradient (w1's, d_model x d_ff) per rank, over NCCL with a rank per card
# and over gloo with this many ranks; the dry-run's production cells (the
# reference's shapes on its (16, 16) mesh), then Qwen3-4B pim_w4 at phase
# 20's batch on a 1 x 1 mesh beside phase 20's measured step
PSUM_SHAPE, PSUM_GLOO_RANKS, PSUM_REPS = (2560, 9728), 4, 20
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                ("qwen3-4b", "decode_32k"),
                ("deepseek-v2-lite-16b", "train_4k"))
SHARDED_TIMEOUT_S = 300

# Phase 23: the row kernels each PIM example's path launches on the card
# (the quickstart's recorded programs run fused shift segments; the
# crypto case study's VM routines every row entry)
EXAMPLE_KERNELS = {
    "quickstart_torch": ("shift_rows", "meter_fold"),
    "pim_crypto_torch": ("shift_rows", "bitwise_rows[maj]",
                         "bitwise_rows[not]", "meter_fold")}
LM_ARCH = ("qwen3-4b", {"quant": "pim_w4", "quant_mode": "shift_add"})
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 16
# (M, K, N) of the serving path's FFN linears at decode (M = batch) and at
# prefill (M = batch x prompt); the first is the table's row
PIM_SHAPES = ((4, 2560, 9728), (4, 9728, 2560), (512, 2560, 9728),
              (512, 9728, 2560))
# recurrentgemma-2b's GeGLU linears (d_ff 7,680) at decode and prefill,
# timed at its pim_w4 shift_add only
PIM_SHAPES_RG = ((4, 2560, 7680), (4, 7680, 2560), (512, 2560, 7680),
                 (512, 7680, 2560))
# the dense configurations' FFN linears, (d_model, d_ff) and back, at
# decode and prefill, pim_w4 shift_add: yi-34b, qwen2.5-32b, starcoder2-7b
PIM_SHAPES_DENSE = tuple((m, k, n) for d, f in ((7168, 20480),
                                                (5120, 27648),
                                                (4608, 18432))
                         for m in (4, 512) for k, n in ((d, f), (f, d)))
# Phase 20's training linears: (M, K, N) at M = batch 8 x 256 tokens, each
# shape taken by a forward, its recompute, the dscales accumulator and the
# other shape's dx on the transposed codes
PIM_SHAPES_TRAIN = ((2048, 2560, 9728), (2048, 9728, 2560))
# decode-sized calls are timed over this many copies of their weights,
# cycled (4 x 25 MB of int8 codes, beyond the 50 MB L2), as a decode step
# reads 108 different weights
WEIGHT_COPIES = 4
# flash_attn: (B, KV, G, dk, dv, Sq, Sk, last query position, window,
# ring). Qwen3-4B's heads at prefill and at decode (the slots after the
# query's position hold kpos -1 and poisoned values), the same decode over
# an 8,192-slot cache, MLA's decode (deepseek-v2-lite: one 576-wide latent
# key head, 512-wide values, 16 query heads), recurrentgemma-2b's decode
# (one kv head of 256, 10 query heads, a 2,048-slot ring under its 2,048
# window, positions unsorted), MLA's prefill (16 heads, dk 192, dv 128),
# Qwen3-4B's heads at a 2,048-token causal prompt (batch 1) and MLA's
# decode over phase 16's 144-slot cache (deepseek's serving shape); then
# recurrentgemma-2b's at phase 18's serving shapes: decode over its
# 144-slot ring (prompt 128 + 16 tokens, under the 2,048 window) and
# prefill at 128 tokens, dk = dv = 256; then the dense configurations'
# heads at phase 25's shapes (yi-34b G 7, qwen2.5-32b G 5, starcoder2-7b
# G 9 under its 4,096 window): prefill at 128 tokens and decode over the
# 144 slots, and starcoder2-7b's at phase 27's: prefill over 4,352 tokens,
# decode over the wrapped 4,096-slot ring
FLASH_SHAPES = {
    "prefill": (4, 8, 4, 128, 128, 128, 128, 127, None, False),
    "decode": (4, 8, 4, 128, 128, 1, 144, 135, None, False),
    "decode,8k": (4, 8, 4, 128, 128, 1, 8192, 8183, None, False),
    "decode,mla": (4, 1, 16, 576, 512, 1, 2048, 2040, None, False),
    "decode,recurrentgemma": (4, 1, 10, 256, 256, 1, 2048, 5000, 2048, True),
    "prefill,mla": (4, 16, 1, 192, 128, 128, 128, 127, None, False),
    "prefill,2k": (1, 8, 4, 128, 128, 2048, 2048, 2047, None, False),
    "decode,mla,144": (4, 1, 16, 576, 512, 1, 144, 135, None, False),
    "decode,recurrentgemma,144": (4, 1, 10, 256, 256, 1, 144, 135, 2048,
                                  False),
    "prefill,recurrentgemma": (4, 1, 10, 256, 256, 128, 128, 127, 2048,
                               False),
    "prefill,yi": (4, 8, 7, 128, 128, 128, 128, 127, None, False),
    "prefill,qwen2.5": (4, 8, 5, 128, 128, 128, 128, 127, None, False),
    "prefill,starcoder2": (4, 4, 9, 128, 128, 128, 128, 127, 4096, False),
    "prefill,starcoder2,4352": (1, 4, 9, 128, 128, 4352, 4352, 4351, 4096,
                                False),
    "decode,yi,144": (4, 8, 7, 128, 128, 1, 144, 135, None, False),
    "decode,qwen2.5,144": (4, 8, 5, 128, 128, 1, 144, 135, None, False),
    "decode,starcoder2,144": (4, 4, 9, 128, 128, 1, 144, 135, 4096, False),
    "decode,starcoder2,ring": (1, 4, 9, 128, 128, 1, 4096, 4366, 4096, True),
    # Qwen3-4B's heads at phase 30's 32,768 positions: prefill over 32,752
    # causal tokens, decode over the 32,768-slot cache at the last step's
    # position
    "prefill,32k": (1, 8, 4, 128, 128, 32752, 32752, 32751, None, False),
    "decode,32k": (1, 8, 4, 128, 128, 1, 32768, 32766, None, False),
}
# A shape whose plain version would take more than FLASH_PLAIN_BYTES of
# float32 scores (prefill,32k: 137 GB) is long: the plain version runs on
# its first and last FLASH_LONG_ROWS query rows alone, SDPA on the whole
# shape (causal, kv heads repeated)
FLASH_PLAIN_BYTES = 2 ** 32
FLASH_LONG_ROWS = 1024
# phase 20's training attention: Qwen3-4B's heads over 8 x 256 causal
# tokens, the forward asked for the log-sum-exp
FLASH_TRAIN = (8, 8, 4, 128, 128, 256, 256, 255, None, False)
# the three flash routes at these query positions per pair (G = 4: 4 to
# 256 rows) over these key slots: the route threshold
FLASH_ROUTES = ("split_kv", "tensor_core", "tiled")
FLASH_THRESHOLD_SQ = (1, 4, 16, 32, 64)
FLASH_THRESHOLD_SK = (144, 8192)
# the split route's key split counts timed at each decode shape, beside
# the one its cost rule picks
FLASH_SPLITS = (1, 2, 4, 8, 16, 32, 64)
# the pim_matmul routes at these M, at (M, 2560) @ (2560, 9728), w4
# (swap_ab below TC_MIN_M); the tensor-core kernel's K splits timed at
# the two prefill shapes, the swapped kernel's at the two decode shapes
THRESHOLD_MS = (4, 8, 16, 64)
PIM_ROUTES = ("tensor_core", "swap_ab", "cuda_core")
TC_SPLITS = (1, 2, 3)
SWAP_SPLITS = (1, 2, 3, 4, 6, 8, 13, 16, 24, 32)
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 2, 32, 4
PIM_W4 = {"quant": "pim_w4", "quant_mode": "shift_add"}
# Phases 16-17: the MoE, MLA and frontend families at their published
# widths, served with phase 7's traffic: (label, arch, overrides, depth).
# deepseek-v2-lite-16b pim_w4 at its full 27 layers (about 31.5 GB on the
# card), llava pim_w4 cut to 4 of 32 layers (phase 28 serves its default
# at all 32), so that the run stays well within its time limit;
# qwen3-moe-30b-a3b and musicgen-medium serve their defaults at full depth
# in phase 28 alone.
FAMILIES = (
    ("serve-deepseek", "deepseek-v2-lite-16b", PIM_W4, None),
    ("serve-llava", "llava-next-mistral-7b", PIM_W4, 4),
)
# phase 17's families, card against CPU at 2 layers: (label, arch,
# overrides)
FAMILIES_PARITY = (
    *((label, arch, overrides) for label, arch, overrides, _ in FAMILIES),
    ("serve-qwen3-moe", "qwen3-moe-30b-a3b", {}),
    ("serve-musicgen", "musicgen-medium", {}),
)
# Phases 18-19: the recurrent families at their published widths and full
# depths with phase 7's traffic: (label, arch, overrides, the depth phase
# 19 cuts it to). recurrentgemma-2b's 5 layers are one (rec, rec, attn)
# block and the 2-layer rec tail.
RECURRENT = (
    ("serve-falcon-mamba", "falcon-mamba-7b", {}, 2),
    ("serve-recurrentgemma", "recurrentgemma-2b",
     {"quant": "pim_w4", "quant_mode": "shift_add"}, 5),
)
# tests/test_decode_consistency.py's bound for both recurrent families:
# their float32 state paths differ in op order between prefill and decode
RECURRENT_DECODE_REL = 3e-2
# Phases 25-26: the dense configurations at their published widths and
# depths with phase 7's traffic, and Qwen3-4B in the quantizations phase 7
# does not serve: (label, arch, overrides, the depth served, None for the
# config's own). yi-34b and qwen2.5-32b take pim_w4: in bf16 their weights
# and float32 head (~69-71 GB) leave no room on one 80 GB card. Qwen3-4B's
# three runs repeat phase 7's shapes and are cut to QWEN3_DEPTH of its 36
# layers, so that phases 25-27 stay near 250 s of the script's limit.
QWEN3_DEPTH = 8
DENSE = (
    ("serve-yi", "yi-34b", PIM_W4, None),
    ("serve-qwen2.5", "qwen2.5-32b", PIM_W4, None),
    ("serve-starcoder2", "starcoder2-7b", PIM_W4, None),
    ("serve-qwen3-w4-dequant", "qwen3-4b",
     {"quant": "pim_w4", "quant_mode": "dequant"}, QWEN3_DEPTH),
    ("serve-qwen3-w8", "qwen3-4b",
     {"quant": "pim_w8", "quant_mode": "shift_add"}, QWEN3_DEPTH),
    ("serve-qwen3-w8-dequant", "qwen3-4b",
     {"quant": "pim_w8", "quant_mode": "dequant"}, QWEN3_DEPTH),
)
# the runs each of whose calls must take both routes of both LM kernels
DENSE_BOTH_ROUTES = ("serve-yi", "serve-qwen2.5", "serve-starcoder2")
# Phase 27: starcoder2-7b past its 4,096-token window (code completion
# with more than 4k tokens of repository context): one request of
# RING_PROMPT tokens at full depth, its cache a ring of 4,096 slots that
# every decode step reads wrapped; then RING_CHECK_LAYERS layers, the
# card's kernels against their plain versions run on the card
RING = ("serve-starcoder2-ring", "starcoder2-7b", PIM_W4)
RING_BATCH, RING_PROMPT, RING_CHECK_LAYERS = 1, 4352, 2
# Phases 28-29: each configuration's own default (bf16, quant None) at
# published width and full depth, one model on the card at a time,
# through the serving CLI at its own defaults (CLI_BATCH x CLI_PROMPT,
# CLI_NEW new), then with phase 7's traffic and checks (lean: no eager
# timing): (arch, MoE dispatches replayed on the same weights). yi-34b and
# qwen2.5-32b do not fit one card in bf16 beside their float32 heads
# (phase 25 serves them pim_w4); falcon-mamba-7b's default is phase 18's.
DEFAULTS = (
    ("qwen3-4b", ()), ("starcoder2-7b", ()), ("deepseek-v2-lite-16b", ()),
    ("llava-next-mistral-7b", ()), ("recurrentgemma-2b", ()),
    ("qwen3-moe-30b-a3b", ("gather",)), ("musicgen-medium", ()))
CLI_BATCH, CLI_PROMPT, CLI_NEW = 4, 32, 32
# phase 29: the five that had never run bf16 at width, card against CPU at
# these depths (recurrentgemma-2b's first two layers are recurrent: three
# are one (rec, rec, attn) block)
DEFAULTS_PARITY = {"qwen3-4b": 2, "starcoder2-7b": 2,
                   "deepseek-v2-lite-16b": 2, "llava-next-mistral-7b": 2,
                   "recurrentgemma-2b": 3}
# Phase 30: Qwen3-4B bf16 at 32,768 positions, prefill_32k's sequence and
# decode_32k's cache (configs/shapes.py) at batch 1 (long-document
# question answering at Qwen3's native context): one request of
# LONG_PROMPT tokens and SERVE_NEW new at full depth, then LONG_CHECK_LAYERS
# layers, the card's kernels against their plain versions on the card
LONG_ARCH = "qwen3-4b"
LONG_BATCH, LONG_PROMPT, LONG_CHECK_LAYERS = 1, 32752, 2
# the plain attention's queries per call at long prompts: its float32
# scores (B, KV, G, queries, Sk) take 4.3 GB at 1,024 x 32,752 for
# Qwen3-4B's 32 heads (137 GB for all 32,752 queries at once)
PLAIN_CHUNK = 1024
SHIFT_KS = (1, -1, 31, 32, 33, -33, 999, -999, 65535, 65536, 70000)
# phase 2b: the row entries on (B, 16, 2,048) states, B = 1 and 64 (one
# subarray; the full device's slots); shift chains of these many hops (and
# 32·W, 32·W + 1), both ways
ROW_SHAPE = (16, 2048)
ROW_SLOTS = (1, 64)
ROW_KS = (1, 2, 5, 31, 32, 33, 40, 999, 1000)
# torch ops the executor dispatched per run before the row entries (commit
# edcfc58), counted on the CPU with each kernel wrapper as one (views and
# copies included): the "before" of the launch counts; the routines run on
# PimVM(width=8), one bank. The three routines must fall to at most half.
BEFORE_OPS = {"execute(shift_workload(1000))": 21, "mul_shift_add": 5112,
              "gf_mul": 4849, "add_ripple": 329}
# Phases 9-11: ripple_add at the kernel bench's row block and ragged shapes;
# the bit-plane layer at the crypto case study's sizes (8 KB rows: 2,048
# words, 8,192 byte lanes)
RIPPLE_SHAPE = (512, 2048)
RIPPLE_PAIRS = 8
RIPPLE_RAGGED = ((37, 2048), (5, 33))
# meter_fold's bound: a dependent chain of this many adds in one thread
FADD_CHAIN = 1 << 20
# phase 12: tables of these many rows (and the largest the paths fold),
# folded onto this many slots
FOLD_ROWS = (64, 4001)
FOLD_SLOTS = (1, 64)
WIDTHS = (1, 2, 4, 8, 16, 32)
VM_WORDS, VM_ROWS = 2048, 64
VM_ROUTINES = ("add_ripple", "add_kogge_stone", "mul_shift_add", "xtime",
               "gf_mul", "mixcolumns")
RS_BANKS, RS_WORDS, RS_ROWS, RS_K, RS_NPAR = 32, 65536, 120, 8, 4
PIPE_BANKS, PIPE_WORDS, PIPE_CHUNKS = 8, 2048, 4
OPS = ("not", "and", "or", "xor", "maj")
# Phases 13-15: the static verifier's gates, the serving front end, and the
# paper's Tables 4 and 5.
LINT_FIXTURE = ROOT / "tests" / "fixtures" / "lint" / "pim104.trace"
LINT_100K = 100_000
# Phase 4b: refresh cycles of these fractions of the refresh interval
# (once refused on the card; the reference counts them)
REFRESH_FRACS = (0.6, 0.78, 0.95)
# Phases 3-4's graphs: the pipeline's steps, the workload's steps per phase
# (phase 4's three layouts) and its interleaved order, warm calls timed
GRAPH_PIPE_STEPS = 16
GRAPH_WORKLOAD_STEPS = (2, 2, 2)
GRAPH_ORDER = (0, 1, 2, 0, 1, 2)
GRAPH_REPLAYS = 5
FRONT_TENANTS = 8            # six on the serving bench's stream, two on XOR
FRONT_STREAM_TENANTS = 6
FRONT_BANKS = 4              # banks per tenant: 8 x 4 = the device's 32
FRONT_STEPS = 16
FRONT_SHIFT = 40             # benchmarks/serve_bench.py's chain
# variation % -> (paper Table 4, the reference test's absolute bound)
TABLE4 = {0.0: (0.0, 0.0), 5.0: (0.005, 0.004), 10.0: (0.14, 0.04),
          20.0: (0.30, 0.06)}
TABLE4_TRIALS = 100_000


def say(line: str) -> None:
    print(line, flush=True)


@functools.lru_cache(maxsize=4)
def _seeded_rows(seed: int, shape):
    import numpy as np
    a = np.random.default_rng(seed).integers(0, 2**32, shape,
                                             dtype=np.uint32)
    a.setflags(write=False)
    return a.view(np.int32)


def rows_from_seed(seed: int, shape, torch, device):
    """int32 rows made by numpy from ``seed``, copied onto ``device``."""
    return torch.tensor(_seeded_rows(seed, tuple(shape)), device=device)


def event_us(fn, torch, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in microseconds, host
    launch overhead included (the card waits for the host between the
    events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def device_us(fn, torch, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one call of ``fn``, in microseconds, without the
    host's launch overhead: ``per_graph`` calls captured in a CUDA graph,
    each replay timed with CUDA events, the median of ``reps`` replays
    divided by ``per_graph``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / per_graph)
    return statistics.median(times)


def max_abs_err(a, b):
    a, b = a.cpu(), b.cpu()
    if a.numel() == 0:
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fadd_latency(torch, device) -> dict:
    """The latency of one dependent float32 add on the card: one thread
    adds FADD_CHAIN times in a ``__fadd_rn`` chain (``fadd_chain_kernel``
    in rowops.cu). SM cycles per add from clock64 inside the kernel; ns per
    add from CUDA events around the launch."""
    from repro_torch.kernels.rowops import ops
    lib = ops._lib()
    x = torch.tensor([1.0, 2.0**-30], device=device)
    out = torch.empty(1, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        rc = lib.rowops_fadd_chain(x.data_ptr(), out.data_ptr(),
                                   cycles.data_ptr(), FADD_CHAIN, stream)
        if rc:
            raise RuntimeError(f"fadd_chain launch failed: CUDA error {rc}")

    us = event_us(run, torch, reps=5, warmup=1)
    r = dict(adds=FADD_CHAIN, cycles_per_add=int(cycles.item()) / FADD_CHAIN,
             ns_per_add=us * 1e3 / FADD_CHAIN)
    say(f"fadd chain: {FADD_CHAIN} dependent __fadd_rn adds in one thread: "
        f"{r['cycles_per_add']:.3f} SM cycles per add (clock64), "
        f"{r['ns_per_add']:.4f} ns per add (CUDA events)")
    return r


def fold_bound_ms(m: int, nbytes: int, fadd: dict):
    """meter_fold's bound, in ms, and what sets it: each float (slot,
    field) adds its m increments in table order, so the chains take m
    dependent adds at the measured latency however many run beside each
    other; the bytes (each table and meter read once, written once) at
    the memory rate where they take longer."""
    t_chain = m * fadd["ns_per_add"] * 1e-6
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_chain, t_bytes), ("operations" if t_chain >= t_bytes
                                   else "bytes")


def phase_kernels(torch, device, fadd, n: int = 64, w: int = 2048):
    import numpy as np
    from repro_torch.kernels.rowops import ops, ref

    x = rows_from_seed(1, (n, w), torch, device)
    b = rows_from_seed(2, (n, w), torch, device)
    c = rows_from_seed(3, (n, w), torch, device)
    x_cpu = x.cpu()
    err = {"shift_cols": 0, "bitwise[maj]": 0, "bitwise[not]": 0,
           "bitwise[and]": 0, "bitwise[xor]": 0, "meter_fold": 0}
    for k in SHIFT_KS:
        got = ops.shift_cols(x, k).cpu()
        for exp in (ref.ref_shift_cols(x, k).cpu(),
                    ref.ref_shift_cols(x_cpu, k)):
            if not torch.equal(got, exp):
                raise AssertionError(f"shift_cols k={k} differs from plain")
            err["shift_cols"] = max(err["shift_cols"], max_abs_err(got, exp))
    for op in OPS:
        got = ops.bitwise(x, b, c, op=op)
        exp = ref.ref_bitwise(x, b, c, op=op)
        if not torch.equal(got, exp):
            raise AssertionError(f"bitwise {op} differs from plain")
        if f"bitwise[{op}]" in err:
            err[f"bitwise[{op}]"] = max_abs_err(got, exp)
    # meter_fold at a main-path shape: shift_k(1000)'s event tables folded
    # onto every slot of the full device
    f_tab, i_tab = fold_tables_of(torch, device)
    rng = np.random.default_rng(4)
    f0 = torch.from_numpy((rng.random((n, 6)) * 1e5).astype(np.float32)
                          ).to(device)
    i0 = torch.from_numpy(rng.integers(0, 10**6, (n, 6)).astype(np.int32)
                          ).to(device)
    ff, fi = ops.meter_fold(f_tab, i_tab, f0, i0)
    ef, ei = ref.ref_meter_fold(f_tab, i_tab, f0, i0)
    if not (torch.equal(ff.cpu().view(torch.int32),
                        ef.cpu().view(torch.int32))
            and torch.equal(fi.cpu(), ei.cpu())):
        raise AssertionError("meter_fold differs from the numpy fold")
    err["meter_fold"] = max(max_abs_err(ff.cpu(), ef.cpu()),
                            max_abs_err(fi.cpu(), ei.cpu()))

    m, cols = f_tab.shape[0], f0.shape[1] + i0.shape[1]
    calls = {   # name: (kernel, plain version, one PyTorch call or None)
        "shift_cols": (lambda: ops.shift_cols(x, 999),
                       lambda: ref.ref_shift_cols(x, 999), None),
        "bitwise[maj]": (lambda: ops.bitwise(x, b, c, op="maj"),
                         lambda: ref.ref_bitwise(x, b, c, op="maj"), None),
        "bitwise[not]": (lambda: ops.bitwise(x, op="not"),
                         lambda: ref.ref_bitwise(x, op="not"),
                         lambda: torch.bitwise_not(x)),
        "bitwise[and]": (lambda: ops.bitwise(x, b, op="and"),
                         lambda: ref.ref_bitwise(x, b, op="and"),
                         lambda: torch.bitwise_and(x, b)),
        "bitwise[xor]": (lambda: ops.bitwise(x, b, op="xor"),
                         lambda: ref.ref_bitwise(x, b, op="xor"),
                         lambda: torch.bitwise_xor(x, b)),
        "meter_fold": (lambda: ops.meter_fold(f_tab, i_tab, f0, i0),
                       lambda: ref.ref_meter_fold(f_tab, i_tab, f0, i0),
                       None),
    }
    work = {   # name: (bytes moved, operations, shape)
        "shift_cols": (8 * n * w, 0, f"({n}, {w}) int32, k=999"),
        "bitwise[maj]": (4 * 4 * n * w, 0, f"3 x ({n}, {w}) int32"),
        "bitwise[not]": (2 * 4 * n * w, 0, f"({n}, {w}) int32"),
        "bitwise[and]": (3 * 4 * n * w, 0, f"2 x ({n}, {w}) int32"),
        "bitwise[xor]": (3 * 4 * n * w, 0, f"2 x ({n}, {w}) int32"),
        "meter_fold": (4 * (m * cols + 2 * n * cols), m * n * cols,
                       f"({m}, 6+6) tables onto ({n}, 6+6)"),
    }
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        nbytes, nops, shape = work[name]
        # The plain meter fold runs in numpy on the host: it cannot be
        # captured in a graph, so it is timed with events around the call.
        plain_us = (event_us(plain, torch) if name == "meter_fold"
                    else device_us(plain, torch))
        rows[name] = dict(
            ms=device_us(kernel, torch) / 1e3,
            call_ms=event_us(kernel, torch) / 1e3,
            plain_ms=plain_us / 1e3,
            library_ms=(None if library is None
                        else device_us(library, torch) / 1e3),
            bytes=nbytes, ops=nops, shape=shape)
    for name, r in rows.items():
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["ops"] / H100_F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = err[name]
        beside = ""
        if name == "meter_fold":
            # the adds at the float32 rate would take t_ops; their order
            # makes them a chain, which takes m add latencies
            r["throughput_bound_ms"] = r["bound_ms"]
            r["bound_ms"], r["bound_by"] = fold_bound_ms(m, r["bytes"], fadd)
            beside = (f" = {m} adds x {fadd['ns_per_add']:.4f} ns; the adds "
                      f"at the float32 rate {t_ops * 1e3:.3f} us")
        say(f"kernel {name} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
            f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}{beside}), "
            f"max_abs_err {r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: the executor's row entries against their plain versions, beside
# the lowering they replace
# ---------------------------------------------------------------------------

def old_lowering(torch, ops, bits, seg, rows, delta=1, k=1000):
    """One segment as the executor lowered it before the row entries: the
    out-of-place kernel on gathered source rows, then the glue (row copies;
    for a shift chain the migration masks and the last hop in torch ops)."""
    from repro_torch.core.pim.isa import lsr
    from repro_torch.core.pim.state import EVEN_MASK, ODD_MASK

    def shift1(row):
        zero = torch.zeros(row.shape[:-1] + (1,), dtype=row.dtype,
                           device=row.device)
        if delta > 0:
            return (row << 1) | lsr(torch.cat([zero, row[..., :-1]], -1), 31)
        return lsr(row, 1) | (torch.cat([row[..., 1:], zero], -1) << 31)

    if seg == "maj":
        (a, b, c), dsts = rows
        m = ops.bitwise(bits[:, a].contiguous(), bits[:, b].contiguous(),
                        bits[:, c].contiguous(), op="maj")
        for r in dsts:
            bits[:, r] = m
        return None
    if seg == "not":
        (src,), (dst,) = rows
        dcc = ops.bitwise(bits[:, src].contiguous(), op="not")
        bits[:, dst] = dcc
        return dcc
    src, dst = rows
    y = ops.shift_cols(bits[:, src].contiguous(), delta * (k - 1))
    mt = y & (EVEN_MASK if delta > 0 else ODD_MASK)
    mb = y & (ODD_MASK if delta > 0 else EVEN_MASK)
    bits[:, dst] = shift1(mt) | shift1(mb)
    return mt, mb


def row_cases(r):
    """(name, segment, in place, rows) of the timed row-entry calls on an
    (B, r, W) state: a fused MAJ (T0, T1, T2 and dst; in place, dst is a
    source), a NOT pair (dst and DCC), a 1,000-hop shift chain
    (``shift_workload(1000)``'s)."""
    t0, t1, t2 = r - 3, r - 4, r - 5
    return [("bitwise_rows[maj]", "maj", False, ((0, 1, 2), (t0, t1, t2, 3))),
            ("bitwise_rows[maj]", "maj", True, ((0, 1, 2), (t0, t1, t2, 0))),
            ("bitwise_rows[not]", "not", False, ((7,), (8,))),
            ("bitwise_rows[not]", "not", True, ((7,), (7,))),
            ("shift_rows", "shift", False, (4, 5)),
            ("shift_rows", "shift", True, (4, 4))]


def phase_row_kernels(torch, device):
    """``bitwise_rows`` and ``shift_rows`` at ROW_SLOTS slots of ROW_SHAPE
    rows: bit for bit against their plain versions (every alias; shifts at
    ROW_KS both ways, in place and out of place), then each segment timed:
    the kernel's device time and per-call time, its plain version's, and
    the old lowering's (kernel plus glue, one CUDA graph), beside the bound
    (bytes: source rows read once, destination rows written once)."""
    from repro_torch.kernels.rowops import ops, ref

    r, w = ROW_SHAPE
    checks = 0
    for n in ROW_SLOTS:
        base = rows_from_seed(8, (n, r, w), torch, device)
        for name, seg, in_place, rows in row_cases(r):
            if seg == "shift":
                for delta in (1, -1):
                    for k in ROW_KS + (32 * w, 32 * w + 1):
                        got, exp = base.clone(), base.clone()
                        g = ops.shift_rows(got, *rows, delta, k)
                        e = ref.ref_shift_rows(exp, *rows, delta, k)
                        if not (torch.equal(got, exp)
                                and all(map(torch.equal, g, e))):
                            raise AssertionError(
                                f"shift_rows {rows} delta {delta} k {k} at "
                                f"{n} slots differs from plain")
                        checks += 1
                continue
            side = seg == "not"
            got, exp = base.clone(), base.clone()
            g = ops.bitwise_rows(got, seg, *rows, side=side)
            e = ref.ref_bitwise_rows(exp, seg, *rows, side=side)
            if not (torch.equal(got, exp)
                    and (not side or torch.equal(g, e))):
                raise AssertionError(f"{name} {rows} at {n} slots differs "
                                     "from plain")
            checks += 1
    out = {}
    for n in ROW_SLOTS:
        for name, seg, in_place, rows in row_cases(r):
            bits = rows_from_seed(8, (n, r, w), torch, device)
            if seg == "shift":
                calls = (lambda: ops.shift_rows(bits, *rows, 1, 1000),
                         lambda: ref.ref_shift_rows(bits, *rows, 1, 1000))
                moved = 1 + 3            # the source; dst, mt, mb
            else:
                side = seg == "not"
                calls = (lambda: ops.bitwise_rows(bits, seg, *rows,
                                                  side=side),
                         lambda: ref.ref_bitwise_rows(bits, seg, *rows,
                                                      side=side))
                moved = len(rows[0]) + len(rows[1]) + side
            old = lambda: old_lowering(torch, ops, bits, seg, rows)
            before = dict(ops.LAUNCHES)
            calls[0]()
            torch.cuda.synchronize()
            launched = sum(ops.LAUNCHES[k] - before[k] for k in before)
            if launched != 1:
                raise AssertionError(f"{name}: {launched} launches, not 1")
            nbytes = 4 * moved * n * w
            key = (f"{name} ({n}, {r}, {w}) "
                   f"{'in place' if in_place else 'out of place'}")
            out[key] = dict(
                name=name, slots=n, in_place=in_place,
                ms=device_us(calls[0], torch) / 1e3,
                call_ms=event_us(calls[0], torch) / 1e3,
                plain_ms=device_us(calls[1], torch) / 1e3,
                old_ms=device_us(old, torch) / 1e3,
                old_call_ms=event_us(old, torch) / 1e3,
                bytes=nbytes, bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, max_abs_err=0)
    for key, v in out.items():
        say(f"kernel {key}: kernel {v['ms'] * 1e3:.2f} us "
            f"({v['call_ms'] * 1e3:.2f} us per call with the host's launch),"
            f" old lowering {v['old_ms'] * 1e3:.2f} us "
            f"({v['old_call_ms'] * 1e3:.2f} us per call), plain "
            f"{v['plain_ms'] * 1e3:.2f} us, bound {v['bound_ms'] * 1e3:.3f} "
            f"us (bytes), max_abs_err 0")
    say(f"row entries: {checks} calls bit for bit against their plain "
        f"versions at {ROW_SLOTS} slots x {r} rows x {w} words, every alias;"
        " one launch per call")
    return out


class RowTally:
    """Within ``with``, counts the fused segments and residual SHIFT, TRA
    and NOT-to-DCC rows of every compiled program the executor runs on the
    card: the calls the row entries take, one launch each. Read from the
    compiled programs, not from the wrappers' counts."""

    def __init__(self):
        self.rows = 0

    def __enter__(self):
        from repro_torch.core.pim import exec as pim_exec
        from repro_torch.core.pim import ir
        from repro_torch.core.pim.compile import (SegMaj, SegNot, SegScan,
                                                  SegShiftRun)
        self._exec, self._run = pim_exec, pim_exec._run_segments
        kinds = (ir.OP_SHIFT, ir.OP_TRA, ir.OP_NOT2DCC)

        def spy(compiled, bits, *args):
            if bits.device.type == "cuda":
                for seg in compiled.segments:
                    if isinstance(seg, (SegMaj, SegNot, SegShiftRun)):
                        self.rows += 1
                    elif isinstance(seg, SegScan):
                        self.rows += sum(op.op in kinds for op in seg.ops)
            return self._run(compiled, bits, *args)

        pim_exec._run_segments = spy
        return self

    def __exit__(self, *exc):
        self._exec._run_segments = self._run
        return False


def row_records(top) -> dict:
    """The row entries' and the meter fold's kernel records in a profiler
    window (``device_share``'s ``top``), by kernel."""
    out: dict = {}
    for k in top:
        for kernel in ("shift_rows_kernel", "bitwise_rows_kernel",
                       "meter_fold_kernel"):
            if kernel in k["name"]:
                out[kernel] = out.get(kernel, 0) + k["count"]
    return out


def captured_rows(replayed) -> int:
    """The row-entry launches that the replayed graphs' captures recorded:
    their nodes' label, not a launch count."""
    return sum(n for g in replayed for (counter, key), n in g.kernels.items()
               if counter == "launches" and key in ("bitwise_rows",
                                                    "shift_rows"))


def launch_count(torch, name, fn) -> dict:
    """``fn`` three times with the PIM graphs dropped first: the first call
    runs eagerly, the second captures its graph (a one-off program, such as
    a VM flush, runs eagerly again), the third replays it under the
    profiler. The segments and rows are tallied at the second call (at
    capture the segment walk runs once, as it does eagerly); the third's
    window holds the card's operations (kernels, copies and fills), the
    row entries' kernel records and its graph and kernel launches. Fails
    unless the row entries ran once per segment and row: launched by the
    wrappers in the window (their counts, which a replay does not move) or
    recorded into the replayed graph at its capture; if the profiler saw
    more row kernels than that, or another number inside a replayed graph;
    or if an old out-of-place entry ran. The profiler has been seen to miss
    one kernel record of a few dozen on the card; a row kernel it misses
    outside a graph must then show as a runtime launch call without a
    kernel record."""
    from repro_torch.core.pim import graphs
    from repro_torch.kernels.rowops import ops
    graphs._entries.clear()
    graphs._seen.clear()
    fn()
    torch.cuda.synchronize()
    with RowTally() as tally:
        fn()
    torch.cuda.synchronize()
    ops.reset_launches()
    graphs._replay_log = []
    try:
        sh = device_share(torch, fn)
        replayed = graphs._replay_log
    finally:
        graphs._replay_log = None
    records = row_records(sh["top"])
    row_kernels = (records.get("shift_rows_kernel", 0)
                   + records.get("bitwise_rows_kernel", 0))
    scratch = ops.SHIFT_ROUTES["scratch"] + sum(
        g.kernels.get(("routes", "scratch"), 0) for g in replayed)
    kernels = sum(k["count"] for k in sh["top"]
                  if not k["name"].startswith(("Memcpy", "Memset")))
    rec = dict(device_ops=sum(k["count"] for k in sh["top"]),
               launch_calls=sh["launch_calls"], kernel_records=kernels,
               graph_launches=sh["graph_launches"],
               graph_nodes=[g.nodes for g in replayed],
               top=sh["top"],
               row_kernels=row_kernels, rows=tally.rows,
               wrapper_launches=ops.LAUNCHES["bitwise_rows"]
               + ops.LAUNCHES["shift_rows"],
               captured_rows=captured_rows(replayed), scratch_copies=scratch,
               old_entries=(ops.LAUNCHES["bitwise"]
                            + ops.LAUNCHES["shift_cols"]
                            + sum(g.kernels.get(("launches", k), 0)
                                  for g in replayed
                                  for k in ("bitwise", "shift_cols"))),
               before=BEFORE_OPS.get(name), wall_ms=sh["wall_ms"],
               device_ms=sh["device_ms"])
    unrecorded = max(rec["launch_calls"] - kernels, 0)
    if not (rec["wrapper_launches"] + rec["captured_rows"] == rec["rows"]
            >= rec["row_kernels"]
            and rec["rows"] - rec["row_kernels"] <= unrecorded
            and (not replayed or rec["row_kernels"] == rec["captured_rows"])
            and rec["old_entries"] == 0
            and rec["graph_launches"] == len(replayed)):
        raise AssertionError(f"launches {name}: {rec}")
    return rec


def say_launches(counts: dict) -> None:
    say("launches per run (device operations in the profiler window of a "
        "warm call; row kernels = fused segments + residual SHIFT/TRA/NOT "
        "rows, one kernel each, tallied at capture; before: torch ops the "
        "executor dispatched before the row entries, at commit edcfc58, "
        "counted on the CPU): " + "; ".join(
            f"{k} {v['device_ops']} ({v['graph_launches']} graph launches"
            + (f" of {'/'.join(map(str, v['graph_nodes']))} nodes"
               if v["graph_nodes"] else "")
            + f", {v['launch_calls']} kernel launches outside graphs, "
            f"{v['wrapper_launches']} row-entry launches by the wrappers "
            f"and {v['captured_rows']} recorded in the replayed graph for "
            f"{v['rows']} segments and rows, "
            f"{v['row_kernels']} row kernels in the profiler, "
            f"{max(v['launch_calls'] - v['kernel_records'], 0)} launch "
            "calls without a kernel record"
            + (f", {v['scratch_copies']} scratch copies"
               if v["scratch_copies"] else "")
            + (f"; before {v['before']}" if v["before"] else "") + ")"
            for k, v in counts.items()))


def fold_tables_of(torch, device, m: int | None = None):
    """shift_workload(1000)'s event tables (4,001 rows) on ``device``, or
    their first ``m`` rows."""
    import numpy as np
    from repro_torch.core import pim
    f_tab, i_tab = pim.cost_tables(pim.shift_workload_program(1000, 512,
                                                              2048))
    return (torch.from_numpy(np.array(f_tab[:m])).to(device),
            torch.from_numpy(np.array(i_tab[:m])).to(device))


class FoldShapes:
    """Within ``with``, records the tables every ``meter_fold`` call on the
    card folds and keeps the largest (most rows); the wrapper itself, and
    its launch count, are untouched."""

    def __init__(self):
        self.calls, self.largest = 0, None

    def __enter__(self):
        from repro_torch.kernels.rowops import ops
        self._ops, self._fold = ops, ops.meter_fold

        def spy(f_tab, i_tab, f0, i0):
            if f0.device.type == "cuda":
                self.calls += 1
                if (self.largest is None
                        or f_tab.shape[0] > self.largest[0].shape[0]):
                    self.largest = (f_tab, i_tab)
            return self._fold(f_tab, i_tab, f0, i0)

        ops.meter_fold = spy
        return self

    def __exit__(self, *exc):
        self._ops.meter_fold = self._fold
        return False


def phase_fold_sweep(torch, device, fadd, largest):
    """meter_fold at FOLD_ROWS rows and at the largest table the paths
    folded (``largest``: its own field counts), onto FOLD_SLOTS slots: bit
    for bit against its plain version; device time beside the chain
    bound."""
    import numpy as np
    from repro_torch.kernels.rowops import ops, ref

    tables = [fold_tables_of(torch, device, m) for m in FOLD_ROWS]
    tables.append(largest)
    rng = np.random.default_rng(12)
    rows = []
    for f_tab, i_tab in tables:
        m, nf, ni = f_tab.shape[0], f_tab.shape[1], i_tab.shape[1]
        for slots in FOLD_SLOTS:
            f0 = torch.from_numpy((rng.random((slots, nf)) * 1e5)
                                  .astype(np.float32)).to(device)
            i0 = torch.from_numpy(rng.integers(0, 10**6, (slots, ni))
                                  .astype(np.int32)).to(device)
            got = ops.meter_fold(f_tab, i_tab, f0, i0)
            exp = ref.ref_meter_fold(f_tab, i_tab, f0, i0)
            if not (torch.equal(got[0].view(torch.int32),
                                exp[0].view(torch.int32))
                    and torch.equal(got[1], exp[1])):
                raise AssertionError(f"meter_fold m={m} slots={slots} "
                                     "differs from the numpy fold")
            nbytes = 4 * (m * (nf + ni) + 2 * slots * (nf + ni))
            bound_ms, bound_by = fold_bound_ms(m, nbytes, fadd)
            r = dict(m=m, slots=slots, nf=nf, ni=ni, bound_ms=bound_ms,
                     bound_by=bound_by,
                     ms=device_us(lambda: ops.meter_fold(f_tab, i_tab, f0,
                                                         i0), torch) / 1e3)
            rows.append(r)
            say(f"fold m={m} slots={slots} ({nf}+{ni} fields): kernel "
                f"{r['ms'] * 1e3:.2f} us, chain bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}), "
                f"{r['ms'] / bound_ms:.2f}x the bound; bit for bit")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: one subarray at full geometry through execute()
# ---------------------------------------------------------------------------

def subarray_programs(rows: int = 512, words: int = 2048):
    """(name, program, refresh) of the subarray phase."""
    import numpy as np
    from repro_torch.core import pim

    out = [(f"shift_workload({n})", pim.shift_workload_program(n, rows,
                                                                words), False)
           for n in (1, 50, 100, 512, 1000)]
    b = pim.ProgramBuilder(rows, words)
    row = np.random.default_rng(5).integers(0, 2**32, (words,),
                                            dtype=np.uint32)
    b.write_row(0, row).issue().shift_k(0, 1, 1000)
    b.read_row(1)
    out.append(("quickstart", b.build(), True))
    out.append(("ambit_xor", pim.ambit_xor_program(rows, words), False))
    return out


def subarray_state(torch, device, rows: int = 512, words: int = 2048):
    from repro_torch.core import pim
    bits = rows_from_seed(6, (rows, words), torch, device)
    return pim.reserve_control_rows(pim.SubarrayState(
        bits=bits, mig_top=torch.zeros(words, dtype=torch.int32,
                                       device=device),
        mig_bot=torch.zeros(words, dtype=torch.int32, device=device),
        dcc=torch.zeros(words, dtype=torch.int32, device=device),
        meter=pim.CostMeter.zeros(device)))


def states_equal(torch, a, b) -> bool:
    fields = ("bits", "mig_top", "mig_bot", "dcc")
    if not all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields):
        return False
    from repro_torch.core.pim.state import FLOAT_FIELDS, INT_FIELDS
    for f in FLOAT_FIELDS + INT_FIELDS:
        x, y = getattr(a.meter, f).cpu(), getattr(b.meter, f).cpu()
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def reads_equal(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu())
                                    for x, y in zip(a, b))


def run_subarray(torch, device, rows=512, words=2048):
    """Main-path runs of phase 3 on ``device``: name -> ExecResult."""
    from repro_torch.core import pim
    state = subarray_state(torch, device, rows, words)
    return {name: pim.execute(prog, state, refresh=refresh)
            for name, prog, refresh in subarray_programs(rows, words)}


def check_subarray(torch, device, results, rows=512, words=2048):
    from repro_torch.core import pim
    gpu_state = subarray_state(torch, device, rows, words)
    cpu_state = subarray_state(torch, "cpu", rows, words)
    for name, prog, refresh in subarray_programs(rows, words):
        got = results[name]
        eager, eager_reads = pim.run_program(gpu_state, prog)
        if refresh:
            eager.meter = pim.apply_refresh(eager.meter)
        cpu = pim.execute(prog, cpu_state, refresh=refresh)
        for what, st, rd in (("eager ISA on the card", eager, eager_reads),
                             ("execute on the CPU", cpu.state, cpu.reads)):
            if not (states_equal(torch, got.state, st)
                    and reads_equal(torch, got.reads, rd)):
                raise AssertionError(f"subarray {name}: execute on the card "
                                     f"differs from the {what}")


# ---------------------------------------------------------------------------
# Phase 4: the full device through schedule()
# ---------------------------------------------------------------------------

def device_steps(cfg):
    """Three steps of per-slot programs: (programs, flags)."""
    import numpy as np
    from repro_torch.core import pim

    R, W = cfg.num_rows, cfg.words

    def chain(src, dst, k):
        return pim.ProgramBuilder(R, W).issue().shift_k(src, dst, k).build()

    mixed = (pim.ProgramBuilder(R, W).issue().ambit_and(4, 5, 6)
             .ambit_or(6, 7, 8).ambit_not(8, 9).shift_k(9, 10, 7)
             .tra(11, 12, 13).dra(13, 14).build())
    steps = []
    for k, flags in enumerate(({}, {"async_host": True},
                               {"async_host": True, "refresh": True})):
        rng = np.random.default_rng(100 + k)
        host = pim.ProgramBuilder(R, W).issue()
        host.write_row(20, np.zeros(W, np.uint32)).shift_k(20, 21, 64)
        host.read_row(21)
        host = host.build()
        flat = []
        for slot in range(cfg.n_slots):
            kind = slot % 8
            if kind == 0:
                flat.append(chain(0, 1, 40 + k))
            elif kind == 1:
                flat.append(chain(2, 3, -100))
            elif kind == 2:
                flat.append(chain(1, 15, 300))
            elif kind == 3:
                flat.append(pim.ambit_xor_program(R, W, a=0, b=1, dst=2))
            elif kind == 4:        # same stream, per-slot HOSTW data
                flat.append(host.with_payloads([rng.integers(
                    0, 2**32, (W,), dtype=np.uint32)]))
            elif kind == 5:
                flat.append(pim.xor_reduce_program(R, W, [0, 1, 2], 3))
            elif kind == 6:
                flat.append(None)
            else:
                flat.append(mixed)
        nb = cfg.n_banks
        moves = [((b, 0, 1), ((b + 1) % nb, 1, 30)) for b in range(nb)]
        if k == 1:     # a dependent chain: a later copy reads an earlier one
            moves += [((0, 1, 30), (5, 0, 31)), ((5, 0, 31), (9, 1, 32))]
        steps.append((pim.gather_rows(cfg, moves, flat), flags))
    return steps


def device_start(torch, device, cfg):
    from repro_torch.core import pim
    dev = pim.make_device(cfg, device=device)
    dev.banks.bits[:, :-2] = rows_from_seed(
        7, (cfg.n_slots, cfg.num_rows - 2, cfg.words), torch, device)
    return dev


def run_device(torch, device, cfg, steps, verify=False):
    from repro_torch.core import pim
    dev = device_start(torch, device, cfg)
    results = []
    for programs, flags in steps:
        r = pim.schedule(dev, programs, verify=verify, **flags)
        results.append(r)
        dev = r.state
    return results


def check_device(torch, gpu_results, cpu_results):
    for k, (g, c) in enumerate(zip(gpu_results, cpu_results)):
        if not states_equal(torch, g.state.banks, c.state.banks):
            raise AssertionError(f"device step {k}: state differs from CPU")
        for f in ("wall_ns", "energy_nj"):
            x, y = getattr(g, f).cpu(), getattr(c, f).cpu()
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"device step {k}: {f} {x} != {y}")
        for f in ("copy_ns", "copy_queue_ns", "copy_total_ns", "bus_ns",
                  "host_bytes", "channel_bus_ns", "host_overlap_ns"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"device step {k}: {f} differs")
        gr, cr = g.reads, c.reads
        if len(gr) != len(cr) or any(
                len(a) != len(b) or any((x != y).any() for x, y in zip(a, b))
                for a, b in zip(gr, cr)):
            raise AssertionError(f"device step {k}: reads differ")
        if not (torch.isfinite(g.wall_ns) and float(g.wall_ns) > 0
                and float(g.energy_nj) > 0):
            raise AssertionError(f"device step {k}: bad wall/energy")


# ---------------------------------------------------------------------------
# Phase 4b: refresh cycles past half the interval (ROADMAP C9, repaired)
# ---------------------------------------------------------------------------

def phase_refresh(torch, device) -> dict:
    """``refresh_events`` on the card at tRFC = REFRESH_FRACS·tREFI over
    seeded busy times (counts below 2^30), eagerly and captured in a CUDA
    graph replayed on other busy times, each equal to the CPU's loop (which
    the CPU tests hold to the reference's ``while_loop``); phase 4's three
    steps on a small device at the first of them, refreshed, each run
    (eager, capture, replay) equal to the CPU's bit for bit; tRFC =
    tREFI refused on the card."""
    import dataclasses

    import numpy as np
    from repro_torch.core import pim
    from repro_torch.core.pim import timing

    def busy_times(cfg, seed):
        rng = np.random.default_rng(seed)
        b = (rng.random(20000) * 10.0 ** rng.integers(0, 12, 20000)
             ).astype(np.float32)
        return torch.from_numpy(b[b / (cfg.tREFI - cfg.tRFC) < 2.0 ** 30][
            :15000])

    out = {}
    for frac in REFRESH_FRACS:
        cfg = dataclasses.replace(pim.DEFAULT_TIMING,
                                  tRFC=frac * pim.DEFAULT_TIMING.tREFI)
        a, b = busy_times(cfg, 20), busy_times(cfg, 21)
        eager = pim.refresh_events(a.to(device), cfg).cpu()
        static = a.to(device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pim.refresh_events(static, cfg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            counted = pim.refresh_events(static, cfg)
        static.copy_(b)
        graph.replay()
        replayed = counted.cpu()
        if not (torch.equal(eager, pim.refresh_events(a, cfg))
                and torch.equal(replayed, pim.refresh_events(b, cfg))):
            raise AssertionError(f"refresh_events at tRFC {cfg.tRFC}: the "
                                 "card differs from the CPU's loop")
        rounds = timing._refresh_plan(cfg.tRFC, cfg.tREFI)[3]
        out[str(frac)] = {"busy": len(a), "rounds": rounds,
                          "largest": int(eager.max())}
        del graph, static, counted
    long = dataclasses.replace(pim.DEFAULT_TIMING, tRFC=REFRESH_FRACS[0]
                               * pim.DEFAULT_TIMING.tREFI)
    cfg = pim.paper_device(16, subarrays=2, num_rows=64, words=64,
                           timing=long)
    steps = [(programs, {"async_host": True, "refresh": True})
             for programs, _ in device_steps(cfg)]
    cpu = run_device(torch, "cpu", cfg, steps)
    for _ in range(3):          # eager, capture, replay
        check_device(torch, run_device(torch, device, cfg, steps), cpu)
    try:
        pim.refresh_events(torch.ones(4, device=device), dataclasses.replace(
            pim.DEFAULT_TIMING, tRFC=pim.DEFAULT_TIMING.tREFI))
    except ValueError:
        pass
    else:
        raise AssertionError("refresh_events counted tRFC = tREFI")
    say("refresh (C9): refresh_events on the card at tRFC = "
        + ", ".join(f"{f} ({v['rounds']} re-counts, counts to "
                    f"{v['largest']})" for f, v in out.items())
        + " x tREFI, eager and replayed from a CUDA graph == the CPU's loop "
        f"over {sum(v['busy'] for v in out.values())} busy times; 3 "
        f"refreshed schedule() steps at {REFRESH_FRACS[0]} x tREFI, eager, "
        "captured and replayed == CPU bit for bit; tRFC = tREFI refused")
    return out


# ---------------------------------------------------------------------------
# Phases 3-4, graphs: each PIM entry's warm call one CUDA-graph replay
# ---------------------------------------------------------------------------

def _rows_equal(torch, a, b) -> bool:
    """Two nested tuples of row or float32 tensors (or plain numbers)
    equal, float32 as bit patterns."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_rows_equal(torch, x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        x = torch.as_tensor(a).cpu()
        y = torch.as_tensor(b).cpu()
        if x.dtype == torch.float32:
            x = x.view(torch.int32)
        if y.dtype == torch.float32:
            y = y.view(torch.int32)
        return x.shape == y.shape and torch.equal(x, y)
    return a == b


def results_equal(torch, a, b) -> bool:
    """Two results of one PIM entry bit for bit: states (rows, migration
    and DCC rows, every meter field, the async credit), reads, and per
    step ``wall_ns``, ``energy_nj``, hidden host time and (workloads) the
    boundary credit."""
    import numpy as np
    from repro_torch.core import pim
    if isinstance(a, VMRun):
        return (states_equal(torch, a.state, b.state)
                and len(a.values) == len(b.values)
                and all(np.array_equal(x, y)
                        for x, y in zip(a.values, b.values)))
    if isinstance(a, pim.ExecResult):
        return (states_equal(torch, a.state, b.state)
                and reads_equal(torch, a.reads, b.reads))
    if not (states_equal(torch, a.state.banks, b.state.banks)
            and _rows_equal(torch, a.state.host_credit_ns,
                            b.state.host_credit_ns)):
        return False
    pa = a.phases if hasattr(a, "phases") else (a,)
    pb = b.phases if hasattr(b, "phases") else (b,)
    return len(pa) == len(pb) and all(
        _rows_equal(torch, x._group_reads, y._group_reads)
        and _rows_equal(torch, (x.wall_ns, x.energy_nj,
                                x.host_overlap_ns_lazy,
                                getattr(x, "_boundary_credit_ns", 0.0)),
                        (y.wall_ns, y.energy_nj, y.host_overlap_ns_lazy,
                         getattr(y, "_boundary_credit_ns", 0.0)))
        for x, y in zip(pa, pb))


class VMRun(tuple):
    """A single-bank VM's state and the values its run returned, flat."""

    state = property(lambda self: self[0])
    values = property(lambda self: self[1])


def vm_one_bank(device):
    """A single-bank VM at phase 10's row size (``VM_ROWS`` x
    ``VM_WORDS``): its recorded runs go through ``exec``'s pipeline and
    workload runners."""
    from repro_torch.core.bitplane import PimVM
    return PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)


def vm_graph_runs(seed: int = 31):
    """``(run_pipeline, run_workload)`` calls on a single-bank VM: four
    ripple-add steps, then those and three xtime steps as two phases. Each
    returns a ``VMRun``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lanes = VM_WORDS * 32 // 8
    xs = [(rng.integers(0, 256, lanes), rng.integers(0, 256, lanes))
          for _ in range(4)]
    ys = [rng.integers(0, 256, lanes) for _ in range(3)]

    def flat(outs):
        return [np.asarray(v) for seq in outs for v in
                (seq if isinstance(seq, (list, tuple)) else [seq])]

    def pipe(vm):
        return VMRun((vm.state, flat(vm.run_pipeline(_add_step, xs))))

    def workload(vm):
        return VMRun((vm.state, flat(vm.run_workload(
            [(_add_step, xs), (_xtime_step, ys)]))))

    return pipe, workload


def graph_entries(cfg, steps) -> dict:
    """name -> (input kind, call, graph launches of a warm call): the PIM
    entries at full geometry whose warm call is one CUDA-graph replay,
    ``schedule_workload`` with ``order=`` one replay per step. The
    workload's three phases are phase 4's three steps' layouts with their
    async flags, two steps each. The VM's runs take a fresh single-bank VM
    (kind ``vm``), made outside the timed window."""
    from repro_torch.core import pim
    prog = pim.shift_workload_program(1000)
    (l0, f0), (l1, _), _ = steps
    phases = [pim.Phase.repeat(lay, n, async_host=bool(f.get("async_host")))
              for (lay, f), n in zip(steps, GRAPH_WORKLOAD_STEPS)]
    vm_pipe, vm_workload = vm_graph_runs()
    return {
        "execute(shift_workload(1000))": (
            "subarray", lambda st: pim.execute(prog, st), 1),
        "VM run_pipeline (1 bank)": ("vm", vm_pipe, 1),
        "VM run_workload (1 bank)": ("vm", vm_workload, 1),
        "schedule() step 1": (
            "device", lambda dev: pim.schedule(dev, l0, **f0), 1),
        f"schedule_pipeline {GRAPH_PIPE_STEPS} steps": (
            "device", lambda dev: pim.schedule_pipeline(
                dev, l1, n_steps=GRAPH_PIPE_STEPS, async_host=True), 1),
        "schedule_workload 3 phases": (
            "device", lambda dev: pim.schedule_workload(dev, phases,
                                                        refresh=True), 1),
        "schedule_workload order=": (
            "device", lambda dev: pim.schedule_workload(
                dev, phases, order=GRAPH_ORDER, refresh=True),
            len(GRAPH_ORDER)),
    }


def graph_kernels(sh, replayed) -> dict:
    """The row kernels of a warm call's profiler window, by kernel, beside
    those its replayed graphs' captures recorded (their label). Fails
    unless the two agree: the window's row and fold kernels are the
    graphs'."""
    got = row_records(sh["top"])
    label: dict = {}
    for g in replayed:
        for (counter, key), n in g.kernels.items():
            if counter == "launches" and key in ("shift_rows",
                                                 "bitwise_rows",
                                                 "meter_fold"):
                label[f"{key}_kernel"] = label.get(f"{key}_kernel", 0) + n
    if got != label:
        raise AssertionError(f"graph kernels: the profiler saw {got}, the "
                             f"replayed graphs hold {label}")
    return got


def phase_graphs(torch, device, cfg, steps) -> dict:
    """Each PIM entry's first call (eager), second (capture, then one
    replay) and warm calls (replays, median of GRAPH_REPLAYS) on the host
    clock, with the graphs dropped before the first; the three card calls
    and the CPU's bit for bit; a warm call under the profiler: its kernel
    ms, graph and kernel launches (exactly the entry's replays and none
    outside a graph, else the run fails), its graphs' nodes, the capture
    ms and the pool bytes the captures reserved."""
    import importlib
    from repro_torch.core.pim import graphs
    sched = importlib.import_module("repro_torch.core.pim.schedule")
    inputs = {"subarray": {w: subarray_state(torch, w)
                           for w in (device, "cpu")},
              "device": {w: device_start(torch, w, cfg)
                         for w in (device, "cpu")}}

    def arg_for(kind, where):
        return vm_one_bank(where) if kind == "vm" else inputs[kind][where]

    out = {}
    for name, (kind, call, n_replays) in graph_entries(cfg, steps).items():
        times = []
        graphs._entries.clear()
        graphs._seen.clear()
        results = []
        for k in range(2 + GRAPH_REPLAYS):
            arg = arg_for(kind, device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            results.append(call(arg))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if k == 0 and graphs._entries:
                raise AssertionError(f"graphs {name}: the first call "
                                     "captured a graph")
        held = [e for e in graphs._entries.values()
                if isinstance(e, graphs._Graph)]
        cpu = call(arg_for(kind, "cpu"))
        for k, r in enumerate(results):
            if not results_equal(torch, r, cpu):
                raise AssertionError(f"graphs {name}: call {k + 1} on the "
                                     "card differs from the CPU")
        if not results_equal(torch, results[0], call(arg_for(kind, device))):
            raise AssertionError(f"graphs {name}: a later call changed the "
                                 "first call's result")
        arg = arg_for(kind, device)
        d0 = sched.SCHED_STATS["dispatches"]
        graphs._replay_log = []
        try:
            sh = device_share(torch, lambda: call(arg))
            replayed = graphs._replay_log
        finally:
            graphs._replay_log = None
        rec = dict(first_ms=times[0], second_ms=times[1],
                   capture_ms=sum(g.capture_ms for g in held),
                   replayed_ms=statistics.median(times[2:]),
                   replayed_ms_all=times[2:], kernel_ms=sh["device_ms"],
                   graph_launches=sh["graph_launches"],
                   kernel_launches=sh["launch_calls"],
                   dispatches=sched.SCHED_STATS["dispatches"] - d0,
                   graphs=len(held), nodes=[g.nodes for g in held],
                   replayed_nodes=[g.nodes for g in replayed],
                   graph_kernels=graph_kernels(sh, replayed),
                   pool_bytes=sum(g.pool_bytes for g in held),
                   pinned_bytes=sum(g.nbytes for g in held),
                   profile_wall_ms=sh["wall_ms"])
        if (rec["graph_launches"], rec["kernel_launches"],
                len(replayed)) != (n_replays, 0, n_replays):
            raise AssertionError(f"graphs {name}: {rec['graph_launches']} "
                                 f"graph launches ({len(replayed)} replays) "
                                 f"and {rec['kernel_launches']} kernel "
                                 f"launches per warm call, not "
                                 f"{n_replays} and 0")
        out[name] = rec
        say(f"graphs {name}: first call {rec['first_ms']:.2f} ms (eager), "
            f"second {rec['second_ms']:.2f} ms (capture "
            f"{rec['capture_ms']:.2f} ms of it, then one replay), replayed "
            f"{rec['replayed_ms']:.3f} "
            f"ms (median of {GRAPH_REPLAYS}; "
            + ", ".join(f"{t:.3f}" for t in times[2:])
            + f") beside {rec['kernel_ms']:.3f} ms of kernels; "
            f"{rec['graph_launches']} cudaGraphLaunch and "
            f"{rec['kernel_launches']} kernel launches per warm call, "
            f"dispatches {rec['dispatches']}; {rec['graphs']} graph(s) of "
            + "/".join(map(str, rec["nodes"])) + " nodes (replayed: "
            + "/".join(map(str, rec["replayed_nodes"])) + ", their kernel "
            "records in the profiler " + json.dumps(rec["graph_kernels"])
            + "); pool "
            f"{rec['pool_bytes']} bytes reserved at capture, "
            f"{rec['pinned_bytes']} bytes of static inputs and outputs; "
            "== eager first call == CPU, bit for bit")
    graphs._entries.clear()
    graphs._seen.clear()
    return out


# ---------------------------------------------------------------------------

def device_share(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host-clock ms of the
    window, the card's summed kernel time in it, their ratio (the card's
    busy share; one stream, so kernels do not overlap), every kernel, the
    longest first, the host's kernel-launch calls to the CUDA runtime
    (``launch_calls``) and to the driver (``driver_launch_calls``), and its
    CUDA-graph launches (``graph_launches``). The profiler's raw events are
    summed by name here (what ``key_averages`` reports for them, without
    building its event tree, which takes seconds for a replayed graph of
    10^5 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name, launch_calls, driver_calls, graph_launches = {}, 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        # device-side entries only (kernels, copies)
        if e.device_type() == DeviceType.CUDA:
            entry = by_name.setdefault(name, [0.0, 0])
            entry[0] += e.duration_ns() / 1e6
            entry[1] += 1
        elif name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launch_calls += 1
        elif name.startswith("cuLaunchKernel"):
            driver_calls += 1
        elif name.startswith("cudaGraphLaunch"):
            graph_launches += 1
    kernels = sorted(((ms, name, n) for name, (ms, n) in by_name.items()
                      if ms > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else 0.0,
            "top": [{"name": k[1], "ms": k[0], "count": k[2]}
                    for k in kernels], "launch_calls": launch_calls,
            "driver_launch_calls": driver_calls,
            "graph_launches": graph_launches}


# ---------------------------------------------------------------------------
# Phase 6: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def _kernel_row(torch, kernel, plain, library, nbytes, nops, shape, err,
                per_graph=5, reps=5):
    """Times of one kernel call (device and per call), its plain version and
    its library call, in ms, and its bound from ``nbytes`` and ``nops``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_BF16_OPS_PER_S * 1e3
    return dict(
        ms=device_us(kernel, torch, per_graph, reps) / 1e3,
        call_ms=event_us(kernel, torch, reps=reps) / 1e3,
        plain_ms=device_us(plain, torch, per_graph, reps) / 1e3,
        library_ms=device_us(library, torch, per_graph, reps) / 1e3,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, ops=nops, shape=shape, max_abs_err=err)


def _say_row(name, r):
    route = f" [{r['route']}]" if "route" in r else ""
    beside = "".join(f", {other} route {r[f'{other}_ms'] * 1e3:.2f} us"
                     for other in ("tiled", "cuda_core")
                     if f"{other}_ms" in r)
    say(f"kernel {name}{route} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
        f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
        f"plain {r['plain_ms'] * 1e3:.2f} us, library "
        f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us "
        f"({r['bound_by']}){beside}, max_abs_err {r['max_abs_err']:.3e}"
        + ("" if "of_bound" not in r else
           f" ({r['of_bound']['bfloat16']:.3f} of the bound per query row; "
           f"float32 on the {r['route_f32']} route {r['max_abs_err_f32']:.3e}"
           f", {r['of_bound']['float32']:.3f} of its bound)"))


def cycled(copies):
    """``fn`` -> a callable that calls ``fn(*copies[i % len(copies)])``
    with i counting its calls: each call finds other operands."""
    def wrap(fn):
        calls = iter(range(10**9))
        return lambda: fn(*copies[next(calls) % len(copies)])
    return wrap


def phase_lm_kernels(torch, device):
    """pim_matmul and flash_attn at the serving path's shapes, each against
    its plain version on the same tensors; name -> row."""
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.kernels.pim_matmul import ref as pref

    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}
    cases = [(shape, (4, 8), ("shift_add", "dequant"))
             for shape in PIM_SHAPES]
    cases += [(shape, (4,), ("shift_add",))
              for shape in PIM_SHAPES_RG + PIM_SHAPES_TRAIN
              + PIM_SHAPES_DENSE]
    for (m, k, n), bit_widths, modes in cases:
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device)
        decode = m < pm.TC_MIN_M
        for bits in bit_widths:
            w_int, scales = pm.quantize(w, bits)
            w_deq = pref.ref_dequant(w_int, scales, bits).to(
                torch.bfloat16)
            # decode: the timed calls cycle over WEIGHT_COPIES copies
            copies = [(w_int, w_deq)] + [
                (w_int.clone(), w_deq.clone())
                for _ in range(WEIGHT_COPIES - 1 if decode else 0)]
            out = torch.empty((m, n), device=device)
            for mode in modes:
                def kernel(w_int, w_deq, x=x, scales=scales, mode=mode,
                           bits=bits):
                    return pm.pim_matmul(x, w_int, scales, mode=mode,
                                         bits=bits)

                def plain(w_int, w_deq, x=x, scales=scales, mode=mode,
                          bits=bits):
                    return pref.ref_pim_matmul_raw(
                        x, w_int, mode=mode, bits=bits) * scales[None, :]

                got, exp = kernel(w_int, w_deq), plain(w_int, w_deq)
                torch.cuda.synchronize()
                err = max_abs_err(got, exp)
                top = float(exp.abs().max())
                if not (torch.isfinite(got).all() and err <= PIM_REL * top):
                    raise AssertionError(
                        f"pim_matmul {mode} w{bits} ({m}, {k}, {n}): "
                        f"max abs err {err} > {PIM_REL} x {top}")
                name = f"pim_matmul[{mode},w{bits}] ({m},{k})@({k},{n})"
                cyc = cycled(copies)
                rows[name] = _kernel_row(
                    torch, cyc(kernel), cyc(plain),
                    cyc(lambda w_int, w_deq, x=x: torch.matmul(x, w_deq)),
                    2 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n,
                    f"x ({m}, {k}) bf16, w ({k}, {n}) int{bits}"
                    + (f", {len(copies)} weight copies cycled"
                       if decode else ""), err)
                rows[name]["route"] = pm.route(m, k, n, x.dtype)
                if decode:
                    rows[name]["cuda_core_ms"] = device_us(
                        cyc(lambda w_int, w_deq, x=x, scales=scales,
                            out=out, mode=mode, bits=bits:
                            pm._launch(x, w_int, scales, out, mode, bits,
                                       "cuda_core")),
                        torch, 5, 5) / 1e3
                _say_row(name, rows[name])
                del got, exp
            del copies
    for phase, shape in FLASH_SHAPES.items():
        name = f"flash_attn[{phase}]"
        rows[name] = flash_row(torch, device, gen, shape)
        _say_row(name, rows[name])
    name = "flash_attn[prefill,lse]"
    rows[name] = flash_lse_row(torch, device, gen, FLASH_TRAIN)
    _say_row(name, rows[name])
    return rows


def flash_operands(torch, device, gen, shape):
    """q, k, v (float32), positions and the seen mask (B, Sq, Sk) of one
    FLASH_SHAPES entry; unwritten slots hold kpos -1 and poisoned
    values."""
    B, KV, G, dk, dv, sq, sk, last, window, ring = shape
    q = torch.randn((B, sq, KV, G, dk), generator=gen, device=device)
    k = torch.randn((B, sk, KV, dk), generator=gen, device=device)
    v = torch.randn((B, sk, KV, dv), generator=gen, device=device)
    pos_q = torch.arange(last - sq + 1, last + 1, dtype=torch.int32,
                         device=device)
    slots = torch.arange(sk, dtype=torch.int32, device=device)
    if ring:      # slot j holds the latest position p <= last, p = j mod sk
        pos_k = (last - torch.remainder(last - slots, sk)).repeat(B, 1)
    else:
        pos_k = slots.repeat(B, 1)
        pos_k[:, last + 1:] = -1
    v[pos_k < 0] = 1e4                # unwritten slots must weigh 0
    seen = ((pos_k[:, None, :] >= 0)
            & (pos_k[:, None, :] <= pos_q[None, :, None]))   # (B, Sq, Sk)
    if window is not None:
        seen &= (pos_q[None, :, None] - pos_k[:, None, :]) < window
    return q, k, v, pos_q, pos_k, seen


def flash_row_bound(exp):
    """FLASH_BF16_REL of max |exp| over each query row of a (B, Sq, KV, G,
    dv) output, broadcast to its shape."""
    return FLASH_BF16_REL * exp.float().abs().amax(dim=(2, 3, 4),
                                                   keepdim=True)


def flash_row(torch, device, gen, shape):
    """One flash_attn shape: the kernel of the route ops.route gives it
    against its plain version in float32 and bf16 (bf16 per query row,
    ``flash_row_bound``), then timed in bf16 beside the plain version and
    SDPA (timed only; the port never calls it); a tensor-core row also
    times the tiled route on the same tensors. The route takes float32 to
    the CUDA cores (tiled or split), so a tensor-core row's float32 error
    is theirs. A long shape (FLASH_PLAIN_BYTES): the plain version on the
    first and last FLASH_LONG_ROWS query rows alone, SDPA causal on
    repeated kv heads, fewer timed calls and no tiled route."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_attn import ref as fref

    B, KV, G, dk, dv, sq, sk, last, window, ring = shape
    long = 4 * B * KV * G * sq * sk > FLASH_PLAIN_BYTES
    q, k, v, pos_q, pos_k, seen = flash_operands(torch, device, gen, shape)
    held = torch.arange(sq, device=device)
    if long:
        held = torch.cat([held[:FLASH_LONG_ROWS], held[-FLASH_LONG_ROWS:]])

    def plain(q, k, v):
        if len(held) == sq:
            return fref.ref_flash_attention(q, k, v, pos_q, pos_k,
                                            window=window)
        return fref.ref_flash_attention(q[:, held], k, v, pos_q[held],
                                        pos_k, window=window)

    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args = (q.to(dt), k.to(dt), v.to(dt), pos_q, pos_k)
        got = fa.flash_attention(*args, window=window)
        got = got if len(held) == sq else got[:, held]
        exp = plain(*args[:3])
        torch.cuda.synchronize()
        diff = (got.float() - exp.float()).abs()
        bound = (FLASH_F32_ABS if dt == torch.float32 else
                 flash_row_bound(exp))
        share = float((diff / bound).max())
        if not (got.shape == exp.shape and torch.isfinite(got.float()).all()
                and share < 1):
            raise AssertionError(f"flash_attn {shape} {dt}: max abs err "
                                 f"{float(diff.max())}, {share:.3f} of the "
                                 "bound")
        errs[str(dt).split(".")[-1]] = float(diff.max()), share
        del got, exp, diff
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    qt = qb.reshape(B, sq, KV * G, dk).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    mask = seen[:, None]
    pairs = int(seen.sum())
    if long and sq > 1:      # causal from position 0: no mask to build
        kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
    rows_held = ("" if len(held) == sq else
                 f"; plain on query rows 0-{FLASH_LONG_ROWS - 1} and "
                 f"{sq - FLASH_LONG_ROWS}-{sq - 1}")
    row = _kernel_row(
        torch,
        lambda: fa.flash_attention(qb, kb, vb, pos_q, pos_k, window=window),
        lambda: plain(qb, kb, vb), library,
        2 * (qb.numel() + kb.numel() + vb.numel() + B * sq * KV * G * dv)
        + 4 * (pos_q.numel() + pos_k.numel()),
        2 * (dk + dv) * KV * G * pairs,
        f"q ({B}, {sq}, {KV}, {G}, {dk}), k ({B}, {sk}, {KV}, {dk}), v "
        f"(.., {dv}) bf16{'' if window is None else f', window {window}'}"
        f"{', ring' if ring else ''}, {pairs} seen (query, key) pairs"
        + rows_held, errs["bfloat16"][0], per_graph=1 if long else 10,
        reps=3 if long else 10)
    row["route"] = fa.route(sq, G, torch.bfloat16, dk, dv)
    row["route_f32"] = fa.route(sq, G, torch.float32, dk, dv)
    row["max_abs_err_f32"] = errs["float32"][0]
    row["of_bound"] = {dt: share for dt, (_, share) in errs.items()}
    row["plain_rows"] = len(held)
    if row["route"] == "tensor_core" and not long:
        out = torch.empty(qb.shape[:-1] + (dv,), dtype=qb.dtype,
                          device=device)
        row["tiled_ms"] = device_us(lambda: fa._launch(
            qb, kb, vb, pos_q, pos_k, out, window, dk ** -0.5, "tiled"),
            torch, 5, 5) / 1e3
        del out
    if row["route"] == "split_kv":
        row["splits"] = fa._splits(B * KV, sq * G, sk, dk, dv, 1,
                                   device.index or 0)
    del q, k, v, qb, kb, vb, qt, kt, vt
    return row


def flash_routes_timed(torch, device):
    """Device us of the three flash routes, bf16, at Qwen3-4B's heads (B
    4, KV 8, G 4, dh 128) for each Sq of FLASH_THRESHOLD_SQ and Sk of
    FLASH_THRESHOLD_SK, the queries at the last positions; then of the
    split route at each count of FLASH_SPLITS and its own at the decode
    shapes of FLASH_SHAPES."""
    from repro_torch.kernels.flash_attn import ops as fa

    gen = torch.Generator(device=device).manual_seed(19)
    times = {}
    for sk in FLASH_THRESHOLD_SK:
        for sq in FLASH_THRESHOLD_SQ:
            q, k, v, pos_q, pos_k, _ = flash_operands(
                torch, device, gen, (4, 8, 4, 128, 128, sq, sk, sk - 1, None,
                                     False))
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            out = torch.empty_like(q)
            times[f"rows {4 * sq}, Sk {sk}"] = {
                which: device_us(lambda which=which: fa._launch(
                    q, k, v, pos_q, pos_k, out, None, 128 ** -0.5, which),
                    torch, 5, 5)
                for which in FLASH_ROUTES}
            del q, k, v, out
    say(f"route threshold flash_attn (B 4, KV 8, G 4, dh 128, bf16), "
        f"SPLIT_MAX_ROWS {fa.SPLIT_MAX_ROWS}: " + "; ".join(
            f"{key}: " + ", ".join(f"{w} {t[w]:.2f} us" for w in FLASH_ROUTES)
            for key, t in times.items()))
    splits = {}
    for phase, shape in FLASH_SHAPES.items():
        B, KV, G, dk, dv, sq, sk, last, window, ring = shape
        if fa.route(sq, G, torch.bfloat16, dk, dv) != "split_kv":
            continue
        q, k, v, pos_q, pos_k, _ = flash_operands(torch, device, gen, shape)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = torch.empty(q.shape[:-1] + (dv,), dtype=q.dtype, device=device)
        chosen = fa._splits(B * KV, sq * G, sk, dk, dv, 1, device.index or 0)
        us = {n: device_us(lambda n=n: fa._launch(
            q, k, v, pos_q, pos_k, out, window, dk ** -0.5, "split_kv", n),
            torch, 5, 5) for n in sorted({chosen, *FLASH_SPLITS})}
        splits[phase] = {"chosen": chosen, "us": us}
        say(f"splits flash_attn[{phase}] chosen {chosen}: " + ", ".join(
            f"{n}: {t:.2f} us" for n, t in us.items()))
        del q, k, v, out
    return {"threshold_us": times, "splits": splits}


def pim_routes_timed(torch, device):
    """Device us of the pim_matmul routes at the threshold's M, of the
    tensor-core kernel at each K split count at M = 512 and of the
    swapped kernel at each at M = 4 (w4 shift_add); the calls cycle over
    WEIGHT_COPIES copies of the weights."""
    from repro_torch.kernels.pim_matmul import ops as pm

    gen = torch.Generator(device=device).manual_seed(17)

    def operands(m, k, n):
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        w_int, scales = pm.quantize(
            torch.randn((k, n), generator=gen, device=device), 4)
        copies = [(w_int,)] + [(w_int.clone(),)
                               for _ in range(WEIGHT_COPIES - 1)]
        return x, copies, scales, torch.empty((m, n), device=device)

    def timed(ops, which, splits=None):
        x, copies, scales, out = ops
        return device_us(cycled(copies)(
            lambda w_int: pm._launch(x, w_int, scales, out, "shift_add", 4,
                                     which, splits)), torch, 5, 5)

    threshold = {}
    for m in THRESHOLD_MS:
        ops = operands(m, 2560, 9728)
        threshold[m] = {r: timed(ops, r) for r in PIM_ROUTES
                        if r != "swap_ab" or m < pm.TC_MIN_M}
        del ops
    say(f"route threshold (M, 2560) @ (2560, 9728) w4, {WEIGHT_COPIES} "
        f"weight copies cycled, TC_MIN_M {pm.TC_MIN_M}: " + "; ".join(
            f"M {m}: " + ", ".join(f"{r} {us:.2f} us" for r, us in t.items())
            for m, t in threshold.items()))
    lib = pm._lib()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = {}
    for which, label, rule, counts, shapes in (
            ("tensor_core", "tc", lib.pim_matmul_tc_splits, TC_SPLITS,
             PIM_SHAPES[2:]),
            ("swap_ab", "swap_ab", lib.pim_matmul_swap_splits, SWAP_SPLITS,
             PIM_SHAPES[:2])):
        for m, k, n in shapes:
            ops = operands(m, k, n)
            chosen = rule(m, k, n, 4, sms)
            times = {s: timed(ops, which, s)
                     for s in sorted({chosen, *counts})}
            splits[f"{label} ({m},{k})@({k},{n})"] = {"chosen": chosen,
                                                      "us": times}
            say(f"splits pim_matmul[{label}] ({m},{k})@({k},{n}) w4, "
                f"chosen {chosen}: " + ", ".join(f"{s}: {t:.2f} us"
                                                 for s, t in times.items()))
            del ops
    return {"threshold_us": threshold, "splits": splits}


def ptxas(library, kernel, key):
    """Registers, static shared memory and spill bytes ptxas reported for
    each kernel instance of ``library`` whose mangled name matches the
    regex ``kernel``, under ``key(match)``; empty where this process did
    not build the library."""
    import re
    from repro_torch.kernels import _build

    out = {}
    for part in _build.BUILD_LOG.get(library, "").split(
            "Compiling entry function")[1:]:
        match = re.search(kernel, part)
        if match is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
        out[key(match)] = {
            "registers": int(regs.group(1)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "spill_bytes": int(spills.group(1)) + int(spills.group(2))}
    return out


def tc_ptxas():
    """ptxas's report of each instance of the tensor-core kernel, and its
    dynamic shared memory."""
    from repro_torch.kernels.pim_matmul import ops as pm
    return {"dynamic_smem_bytes": pm._lib().pim_matmul_tc_smem_bytes(),
            **ptxas("pim_matmul", r"pim_matmul_tc_kernelILi(\d+)E",
                    lambda m: f"bits{m.group(1)}")}


def flash_ptxas():
    """ptxas's report of each instance of the split route's two kernels
    ("split bf16 rb4", ..., "merge f32")."""
    return ptxas(
        "flash_attn",
        r"flash_(split|merge)_kernelI(13__nv_bfloat16|f)(?:Li(\d+)E)?",
        lambda m: (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'}"
                   + (f" rb{m.group(3)}" if m.group(3) else "")))


# flash's tensor-core instances that must not spill: the serving path's
# (128, 128), MLA's prefill (192, 128) and recurrentgemma's (256, 256)
FLASH_TC_NO_SPILL = ("128/128", "192/128", "256/256")


def flash_tc_ptxas():
    """ptxas's report of each instance of flash's tensor-core kernel
    ("128/128": dk and dv widths), and its dynamic shared memory at the
    prefill shapes."""
    import torch
    from repro_torch.kernels.flash_attn import ops as fa
    lib = fa._lib()
    smem = {}
    for phase, (_, _, G, dk, dv, sq, sk, *_) in FLASH_SHAPES.items():
        if fa.route(sq, G, torch.bfloat16, dk, dv) == "tensor_core":
            smem[phase] = lib.flash_attn_tc_smem_bytes(dk, dv, sk)
    return {"dynamic_smem_bytes": smem,
            **ptxas("flash_attn", r"flash_tc_kernelILi(\d+)ELi(\d+)E",
                    lambda m: f"{m.group(1)}/{m.group(2)}")}


def sass_opcodes(library, kernel, key):
    """Opcode counts (a ``collections.Counter``, "IMAD.MOV" counted as
    "IMAD") of each instance of ``library``'s kernels whose mangled name
    matches ``kernel``, from ``cuobjdump -sass`` of the built library,
    under ``key(match)``."""
    import collections
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path(library))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        match = re.match(r"\S*" + kernel, part)
        if match is not None:
            counts[key(match)] = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+([A-Z][A-Z0-9]*)", part))
    return counts


def hmma_counts(library, kernel, key):
    """HMMA instructions in each instance of ``library``'s kernels whose
    mangled name matches ``kernel`` (see ``sass_opcodes``)."""
    return {k: c["HMMA"] for k, c in sass_opcodes(library, kernel,
                                                  key).items()}


def tc_sass():
    """HMMA instructions in each instance of pim_matmul's tensor-core
    kernel (bits -> count)."""
    return hmma_counts("pim_matmul", r"pim_matmul_tc_kernelILi(\d+)E",
                       lambda m: f"bits{m.group(1)}")


SWAP_KERNEL = r"pim_matmul_swap_kernelILi(\d+)ELi(\d+)E"


def swap_key(match):
    return f"bits{match.group(1)} mf{match.group(2)}"


def swap_ptxas():
    """ptxas's report of each instance of pim_matmul's swapped-operand
    kernel ("bits4 mf1": planes, n8 fragments of the batch)."""
    return ptxas("pim_matmul", SWAP_KERNEL, swap_key)


# The swapped kernel's loop body is two k16 steps, 64 weight codes per lane
# each; its integer instructions by pipe, at NVIDIA's per-SM rates for
# compute capability 9.0: logic, shifts, permutes and adds on the 64-lane
# integer pipe; IMAD on the FMA pipe, 64 lanes; conversions at 16.
SWAP_CODES_PER_PASS = 2 * 64
SWAP_PIPES = {"alu": (("LOP3", "PRMT", "SHF", "IADD3", "LEA", "ISETP",
                       "SEL", "VIADD"), 64),
              "imad": (("IMAD",), 64),
              "conversion": (("I2F", "F2FP", "F2F"), 16)}


def swap_sass():
    """Each instance of the swapped kernel: its HMMA count and its integer
    instructions per weight code by pipe (the static count of the whole
    kernel over the 128 codes a lane takes in one pass of its two-step
    loop, so the one-time prologue and epilogue count too)."""
    out = {}
    for key, ops in sass_opcodes("pim_matmul", SWAP_KERNEL,
                                 swap_key).items():
        out[key] = {"HMMA": ops["HMMA"], "per_code": {
            pipe: sum(ops[o] for o in names) / SWAP_CODES_PER_PASS
            for pipe, (names, _) in SWAP_PIPES.items()}}
    return out


def swap_integer_floor_ms(per_code, codes):
    """The least time ``codes`` weight codes' integer work takes on one
    H100: the busiest pipe's instructions over its lanes x 132 SMs x 1.98
    GHz."""
    return max(per_code[pipe] * codes / (lanes * 132 * 1.98e9)
               for pipe, (_, lanes) in SWAP_PIPES.items()) * 1e3


def flash_tc_sass():
    """HMMA instructions in each instance of flash's tensor-core kernel
    ("128/128" -> count)."""
    return hmma_counts("flash_attn", r"flash_tc_kernelILi(\d+)ELi(\d+)E",
                       lambda m: f"{m.group(1)}/{m.group(2)}")


# ---------------------------------------------------------------------------
# Phases 7-8 and 16-17: the LM serving path
# ---------------------------------------------------------------------------

def lm_config(**overrides):
    from repro_torch.configs import get_config
    arch, quant = LM_ARCH
    return get_config(arch, **quant, **overrides)


def family_config(arch, overrides, **more):
    """``arch``'s configuration with ``overrides`` (``impl``: the MoE's
    dispatch) and ``more``."""
    import dataclasses
    from repro_torch.configs import get_config
    kw = {**overrides, **more}
    impl = kw.pop("impl", None)
    cfg = get_config(arch, **kw)
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


def cfg_name(cfg) -> str:
    """The arch, its quantization and (MoE) dispatch, as the lines name
    them."""
    name = cfg.arch_id
    if cfg.quant:
        name += f" {cfg.quant} {cfg.quant_mode}"
    if cfg.moe is not None:
        name += f" impl {cfg.moe.impl}"
    return name


def pim_linears(cfg) -> int:
    """The quantized linears one pass of the model runs, each one
    pim_matmul launch: every dense FFN's (the hybrid's: one per layer,
    recurrent or attention), a MoE layer's shared experts' (attention, the
    routed experts, the recurrent mixers and the heads are not quantized,
    as in the reference; an SSM layer has no FFN)."""
    if not cfg.quant or cfg.family == "ssm":
        return 0
    per_ffn = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.moe is None:
        return per_ffn * cfg.n_layers
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    shared = 1 if cfg.moe.n_shared_experts else 0
    return per_ffn * (cfg.moe.first_k_dense + shared * n_moe)


def prompt_tokens(torch, seed, batch, length, vocab, device):
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, vocab, (batch, length)), dtype=torch.int32, device=device)


def seeded_normal(torch, seed, shape, device):
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                           dtype=torch.float32, device=device)


def prompt_batch(torch, cfg, seed, batch, length, device):
    """A seeded prompt on ``device``: ``length`` tokens, after a vision
    model's ``n_patches`` patch embeddings (float32); an audio model's
    ``length`` frame embeddings."""
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": seeded_normal(
            torch, seed, (batch, length, cfg.d_model), device)}
    out = {"tokens": prompt_tokens(torch, seed, batch, length,
                                   cfg.vocab_size, device)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = seeded_normal(
            torch, seed + 1, (batch, cfg.n_patches, cfg.d_model), device)
    return out


def input_key(cfg) -> str:
    return "frame_embeds" if cfg.frontend == "audio_frames" else "tokens"


def prompt_len(cfg, batch) -> int:
    """Positions the prompt takes (the patches, then the tokens)."""
    n = batch[input_key(cfg)].shape[1]
    return n + (cfg.n_patches if cfg.frontend == "vision_patches" else 0)


def rel_err(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def teacher_forced(cfg, model, batch, feed, device):
    """Prefill logits, then one decode step per entry of ``feed`` ((B, n)
    tokens, or (B, n, D) frames) over a cache of prompt + n + 1 positions
    (greedy_generate's for n + 1 tokens): a list of float32 logits."""
    from repro_torch.models import decode_step, prefill
    s, n = prompt_len(cfg, batch), feed.shape[1]
    logits, caches = prefill(cfg, model, batch, s + n + 1, device=device)
    out = [logits]
    for t in range(n):
        logits, caches = decode_step(cfg, model,
                                     {input_key(cfg): feed[:, t:t + 1]},
                                     s + t, caches, device=device)
        out.append(logits)
    return out


def argmax_chain(torch, cfg, logits):
    """(B, n) int32: the argmax of each step's (B, 1, V) logits."""
    return torch.stack([torch.argmax(lg[:, 0, :cfg.vocab_size], -1)
                        for lg in logits], dim=1).to(torch.int32)


class RouterLog:
    """The router probabilities (float32, on the host) of every
    ``moe_ffn`` call made inside the ``with`` block, in call order: one
    (tokens, E) table per MoE layer and pass. Eager calls only: the copy
    to the host synchronises."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import ffn
        self._ffn, self._orig = ffn, ffn.moe_ffn

        def record(cfg, p, x):
            logits = x.reshape(-1, x.shape[-1]).float() @ p.router
            self.calls.append(self.torch.softmax(logits, -1).cpu())
            return self._orig(cfg, p, x)

        ffn.moe_ffn = record
        return self

    def __exit__(self, *exc):
        self._ffn.moe_ffn = self._orig


def router_flips(torch, cfg, ref, got, where):
    """The tokens whose top-k experts differ between the reference run's
    router tables ``ref`` and ``got`` (pairs of (tokens, E) tables, the
    same rows): dicts of request, position and MoE layer (``where(pair,
    row)``), the reference's margin (k-th less (k+1)-th probability) and
    k-th probability, and whether an earlier flip of that request (an
    earlier layer, at or before that position) reaches it."""
    K = cfg.moe.top_k
    flips = []
    for i, (a, b) in enumerate(zip(ref, got)):
        top = a.topk(K + 1, dim=-1)
        sa = top.indices[:, :K].sort(-1).values
        sb = b.topk(K, dim=-1).indices.sort(-1).values
        for row in (sa != sb).any(-1).nonzero().flatten().tolist():
            request, position, layer = where(i, row)
            flips.append(dict(
                request=request, position=position, layer=layer,
                margin=float(top.values[row, K - 1] - top.values[row, K]),
                p_k=float(top.values[row, K - 1])))
    for f in flips:
        f["follows"] = any(
            g["request"] == f["request"] and g["position"] <= f["position"]
            and g["layer"] < f["layer"] for g in flips)
    return flips


def capacity_kept(torch, cfg, probs):
    """(tokens, E) bool: the experts each token of one ``moe_ffn`` call
    reaches after the capacity drops, from its router table ``probs``:
    top-k, slot-major priority over chunks of ``dispatch_chunk`` tokens,
    ``ffn._capacity`` slots per expert (as both MoE forms dispatch)."""
    from repro_torch.models.ffn import _capacity
    T, E, K = probs.shape[0], cfg.moe.n_experts, cfg.moe.top_k
    chunk = min(cfg.moe.dispatch_chunk, T)
    C = _capacity(chunk, cfg)
    idx = probs.topk(K, dim=-1).indices
    kept = torch.zeros((T, E), dtype=torch.bool)
    for lo in range(0, T, chunk):
        e = idx[lo:lo + chunk].T.reshape(-1)             # slot-major
        tok = torch.arange(lo, lo + chunk).repeat(K)
        oh = torch.nn.functional.one_hot(e, E)
        keep = (oh.cumsum(0) - 1).gather(1, e[:, None])[:, 0] < C
        kept[tok[keep], e[keep]] = True
    return kept


def router_moved(torch, cfg, ref, got, where):
    """The tokens whose experts after the capacity drops differ between
    the router tables ``ref`` and ``got`` (as ``router_flips``): each
    flip, and each token a flip pushed past an expert's capacity or let
    in; dicts of request, position and MoE layer."""
    moved = []
    for i, (a, b) in enumerate(zip(ref, got)):
        diff = (capacity_kept(torch, cfg, a)
                != capacity_kept(torch, cfg, b)).any(-1)
        for row in diff.nonzero().flatten().tolist():
            request, position, layer = where(i, row)
            moved.append(dict(request=request, position=position,
                              layer=layer))
    return moved


def check_flips(flips, what):
    """A flip that follows no earlier one must lie inside the rounding: a
    reference margin within LOGITS_REL of the k-th probability."""
    wide = [f for f in flips
            if not f["follows"] and not f["margin"] <= LOGITS_REL * f["p_k"]]
    if wide:
        raise AssertionError(f"{what}: routing flips beyond the rounding: "
                             f"{wide}")


def say_flips(flips) -> str:
    return "; ".join(
        f"request {f['request']} position {f['position']} MoE layer "
        f"{f['layer']} (margin {f['margin']:.3e} of p_k {f['p_k']:.3e}"
        + (", after an earlier flip)" if f["follows"] else ")")
        for f in flips) or "no routing flip"


def decode_vs_prefill(torch, cfg, model, batch, max_len, bound=LOGITS_REL,
                      device=None):
    """prefill(S) against prefill(S − 1) + decode_step(S − 1) on the last
    position: (rel, the last token's routing flips between the two, held).
    Held to ``bound`` without MoE (measured, not held, where it is None:
    the recurrent families at full depth). With MoE it is measured, not
    held: the
    two paths round the hidden state differently (MLA's absorbed decode
    more so: the reference's own test allows deepseek 3e-2 at 3 layers),
    which moves router choices whose margin lies inside that difference,
    at the last token (reported here) and at any earlier one (prefill(S)
    and prefill(S − 1) run their products at other shapes)."""
    from repro_torch.models import decode_step, prefill
    key = input_key(cfg)
    S = prompt_len(cfg, batch)
    pre = dict(batch, **{key: batch[key][:, :-1]})
    with RouterLog(torch) as full_log:
        full, _ = prefill(cfg, model, batch, max_len, device=device)
    with RouterLog(torch) as dec_log:
        _, caches = prefill(cfg, model, pre, max_len, device=device)
        dec, _ = decode_step(cfg, model, {key: batch[key][:, -1:]}, S - 1,
                             caches, device=device)
    rel = rel_err(torch, dec, full)
    if cfg.moe is not None:
        B, n = full.shape[0], len(full_log.calls)
        last = [c.reshape(B, S, -1)[:, -1] for c in full_log.calls]
        return rel, router_flips(torch, cfg, last, dec_log.calls[n:],
                                 lambda i, row: (row, S - 1, i)), False
    if bound is None:
        return rel, [], False
    if not rel < bound:
        raise AssertionError(f"{cfg.arch_id}: decode vs prefill logits rel "
                             f"{rel} >= {bound}")
    return rel, [], True


def counted(torch, fn):
    """``fn()`` with the LM kernels' launch counts and DECODE_STATS reset
    just before it and read just after it, and its ms."""
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.serve import engine
    pm.reset_launches()
    fa.reset_launches()
    engine.DECODE_STATS["dispatches"] = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3, dict(
        launches={"pim_matmul": pm.LAUNCHES["pim_matmul"],
                  "flash_attn": fa.LAUNCHES["flash_attn"]},
        routes=dict(pm.ROUTES), flash_routes=dict(fa.ROUTES),
        lse_routes=dict(fa.LSE_ROUTES),
        shapes={shape_key(*key): n for key, n in sorted(pm.SHAPES.items())},
        kinds={kind_key(*key): n for key, n in sorted(pm.KINDS.items())},
        dispatches=engine.DECODE_STATS["dispatches"])


def shape_key(route: str, k: int, n: int) -> str:
    """pim_matmul's launches at (K, N) on ``route``, as counts name them."""
    return f"{route} ({k},{n})"


def kind_key(mode: str, bits: int) -> str:
    """pim_matmul's launches given ``mode`` and ``bits``, as counts name
    them."""
    return f"{mode},w{bits}"


def attention_layers(cfg) -> int:
    """Layers with attention, each one flash_attn launch per pass: every
    layer, but none of an SSM model's and the hybrid's ``attn`` entries of
    its full (rec, rec, attn) blocks (the tail is recurrent)."""
    if cfg.family == "ssm":
        return 0
    if cfg.rglru is not None:
        pat = cfg.rglru.pattern
        return cfg.n_layers // len(pat) * pat.count("attn")
    return cfg.n_layers


def expected_counts(cfg, passes):
    """Launches and routes of prefill and ``passes - 1`` decode steps:
    each quantized linear one pim_matmul launch per pass (prefill's, M =
    batch x prompt, on the tensor cores; a decode step's, M = batch, on the
    swapped operands), each attention layer one flash_attn launch per pass
    (prefill's, hundreds of rows per pair in bf16, on the tensor cores; a
    decode step's split over the keys). Without MoE, pim_matmul's launches
    also by (route, K, N): each dense FFN's w1 (and w3) at (d_model, d_ff),
    its w2 at (d_ff, d_model); all of them by (mode, bits), the config's
    own."""
    n, L = pim_linears(cfg), attention_layers(cfg)
    shapes = None
    if cfg.moe is None:
        D, F = cfg.d_model, cfg.d_ff
        up = n - n // (3 if cfg.act in ("swiglu", "geglu") else 2)
        shapes = {shape_key(route, *kn): count * per
                  for route, per in (("tensor_core", 1),
                                     ("swap_ab", passes - 1))
                  for kn, count in sorted({(D, F): up, (F, D): n - up}
                                          .items()) if count * per}
    return dict(
        launches={"pim_matmul": n * passes, "flash_attn": L * passes},
        routes={"tensor_core": n, "swap_ab": n * (passes - 1),
                "cuda_core": 0},
        flash_routes={"tiled": 0, "split_kv": L * (passes - 1),
                      "tensor_core": L},
        shapes=shapes,
        kinds={kind_key(cfg.quant_mode, cfg.quant_bits): n * passes}
        if n else {})


def check_counts(what, got, cfg, passes,
                 keys=("launches", "routes", "flash_routes", "shapes",
                       "kinds")):
    exp = expected_counts(cfg, passes)
    for k in keys:
        if exp[k] is not None and got[k] != exp[k]:
            raise AssertionError(f"{what}: {k} {got[k]}, expected {exp[k]}")


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def replay_checks(torch, cfg, model, batch, label):
    """``greedy_generate`` of ``cfg`` on ``model``: the first call of its
    signature (warm-up: an eager prefill and decode step; capture; one
    replay) and a replayed call, each one dispatch, the replayed call's
    launches by route those of prefill and SERVE_NEW - 1 decode steps (the
    first adds its warm-up's two passes), its tokens equal on replay and
    equal to the eager loop's argmax chain bit for bit. Returns (tokens,
    first call's ms and counts, replayed call's counts, the graph,
    the eager loop's logits)."""
    from repro_torch.serve.engine import greedy_generate

    def generate():
        return greedy_generate(cfg, model, batch, max_new_tokens=SERVE_NEW)

    before = set(map(id, model.generate_graphs.values()))
    out, first_ms, first = counted(torch, generate)
    (graph,) = [g for g in model.generate_graphs.values()
                if id(g) not in before]
    again, _, counts = counted(torch, generate)
    V = cfg.vocab_size
    if tuple(out.shape) != (batch[input_key(cfg)].shape[0], SERVE_NEW) \
            or out.dtype != torch.int32 or int(out.min()) < 0 \
            or int(out.max()) >= V or not torch.equal(out, again):
        raise AssertionError(f"{label}: greedy_generate gave "
                             f"{tuple(out.shape)} {out.dtype} tokens in "
                             f"[{int(out.min())}, {int(out.max())}], equal "
                             f"on replay: {torch.equal(out, again)}")
    check_counts(f"{label} replayed call", counts, cfg, SERVE_NEW)
    # the first call adds its warm-up's eager prefill and decode step
    check_counts(f"{label} first call", first, cfg, SERVE_NEW + 2,
                 keys=("launches",))
    if counts["dispatches"] != 1 or first["dispatches"] != 1:
        raise AssertionError(f"{label}: DECODE_STATS per call: first "
                             f"{first['dispatches']}, replayed "
                             f"{counts['dispatches']}, expected 1")
    forced = teacher_forced(cfg, model, batch, out[:, :-1], model.device)
    chain = argmax_chain(torch, cfg, forced)
    if not all(torch.isfinite(lg).all() for lg in forced) \
            or not torch.equal(chain, out):
        raise AssertionError(
            f"{label}: the graph's tokens are not the eager loop's argmax "
            f"chain: {int((chain != out).sum())} of {out.numel()} differ")
    return out, first_ms, first, counts, graph, forced


def run_serve(torch, device, cfg=None, label="serve", *, variants=(),
              notes=False, dvp_bound=LOGITS_REL,
              dvp_note="phase 19 holds it at the cut depth to "
                       f"{RECURRENT_DECODE_REL}",
              batch_size=SERVE_BATCH, prompt=SERVE_PROMPT, eager_reps=3,
              lean=False, chain=None):
    """The serving path of ``cfg`` (phase 7: Qwen3-4B at full width and
    depth): ``greedy_generate`` as one CUDA-graph replay per call on
    ``batch_size`` seeded prompts of ``prompt`` tokens, beside the eager
    prefill and decode steps; each of ``variants`` (configs on the same
    weights, e.g. another MoE dispatch) replayed and checked the same way;
    decode against prefill held to ``dvp_bound`` (None: measured only,
    ``dvp_note`` saying where it is held); the eager prefill and loop
    timed ``eager_reps`` times (median), the decode steps ``eager_reps -
    1`` times (at least once). ``lean``: every check, the replayed call's
    times and its profile, but no eager timing, no graph-alone timing and
    no eager profiles (the deep runs of phases 28-30). ``chain``:
    (prompts, tokens) that another greedy_generate made on the same seed's
    weights (the serving CLI's), held bit for bit to the eager argmax
    chain teacher-forced on those prompts before this model is freed (so a
    model of up to 62 GB is not built a third time). Returns (record,
    launches, routes and flash routes of one replayed call)."""
    import gc

    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import engine
    from repro_torch.serve.engine import greedy_generate

    cfg = cfg or lm_config()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights_gb = (torch.cuda.memory_allocated() - base) / 1e9
    batch = prompt_batch(torch, cfg, 12, batch_size, prompt, device)
    torch.cuda.reset_peak_memory_stats()
    L, V = cfg.n_layers, cfg.vocab_size
    S = prompt_len(cfg, batch)

    def generate():
        return greedy_generate(cfg, model, batch, max_new_tokens=SERVE_NEW)

    stages = {"init": init_s}
    t = time.perf_counter()
    out, first_ms, first, counts, graph, forced = replay_checks(
        torch, cfg, model, batch, label)
    stages["checks"] = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches, routes = counts["launches"], counts["routes"]
    flash_routes = counts["flash_routes"]
    engine.DECODE_STATS["dispatches"] = 0
    zero = greedy_generate(cfg, model, batch, max_new_tokens=0)
    if zero.shape != (batch_size, 0) or engine.DECODE_STATS["dispatches"]:
        raise AssertionError(f"{label}: zero new tokens: a dispatch was "
                             "counted")
    other = {}
    for v in variants:
        v_out, v_first_ms, _, v_counts, v_graph, _ = replay_checks(
            torch, v, model, batch, f"{label} {cfg_name(v)}")
        v_ms = [timed(torch, lambda v=v: greedy_generate(
            v, model, batch, max_new_tokens=SERVE_NEW)) for _ in range(3)]
        other[cfg_name(v)] = dict(
            first_generate_ms=v_first_ms, generate_replays_ms=v_ms,
            generate_ms=statistics.median(v_ms),
            graph_pool_bytes=v_graph.pool_bytes,
            launches=v_counts["launches"], tokens=v_out.cpu().tolist(),
            tokens_equal_to=int((v_out == out).sum()))
    del forced
    stages["variants"] = time.perf_counter() - t - stages["checks"]

    # the graph's tokens are the eager loop's argmax chain (checked); decode
    # against prefill on the prompt's last position
    max_len = S + SERVE_NEW
    t = time.perf_counter()
    dvp, dvp_flips, dvp_held = decode_vs_prefill(torch, cfg, model, batch,
                                                 max_len, dvp_bound)
    stages["decode vs prefill"] = time.perf_counter() - t
    t = time.perf_counter()

    key = input_key(cfg)
    prefill_ms = decode_ms = eager_ms = graph_ms = caches = None
    if not lean:
        prefill_ms = statistics.median(
            timed(torch, lambda: prefill(cfg, model, batch, max_len))
            for _ in range(eager_reps))
        per_token = []
        for _ in range(max(1, eager_reps - 1)):
            _, caches = prefill(cfg, model, batch, max_len)

            def steps(caches=caches):
                for t in range(SERVE_NEW - 1):
                    decode_step(cfg, model, {key: out[:, t:t + 1]}, S + t,
                                caches)

            per_token.append(timed(torch, steps) / (SERVE_NEW - 1))
        decode_ms = statistics.median(per_token)
        eager_ms = statistics.median(
            timed(torch, lambda: teacher_forced(cfg, model, batch,
                                                out[:, :-1], device))
            for _ in range(eager_reps))
    replay_ms = [timed(torch, generate) for _ in range(3)]
    generate_ms = statistics.median(replay_ms)
    shares = {}
    if not lean:
        # the graph alone on the card's clock (CUDA events around one
        # replay)
        graph_ms = event_us(graph.graph.replay, torch, reps=3,
                            warmup=1) / 1e3
        _, caches = prefill(cfg, model, batch, max_len)
        shares = {
            "prefill": device_share(torch, lambda: prefill(
                cfg, model, batch, max_len)),
            "decode step": device_share(torch, lambda: decode_step(
                cfg, model, {key: out[:, :1]}, S, caches)),
        }
    stages["timings"] = time.perf_counter() - t
    t = time.perf_counter()
    shares["greedy_generate (replayed)"] = device_share(torch, generate)
    stages["profile"] = time.perf_counter() - t
    replayed = shares["greedy_generate (replayed)"]
    if replayed["graph_launches"] != 1 or replayed["launch_calls"] \
            or replayed["driver_launch_calls"]:
        raise AssertionError(
            f"{label}: a replayed call made {replayed['graph_launches']} "
            f"graph launches and {replayed['launch_calls']} + "
            f"{replayed['driver_launch_calls']} kernel launches; expected "
            "1 and 0")
    # the kernels the graph holds: prefill's and SERVE_NEW - 1 decode
    # steps', from the eager profiles (lean: the replayed call's profile)
    kernels_ms = (replayed["device_ms"] if lean else
                  shares["prefill"]["device_ms"]
                  + (SERVE_NEW - 1) * shares["decode step"]["device_ms"])
    record = dict(
        config=dict(arch=cfg.arch_id, quant=cfg.quant,
                    quant_mode=cfg.quant_mode, n_layers=L,
                    d_model=cfg.d_model, vocab=V, batch=batch_size,
                    prompt=prompt, prompt_positions=S,
                    new_tokens=SERVE_NEW,
                    moe_impl=cfg.moe.impl if cfg.moe else None),
        init_s=init_s, first_generate_ms=first_ms,
        warmup_ms=graph.warmup_s * 1e3, capture_ms=graph.capture_s * 1e3,
        graph_pool_bytes=graph.pool_bytes, weights_gb=weights_gb,
        peak_gb=peak_gb, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
        eager_loop_ms=eager_ms, generate_ms=generate_ms,
        generate_replays_ms=replay_ms, graph_ms=graph_ms,
        graph_kernels_ms=kernels_ms, first_call=first,
        decode_vs_prefill_rel=dvp, decode_vs_prefill_flips=dvp_flips,
        decode_vs_prefill_held=dvp_held, tokens=out.cpu().tolist(),
        profile=shares, routes=routes, flash_routes=flash_routes,
        pim_shapes=counts["shapes"], pim_kinds=counts["kinds"],
        variants=other)
    dvp_note = (f"(bound {dvp_bound})" if dvp_held else
                "(MoE: measured, not held; the last token's routing "
                f"between the two: {say_flips(dvp_flips)})" if cfg.moe else
                f"(measured at full depth, not held; {dvp_note})")
    eager = ("eager: not timed (lean)" if lean else
             f"eager: prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} "
             f"ms per token, the loop (prefill + {SERVE_NEW - 1} steps) "
             f"{eager_ms:.2f} ms")
    say(f"{label} {cfg_name(cfg)} ({L} layers, d_model {cfg.d_model}): "
        f"batch {batch_size}, prompt {prompt}"
        + (f" after {cfg.n_patches} patches" if S != prompt else "")
        + f", {SERVE_NEW} new tokens; {eager}; "
        f"{weights_gb:.2f} GB of weights on the card, peak {peak_gb:.2f} "
        f"GB; decode vs prefill logits rel {dvp:.3e} {dvp_note}; "
        f"launches per call {json.dumps(launches)}")
    say(f"{label} greedy_generate as one CUDA graph: first call "
        f"{first_ms:.2f} ms (warm-up {graph.warmup_s * 1e3:.2f} ms, capture "
        f"{graph.capture_s * 1e3:.2f} ms, then one replay; launches "
        f"{json.dumps(first['launches'])}); replayed call {generate_ms:.2f} "
        f"ms (median of " + ", ".join(f"{t:.2f}" for t in replay_ms) + ")"
        + ("" if graph_ms is None else
           f", the graph alone {graph_ms:.2f} ms on the card's clock")
        + f", {kernels_ms:.3f} ms of kernels in it ("
        + ("its profile" if lean else "eager profiles") + "); graph pool "
        f"{graph.pool_bytes} bytes; DECODE_STATS 1 per call, 0 for zero "
        f"tokens; tokens == the eager loop's argmax chain, bit for bit; "
        f"{replayed['graph_launches']} cudaGraphLaunch and "
        f"{replayed['launch_calls'] + replayed['driver_launch_calls']} "
        "kernel launches per replayed call")
    for name, v in other.items():
        say(f"{label} {name} on the same weights: first call "
            f"{v['first_generate_ms']:.2f} ms, replayed call "
            f"{v['generate_ms']:.2f} ms (median of "
            + ", ".join(f"{t:.2f}" for t in v["generate_replays_ms"])
            + f"); graph pool {v['graph_pool_bytes']} bytes; DECODE_STATS 1 "
            f"per call; tokens == its eager loop's argmax chain, bit for "
            f"bit ({v['tokens_equal_to']} of {batch_size * SERVE_NEW} equal "
            f"to {cfg.moe.impl}'s); launches per call "
            + json.dumps(v["launches"]))
    for name, sh in shares.items():
        say_share(f"{label} {name}", sh)
    flash_ms = {name: sum(k["ms"] for k in sh["top"] if "flash_" in k["name"])
                for name, sh in shares.items()}
    # pim_matmul's kernels and the ordered sum of their K splits
    pim_ms = {name: sum(k["ms"] for k in sh["top"]
                        if "pim_matmul" in k["name"]
                        or "reduce_splits" in k["name"])
              for name, sh in shares.items()}
    # the recurrent scan's loop, one addcmul kernel per step and layer, and
    # Mamba's decays, exp(dt * A) over the scan's (B, chunk, I, N)
    scan_ms = {name: sum(k["ms"] for k in sh["top"] if "addcmul" in k["name"])
               for name, sh in shares.items()}
    exp_ms = sum(k["ms"] for k in shares.get("prefill", replayed)["top"]
                 if "exp_kernel" in k["name"])
    record["flash_ms"], record["pim_matmul_ms"] = flash_ms, pim_ms
    record["scan_ms"], record["scan_exp_ms"] = scan_ms, exp_ms
    scan = ""
    if not lean and (cfg.ssm is not None or cfg.rglru is not None):
        record["scan_bound_ms"] = bound = scan_bound_ms(cfg, S)
        scan = (f", the scan's loop (addcmul) {scan_ms['prefill']:.3f} ms "
                f"(bound {bound:.3f} ms, bytes: its decays and inputs read "
                f"once, its states written once), exp {exp_ms:.3f} ms")
    if lean:
        name = "greedy_generate (replayed)"
        say(f"{label} replayed call: {replayed['device_ms']:.3f} ms of "
            f"kernels, pim_matmul {pim_ms[name]:.3f} ms and flash_attn "
            f"{flash_ms[name]:.3f} ms of it; by name: " + "; ".join(
                f"{k['name'][:60]} {k['ms']:.3f} ms x{k['count']}"
                for k in replayed["top"][:8]))
    else:
        say(f"{label} prefill: {shares['prefill']['device_ms']:.3f} ms of "
            f"kernels, pim_matmul {pim_ms['prefill']:.3f} ms and flash_attn "
            f"{flash_ms['prefill']:.3f} ms of it{scan}"
            + (" (with the tiled kernel at prefill, one H100 took 44.793 ms, "
               "flash 3.619 ms of it)" if notes else ""))
        say(f"{label} decode step: "
            f"{shares['decode step']['device_ms']:.3f} ms of kernels, "
            f"pim_matmul {pim_ms['decode step']:.3f} ms and "
            f"flash_attn {flash_ms['decode step']:.3f} ms of it"
            + (" (with the CUDA-core pim_matmul at decode, one H100 took "
               "17.05-17.19 ms, pim_matmul 10.048 ms of it)" if notes else ""))
    if chain is not None:
        t = time.perf_counter()
        prompts, toks = chain
        got = argmax_chain(torch, cfg, teacher_forced(
            cfg, model, prompts, toks[:, :-1], device))
        if not torch.equal(got, toks):
            raise AssertionError(
                f"{label}: the other call's tokens are not the eager argmax "
                f"chain of the same weights and prompts: "
                f"{int((got != toks).sum())} of {toks.numel()} differ")
        stages["chain"] = time.perf_counter() - t
    record["stages_s"] = stages
    say(f"{label} stages: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in stages.items()))
    del model, caches, graph
    gc.collect()
    torch.cuda.empty_cache()
    record["left_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    say(f"{label}: {record['left_gb']:.3f} GB still allocated after the "
        "model and its graphs are freed")
    return record, launches, routes, flash_routes


def scan_bound_ms(cfg, S: int) -> float:
    """The byte bound of prefill's scan loop over an S-token prompt: in
    every recurrent layer, the float32 decays a and inputs b read once and
    the states written once, over the padded length (B, Sp, I, N) for
    Mamba, (B, Sp, W) for the RG-LRU."""
    if cfg.ssm is not None:
        chunk, state = cfg.ssm.scan_chunk, (cfg.ssm.expand * cfg.d_model
                                            * cfg.ssm.d_state)
        layers = cfg.n_layers
    else:
        chunk, state = cfg.rglru.scan_chunk, cfg.rglru.lru_width
        layers = cfg.n_layers - attention_layers(cfg)
    chunk = min(chunk, S)
    padded = -(-S // chunk) * chunk
    return (3 * layers * SERVE_BATCH * padded * state * 4
            / H100_BYTES_PER_S * 1e3)


def run_audio(torch, device, cfg, label):
    """An audio-frame model through ``prefill`` and teacher-forced
    ``decode_step`` on seeded frames (its ``greedy_generate`` returns the
    empty result for zero tokens and raises for more, as the reference's
    does): launch counts of one loop (reset just before, read just after),
    the loop's logits finite, (B, 1, n_codebooks, V) and the same on a
    second run bit for bit, decode against prefill, the eager ms and the
    busy shares. Returns (record, launches, flash routes)."""
    import gc

    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import greedy_generate

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    weights_gb = (torch.cuda.memory_allocated() - base) / 1e9
    batch = prompt_batch(torch, cfg, 12, SERVE_BATCH, SERVE_PROMPT, device)
    feed = seeded_normal(torch, 14, (SERVE_BATCH, SERVE_NEW - 1,
                                     cfg.d_model), device)
    if greedy_generate(cfg, model, batch, max_new_tokens=0).shape \
            != (SERVE_BATCH, 0):
        raise AssertionError(f"{label}: zero tokens is not the empty result")
    try:
        greedy_generate(cfg, model, batch, max_new_tokens=1)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{label}: greedy_generate served an audio "
                             "model")

    def loop():
        return teacher_forced(cfg, model, batch, feed, device)

    logits, loop_ms, counts = counted(torch, loop)
    check_counts(label, counts, cfg, SERVE_NEW)
    again = loop()
    shape = (SERVE_BATCH, 1, cfg.n_codebooks, cfg.vocab_size)
    if any(tuple(lg.shape) != shape or not torch.isfinite(lg).all()
           for lg in logits) \
            or not all(torch.equal(a, b) for a, b in zip(logits, again)):
        raise AssertionError(f"{label}: logits not finite {shape} or not "
                             "the same on a second run")
    S = SERVE_PROMPT
    max_len = S + SERVE_NEW
    dvp, _, _ = decode_vs_prefill(torch, cfg, model, batch, max_len)
    prefill_ms = statistics.median(
        timed(torch, lambda: prefill(cfg, model, batch, max_len))
        for _ in range(3))
    eager_ms = statistics.median(timed(torch, loop) for _ in range(3))
    _, caches = prefill(cfg, model, batch, max_len)
    shares = {
        "prefill": device_share(torch, lambda: prefill(cfg, model, batch,
                                                       max_len)),
        "decode step": device_share(torch, lambda: decode_step(
            cfg, model, {"frame_embeds": feed[:, :1]}, S, caches)),
    }
    record = dict(
        config=dict(arch=cfg.arch_id, n_layers=cfg.n_layers,
                    d_model=cfg.d_model, batch=SERVE_BATCH, prompt=S,
                    steps=SERVE_NEW - 1),
        weights_gb=weights_gb, first_loop_ms=loop_ms, prefill_ms=prefill_ms,
        eager_loop_ms=eager_ms, decode_vs_prefill_rel=dvp, profile=shares,
        launches=counts["launches"], flash_routes=counts["flash_routes"])
    say(f"{label} {cfg.arch_id} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_codebooks} codebook heads): batch "
        f"{SERVE_BATCH}, {S} seeded frames, prefill + {SERVE_NEW - 1} "
        f"teacher-forced decode steps on seeded frames; eager: prefill "
        f"{prefill_ms:.2f} ms, the loop {eager_ms:.2f} ms (first "
        f"{loop_ms:.2f}); {weights_gb:.2f} GB of weights; logits {shape} "
        f"finite, equal on a second run; decode vs prefill rel {dvp:.3e} "
        f"(bound {LOGITS_REL}); greedy_generate: empty at 0 tokens, "
        f"ValueError at 1 (as the reference's KeyError); launches per loop "
        f"{json.dumps(counts['launches'])}")
    for name, sh in shares.items():
        say_share(f"{label} {name}", sh)
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return record, counts["launches"], counts["flash_routes"]


def moe_parity(torch, cfg, model, device):
    """The first MoE layer's FFN of ``model`` on identical seeded inputs,
    on the card in both dispatches; returns a function that, given the
    model moved to the CPU, runs the same there and compares: per token,
    the card's output within LOGITS_REL of max |y| of the CPU's wherever
    the router's top-k agrees (the router logits are float32 products
    that the two sides sum in other orders, so a choice whose margin lies
    inside that rounding may differ: reported, held inside the
    rounding)."""
    import dataclasses

    from repro_torch.models import ffn as ffn_mod
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = seeded_normal(torch, 16, (PARITY_BATCH, PARITY_PROMPT, cfg.d_model),
                      device).to(dt)
    cfgs = {impl: dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl)) for impl in ("einsum", "gather")}

    def run(p, x):
        probs = torch.softmax(x.reshape(-1, cfg.d_model).float() @ p.router,
                              -1).cpu()
        return probs, {impl: ffn_mod.moe_ffn(c, p, x)[0].reshape(
            -1, cfg.d_model).cpu() for impl, c in cfgs.items()}

    card_probs, card_y = run(model.layers[0].ffn, x)

    def compare(cpu_model):
        cpu_probs, cpu_y = run(cpu_model.layers[0].ffn, x.cpu())
        flips = router_flips(torch, cfg, [cpu_probs], [card_probs],
                             lambda i, row: (row, 0, 0))
        check_flips(flips, "MoE layer on identical inputs")
        rows = sorted(set(range(card_probs.shape[0]))
                      - {f["request"] for f in flips})
        impls = {impl: {"rel": rel_err(torch, card_y[impl][rows],
                                       cpu_y[impl][rows]),
                        "held": len(rows)} for impl in cfgs}
        bad = {k: v for k, v in impls.items() if not v["rel"] < LOGITS_REL}
        if bad:
            raise AssertionError(f"MoE layer card vs CPU: {bad}; "
                                 + say_flips(flips))
        return {"tokens": card_probs.shape[0], "flips": flips,
                "impls": impls}

    return compare


def run_lm_parity(torch, device, cfg=None, label="lm parity",
                  dvp_bound=None):
    """Full width, PARITY_LAYERS layers (or ``cfg``'s): greedy_generate on
    the card (one graph replay), its tokens the card's eager argmax chain;
    then the same weights and tokens teacher-forced on the CPU, and the
    CPU's tokens, which must equal the card's wherever the card's top-2
    margin exceeds twice the bound: the argmax of its teacher-forced
    logits, which are its eager greedy_generate's tokens up to a request's
    first token apart from the card's, the last one the check reads (so
    the CPU makes one pass over the weights, not two). An audio
    model: seeded frames teacher-forced on both. A MoE model: both sides'
    router choices recorded; a request's step is not held where a token
    whose experts differ after the capacity drops (a routing flip, which
    must lie inside the rounding, or a token it pushed past an expert's
    capacity or let in) reaches it: its own position from the last layer,
    every later one from an earlier layer. With
    ``dvp_bound``, decode against prefill held to it on the card and on
    the CPU."""
    from repro_torch.models import init_params
    from repro_torch.serve import engine
    from repro_torch.serve.engine import greedy_generate

    cfg = cfg or lm_config(n_layers=PARITY_LAYERS)
    audio = cfg.frontend == "audio_frames"
    model = init_params(cfg, 1, device=device)
    batch = prompt_batch(torch, cfg, 13, PARITY_BATCH, PARITY_PROMPT,
                         device)
    S = prompt_len(cfg, batch)
    if audio:
        feed = seeded_normal(torch, 15, (PARITY_BATCH, PARITY_NEW - 1,
                                         cfg.d_model), device)
    else:
        engine.DECODE_STATS["dispatches"] = 0
        toks = greedy_generate(cfg, model, batch, max_new_tokens=PARITY_NEW)
        if engine.DECODE_STATS["dispatches"] != 1:
            raise AssertionError(f"{label}: not one dispatch on the card")
        feed = toks[:, :-1]
    with RouterLog(torch) as card_log:
        card = [lg.cpu() for lg in teacher_forced(cfg, model, batch, feed,
                                                  device)]
    moe = moe_parity(torch, cfg, model, device) if cfg.moe else None
    dvp = {}
    if dvp_bound is not None:
        dvp["card"] = decode_vs_prefill(torch, cfg, model, batch,
                                        S + PARITY_NEW, dvp_bound)[0]
    if not audio:
        toks = toks.cpu()
        if not torch.equal(toks, argmax_chain(torch, cfg, card)):
            raise AssertionError(f"{label}: the graph's tokens are not the "
                                 "argmax chain")
    model.to("cpu")
    if model.generate_graphs:
        raise AssertionError(f"{label}: moving the model kept its graphs")
    batch = {k: v.cpu() for k, v in batch.items()}
    t = time.perf_counter()
    with RouterLog(torch) as cpu_log:
        cpu = teacher_forced(cfg, model, batch, feed.cpu(), "cpu")
    if not audio:
        cpu_toks = argmax_chain(torch, cfg, cpu)
    if dvp_bound is not None:
        dvp["cpu"] = decode_vs_prefill(torch, cfg, model, batch,
                                       S + PARITY_NEW, dvp_bound,
                                       device="cpu")[0]
    cpu_s = time.perf_counter() - t
    flips = moved = []
    if cfg.moe is not None:
        moe = moe(model)
        n_moe = cfg.n_layers - cfg.moe.first_k_dense

        def where(i, row):
            step, layer = divmod(i, n_moe)
            b, pos = divmod(row, S) if step == 0 else (row, S + step - 1)
            return b, pos, layer

        flips = router_flips(torch, cfg, cpu_log.calls, card_log.calls,
                             where)
        check_flips(flips, label)
        moved = router_moved(torch, cfg, cpu_log.calls, card_log.calls,
                             where)
    dropped = [m for m in moved if not any(
        (f["request"], f["position"], f["layer"])
        == (m["request"], m["position"], m["layer"]) for f in flips)]

    def reaches(m, step):
        """A token moved in the last layer moves its own logits alone; one
        moved in an earlier layer, through the attention after it, every
        later position of its request too."""
        pos = S - 1 + step
        last = m["layer"] == n_moe - 1
        return m["position"] == pos if last else m["position"] <= pos

    def held(step):
        reached = {m["request"] for m in moved if reaches(m, step)}
        return [b for b in range(PARITY_BATCH) if b not in reached]

    rels = [rel_err(torch, a[held(t)], b[held(t)]) if held(t) else None
            for t, (a, b) in enumerate(zip(card, cpu))]
    if not all(torch.isfinite(a).all() for a in card) \
            or any(r is not None and not r < LOGITS_REL for r in rels):
        raise AssertionError(f"{label}: card vs CPU logits rel {rels} "
                             f"(bound {LOGITS_REL}); {say_flips(flips)}; "
                             f"moved by the capacity drops {dropped}")
    checked = equal = 0
    if not audio:
        equal = int((cpu_toks == toks).sum())
        for b in range(PARITY_BATCH):
            for t, lg in enumerate(card):
                if b not in held(t):
                    continue
                row = lg[b, 0, :cfg.vocab_size].double()
                top2 = row.topk(2).values
                if top2[0] - top2[1] <= 2 * LOGITS_REL * row.abs().max():
                    break
                if cpu_toks[b, t] != toks[b, t]:
                    raise AssertionError(
                        f"{label}: request {b} token {t}: CPU "
                        f"{int(cpu_toks[b, t])}, card {int(toks[b, t])}")
                checked += 1
    what = (f"{PARITY_PROMPT} frames, {PARITY_NEW - 1} teacher-forced "
            "frames" if audio else
            f"prompt {PARITY_PROMPT}"
            + (f" after {cfg.n_patches} patches" if S != PARITY_PROMPT
               else "") + f", {PARITY_NEW} tokens")
    say(f"{label} {cfg_name(cfg)} at full width, {cfg.n_layers} layers, "
        f"batch "
        f"{PARITY_BATCH}, {what}: card ("
        + ("eager, kernels" if audio else "one graph replay, kernels")
        + ") vs CPU (eager, plain versions) logits rel per step "
        + ", ".join("not held" if r is None else f"{r:.3e}" for r in rels)
        + f" (bound {LOGITS_REL})"
        + (f"; {say_flips(flips)}" if cfg.moe is not None else "")
        + ("" if not dropped else "; capacity drops moved by them: "
           + ", ".join(f"request {m['request']} position {m['position']} "
                       f"MoE layer {m['layer']}" for m in dropped))
        + ("" if audio else
           f"; the CPU's argmax tokens: {equal} of {toks.numel()} equal to "
           f"the card's, {checked} held to them (those before a card top-2 "
           f"margin within twice the bound)")
        + ("" if dvp_bound is None else
           f"; decode vs prefill rel on the card {dvp['card']:.3e}, on the "
           f"CPU {dvp['cpu']:.3e} (bound {dvp_bound})")
        + f"; CPU run {cpu_s:.1f} s")
    out = {"rel_per_step": rels, "cpu_s": cpu_s, "flips": flips,
           "capacity_moved": dropped,
           "tokens_checked": checked, "moe_layer": moe,
           "decode_vs_prefill": dvp}
    if moe is not None:
        say(f"{label} {cfg.arch_id} MoE layer 0 at full width on identical "
            f"inputs ({moe['tokens']} tokens), card vs CPU: "
            + "; ".join(f"{impl} rel {r['rel']:.3e} on {r['held']} tokens"
                        for impl, r in moe["impls"].items())
            + f" (bound {LOGITS_REL}); {say_flips(moe['flips'])}")
    if not audio:
        out.update(tokens=toks.tolist(), cpu_tokens=cpu_toks.tolist())
    return out


def say_share(name: str, sh: dict) -> None:
    if sh["device_ms"] == 0.0:
        say(f"profile {name}: device time not measured (the profiler "
            "recorded no kernel time)")
        return
    say(f"profile {name}: {sh['wall_ms']:.2f} ms on the host clock, "
        f"{sh['device_ms']:.3f} ms of kernels, busy share "
        f"{sh['busy_share']:.3f}; top: "
        + "; ".join(f"{k['name'][:80]} {k['ms']:.3f} ms x{k['count']}"
                    for k in sh["top"][:3]))


# ---------------------------------------------------------------------------
# Phases 25-27: the dense and quantized serving paths at published widths
# ---------------------------------------------------------------------------

def check_routes(label, routes, flash_routes):
    """Both routes of both LM kernels ran in ``label``'s call."""
    idle = [k for k, v in (("pim_matmul[tensor_core]", routes["tensor_core"]),
                           ("pim_matmul[swap_ab]", routes["swap_ab"]),
                           ("flash_attn[tensor_core]",
                            flash_routes["tensor_core"]),
                           ("flash_attn[split_kv]", flash_routes["split_kv"]))
            if v == 0]
    if idle:
        raise AssertionError(f"routes never launched on the {label} path: "
                             f"{idle}")


def say_kernels(label, rec, launches, routes, flash_routes) -> None:
    say(f"kernels {label} " + json.dumps(launches) + " routes "
        + json.dumps(routes) + " flash routes " + json.dumps(flash_routes)
        + " by (route, K, N) " + json.dumps(rec["pim_shapes"])
        + " by (mode, bits) " + json.dumps(rec["pim_kinds"]))


def run_dense(torch, device) -> dict:
    """Phase 25: each DENSE run through ``run_serve`` with phase 7's
    traffic, one model at a time (each freed with its graphs before the
    next is built); decode against prefill measured at full depth, not
    held. Returns label -> record, each with its launches."""
    records = {}
    for label, arch, overrides, depth in DENSE:
        cut = {} if depth is None else {"n_layers": depth}
        t = time.perf_counter()
        rec, launches, routes, flash_routes = run_serve(
            torch, device, family_config(arch, overrides, **cut), label,
            dvp_bound=None, dvp_note="as phase 18's; phase 26 holds the card "
            f"to the CPU at {PARITY_LAYERS} layers", eager_reps=1)
        rec["launches"], rec["phase_s"] = launches, time.perf_counter() - t
        records[label] = rec
        say_kernels(label, rec, launches, routes, flash_routes)
        if label in DENSE_BOTH_ROUTES:
            check_routes(label, routes, flash_routes)
    return records


class PlainKernels:
    """Inside the ``with`` block each launch of pim_matmul's and
    flash_attn's kernels on the card runs the kernel's plain version on
    the same tensors instead, into the same output, and counts nothing:
    the plain reference at sizes the CPU would take too long for. The
    plain attention takes at most PLAIN_CHUNK queries a call (each query
    row is computed alone)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attn import ops as fa
        from repro_torch.kernels.flash_attn import ref as fref
        from repro_torch.kernels.pim_matmul import ops as pm
        from repro_torch.kernels.pim_matmul import ref as pref
        self._mods = (pm, fa)
        self._saved = (pm._launch, fa._launch)

        def pim(x, w_int, scales, out, mode, bits, which, splits=None):
            return out.copy_(pref.ref_pim_matmul_raw(
                x, w_int, mode=mode, bits=bits) * scales[None, :])

        def flash(q, k, v, pos_q, pos_k, out, window, scale, which,
                  splits=None, lse=None):
            if lse is not None:
                raise ValueError("PlainKernels: no log-sum-exp")
            for i in range(0, q.shape[1], PLAIN_CHUNK):
                j = i + PLAIN_CHUNK
                out[:, i:j] = fref.ref_flash_attention(
                    q[:, i:j], k, v, pos_q[i:j], pos_k, window=window,
                    scale=scale)
            return out

        pm._launch, fa._launch = pim, flash
        return self

    def __exit__(self, *exc):
        pm, fa = self._mods
        pm._launch, fa._launch = self._saved


def run_ring(torch, device) -> dict:
    """Phase 27: starcoder2-7b at full depth past its window (RING_BATCH x
    RING_PROMPT tokens, SERVE_NEW new) through ``run_serve``; then at
    RING_CHECK_LAYERS layers the same traffic, greedy_generate's tokens the
    card's argmax chain, the card's kernels teacher-forced against their
    plain versions on the card (``PlainKernels``) step by step within
    LOGITS_REL, and the ring's slots after the last step: every one written,
    positions S + n - 4,096 .. S + n - 1 (S the prompt, n the decode steps),
    the decode steps' writes wrapped past slot 0."""
    label, arch, overrides = RING
    cfg = family_config(arch, overrides)
    t = time.perf_counter()
    rec, launches, routes, flash_routes = run_serve(
        torch, device, cfg, label, dvp_bound=None,
        dvp_note="its 2-layer model is held below, kernels against plain",
        batch_size=RING_BATCH, prompt=RING_PROMPT, eager_reps=1)
    rec["launches"], rec["phase_s"] = launches, time.perf_counter() - t
    say_kernels(label, rec, launches, routes, flash_routes)
    check_routes(label, routes, flash_routes)

    cfg = family_config(arch, overrides, n_layers=RING_CHECK_LAYERS)
    S, n, W = RING_PROMPT, SERVE_NEW - 1, cfg.sliding_window
    card, plain, toks, kpos, plain_kpos, card_s, plain_s = plain_check(
        torch, device, cfg, label, RING_BATCH, RING_PROMPT)
    # slots: the last W positions, each at slot pos % W
    want = torch.arange(S + n - W, S + n, dtype=torch.int32)
    slots = torch.full((W,), -1, dtype=torch.int32)
    slots[want % W] = want
    if not (kpos.shape[-1] == W and torch.equal(kpos, plain_kpos)
            and bool((kpos == slots).all())):
        raise AssertionError(f"{label}: the ring's slots {tuple(kpos.shape)} "
                             f"hold positions {int(kpos.min())} .. "
                             f"{int(kpos.max())}, expected {S + n - W} .. "
                             f"{S + n - 1} at slot pos % {W}")
    rels = kernels_vs_plain(torch, label, card, plain)
    say(f"{label} {cfg_name(cfg)} at full width, {cfg.n_layers} layers, "
        f"batch {RING_BATCH}, prompt {S}, {SERVE_NEW} tokens: one graph "
        f"replay, tokens == the card's argmax chain; the ring's {W} slots "
        f"after the last step hold positions {S + n - W} .. {S + n - 1} "
        f"(decode wrote slots {S % W} .. {(S + n - 1) % W}); card (kernels) "
        "vs card (plain versions) logits rel per step " + ", ".join(
            f"{r:.3e}" for r in rels) + f" (bound {LOGITS_REL}); kernels "
        f"{card_s:.1f} s, plain {plain_s:.1f} s")
    rec["check"] = {"layers": cfg.n_layers, "rel_per_step": rels,
                    "tokens": toks.cpu().tolist(), "kernels_s": card_s,
                    "plain_s": plain_s}
    del card, plain
    return rec


def plain_check(torch, device, cfg, label, batch_size, prompt):
    """``cfg`` (a cut depth) on ``batch_size`` seeded prompts of ``prompt``
    tokens: greedy_generate's SERVE_NEW tokens in one dispatch, the card's
    argmax chain of its kernels teacher-forced on them, and the same
    teacher-forced with the kernels' plain versions on the card
    (``PlainKernels``). Returns (the kernels' logits per step, the plain
    versions', the tokens, both runs' cache positions (the stack's kpos),
    the two runs' s)."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import engine
    from repro_torch.serve.engine import greedy_generate

    t = time.perf_counter()
    model = init_params(cfg, 1, device=device)
    batch = prompt_batch(torch, cfg, 13, batch_size, prompt, device)
    engine.DECODE_STATS["dispatches"] = 0
    toks = greedy_generate(cfg, model, batch, max_new_tokens=SERVE_NEW)
    if engine.DECODE_STATS["dispatches"] != 1:
        raise AssertionError(f"{label}: not one dispatch on the card")

    def forced():
        lg, caches = prefill(cfg, model, batch, prompt + SERVE_NEW)
        out = [lg.cpu()]
        for i in range(SERVE_NEW - 1):
            lg, caches = decode_step(cfg, model, {"tokens": toks[:, i:i + 1]},
                                     prompt + i, caches)
            out.append(lg.cpu())
        return out, caches["stack"]["kpos"].cpu()

    card, kpos = forced()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    with PlainKernels():
        plain, plain_kpos = forced()
    plain_s = time.perf_counter() - t
    if not torch.equal(toks.cpu(), argmax_chain(torch, cfg, card)):
        raise AssertionError(f"{label}: the graph's tokens are not the card's "
                             "argmax chain")
    del model, batch
    return card, plain, toks, kpos, plain_kpos, card_s, plain_s


def kernels_vs_plain(torch, label, card, plain):
    """Each step's logits rel, the card's kernels against their plain
    versions, held to LOGITS_REL."""
    rels = [rel_err(torch, a, b) for a, b in zip(card, plain)]
    if not all(torch.isfinite(a).all() for a in card) \
            or not all(r < LOGITS_REL for r in rels):
        raise AssertionError(f"{label}: kernels vs plain logits rel {rels} "
                             f"(bound {LOGITS_REL})")
    return rels


def check_default_counts(label, launches, flash_routes):
    """A bf16 default's call: no pim_matmul launch (its linears are ``x @
    w``, as the reference's ``models/common.py``), both flash routes."""
    if launches["pim_matmul"] or not (flash_routes["tensor_core"]
                                      and flash_routes["split_kv"]):
        raise AssertionError(f"{label}: launches {launches}, flash routes "
                             f"{flash_routes}: expected no pim_matmul and "
                             "both flash routes")


def run_cli(torch, arch):
    """``repro_torch.launch.serve.main(["--arch", arch])`` in this process
    at the CLI's defaults: (its req lines' tokens, (CLI_BATCH, CLI_NEW)
    int32 on the host, its s); its greedy_generate must be one dispatch
    (on the card one graph replay); its model is freed before this
    returns."""
    import contextlib
    import gc
    import io
    import re

    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import engine
    out = io.StringIO()
    engine.DECODE_STATS["dispatches"] = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve_cli.main(["--arch", arch])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    reqs = re.findall(r"req(\d+): \[([^\]]*)\]", out.getvalue())
    if [int(i) for i, _ in reqs] != list(range(CLI_BATCH)) \
            or engine.DECODE_STATS["dispatches"] != 1:
        raise AssertionError(f"serve CLI {arch}: printed {out.getvalue()!r} "
                             f"in {engine.DECODE_STATS['dispatches']} "
                             "dispatches")
    return torch.tensor([[int(x) for x in body.split()] for _, body in reqs],
                        dtype=torch.int32), cli_s


def run_defaults(torch, device) -> dict:
    """Phase 28: each DEFAULTS configuration at its own default, published
    width and full depth, one model on the card at a time: first the
    serving CLI, in process, at its defaults (its ``req`` lines, one
    greedy_generate replay on its own ``init_params(cfg, 0)``); then the
    same weights built again for ``run_serve`` (lean) with phase 7's
    traffic and checks, no pim_matmul launch and both flash routes in each
    call, decode against prefill measured, and on them the CLI's tokens
    the eager argmax chain teacher-forced on the CLI's prompts bit for
    bit. musicgen-medium: ``run_audio`` at full depth, and the CLI raising
    where the reference's does. Returns arch -> record."""
    from repro_torch.launch import serve as serve_cli
    records = {}
    for arch, impls in DEFAULTS:
        label = f"default-{arch}"
        cfg = family_config(arch, {})
        t = time.perf_counter()
        if cfg.frontend == "audio_frames":
            rec, launches, flash_routes = run_audio(torch, device, cfg,
                                                    label)
            try:
                run_cli(torch, arch)
            except ValueError as e:
                rec["cli"] = f"ValueError: {e}"
            else:
                raise AssertionError(f"{label}: the serve CLI served an "
                                     "audio model")
            say(f"{label} serve CLI: ValueError, as the reference CLI's "
                "KeyError (frame_embeds)")
        else:
            cli, cli_s = run_cli(torch, arch)
            variants = [family_config(arch, {}, impl=impl) for impl in impls]
            rec, launches, routes, flash_routes = run_serve(
                torch, device, cfg, label, variants=variants,
                dvp_bound=None, dvp_note="phase 29 holds the card to the "
                "CPU at a cut depth", lean=True,
                chain=(serve_cli.prompts(cfg, CLI_BATCH, CLI_PROMPT, device),
                       cli.to(device)))
            rec["cli"] = {"tokens": cli.tolist(), "s": cli_s}
            say(f"{label} serve CLI (python -m repro_torch.launch.serve "
                f"--arch {arch}): req0-req{CLI_BATCH - 1}, {CLI_BATCH} x "
                f"{CLI_PROMPT} tokens, {CLI_NEW} new, one greedy_generate "
                f"replay on its init_params(cfg, 0), in {cli_s:.1f} s with "
                "its build and capture; its tokens == the eager argmax "
                "chain of the same weights built again, teacher-forced on "
                "its prompts, bit for bit")
        check_default_counts(label, launches, flash_routes)
        rec["launches"], rec["flash_routes"] = launches, flash_routes
        rec["phase_s"] = time.perf_counter() - t
        say(f"kernels {label} " + json.dumps(launches) + " flash routes "
            + json.dumps(flash_routes) + f"; {rec['phase_s']:.1f} s")
        records[arch] = rec
    return records


def run_long(torch, device) -> dict:
    """Phase 30: LONG_ARCH at its default, full depth, one request of
    LONG_PROMPT tokens and SERVE_NEW new (32,768 positions) through
    ``run_serve`` (lean) with phase 7's checks; then LONG_CHECK_LAYERS
    layers, the same traffic, the card's kernels against their plain
    versions on the card step by step."""
    label = f"long-{LONG_ARCH}"
    t = time.perf_counter()
    rec, launches, _, flash_routes = run_serve(
        torch, device, family_config(LONG_ARCH, {}), label, dvp_bound=None,
        dvp_note="its 2-layer model is held below, kernels against plain",
        batch_size=LONG_BATCH, prompt=LONG_PROMPT, lean=True)
    check_default_counts(label, launches, flash_routes)
    rec["launches"], rec["flash_routes"] = launches, flash_routes
    rec["phase_s"] = time.perf_counter() - t
    say(f"kernels {label} " + json.dumps(launches) + " flash routes "
        + json.dumps(flash_routes))
    cfg = family_config(LONG_ARCH, {}, n_layers=LONG_CHECK_LAYERS)
    card, plain, toks, _, _, card_s, plain_s = plain_check(
        torch, device, cfg, label, LONG_BATCH, LONG_PROMPT)
    rels = kernels_vs_plain(torch, label, card, plain)
    say(f"{label} {cfg_name(cfg)} at full width, {cfg.n_layers} layers, "
        f"batch {LONG_BATCH}, prompt {LONG_PROMPT}, {SERVE_NEW} tokens: one "
        "graph replay, tokens == the card's argmax chain; card (kernels) vs "
        "card (plain versions, the attention over "
        f"{PLAIN_CHUNK} queries a call) logits rel per step "
        + ", ".join(f"{r:.3e}" for r in rels) + f" (bound {LOGITS_REL}); "
        f"kernels {card_s:.1f} s, plain {plain_s:.1f} s")
    rec["check"] = {"layers": cfg.n_layers, "rel_per_step": rels,
                    "tokens": toks.cpu().tolist(), "kernels_s": card_s,
                    "plain_s": plain_s}
    return rec


# ---------------------------------------------------------------------------
# Phases 20-21: training's gradient path
# ---------------------------------------------------------------------------

def train_batch(torch, cfg, seed, batch, seq, device):
    """Seeded next-token data: ``seq + 1`` tokens per row, the inputs the
    first ``seq`` and the labels the last ``seq``."""
    import numpy as np
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1)), dtype=torch.long,
        device=device)
    return {"tokens": tok[:, :-1].contiguous(),
            "labels": tok[:, 1:].contiguous()}


def train_expected(cfg, passes: int = 1) -> dict:
    """pim_matmul and flash_attn launches of ``passes`` training passes of
    ``cfg``, forward and backward apart. Forward: each quantized linear one
    launch at its (K, N), each attention layer one flash launch with the
    log-sum-exp, all on the tensor cores (M = tokens of the pass). Backward,
    with ``cfg.remat``: the layer's forward again (the recompute: the same
    launches), then per linear two more, dx on the transposed codes (w1,
    w3 at (d_ff, d_model), w2 at (d_model, d_ff)) and the unscaled
    accumulator for dscales at the forward's (K, N); flash's backward is
    plain torch."""
    n, L = pim_linears(cfg), attention_layers(cfg)
    D, F = cfg.d_model, cfg.d_ff
    up = n - n // 3                     # SwiGLU: w1 and w3 up, w2 down
    down = n - up
    tc = "tensor_core"
    fwd = {shape_key(tc, D, F): up, shape_key(tc, F, D): down}
    bwd = {shape_key(tc, D, F): 2 * up + down,
           shape_key(tc, F, D): 2 * down + up}

    def times(d):
        return {k: v * passes for k, v in d.items()}

    return {
        "forward": {"pim_matmul": n * passes, "flash_lse": L * passes,
                    "shapes": times(fwd)},
        "backward": {"pim_matmul": 3 * n * passes, "flash_lse": L * passes,
                     "shapes": times(bwd)},
        "remat": {"pim_matmul": n * passes, "flash_lse": L * passes}}


def train_counts(counts: dict) -> dict:
    """What ``counted`` read, as ``train_expected`` names it."""
    return {"pim_matmul": counts["launches"]["pim_matmul"],
            "flash_lse": counts["lse_routes"]["tensor_core"],
            "shapes": counts["shapes"]}


def check_train_counts(what, got, exp) -> None:
    other = {k: v for k, v in got["routes"].items() if k != "tensor_core"}
    flash_other = {k: v for k, v in got["flash_routes"].items()
                   if k != "tensor_core"}
    if (train_counts(got) != exp or any(other.values())
            or any(flash_other.values())
            or got["launches"]["flash_attn"] != exp["flash_lse"]):
        raise AssertionError(f"{what}: launches {train_counts(got)} routes "
                             f"{got['routes']} flash {got['flash_routes']}, "
                             f"expected {exp} on the tensor cores, every "
                             "flash launch with its log-sum-exp")


def add_counts(a: dict, b: dict) -> dict:
    return {"pim_matmul": a["pim_matmul"] + b["pim_matmul"],
            "flash_lse": a["flash_lse"] + b["flash_lse"],
            "shapes": {k: a["shapes"].get(k, 0) + b["shapes"].get(k, 0)
                       for k in sorted({**a["shapes"], **b["shapes"]})}}


def event_ms(torch, fn):
    """``fn()`` and its ms on CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run_train(torch, device):
    """Phase 20: Qwen3-4B pim_w4 shift_add at full width and depth takes
    TRAIN_STEPS AdamW steps (the reference CLI's defaults: batch 8 x 256
    tokens, lr 1e-3, warmup_cosine over 100 steps with 10 of warm-up) on
    one seeded batch, then one step with microbatches=2 against one with 1
    from the same state; then serves the trained model. Returns (record,
    launches of the measured steps by (route, K, N))."""
    import gc

    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train import (init_train_state, make_train_step,
                                   trainable_params)

    cfg = lm_config()
    if not cfg.remat:
        raise AssertionError("the training phase runs with remat")
    label = f"train {cfg_name(cfg)} ({cfg.n_layers} layers, d_model " \
        f"{cfg.d_model}, remat)"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, 5, device=device)
    params = trainable_params(model)
    n_train = sum(p.numel() for p in params)
    batch = train_batch(torch, cfg, 7, TRAIN_BATCH, TRAIN_SEQ, device)
    rec = {"config": cfg_name(cfg), "layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "schedule": TRAIN_SCHEDULE, "trainable_params": n_train}

    # one forward and one backward pass, counted apart (grads dropped)
    exp1 = train_expected(cfg)
    (loss, _), fwd_ms, fwd = counted(torch, lambda: loss_fn(cfg, model,
                                                            batch))
    _, bwd_ms, bwd = counted(torch, lambda: loss.backward())
    check_train_counts(f"{label}: forward", fwd, exp1["forward"])
    check_train_counts(f"{label}: backward", bwd, exp1["backward"])
    for p in params:
        p.grad = None
    del loss
    codes_t = sum(b.numel() for n, b in model.named_buffers()
                  if n.endswith("w_int_t"))
    rec["codes_t_gb"] = codes_t / 1e9
    rec["launches"] = {"forward": train_counts(fwd),
                       "backward": train_counts(bwd),
                       "of which remat's recompute": exp1["remat"]}
    say(f"{label}: {n_train / 1e9:.3f} B trainable parameters (every "
        f"floating leaf; the int8 codes frozen), transposed codes "
        f"{codes_t / 1e9:.3f} GB int8 built by the first backward; one "
        f"pass of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: forward "
        f"{fwd_ms:.1f} ms, launches " + json.dumps(train_counts(fwd))
        + f"; backward {bwd_ms:.1f} ms, launches "
        + json.dumps(train_counts(bwd)) + " (remat's recompute "
        + json.dumps(exp1["remat"]) + " of them; the rest dx on the "
        "transposed codes and the accumulator for dscales)")

    sched = functools.partial(warmup_cosine, **TRAIN_SCHEDULE)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR), sched)
    opt = init_train_state(model)
    hist, step_shapes = [], {}
    exp_step = add_counts(exp1["forward"], exp1["backward"])
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        (m, ms), host_ms, counts = counted(
            torch, lambda: event_ms(torch, lambda: step(model, opt, batch)))
        check_train_counts(f"{label}: step {i + 1}", counts, exp_step)
        for k, v in counts["shapes"].items():
            step_shapes[k] = step_shapes.get(k, 0) + v
        h = {k: float(m[k]) for k in ("loss", "grad_norm", "skipped",
                                      "lr_scale")}
        h.update(ms=ms, host_ms=host_ms,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=train_counts(counts))
        hist.append(h)
        say(f"train step {i + 1}: loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}, skipped {h['skipped']:.0f}, lr_scale "
            f"{h['lr_scale']:.3f}, {ms:.1f} ms (CUDA events), peak "
            f"{h['peak_gb']:.2f} GB, launches "
            + json.dumps(h["launches"]))
    rec["steps"] = hist
    bad = [i + 1 for i, h in enumerate(hist)
           if h["skipped"] or not all(map(math.isfinite, (
               h["loss"], h["grad_norm"])))]
    if bad or not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"{label}: steps {bad} skipped or not finite, "
                             f"or the loss did not fall: "
                             f"{[h['loss'] for h in hist]}")

    # step TRAIN_STEPS + 1 from one state, microbatches 1 and 2
    with torch.no_grad():
        snap = ([p.detach().clone() for p in params],
                [t.clone() for t in opt["mu"]],
                [t.clone() for t in opt["nu"]], opt["step"].clone())
    (m1, ms1), _, c1 = counted(
        torch, lambda: event_ms(torch, lambda: step(model, opt, batch)))
    with torch.no_grad():
        after1 = [p.detach().clone() for p in params]
        for dst, src in zip(params + opt["mu"] + opt["nu"],
                            snap[0] + snap[1] + snap[2]):
            dst.copy_(src)
        opt["step"] = snap[3]
    del snap
    step2 = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR), sched,
                            microbatches=2)
    (m2, ms2), _, c2 = counted(
        torch, lambda: event_ms(torch, lambda: step2(model, opt, batch)))
    check_train_counts(f"{label}: microbatches 1", c1, exp_step)
    check_train_counts(f"{label}: microbatches 2", c2,
                       add_counts(*[train_expected(cfg, 2)[k]
                                    for k in ("forward", "backward")]))
    with torch.no_grad():
        dparams = max(float((a.float() - p.detach().float()).abs().max())
                      for a, p in zip(after1, params))
    del after1
    dloss = abs(float(m1["loss"]) - float(m2["loss"]))
    rec["microbatches"] = {"loss_1": float(m1["loss"]),
                           "loss_2": float(m2["loss"]), "dloss": dloss,
                           "dparams": dparams, "ms_1": ms1, "ms_2": ms2,
                           "skipped": [float(m1["skipped"]),
                                       float(m2["skipped"])]}
    say(f"train step {TRAIN_STEPS + 1} from one state: microbatches 1 "
        f"loss {float(m1['loss']):.4f} ({ms1:.1f} ms), microbatches 2 loss "
        f"{float(m2['loss']):.4f} ({ms2:.1f} ms): |dloss| {dloss:.2e} "
        f"(bound {TRAIN_MB_LOSS}), max |dparam| {dparams:.2e} (bound "
        f"{TRAIN_MB_PARAMS}); launches "
        + json.dumps(train_counts(c2)) + " with 2")
    if not (dloss < TRAIN_MB_LOSS and dparams < TRAIN_MB_PARAMS) \
            or float(m1["skipped"]) or float(m2["skipped"]):
        raise AssertionError(f"{label}: microbatches 2 against 1: loss "
                             f"{dloss}, params {dparams}")
    del opt, step, step2, m1, m2
    gc.collect()

    # serve the trained model; a model rebuilt through convert from the
    # trained params gives the same logits, bit for bit (a stale
    # head_f32 would not)
    sbatch = prompt_batch(torch, cfg, 3, SERVE_BATCH, SERVE_PROMPT, device)
    tokens, first_ms, _, counts, _, forced = replay_checks(
        torch, cfg, model, sbatch, f"{label}, trained")
    head_fresh = torch.equal(model.head_f32, model.embed.detach().float())
    t = time.perf_counter()
    rebuilt = lm_params_from_numpy(cfg, lm_params_to_numpy(model),
                                   device=device)
    convert_s = time.perf_counter() - t
    again = teacher_forced(cfg, rebuilt, sbatch, tokens[:, :-1], device)
    same = all(torch.equal(a, b) for a, b in zip(forced, again))
    if not (head_fresh and same):
        raise AssertionError(f"{label}: head_f32 refreshed {head_fresh}; "
                             f"the rebuilt model's logits equal: {same}")
    rec["serve"] = {"first_call_ms": first_ms, "launches": counts,
                    "convert_s": convert_s}
    say(f"train serve: the trained model's greedy_generate (one graph "
        f"replay, {SERVE_BATCH} x {SERVE_PROMPT} + {SERVE_NEW} tokens) is "
        "its eager argmax chain bit for bit, launches per call "
        + json.dumps(counts["launches"]) + "; head_f32 refreshed in place; "
        f"a model rebuilt through convert ({convert_s:.1f} s) gives the "
        f"same prefill and {SERVE_NEW - 1} decode logits bit for bit")
    del model, rebuilt, forced, again, params
    gc.collect()
    torch.cuda.empty_cache()
    rec["left_allocated_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    return rec, step_shapes


def run_train_parity(torch, device):
    """Phase 21: full width, TRAIN_CHECK_LAYERS layers: one training pass's
    loss and every gradient leaf on the card against the port on the CPU
    (the same weights, built on the CPU and copied), within GRAD_REL of
    max |CPU| per leaf."""
    import copy

    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.models import init_params, loss_fn, trainable
    from repro_torch.models.transformer import tree_leaves

    cfg = lm_config(n_layers=TRAIN_CHECK_LAYERS)
    cpu_model = init_params(cfg, 9, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = train_batch(torch, cfg, 11, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                        "cpu")
    out = {}
    for where, model in (("card", card_model), ("cpu", cpu_model)):
        trainable(model)
        t = time.perf_counter()
        loss, _ = loss_fn(cfg, model, {k: v.to(model.device)
                                       for k, v in batch.items()})
        loss.backward()
        out[where] = (float(loss.detach()), dict(tree_leaves(
            lm_params_to_numpy(model, grads=True))),
            time.perf_counter() - t)
    (lc, gc_, card_s), (lp, gp, cpu_s) = out["card"], out["cpu"]
    worst, errs = 0.0, {}
    for key, ref in gp.items():
        err = float(abs(gc_[key] - ref).max() / (abs(ref).max() + 1e-30))
        errs[key] = err
        worst = max(worst, err)
    loss_rel = abs(lc - lp) / abs(lp)
    top = max(errs, key=errs.get)
    say(f"train parity {cfg_name(cfg)} at full width, "
        f"{TRAIN_CHECK_LAYERS} layers, {TRAIN_CHECK_BATCH} x "
        f"{TRAIN_CHECK_SEQ} tokens: loss card {lc:.5f}, CPU {lp:.5f} (rel "
        f"{loss_rel:.2e}); {len(errs)} gradient leaves, worst {top} "
        f"{worst:.2e} of max |CPU| (bound {GRAD_REL}); card {card_s:.1f} s, "
        f"CPU {cpu_s:.1f} s")
    if set(gc_) != set(gp) or loss_rel > GRAD_REL or worst > GRAD_REL:
        raise AssertionError(f"train parity: loss rel {loss_rel}, worst "
                             f"leaf {top} {worst}")
    return {"loss_card": lc, "loss_cpu": lp, "loss_rel": loss_rel,
            "grad_rel": errs, "card_s": card_s, "cpu_s": cpu_s}


def flash_lse_row(torch, device, gen, shape):
    """Phase 20's flash shape with the log-sum-exp: the kernel of its route
    against the plain version, output in bf16 within FLASH_BF16_REL and
    the log-sum-exp within FLASH_LSE_ABS, then timed beside the plain
    version and SDPA (which returns no log-sum-exp)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_attn import ref as fref

    B, KV, G, dk, dv, sq, sk, last, window, ring = shape
    q, k, v, pos_q, pos_k, seen = flash_operands(torch, device, gen, shape)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got, lse = fa.flash_attention(qb, kb, vb, pos_q, pos_k, return_lse=True)
    exp, exp_lse = fref.ref_flash_attention(qb, kb, vb, pos_q, pos_k,
                                            return_lse=True)
    torch.cuda.synchronize()
    err = max_abs_err(got.float(), exp.float())
    lse_err = max_abs_err(lse, exp_lse)
    bound = FLASH_BF16_REL * float(exp.float().abs().max())
    if not (err < bound and lse_err < FLASH_LSE_ABS
            and torch.isfinite(lse).all()):
        raise AssertionError(f"flash_attn lse {shape}: out err {err} "
                             f"(bound {bound}), lse err {lse_err}")
    qt = qb.reshape(B, sq, KV * G, dk).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    pairs = int(seen.sum())
    row = _kernel_row(
        torch,
        lambda: fa.flash_attention(qb, kb, vb, pos_q, pos_k,
                                   return_lse=True),
        lambda: fref.ref_flash_attention(qb, kb, vb, pos_q, pos_k,
                                         return_lse=True),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=seen[:, None], enable_gqa=True),
        2 * (qb.numel() + kb.numel() + vb.numel() + B * sq * KV * G * dv)
        + 4 * (pos_q.numel() + pos_k.numel() + B * KV * G * sq),
        2 * (dk + dv) * KV * G * pairs,
        f"q ({B}, {sq}, {KV}, {G}, {dk}), k ({B}, {sk}, {KV}, {dk}), v "
        f"(.., {dv}) bf16, lse (B, KV, G, Sq) float32, {pairs} seen "
        "(query, key) pairs", err, per_graph=10, reps=10)
    row["route"] = fa.route(sq, G, torch.bfloat16, dk, dv)
    row["lse_max_abs_err"] = lse_err
    return row


# ---------------------------------------------------------------------------
# Phases 22-23: training's loop, checkpoints and CLI; the examples
# ---------------------------------------------------------------------------

def captured(fn):
    """``fn()`` with its standard output captured: (result, lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


class CkptTimes:
    """Times each ``checkpoint.save`` and ``checkpoint.restore`` the loop
    makes (ms on the host clock, the card synchronized on both sides) and
    the bytes each save wrote, while in the ``with`` block."""

    def __init__(self, torch):
        self.torch = torch
        self.saves, self.restores = [], []

    def __enter__(self):
        from repro_torch.ckpt import checkpoint
        self.ckpt = checkpoint
        self.orig = (checkpoint.save, checkpoint.restore)
        save, restore = self.orig

        def timed_call(fn, out, *args, **kwargs):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return got

        def save_timed(*args, **kwargs):
            path = timed_call(save, self.saves, *args, **kwargs)
            self.saves[-1] = (self.saves[-1], sum(
                f.stat().st_size for f in Path(path).iterdir()))
            return path

        checkpoint.save = save_timed
        checkpoint.restore = lambda *a, **k: timed_call(restore,
                                                        self.restores, *a,
                                                        **k)
        return self

    def __exit__(self, *exc):
        self.ckpt.save, self.ckpt.restore = self.orig
        return False


def ckpt_arrays(d, step):
    import numpy as np
    with np.load(Path(d) / f"step_{step:08d}" / "host0.npz") as z:
        return {k: z[k] for k in z.files}


def as_float(a):
    """A checkpoint array as float64 values (bf16 from its uint16 bits)."""
    import numpy as np
    if a.dtype == np.uint16:
        a = (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def run_train_loop(torch, device, keep: str):
    """Phase 22: the training CLI (``repro_torch.launch.train.main``)
    in-process at full width and depth (Qwen3-4B pim_w4, TRAIN_BATCH x
    TRAIN_SEQ, TRAIN_STEPS steps, no checkpoints), its launches held to
    phase 20's per step; then the loop's resume at full width with
    RESUME_LAYERS layers: RESUME_STEPS uninterrupted steps against half of
    them, then a resume to all, every trainable leaf, moment and the step
    counter bit for bit, with the checkpoint's bytes and its save and
    restore times; the uninterrupted run's checkpoints stay in ``keep``
    (phase 24 restores them). Returns the record."""
    import dataclasses
    import gc
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train import train_loop, trainable_params

    cfg = lm_config()
    argv = ["--arch", LM_ARCH[0], "--quant", LM_ARCH[1]["quant"],
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS)]
    if cfg != dataclasses.replace(get_config(LM_ARCH[0]),
                                  quant=LM_ARCH[1]["quant"]):
        raise AssertionError("the CLI's config is not phase 20's")
    (hist, lines), host_ms, counts = counted(
        torch, lambda: captured(lambda: train_cli.main(argv)))
    per_step = add_counts(*[train_expected(cfg)[k]
                            for k in ("forward", "backward")])
    exp = {"pim_matmul": per_step["pim_matmul"] * TRAIN_STEPS,
           "flash_lse": per_step["flash_lse"] * TRAIN_STEPS,
           "shapes": {k: v * TRAIN_STEPS
                      for k, v in per_step["shapes"].items()}}
    check_train_counts("train-loop cli", counts, exp)
    done = [line for line in lines if line.startswith("done: ")]
    if len(done) != 1 or len(hist["loss"]) != TRAIN_STEPS \
            or hist["skipped"] or not all(map(math.isfinite, hist["loss"])):
        raise AssertionError(f"train-loop cli: {lines}, {hist}")
    for line in lines:
        say(f"train-loop cli: {line}")
    step_ms = [t * 1e3 for t in hist["step_time"]]
    per = train_counts(counts)
    per = {"pim_matmul": per["pim_matmul"] // TRAIN_STEPS,
           "flash_lse": per["flash_lse"] // TRAIN_STEPS,
           "shapes": {k: v // TRAIN_STEPS for k, v in per["shapes"].items()}}
    rec = {"argv": argv, "step_ms": step_ms, "loss": hist["loss"],
           "skipped": hist["skipped"], "stragglers": hist["stragglers"],
           "host_ms": host_ms, "launches_per_step": per, "done": done[0]}
    say(f"train-loop cli {cfg_name(cfg)} ({cfg.n_layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens of the synthetic stream): "
        "steps " + ", ".join(f"{t:.1f}" for t in step_ms) + " ms "
        "(history['step_time'], host clock around each step and its "
        f"metrics' read), losses " + ", ".join(
            f"{v:.4f}" for v in hist["loss"]) + f", skipped "
        f"{hist['skipped']}; {host_ms / 1e3:.1f} s in all; launches per "
        "step " + json.dumps(per) + " (phase 20's, held)")
    del hist
    gc.collect()
    torch.cuda.empty_cache()

    # the resume check, at full width with RESUME_LAYERS layers
    rcfg = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    sched = functools.partial(warmup_cosine, **TRAIN_SCHEDULE)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_every=10**6,
              opt_cfg=AdamWConfig(lr=TRAIN_LR), schedule_fn=sched,
              log=lambda *a: None, device=device)
    half = RESUME_STEPS // 2
    d1 = keep
    with tempfile.TemporaryDirectory() as d2, CkptTimes(torch) as ct:
        m1, h1 = train_loop(rcfg, steps=RESUME_STEPS, ckpt_dir=d1, **kw)
        _, h2a = train_loop(rcfg, steps=half, ckpt_dir=d2, **kw)
        gc.collect()
        m2, h2 = train_loop(rcfg, steps=RESUME_STEPS, ckpt_dir=d2, **kw)
        same_params = all(torch.equal(a.detach(), b.detach()) for a, b in
                          zip(trainable_params(m1), trainable_params(m2)))
        del m1, m2
        gc.collect()
        a, b = ckpt_arrays(d1, RESUME_STEPS), ckpt_arrays(d2, RESUME_STEPS)
        worst, worst_key = 0.0, None
        equal = sorted(a) == sorted(b)
        for k in a:
            if not (k in b and a[k].dtype == b[k].dtype
                    and a[k].shape == b[k].shape):
                equal = False
                continue
            if not np.array_equal(a[k], b[k]):
                equal = False
                diff = float(np.abs(as_float(a[k]) - as_float(b[k])).max())
                if diff > worst:
                    worst, worst_key = diff, k
        n_keys = len(a)
        del a, b
    losses_equal = h1["loss"][half:] == h2["loss"]
    (save_ms, nbytes), restore_ms = ct.saves[1], ct.restores[0]
    rrec = {"layers": RESUME_LAYERS, "steps": RESUME_STEPS, "resume_at": half,
            "ckpt_bytes": nbytes, "save_ms": [s for s, _ in ct.saves],
            "restore_ms": ct.restores, "keys": n_keys,
            "worst_abs_diff": worst, "worst_key": worst_key,
            "bit_equal": equal and same_params, "losses_equal": losses_equal,
            "losses": h1["loss"], "resumed_losses": h2a["loss"] + h2["loss"]}
    rec["resume"] = rrec
    say(f"train-loop resume {cfg_name(rcfg)} at full width, "
        f"{RESUME_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"{RESUME_STEPS} steps against {half}, then a resume to "
        f"{RESUME_STEPS}: checkpoint {nbytes} bytes as written ({n_keys} "
        f"arrays: trainable leaves, float32 moments, step), save "
        + " / ".join(f"{s:.0f}" for s in rrec["save_ms"]) + " ms, restore "
        f"{restore_ms:.0f} ms (host clock, the card synchronized); every "
        f"array bit for bit: {rrec['bit_equal']} (worst |diff| {worst:.3e}"
        + (f" at {worst_key}" if worst_key else "") + "), losses equal: "
        f"{losses_equal} ({', '.join(f'{v:.4f}' for v in h1['loss'])})")
    if not (rrec["bit_equal"] and losses_equal and len(ct.restores) == 1):
        raise AssertionError(f"train-loop resume: {rrec}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def row_launches(torch):
    """The row kernels' counts as the kernels lines name them."""
    from repro_torch.kernels.rowops import ops
    torch.cuda.synchronize()
    return {**ops.LAUNCHES,
            **{f"bitwise_rows[{k}]": v for k, v in ops.ROWS_BY_OP.items()},
            **{f"shift_rows[{k}]": v for k, v in ops.SHIFT_ROUTES.items()}}


def run_examples(torch):
    """Phase 23: each ``examples/*_torch.py`` example's ``main`` on the
    card (its default device), the launch counts reset just before it and
    read just after it; the PIM examples' lines against their CPU run's,
    line for line."""
    import importlib.util
    import tempfile

    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.kernels.rowops import ops

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def run(name, argv):
        mod = load(name)
        for reset in (ops.reset_launches, pm.reset_launches,
                      fa.reset_launches):
            reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, lines = captured(lambda: mod.main(argv))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {**{k: v for k, v in row_launches(torch).items() if v},
                    "pim_matmul": pm.LAUNCHES["pim_matmul"],
                    "flash_attn": fa.LAUNCHES["flash_attn"]}
        return out, lines, ms, launches

    rec = {}
    for name in ("quickstart_torch", "pim_crypto_torch"):
        _, card_lines, card_ms, launches = run(name, [])
        _, cpu_lines, cpu_ms, _ = run(name, ["--device", "cpu"])
        for line in card_lines:
            if line:
                say(f"examples {name}: {line}")
        equal = card_lines == cpu_lines
        rec[name] = {"lines": card_lines, "ms": card_ms, "cpu_ms": cpu_ms,
                     "equal_to_cpu": equal, "launches": launches}
        say(f"examples {name}: {len(card_lines)} lines, card == CPU line "
            f"for line: {equal}; {card_ms:.0f} ms on the card, {cpu_ms:.0f}"
            f" ms on the CPU; launches " + json.dumps(launches))
        if not equal:
            raise AssertionError(f"{name}: card {card_lines}, CPU "
                                 f"{cpu_lines}")
        idle = [k for k in EXAMPLE_KERNELS[name] if not launches.get(k)]
        if idle:
            raise AssertionError(f"{name}: kernels never launched: {idle}")

    (out, out2, out_q), lines, ms, launches = run("serve_lm_torch", [])
    for line in lines:
        say(f"examples serve_lm_torch: {line}")
    rec["serve_lm_torch"] = {"lines": lines, "ms": ms, "launches": launches}
    say(f"examples serve_lm_torch: two calls equal: "
        f"{bool(torch.equal(out, out2))}; {ms:.0f} ms; launches "
        + json.dumps(launches))
    if not (torch.equal(out, out2) and out.is_cuda and out_q.is_cuda
            and launches["pim_matmul"] and launches["flash_attn"]):
        raise AssertionError(f"serve_lm_torch: {launches}")

    with tempfile.TemporaryDirectory() as d:
        hist, lines, ms, launches = run("train_lm_torch", ["--ckpt-dir", d])
        kept = sorted(p.name for p in Path(d).iterdir())
    for line in lines:
        if line and not line.startswith("checkpoints in "):
            say(f"examples train_lm_torch: {line}")
    rec["train_lm_torch"] = {"lines": lines, "ms": ms, "launches": launches,
                             "step_ms": [t * 1e3 for t in hist["step_time"]],
                             "checkpoints": kept}
    say(f"examples train_lm_torch: {len(hist['loss'])} steps in "
        f"{ms / 1e3:.1f} s, checkpoints kept {kept}; launches "
        + json.dumps(launches))
    if lines[-1] != "OK: loss decreased" or hist["skipped"] \
            or not launches["flash_attn"]:
        raise AssertionError(f"train_lm_torch: {lines[-3:]}, {launches}")
    return rec


# ---------------------------------------------------------------------------
# Phase 9: ripple_add against its plain version; fused against composed
# ---------------------------------------------------------------------------

def ripple_library(torch, width):
    """One PyTorch call that computes ``ripple_add`` at ``width``, with its
    name, or (None, "none"). At w 1 the interior mask is 0 and no carry
    moves, so the add is ``a ^ b``; at w 8, 16 and 32 little-endian packing
    and wrap-around addition make it one ``torch.add`` on the rows viewed
    as uint8, int16 or int32. w 2 and 4 have no such call."""
    if width == 1:
        return (lambda x, y: torch.bitwise_xor(x, y)), "torch.bitwise_xor"
    dt = {8: "uint8", 16: "int16", 32: "int32"}.get(width)
    if dt is None:
        return None, "none"
    view = getattr(torch, dt)
    return (lambda x, y: torch.add(x.view(view), y.view(view))
            .view(torch.int32)), f"torch.add on {dt}"


def phase_ripple(torch, device):
    """ripple_add at every width: exact against its plain version; device,
    plain and library times and the bound. Returns (rows, fused record)."""
    from repro_torch.kernels.rowops import ops, ref

    n, w = RIPPLE_SHAPE
    # RIPPLE_PAIRS operand pairs (64 MiB) cycled through by the timed
    # calls, so that each call finds its inputs outside the 50 MB L2, as
    # the HBM bound assumes
    pairs = [(rows_from_seed(40 + 2 * i, (n, w), torch, device),
              rows_from_seed(41 + 2 * i, (n, w), torch, device))
             for i in range(RIPPLE_PAIRS)]
    a, b = pairs[0]
    for shape in RIPPLE_RAGGED:
        ra = rows_from_seed(33, shape, torch, device)
        rb = rows_from_seed(34, shape, torch, device)
        for width in WIDTHS:
            if not torch.equal(ops.ripple_add(ra, rb, width=width),
                               ref.ref_ripple_add(ra, rb, width)):
                raise AssertionError(f"ripple_add w{width} {shape} differs "
                                     "from plain")

    cycled_pairs = cycled(pairs)
    rows = {}
    for width in WIDTHS:
        for pa, pb in pairs:
            got = ops.ripple_add(pa, pb, width=width)
            exp = ref.ref_ripple_add(pa, pb, width)
            if not torch.equal(got, exp):
                raise AssertionError(f"ripple_add w{width} differs from "
                                     "plain")
        got = ops.ripple_add(a, b, width=width)
        exp = ref.ref_ripple_add(a, b, width)
        if not torch.equal(got.cpu(), ref.ref_ripple_add(a.cpu(), b.cpu(),
                                                         width)):
            raise AssertionError(f"ripple_add w{width} differs from plain "
                                 "on the CPU")
        library, lib_note = ripple_library(torch, width)
        if library is not None and not all(
                torch.equal(library(pa, pb), ops.ripple_add(pa, pb,
                                                            width=width))
                for pa, pb in pairs):
            library, lib_note = None, f"none ({lib_note} differs)"
        # Operations: the masked lane add, ((a & ~H) + (b & ~H)) ^ ((a ^ b)
        # & H), four logic operations and one add per word at every width,
        # as nvcc emits them (LOP3 and IADD3 on the integer pipe; the sass
        # line counts them).
        nbytes = 12 * n * w
        nops = 5 * n * w
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = nops / H100_INT32_OPS_PER_S * 1e3
        kernel = lambda x, y, width=width: ops.ripple_add(x, y, width=width)
        r = dict(
            ms=device_us(cycled_pairs(kernel), torch) / 1e3,
            call_ms=event_us(cycled_pairs(kernel), torch) / 1e3,
            plain_ms=device_us(cycled_pairs(lambda x, y, width=width:
                                      ref.ref_ripple_add(x, y, width)),
                               torch) / 1e3,
            library_ms=(None if library is None
                        else device_us(cycled_pairs(library), torch) / 1e3),
            library=lib_note, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ops=nops, max_abs_err=max_abs_err(got, exp),
            shape=f"2 x ({n}, {w}) int32, w {width}")
        rows[f"ripple_add[w{width}]"] = r
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us ({lib_note})")
        say(f"kernel ripple_add[w{width}] {r['shape']}: kernel "
            f"{r['ms'] * 1e3:.2f} us ({r['call_ms'] * 1e3:.2f} us per call "
            f"with the host's launch), plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {lib}, bound {r['bound_ms'] * 1e3:.3f} us "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']}")

    # The kernel bench's path, ripple_add's own (the bit-plane VM records
    # PIM commands instead, as the reference's does): the fused adder at
    # w 8, the bit-plane layer's byte lanes, beside its op-by-op
    # composition, with the launch counts reset just before and read just
    # after.
    def composed_ripple_add(x, y):
        return ref.composed_ripple_add(x, y, 8, bitwise=ops.bitwise,
                                       shift_cols=ops.shift_cols)

    ops.reset_launches()
    fused = ops.ripple_add(a, b, width=8)
    composed = composed_ripple_add(a, b)
    torch.cuda.synchronize()
    bench_launches = dict(ops.LAUNCHES)
    bench_ops = dict(ops.LAUNCHES_BY_OP)
    n_composed = bench_launches["bitwise"] + bench_launches["shift_cols"]
    if not torch.equal(fused, composed) or n_composed != 2 + 4 * 7:
        raise AssertionError(f"fused ripple_add != composed ({n_composed} "
                             "launches)")
    if bench_launches["ripple_add"] == 0:
        raise AssertionError("ripple_add never launched on the kernel "
                             "bench's path")
    rec = dict(
        width=8, launches=bench_launches, by_op=bench_ops,
        composed_launches=n_composed,
        fused_ms=device_us(cycled_pairs(
            lambda x, y: ops.ripple_add(x, y, width=8)), torch) / 1e3,
        composed_ms=device_us(cycled_pairs(composed_ripple_add),
                              torch) / 1e3,
        fused_bytes=12 * n * w,
        composed_bytes=(2 * 12 + 7 * (8 + 12 + 12 + 12)) * n * w)
    say(f"fused ripple_add[w8] {n}x{w}: fused {rec['fused_ms'] * 1e3:.2f} us "
        f"== composed ({n_composed} bitwise/shift_cols launches) "
        f"{rec['composed_ms'] * 1e3:.2f} us, bit for bit; rows moved "
        f"{rec['fused_bytes'] / 2**20:.0f} MiB fused vs "
        f"{rec['composed_bytes'] / 2**20:.0f} MiB composed")
    return rows, rec


def ripple_sass():
    """Instructions per word of ``ripple_add`` at w 32 (the 16-byte-vector
    kernel), counted in ``cuobjdump -sass`` of the built library: what the
    bound's operation count rests on. A thread adds kRippleVecs vectors
    and at most one word of the tail, so the counts are divided by 4 x
    kRippleVecs + 1 words (IADD3 and IMAD include the address arithmetic).
    None where the toolkit has no ``cuobjdump``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    vecs = int(re.search(r"constexpr int kRippleVecs = (\d+);",
                         (ROOT / SOURCES["rowops"]).read_text()).group(1))
    ops = sass_opcodes("rowops", r"ripple_add_vec4_kernelILi32E",
                       lambda m: "w32")["w32"]
    return {k: ops[k] / (4 * vecs + 1) for k in ("LOP3", "IADD3", "IMAD")}


# ---------------------------------------------------------------------------
# Phases 10-11: the bit-plane layer at the case study's sizes
# ---------------------------------------------------------------------------

def _meters(vm) -> dict:
    return {"time_ns": vm.time_ns, "energy_nj": vm.energy_nj,
            "setup_energy_nj": vm.setup_energy_nj,
            "host_overlap_ns": vm.host_overlap_ns, "counts": vm.counts()}


def _timed(torch, device, fn):
    """(result, host ms) of ``fn``, ending in a sync on the card."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _routine(name, vm, ra, rb):
    from repro_torch.core.bitplane import arith, gf
    return {"add_ripple": lambda: arith.add_ripple(vm, ra, rb),
            "add_kogge_stone": lambda: arith.add_kogge_stone(vm, ra, rb),
            "mul_shift_add": lambda: arith.mul_shift_add(vm, ra, rb),
            "xtime": lambda: gf.xtime(vm, ra),
            "gf_mul": lambda: gf.gf_mul(vm, ra, rb),
            "mixcolumns": lambda: gf.mixcolumns(vm, ra)}[name]()


def _oracle(name, a, b):
    from repro_torch.core.bitplane import arith, gf
    if name == "mixcolumns":
        return gf.ref_mixcolumns(a.reshape(-1, 4)).reshape(-1)
    return {"add_ripple": lambda: arith.ref_add(a, b, 8),
            "add_kogge_stone": lambda: arith.ref_add(a, b, 8),
            "mul_shift_add": lambda: arith.ref_mul(a, b, 8),
            "xtime": lambda: gf.ref_xtime(a),
            "gf_mul": lambda: gf.ref_gf_mul(a, b)}[name]()


def _add_step(vm, x):
    """One recurring pipeline step: load two byte-lane rows, add them."""
    from repro_torch.core.bitplane import arith
    a, b = vm.load(x[0]), vm.load(x[1])
    s = arith.add_ripple(vm, a, b)
    vm.free(a, b)
    return s


def _xtime_step(vm, x):
    from repro_torch.core.bitplane import gf
    a = vm.load(x)
    t = gf.xtime(vm, a)
    vm.free(a)
    return t


def run_bitplane(torch, device, seed=21, check_oracles=False):
    """The bit-plane path on ``device``. Returns (values, record): the
    values (reads, float32 meters, counts) phase 11 compares across
    devices, and the record of times and DDR3 model outputs. With
    ``check_oracles`` the RS encodes are also held against the numpy
    oracle (tens of seconds of host Python at these sizes)."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM, layout, rs
    from repro_torch.kernels.rowops import ops

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    values, record = {}, {"routines": {}}
    for name in VM_ROUTINES:
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
        a = rng.integers(0, 256, vm.lanes)
        b = rng.integers(0, 256, vm.lanes)
        ra, rb = vm.load(a), vm.load(b)
        t0, e0 = vm.time_ns, vm.energy_nj
        got, host_ms = _timed(torch, device,
                              lambda: vm.read(_routine(name, vm, ra, rb)))
        if not np.array_equal(got, _oracle(name, a, b)):
            raise AssertionError(f"PimVM {name} differs from its oracle")
        values[name] = ([got], _meters(vm))
        record["routines"][name] = dict(
            host_ms=host_ms, ddr3_ns=vm.time_ns - t0,
            ddr3_nj=vm.energy_nj - e0, counts=vm.counts())
        if name == "add_ripple":
            # the fused adder (the kernel bench's form of the same add)
            # on the rows the VM loaded; its launch is this check's, not
            # the VM path's, and is counted apart
            rows = vm.state.bits
            before = ops.LAUNCHES["ripple_add"]
            fused = ops.ripple_add(rows[ra:ra + 1].contiguous(),
                                   rows[rb:rb + 1].contiguous(), width=8)
            record["check_launches"] = ops.LAUNCHES["ripple_add"] - before
            if not np.array_equal(
                    layout.unpack_elements(fused[0], 8, vm.lanes), got):
                raise AssertionError("ripple_add on the VM's rows differs "
                                     "from add_ripple's read-back row")

    # RS(12,8) on 32 banks of full rows, and on one 65,536-word subarray
    msg = rng.integers(0, 256, (RS_K, RS_WORDS * 4))
    pars, rs_rec = [], {}
    for what, banks in (("32 banks", RS_BANKS), ("one subarray", 1)):
        vm = PimVM(width=8, num_rows=RS_ROWS, words=RS_WORDS, n_banks=banks,
                   device=device)
        regs = [vm.load(msg[i]) for i in range(RS_K)]
        t0, e0 = vm.time_ns, vm.energy_nj
        par, host_ms = _timed(torch, device, lambda: np.stack(
            vm.read_many(rs.rs_encode(vm, regs, RS_NPAR))))
        pars.append(par)
        values[f"rs_encode {what}"] = ([par], _meters(vm))
        rs_rec[what] = dict(host_ms=host_ms, ddr3_ns=vm.time_ns - t0,
                            ddr3_nj=vm.energy_nj - e0)
    if not np.array_equal(pars[0], pars[1]):
        raise AssertionError("RS encode: 32 banks != one wide subarray")
    if check_oracles and not np.array_equal(
            pars[0], rs.ref_rs_encode(msg, RS_NPAR)):
        raise AssertionError("RS encode on 32 banks differs from the oracle")
    record["rs"] = rs_rec

    # the async pipeline (crypto_casestudy._async_pipeline at this size)
    lanes = PIPE_WORDS * 4
    msgs = [rng.integers(0, 256, (RS_K, lanes)) for _ in range(PIPE_CHUNKS)]
    pipe = {}
    for async_host in (False, True):
        vm = PimVM(width=8, num_rows=RS_ROWS, words=PIPE_WORDS,
                   n_banks=PIPE_BANKS, async_host=async_host, device=device)

        def encode_all(vm=vm):
            out = []
            for m in msgs:
                regs = [vm.load(m[i]) for i in range(RS_K)]
                par = rs.rs_encode(vm, regs, RS_NPAR)
                out.append(np.stack(vm.read_many(par)))
                vm.free(*regs, *par)
            return np.stack(out)

        got, host_ms = _timed(torch, device, encode_all)
        pipe[async_host] = (vm, got, host_ms)
        values[f"pipeline async={async_host}"] = ([got], _meters(vm))
    (vs, gs, ms_s), (va, ga, ms_a) = pipe[False], pipe[True]
    hidden = va.host_overlap_ns
    if check_oracles:
        for c, m in enumerate(msgs):
            if not np.array_equal(gs[c], rs.ref_rs_encode(m, RS_NPAR)):
                raise AssertionError(f"pipeline chunk {c} differs from the "
                                     "oracle")
    if not (np.array_equal(gs, ga) and vs.energy_nj == va.energy_nj
            and va.time_ns < vs.time_ns
            and abs((vs.time_ns - va.time_ns) - hidden)
            <= 1e-6 * vs.time_ns):
        raise AssertionError("async pipeline: the case study's identities "
                             "do not hold")
    record["pipeline"] = dict(sync_ns=vs.time_ns, async_ns=va.time_ns,
                              hidden_ns=hidden, energy_nj=vs.energy_nj,
                              sync_host_ms=ms_s, async_host_ms=ms_a,
                              exact=(vs.time_ns - va.time_ns) == hidden)

    # run_pipeline / run_workload on a sharded VM against step-by-step
    xs = [(rng.integers(0, 256, VM_WORDS * 4),
           rng.integers(0, 256, VM_WORDS * 4)) for _ in range(4)]
    ys = [rng.integers(0, 256, VM_WORDS * 4) for _ in range(3)]
    runs, dispatches = {}, {}
    sched = importlib.import_module("repro_torch.core.pim.schedule")
    for mode in ("run", "stepwise"):
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, n_banks=8,
                   async_host=True, device=device)
        # every mask the steps use, created once before them: inside a
        # pipeline step a new mask would be host-written at every step
        for pattern in (0xFE, 0xFC, 0xF0, 0x7F, 0x3F, 0x0F, 0x80, 0x1B):
            vm.mask(pattern)
        d0 = sched.SCHED_STATS["dispatches"]
        if mode == "run":
            out, host_ms = _timed(torch, device, lambda: (
                vm.run_pipeline(_add_step, xs),
                vm.run_workload([(_add_step, xs[:2]), (_xtime_step, ys)])))
        else:
            def stepwise(vm=vm):
                res = []
                for fn, steps in ((_add_step, xs), (_add_step, xs[:2]),
                                  (_xtime_step, ys)):
                    out = []
                    for x in steps:
                        reg = fn(vm, x)
                        out.append(vm.read(reg))
                        vm.free(reg)
                    res.append(out)
                return res[0], res[1:]

            out, host_ms = _timed(torch, device, stepwise)
        runs[mode] = (vm, out, host_ms)
        dispatches[mode] = sched.SCHED_STATS["dispatches"] - d0
    (vr, (p, w), ms_r), (vw, (p2, w2), ms_w) = runs["run"], runs["stepwise"]
    flat = lambda o: [v for seq in o for v in seq]
    if not (all(np.array_equal(x, y) for x, y in zip(p + flat(w),
                                                      p2 + flat(w2)))
            and vr.energy_nj == vw.energy_nj and vr.counts() == vw.counts()
            and abs(vr.time_ns - vw.time_ns) <= 1e-6 * vw.time_ns):
        raise AssertionError("run_pipeline/run_workload differ from the "
                             "same steps flushed one by one")
    values["run_pipeline+run_workload"] = (p + flat(w), _meters(vr))
    record["runs"] = dict(run_host_ms=ms_r, stepwise_host_ms=ms_w,
                          run_ns=vr.time_ns, stepwise_ns=vw.time_ns,
                          run_dispatches=dispatches["run"],
                          stepwise_dispatches=dispatches["stepwise"],
                          steps=len(xs) + 2 + len(ys))
    return values, record


def bitplane_equal(a, b) -> bool:
    """Reads equal, counts equal, float meters equal as float32 bits."""
    import numpy as np
    if a.keys() != b.keys():
        return False
    for k in a:
        (ra, ma), (rb, mb) = a[k], b[k]
        if len(ra) != len(rb) or not all(np.array_equal(x, y)
                                         for x, y in zip(ra, rb)):
            return False
        for f, x in ma.items():
            y = mb[f]
            if f == "counts":
                if x != y:
                    return False
            elif np.float32(x).view(np.uint32) != np.float32(y).view(
                    np.uint32):
                return False
    return True


def profile_vm(torch, device):
    """One warm ``mul_shift_add`` on 8 KB rows under the profiler."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM, arith
    vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
    rng = np.random.default_rng(22)
    ra = vm.load(rng.integers(0, 256, vm.lanes))
    rb = vm.load(rng.integers(0, 256, vm.lanes))
    vm.read(arith.mul_shift_add(vm, ra, rb))
    return device_share(torch, lambda: vm.read(arith.mul_shift_add(vm, ra,
                                                                   rb)))


def vm_runs(torch, device, name):
    """``fn`` for launch_count: each call runs routine ``name`` on the next
    of three VMs built (8 KB rows, operands loaded) ahead of the window,
    and reads its result: one flush."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM
    rng = np.random.default_rng(23)
    vms = []
    for _ in range(3):
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
        vms.append((vm, vm.load(rng.integers(0, 256, vm.lanes)),
                    vm.load(rng.integers(0, 256, vm.lanes))))
    it = iter(vms)

    def fn():
        vm, ra, rb = next(it)
        return vm.read(_routine(name, vm, ra, rb))
    return fn


def say_bitplane(record):
    for name, r in record["routines"].items():
        say(f"bitplane PimVM(width=8, num_rows={VM_ROWS}, words={VM_WORDS}) "
            f"{name}: == oracle; {r['host_ms']:.2f} ms on the host clock "
            f"(card); DDR3 model {r['ddr3_ns']:.1f} ns, {r['ddr3_nj']:.1f} "
            f"nJ")
    rs_r = record["rs"]
    say(f"bitplane RS({RS_K + RS_NPAR},{RS_K}) encode, {RS_WORDS * 4} "
        f"codewords ({RS_BANKS} banks x {RS_WORDS // RS_BANKS} words x "
        f"{RS_ROWS} rows, {RS_ROWS * RS_WORDS * 4 / 2**20:.1f} MiB of "
        f"rows): == oracle == one {RS_WORDS}-word subarray; host ms "
        f"{rs_r['32 banks']['host_ms']:.1f} (32 banks), "
        f"{rs_r['one subarray']['host_ms']:.1f} (one subarray); DDR3 model "
        f"{rs_r['32 banks']['ddr3_ns']:.1f} ns vs "
        f"{rs_r['one subarray']['ddr3_ns']:.1f} ns, "
        f"{rs_r['32 banks']['ddr3_nj']:.1f} nJ")
    pp = record["pipeline"]
    say(f"bitplane async pipeline {PIPE_BANKS} banks x {PIPE_WORDS} words x "
        f"{PIPE_CHUNKS} chunks: equal bits and energy "
        f"({pp['energy_nj']:.1f} nJ); sync {pp['sync_ns']:.1f} ns - async "
        f"{pp['async_ns']:.1f} ns = hidden {pp['hidden_ns']:.1f} ns "
        f"(exact: {pp['exact']}); host ms {pp['sync_host_ms']:.1f} sync, "
        f"{pp['async_host_ms']:.1f} async")
    rr = record["runs"]
    say(f"bitplane run_pipeline + run_workload (8 banks, async) == the same "
        f"steps flushed one by one; host ms {rr['run_host_ms']:.1f} vs "
        f"{rr['stepwise_host_ms']:.1f} ({rr['steps']} steps: "
        f"{rr['run_host_ms'] / rr['steps']:.2f} vs "
        f"{rr['stepwise_host_ms'] / rr['steps']:.2f} ms per step; "
        f"dispatches per step {rr['run_dispatches'] / rr['steps']:.3f} vs "
        f"{rr['stepwise_dispatches'] / rr['steps']:.3f}, each call a first "
        f"call, run eagerly); DDR3 wall {rr['run_ns']:.1f} ns vs "
        f"{rr['stepwise_ns']:.1f} ns")


# ---------------------------------------------------------------------------
# Phase 13: the static verifier's gates at full width
# ---------------------------------------------------------------------------

def full_width_trace(text: str, rows: int, words: int) -> str:
    """The pim104 fixture's stream (recorded on a 16-row subarray, AAP and
    TRA only) at ``rows`` x ``words``: its reserved-tail rows (C1 and
    T0..T3, rows 10-15 there) moved to the same tail rows, so the hazard is
    the same one at the paper's geometry."""
    out = []
    for line in text.splitlines():
        if line.startswith("# pim-trace"):
            line = line.replace("rows=16 words=2",
                                f"rows={rows} words={words}")
        elif line.strip() and not line.startswith("#"):
            toks = line.split()
            line = " ".join(toks[:3] + [
                str(int(t) + rows - 16 if int(t) >= 10 else int(t))
                for t in toks[3:]])
        out.append(line)
    return "\n".join(out) + "\n"


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` (host-only work: no card)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def lint_100k_program():
    """The reference test's 100k-op stream: 100,000 AAPs between random
    rows of a 64 x 4 subarray and one seeded TRA hazard at the tail."""
    import numpy as np
    from repro_torch.core import pim
    rng = np.random.default_rng(0)
    b = pim.ProgramBuilder(64, 4)
    b.fill(pim.C0, 0)
    for src, dst in zip(rng.integers(0, 32, LINT_100K),
                        rng.integers(0, 32, LINT_100K)):
        b.rowclone(int(src), int(dst))
    b.tra(1, 1, 2)
    prog = b.build()
    prog.columns
    return prog


def phase_gates(torch, device, cfg, steps) -> dict:
    """execute(), schedule() and schedule_pipeline() with verify=True
    against verify=False on the card, bit for bit; the pim104 fixture
    refused by the gates at its own geometry and at the paper's; the host
    ms of the static tools per program, cold (their caches cleared)."""
    from repro_torch.core import pim
    from repro_torch.core.pim import lint, sem
    state = subarray_state(torch, device)
    for name, prog, refresh in subarray_programs():
        a = pim.execute(prog, state, refresh=refresh, verify=True)
        b = pim.execute(prog, state, refresh=refresh)
        if not (states_equal(torch, a.state, b.state)
                and reads_equal(torch, a.reads, b.reads)):
            raise AssertionError(f"execute({name}, verify=True) differs")
    check_device(torch, run_device(torch, device, cfg, steps, verify=True),
                 run_device(torch, device, cfg, steps))
    start = device_start(torch, device, cfg)
    a, b = (pim.schedule_pipeline(start, steps[0][0], n_steps=3,
                                  verify=verify) for verify in (True, False))
    if not (states_equal(torch, a.state.banks, b.state.banks)
            and torch.equal(a.wall_ns.view(torch.int32),
                            b.wall_ns.view(torch.int32))
            and torch.equal(a.energy_nj.view(torch.int32),
                            b.energy_nj.view(torch.int32))
            and same_reads(a.reads, b.reads)):
        raise AssertionError("schedule_pipeline(verify=True) differs")

    text = LINT_FIXTURE.read_text()
    refused = {}
    small = pim.PimProgram.from_trace(text)
    wide = pim.PimProgram.from_trace(full_width_trace(text, cfg.num_rows,
                                                      cfg.words))
    for what, fn in (
            ("execute (16 x 2)", lambda: pim.execute(
                small, verify=True, device=device)),
            ("execute (512 x 2048)", lambda: pim.execute(
                wide, state, verify=True)),
            ("schedule (64 slots)", lambda: pim.schedule(
                start, [wide] + [None] * (cfg.n_slots - 1), verify=True))):
        try:
            fn()
        except lint.LintError as e:
            refused[what] = sorted({d.code for d in e.report.errors})
        else:
            raise AssertionError(f"{what}: pim104 passed the gate")
        if "PIM104" not in refused[what]:
            raise AssertionError(f"{what}: refused without PIM104")

    def cold_lint(prog):
        lint._lint_cache.clear()
        return lint.lint_program(prog)

    def cold_sem(prog):
        sem._SEM_CACHE.clear()
        return sem.fusion_report(prog)

    per_program = {}
    for name, prog, _ in subarray_programs():
        verdict = cold_sem(prog).verdict
        if verdict != sem.EQUIVALENT:
            raise AssertionError(f"fusion of {name}: {verdict}")
        per_program[name] = {"lint_ms": host_ms(lambda: cold_lint(prog)),
                             "sem_ms": host_ms(lambda: cold_sem(prog)),
                             "fusion": verdict}
    big = lint_100k_program()
    if "PIM103" not in cold_lint(big).codes():
        raise AssertionError("100k-op lint missed its PIM103")
    shifts = pim.ProgramBuilder(64, 4).shift(0, 1, +1)
    for _ in range(LINT_100K - 1):
        shifts.shift(1, 1, +1)
    shifts = shifts.build()
    shifts.columns
    rec = {"refused": refused, "per_program": per_program,
           "lint_100k_ms": host_ms(lambda: cold_lint(big)),
           "sem_100k_ms": host_ms(
               lambda: (sem._SEM_CACHE.clear(), sem.analyze(shifts)))}
    say("gates paper_device(32, subarrays=2): execute x"
        f"{len(per_program)}, 3 schedule() steps and a 3-step "
        "schedule_pipeline with verify=True == verify=False bit for bit; "
        "pim104 refused: " + "; ".join(f"{k} {v}" for k, v in
                                       refused.items()))
    say("gates host ms per program, cold (the card machine's CPU): "
        + "; ".join(f"{k} lint {v['lint_ms']:.2f} sem {v['sem_ms']:.2f}"
                    for k, v in per_program.items())
        + f"; {LINT_100K}-op lint_program {rec['lint_100k_ms']:.1f}, "
        f"{LINT_100K}-shift sem.analyze {rec['sem_100k_ms']:.1f} (the "
        "reference's tests hold both under 1,000 ms)")
    return rec


def same_reads(a, b) -> bool:
    """Two read layouts (numpy rows, nested per step and slot) equal."""
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_reads(a[k], b[k]) for k in a))
    return len(a) == len(b) and all(same_reads(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Phase 14: the multi-tenant serving front end at full width
# ---------------------------------------------------------------------------

def front_workloads(cfg, n_steps):
    """tenant -> per-step tenant-local layouts ([bank][subarray]): six
    tenants on the serving bench's stream (write row 0, a 40-hop shift
    chain, read back), two on ``ambit_xor_program`` after host writes of
    its operand rows, each slot's data private and seeded per step."""
    import numpy as np
    from repro_torch.core import pim
    R, W, S = cfg.num_rows, cfg.words, cfg.subarrays
    rng = np.random.default_rng(23)
    stream = (pim.ProgramBuilder(R, W).issue()
              .write_row(0, np.zeros(W, np.uint32))
              .shift_k(0, 1, FRONT_SHIFT))
    stream.read_row(1)
    stream = stream.build()
    xor = pim.concat([
        pim.ProgramBuilder(R, W).write_row(0, np.zeros(W, np.uint32))
        .write_row(1, np.zeros(W, np.uint32)).build(),
        pim.ambit_xor_program(R, W)])
    out = {}
    for t in range(FRONT_TENANTS):
        base = stream if t < FRONT_STREAM_TENANTS else xor
        kind = "stream" if t < FRONT_STREAM_TENANTS else "xor"
        out[f"{kind}{t}"] = [
            [[base.with_payloads(rng.integers(
                0, 2**32, (len(base.payloads), W), dtype=np.uint32))
              for _ in range(S)] for _ in range(FRONT_BANKS)]
            for _ in range(n_steps)]
    return out


def run_front(torch, device, cfg, workloads, admission_ms=None):
    """Admit every tenant on one front on ``device`` and serve them all:
    (front, results). ``admission_ms`` collects each ``submit``'s host ms
    (shape checks, the admission lint, placement)."""
    from repro_torch.serve import pim_front
    front = pim_front.PimServeFront(cfg, device=device)
    for tid, steps in workloads.items():
        t = time.perf_counter()
        front.submit(tid, steps, banks=FRONT_BANKS)
        if admission_ms is not None:
            admission_ms.append((time.perf_counter() - t) * 1e3)
    return front, front.run()


def front_tenant_reads(results):
    """tenant -> per-step per-slot reads, across every dispatch."""
    out: dict = {}
    for res in results:
        for tid in res.placements:
            got = res.tenant_reads(tid)
            out.setdefault(tid, []).extend(got if res.n_steps > 1
                                           else [got])
    return out


def front_equal(torch, a, res_a, b, res_b) -> None:
    """Two fronts that served the same tenants: slot states, reads, tenant
    reports (float64 sums of float32 slot meters, step walls) and
    ``reconcile()`` bit for bit."""
    import numpy as np
    if not states_equal(torch, a.device.banks, b.device.banks):
        raise AssertionError("front: slot states differ")
    if not same_reads(front_tenant_reads(res_a), front_tenant_reads(res_b)):
        raise AssertionError("front: tenant reads differ")
    for tid, ra in a.reports().items():
        rb = b.report(tid)
        if (ra.busy_ns, ra.energy_nj, ra.host_bytes, ra.n_steps) != (
                rb.busy_ns, rb.energy_nj, rb.host_bytes, rb.n_steps) \
                or not np.array_equal(ra.wall_ns, rb.wall_ns):
            raise AssertionError(f"front: report of {tid} differs")
    if a.reconcile() != b.reconcile():
        raise AssertionError("front: reconcile() differs")
    if [r.coalescing for r in res_a] != [r.coalescing for r in res_b]:
        raise AssertionError("front: coalescing differs")


def phase_front(torch, device, cfg) -> tuple[dict, dict]:
    """Phase 14: eight tenants of four banks on the full device, 16 steps
    each, served by ``PimServeFront`` on the card; a hostile and an
    over-subscribing tenant refused; every tenant held to its isolated
    ``schedule()`` on the card and the front to the CPU's, every step.
    Returns (record, launches of the measured run)."""
    import numpy as np
    from repro_torch.core import pim
    from repro_torch.core.pim import graphs, lint
    from repro_torch.kernels.rowops import ops
    from repro_torch.serve import pim_front
    sched = importlib.import_module("repro_torch.core.pim.schedule")
    workloads = front_workloads(cfg, FRONT_STEPS)

    # the measured run, cold: admission (lint), plans, 16 steps
    admission_ms: list = []
    ops.reset_launches()
    d0 = sched.SCHED_STATS["dispatches"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    front, results = run_front(torch, device, cfg, workloads, admission_ms)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = {**ops.LAUNCHES,
                **{f"bitwise_rows[{k}]": v for k, v in ops.ROWS_BY_OP.items()},
                **{f"shift_rows[{k}]": v
                   for k, v in ops.SHIFT_ROUTES.items()}}
    dispatches = sched.SCHED_STATS["dispatches"] - d0
    steps = sum(r.n_steps for r in results)
    if steps != FRONT_STEPS or front.active:
        raise AssertionError(f"front served {steps} steps")

    # the hostile tenant and the over-subscribing one, after the eight
    text = LINT_FIXTURE.read_text()
    hostile = pim.PimProgram.from_trace(full_width_trace(
        text, cfg.num_rows, cfg.words))
    live = pim_front.PimServeFront(cfg, device=device)
    for tid, steps_ in workloads.items():
        live.submit(tid, steps_, banks=FRONT_BANKS)
    refused = {}
    for tid, steps_, banks in (("hostile", (hostile, FRONT_STEPS), 1),
                               ("greedy", (workloads["stream0"][0], 1),
                                FRONT_BANKS)):
        try:
            live.submit(tid, steps_, banks=banks)
        except pim_front.AdmissionError as e:
            refused[tid] = (str(e)[:160], None if e.report is None
                            else sorted(set(e.report.codes())))
        else:
            raise AssertionError(f"tenant {tid} was admitted")
    if "PIM104" not in refused["hostile"][1] \
            or "over-subscribed" not in refused["greedy"][0]:
        raise AssertionError(f"front refusals: {refused}")

    # warm: the same tenants again, plans cached (the window's graph
    # captured), then a third time (replayed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    warm, warm_results = run_front(torch, device, cfg, workloads)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    front_equal(torch, front, results, warm, warm_results)
    d0 = sched.SCHED_STATS["dispatches"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep, rep_results = run_front(torch, device, cfg, workloads)
    torch.cuda.synchronize()
    replayed_s = time.perf_counter() - t
    replayed_dispatches = sched.SCHED_STATS["dispatches"] - d0
    front_equal(torch, front, results, rep, rep_results)
    # a fourth run, replayed, under the profiler: its kernels are read from
    # the profiler's records, since a replay moves no wrapper's count
    graphs._replay_log = []
    try:
        share = device_share(torch, lambda: run_front(torch, device, cfg,
                                                      workloads))
        replayed = graphs._replay_log
    finally:
        graphs._replay_log = None
    replayed_launches = dict(
        graph_kernels(share, replayed), graph_launches=share[
            "graph_launches"], kernel_launches=share["launch_calls"])
    if share["graph_launches"] != len(replayed) or not replayed:
        raise AssertionError(f"front: {share['graph_launches']} graph "
                             f"launches for {len(replayed)} replays")

    # the admission lint alone, cold, on each kind of tenant's layout
    lint_ms = {}
    for tid in ("stream0", f"xor{FRONT_STREAM_TENANTS}"):
        def cold(layout=workloads[tid][0]):
            lint._lint_cache.clear()
            return pim.lint_schedule(cfg.subdevice(FRONT_BANKS), layout)
        if not cold().ok:
            raise AssertionError(f"front: {tid}'s layout does not lint")
        lint_ms[tid] = host_ms(cold)

    # every tenant alone on a private 4-bank slice of the card
    reads = front_tenant_reads(results)
    for tid, steps_ in workloads.items():
        dev = pim.make_device(cfg.subdevice(FRONT_BANKS), device=device)
        iso_reads = []
        for layout in steps_:
            r = pim.schedule(dev, layout)
            dev = r.state
            iso_reads.append(r.reads)
        idx = torch.tensor(front.report(tid).slots, device=device)
        if not states_equal(torch, front.device.banks.map(lambda x: x[idx]),
                            dev.banks):
            raise AssertionError(f"front: {tid} differs from its isolated "
                                 "schedule()")
        if not same_reads(reads[tid], iso_reads):
            raise AssertionError(f"front: {tid}'s reads differ from its "
                                 "isolated schedule()")
        rep = front.report(tid)
        if (rep.busy_ns, rep.energy_nj) != (
                float(dev.slot_time_ns.cpu().numpy().astype(np.float64)
                      .sum()),
                float(dev.slot_energy_nj.cpu().numpy().astype(np.float64)
                      .sum())):
            raise AssertionError(f"front: {tid}'s meters differ from its "
                                 "isolated schedule()")
    rec_ = front.reconcile()
    for k in ("busy_ns", "energy_nj"):
        d, tn = rec_[f"device_{k}"], rec_[f"tenant_{k}"]
        if abs(d - tn) > 1e-9 * abs(d):
            raise AssertionError(f"front: reconcile {k} {d} != {tn}")

    # the card's front against the CPU's, every step
    t = time.perf_counter()
    cpu, cpu_results = run_front(torch, "cpu", cfg, workloads)
    cpu_s = time.perf_counter() - t
    front_equal(torch, front, results, cpu, cpu_results)

    walls = front.report("stream0").wall_ns     # every tenant's steps
    rec = {"tenants": FRONT_TENANTS, "banks_per_tenant": FRONT_BANKS,
           "steps": FRONT_STEPS, "cold_s": cold_s, "warm_s": warm_s,
           "steps_per_s_cold": FRONT_STEPS / cold_s,
           "steps_per_s_warm": FRONT_STEPS / warm_s,
           "replayed_s": replayed_s,
           "steps_per_s_replayed": FRONT_STEPS / replayed_s,
           "dispatches": dispatches, "dispatches_per_step":
               dispatches / FRONT_STEPS,
           "replayed_dispatches": replayed_dispatches,
           "replayed_launches": replayed_launches,
           "replayed_dispatches_per_step": replayed_dispatches / FRONT_STEPS,
           "coalescing": [r.coalescing for r in results],
           "groups": [r.n_groups for r in results],
           "p50_wall_ns": float(np.percentile(walls, 50)),
           "p99_wall_ns": float(np.percentile(walls, 99)),
           "admission_ms": admission_ms, "admission_lint_ms": lint_ms,
           "refused": refused,
           "reconcile": rec_, "cpu_s": cpu_s,
           "profile": share}
    say(f"front paper_device(32, subarrays=2): {FRONT_TENANTS} tenants x "
        f"{FRONT_BANKS} banks ({FRONT_STREAM_TENANTS} on the {FRONT_SHIFT}"
        f"-hop stream, {FRONT_TENANTS - FRONT_STREAM_TENANTS} on "
        f"ambit_xor), {FRONT_STEPS} steps: {dispatches} dispatches "
        f"({rec['dispatches_per_step']:.4f} per step), coalescing "
        + ", ".join(f"{c:.1f}" for c in rec["coalescing"])
        + f" ({', '.join(map(str, rec['groups']))} stream groups for "
        f"{cfg.n_slots} slots); {rec['steps_per_s_cold']:.2f} steps/s cold "
        f"(admission, plans, {FRONT_STEPS} steps: {cold_s * 1e3:.1f} ms), "
        f"{rec['steps_per_s_warm']:.2f} warm (the window's graph captured: "
        f"{warm_s * 1e3:.1f} ms), {rec['steps_per_s_replayed']:.2f} "
        f"replayed ({replayed_s * 1e3:.1f} ms, {replayed_dispatches} "
        f"dispatches, {rec['replayed_dispatches_per_step']:.4f} per step); "
        "step wall_ns (DDR3 model) "
        f"p50 {rec['p50_wall_ns']:.1f} p99 {rec['p99_wall_ns']:.1f}; host "
        "ms per admission (submit: shapes, lint once per distinct layout, "
        "placement): " + ", ".join(f"{v:.2f}" for v in admission_ms)
        + "; the admission lint alone, cold: " + ", ".join(
            f"{k} {v:.2f}" for k, v in lint_ms.items()))
    say("front refused at admission: " + "; ".join(
        f"{k}: {v[1] or v[0]}" for k, v in refused.items()))
    say(f"front == each tenant's isolated schedule() on the card for "
        f"{FRONT_TENANTS} tenants x {FRONT_STEPS} steps (reads, slot states, "
        "float32 slot meters, tenant busy/energy), reconcile "
        f"{rec_['tenant_busy_ns']:.1f} / {rec_['device_busy_ns']:.1f} ns; "
        f"front (card) == front (CPU) over all {FRONT_STEPS} steps (reads, "
        f"slot states, reports, reconcile; the CPU run {cpu_s:.1f} s)")
    say_share("front", share)
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 15: the paper's Tables 4 and 5
# ---------------------------------------------------------------------------

def phase_tables(torch, device) -> dict:
    """``shift_failure_rate`` on the card at the paper's variation levels
    (100,000 trials, normals from a seeded generator on the card) within
    the reference test's bounds of Table 4; the area model's Table 5."""
    from repro_torch.core import pim
    rates, ms = {}, {}
    for pct, (paper, bound) in TABLE4.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        rate = pim.shift_failure_rate(pct, TABLE4_TRIALS, generator=gen,
                                      device=device)
        if rate.device.type != torch.device(device).type:
            raise AssertionError("shift_failure_rate left the card")
        rates[pct] = float(rate)
        if abs(rates[pct] - paper) > bound:
            raise AssertionError(f"Table 4 at {pct}%: {rates[pct]} not "
                                 f"within {bound} of {paper}")
        ms[pct] = event_us(lambda: pim.shift_failure_rate(
            pct, TABLE4_TRIALS, generator=gen, device=device), torch,
            reps=5, warmup=1) / 1e3
    area = pim.AreaModel()
    rec = {"rates": rates, "ms": ms, "overhead_pct": area.overhead_pct,
           "overhead_with_ambit_pct": area.overhead_with_ambit_pct,
           "mim_plate_side_um": pim.mim_capacitor_plate_side_um()}
    say(f"table4 shift_failure_rate ({TABLE4_TRIALS} trials on the card): "
        + "; ".join(f"{p:g}%: {rates[p]:.5f} (paper {TABLE4[p][0]}, within "
                    f"{TABLE4[p][1]}), {ms[p]:.3f} ms" for p in TABLE4))
    say(f"table5 area: migration cells {area.overhead_pct:.3f}% of a "
        f"{area.rows_per_subarray}-row subarray, "
        f"{area.overhead_with_ambit_pct:.3f}% with Ambit; MIM plate side "
        f"{rec['mim_plate_side_um']:.4f} um; "
        + "; ".join(f"{n}: {v}" for n, _, v in pim.PAPER_TABLE5))
    return rec


# ---------------------------------------------------------------------------
# Phase 24: the sharded path, each process group in a process of its own
# ---------------------------------------------------------------------------

_PSUM_WORKER = r"""
import json, os, re, sys, time
import numpy as np, torch, torch.distributed as dist
backend, rank, world, port, out, dev = sys.argv[1:7]
rank, world = int(rank), int(world)
shape, reps, go = json.loads(sys.argv[7]), int(sys.argv[8]), sys.argv[9]
if torch.cuda.is_available():
    torch.cuda.set_device(rank % torch.cuda.device_count())
dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from repro_torch.optim.grad_compress import psum_compressed

f32 = np.float32
gs = [np.random.default_rng(1000 + r).standard_normal(shape, dtype=f32)
      * f32(1.0 + r) for r in range(world)]
rs = [np.random.default_rng(2000 + r).standard_normal(shape, dtype=f32)
      * f32(0.01) for r in range(world)]


def formula(residual):
    # the reference's arithmetic in numpy: (total, this rank's residual)
    scales, codes, res = [], [], None
    for r in range(world):
        gf = gs[r] + rs[r] if residual else gs[r]
        sc = np.maximum(np.abs(gf).max(), f32(1e-12)) / f32(127.0)
        # int8 codes, as the reference's: a code of -0.0 is 0
        c = np.clip(np.round(gf / sc), -127, 127).astype(np.int8).astype(f32)
        if r == rank:
            res = gf - c * sc
        scales.append(sc)
        codes.append(c)
    smax = max(scales)
    total = sum(np.round(c * (sc / smax)).astype(np.int32)
                for c, sc in zip(codes, scales))
    return total.astype(f32) * smax, res


def run(device):
    rec = {"device": device}
    for case in ("none", "residual"):
        g = torch.from_numpy(gs[rank]).to(device)
        r = torch.from_numpy(rs[rank]).to(device) if case == "residual" \
            else None
        total, new_r = psum_compressed(g, None, r)
        want_t, want_r = formula(case == "residual")
        got_t, got_r = total.cpu().numpy(), new_r.cpu().numpy()
        rec[case] = bool(np.array_equal(got_t.view(np.int32),
                                        want_t.view(np.int32))
                         and np.array_equal(got_r.view(np.int32),
                                            want_r.view(np.int32)))
    g = torch.from_numpy(gs[rank]).to(device)
    while not os.path.exists(go):       # timed alone: the parent says when
        time.sleep(0.05)
    times = []
    for i in range(reps + 3):
        dist.barrier()
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        psum_compressed(g)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e6)
    rec["us"] = sorted(times[3:])[len(times[3:]) // 2]
    return rec


# gloo's refusals of CUDA tensors (a build without CUDA, or no CUDA
# backend on the group); any other error is the port's and is raised
REFUSAL = re.compile(r"No backend type associated with device type cuda"
                     r"|unsupported (gloo )?device|hasCUDA\(\)")
try:
    rec = run(dev)
except RuntimeError as e:
    if dev != "cuda" or backend != "gloo" or not REFUSAL.search(str(e)):
        raise
    rec = run("cpu")
    rec["refused"] = str(e).splitlines()[0][:200]
with open(out, "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
"""

_RESTORE_WORKER = r"""
import json, os, sys, time
import numpy as np, torch
from repro_torch import configs
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import train_state
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.train.step import opt_layout, trainable_params
d, step, out, go = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[6]
cfg = configs.get_config(sys.argv[4], **json.loads(sys.argv[5]))
mesh = make_host_mesh()
model = init_params(cfg, 11, device="cuda")
p_shard, _ = sharding.param_shardings(cfg, mesh, model)
sharding.distribute_model(model, mesh, p_shard)
layout = opt_layout(model)
o_shard = sharding.opt_shardings(mesh, layout, p_shard)
ps = trainable_params(model)
skeleton = train_state(model, {"mu": ps, "nu": ps, "step": 0})
zero = lambda tree: {k: zero(v) if isinstance(v, dict) else 0
                     for k, v in tree.items()}
skeleton["opt"] = {"mu": zero(layout["mu"]), "nu": zero(layout["nu"]),
                   "step": 0}
while not os.path.exists(go):           # timed alone: the parent says when
    time.sleep(0.05)
torch.cuda.synchronize()
t = time.perf_counter()
tree, manifest = checkpoint.restore(d, step, skeleton,
                                    shardings={"opt": o_shard})
torch.cuda.synchronize()
ms = (time.perf_counter() - t) * 1e3
with np.load(f"{d}/step_{step:08d}/host0.npz") as z:
    stored = {k.replace("__", "/"): z[k] for k in z.files}
equal, dtensors = 0, 0
for k, v in checkpoint._flatten(tree).items():
    ts = v.tensors if isinstance(v, checkpoint.Stacked) else [v]
    dtensors += sum(hasattr(t, "full_tensor") for t in ts)
    full = [t.full_tensor() if hasattr(t, "full_tensor") else t for t in ts]
    got = torch.stack(full) if isinstance(v, checkpoint.Stacked) else full[0]
    got = got.detach().cpu()
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16).numpy().view(np.uint16)
    else:
        got = got.numpy()
    equal += int(got.dtype == stored[k].dtype
                 and np.array_equal(got, stored[k]))
with open(out, "w") as f:
    json.dump({"ms": ms, "arrays": len(stored), "equal": equal,
               "dtensors": dtensors, "mesh": list(mesh.shape),
               "layers": cfg.n_layers}, f)
"""

_DRYRUN_WORKER = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
arch, shape_name, mesh, over, out = sys.argv[1:6]
batch, seq = json.loads(sys.argv[6])
shape = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                            global_batch=batch)
rec = dryrun.run_cell(arch, shape_name, mesh, json.loads(over), tag="chip",
                      out_dir=out, shape=shape)
print(rec["status"])
"""


def _spawn(argv, env_extra=None, log: Path | None = None):
    """A process of the repository's ``src``; its output to ``log`` (for
    one that runs beside the whole script), else to pipes."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    if log is not None:
        with open(log, "w") as f:
            p = subprocess.Popen(argv, cwd=str(ROOT), env=env, stdout=f,
                                 stderr=subprocess.STDOUT, text=True)
        p.log = log
        return p
    return subprocess.Popen(argv, cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(procs, what: str):
    """Wait for every process; one that fails or outlives
    SHARDED_TIMEOUT_S fails the run, the others killed."""
    deadline = time.perf_counter() + SHARDED_TIMEOUT_S
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            if p.returncode != 0:
                if err is None:
                    err = Path(p.log).read_text()
                raise AssertionError(f"{what}: a process failed: "
                                     f"{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _psum(backend: str, world: int, device: str, out: Path):
    """psum_compressed's ranks started: (processes, their result files,
    the file whose creation starts their timed calls)."""
    port = _free_port()
    files = [out / f"psum_{backend}_{r}.json" for r in range(world)]
    go = out / f"go_psum_{backend}"
    return [_spawn([sys.executable, "-c", _PSUM_WORKER, backend, str(r),
                    str(world), str(port), str(f), device,
                    json.dumps(PSUM_SHAPE), str(PSUM_REPS), str(go)],
                   {"OMP_NUM_THREADS": "1"})
            for r, f in enumerate(files)], files, go


def start_dryrun() -> list:
    """Phase 24's dry-run cells, started at the beginning of the run (fake
    process groups on the host's CPU, beside the kernels' build; they need
    nothing of the card): the production cells and phase 20's cell on a
    1 x 1 mesh, a process each, stopped at exit if still running."""
    import atexit
    out = ROOT / "chiprun_out" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    for stale in out.glob("*"):
        stale.unlink()
    env = {"OMP_NUM_THREADS": "1"}
    dry = [_spawn([sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", "single",
                   "--tag", "chip", "--out", str(out)], env,
                  out / f"{arch}__{shape}.log")
           for arch, shape in DRYRUN_CELLS]
    train = {"quant": LM_ARCH[1]["quant"],
             "quant_mode": LM_ARCH[1]["quant_mode"]}
    dry.append(_spawn([sys.executable, "-c", _DRYRUN_WORKER, LM_ARCH[0],
                       "train_4k", "1x1", json.dumps(train), str(out),
                       json.dumps([TRAIN_BATCH, TRAIN_SEQ])], env,
                      out / f"{LM_ARCH[0]}__train_4k__1x1.log"))

    def stop():
        for p in dry:
            if p.poll() is None:
                p.kill()
                p.communicate()
    atexit.register(stop)
    return dry


def run_sharded(torch, card: str, ckpt_dir: str, train_step_ms: float,
                dry: list):
    """Phase 24: the sharded path, every process group in processes of its
    own (this process never holds one): the dry-run's cells (``dry``,
    started by ``start_dryrun``), read here; psum_compressed over NCCL
    with one rank per card and over gloo with PSUM_GLOO_RANKS ranks on the
    card's tensors, each rank's result and residual bit for bit against
    numpy's computation of the reference's formula; phase 22's checkpoint
    (RESUME_LAYERS layers) restored onto ``make_host_mesh()`` with
    ``param_shardings``' placements and gathered bit for bit. Their
    processes start together; the timed parts wait for the dry-run and
    then run one after the other (a go file each). Returns the record."""
    from repro_torch.launch import roofline
    out = ROOT / "chiprun_out" / "dryrun_torch"
    rec = {"card": card}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rcfg = {"quant": LM_ARCH[1]["quant"],
            "quant_mode": LM_ARCH[1]["quant_mode"],
            "n_layers": RESUME_LAYERS}
    rfile, rgo = out / "restore.json", out / "go_restore"
    n = torch.cuda.device_count()
    psums = {backend: _psum(backend, world, "cuda", out)
             for backend, world in (("nccl", n),
                                    ("gloo", PSUM_GLOO_RANKS))}
    restore = [_spawn([sys.executable, "-c", _RESTORE_WORKER, ckpt_dir,
                       str(RESUME_STEPS), str(rfile), LM_ARCH[0],
                       json.dumps(rcfg), str(rgo)])]
    procs = restore + [p for ps, _, _ in psums.values() for p in ps]
    try:
        _wait(dry, "dryrun")
        rec["dryrun_wait_s"] = time.perf_counter() - t0
        for backend, (ps, files, go) in psums.items():
            world = len(ps)
            go.touch()
            _wait(ps, f"sharded psum_compressed {backend}")
            ranks = [json.loads(f.read_text()) for f in files]
            ok = all(r["none"] and r["residual"] for r in ranks)
            where = ranks[0]["device"]
            us = statistics.median(r["us"] for r in ranks)
            rec[f"psum_{backend}"] = {"ranks": ranks, "bit_equal": ok,
                                      "us": us}
            say(f"sharded psum_compressed {backend}: {world} rank(s) on "
                f"{where} tensors"
                + (f" (gloo refused CUDA tensors: {ranks[0]['refused']})"
                   if "refused" in ranks[0] else "")
                + f", one {PSUM_SHAPE} float32 gradient each (Qwen3-4B's "
                "w1, from seeds): every rank's total and residual == "
                "numpy's reference formula bit for bit, with and without "
                f"a residual: {ok}; {us:.1f} us per call (host clock, "
                f"median of {PSUM_REPS} per rank) on {card}")
            if not ok:
                raise AssertionError(f"psum_compressed {backend}: {ranks}")

        rgo.touch()
        _wait(restore, "sharded restore")
        r = rec["restore"] = json.loads(rfile.read_text())
        ok = r["equal"] == r["arrays"] and r["dtensors"] > 0
        say(f"sharded restore {LM_ARCH[0]} pim_w4 ({r['layers']} layers, "
            f"phase 22's checkpoint) onto make_host_mesh() {r['mesh']} with "
            f"param_shardings' placements: {r['equal']} of {r['arrays']} "
            f"arrays gathered bit for bit ({r['dtensors']} DTensors); "
            f"restore {r['ms']:.0f} ms (host clock, the card synchronized) "
            f"on {card}")
        if not ok:
            raise AssertionError(f"sharded restore: {r}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rec["wall_s"] = time.perf_counter() - t0
    consts = (f"constants {roofline.PEAK_FLOPS:.4g} FLOP/s bf16, "
              f"{roofline.HBM_BW:.4g} B/s HBM, {roofline.LINK_BW:.4g} B/s "
              f"link, for {card}")
    cells = rec["dryrun"] = {}
    for arch, shape, mesh in [(a, s, "single") for a, s in DRYRUN_CELLS] \
            + [(LM_ARCH[0], "train_4k", "1x1")]:
        c = json.loads((out / f"{arch}__{shape}__{mesh}__chip.json")
                       .read_text())
        cells[f"{arch}/{shape}/{mesh}"] = c
        if c["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: "
                                 f"{c.get('error')}")
        views = [v for v in c["redistributed_views"]
                 if not v["path"].startswith("adamw/")]
        adamw = [v for v in c["redistributed_views"] if v not in views]
        kinds = ", ".join([f"{v['path']} {v['op']} x{v['count']}"
                           for v in views] + ([
            f"adamw grads reduce x{sum(v['count'] for v in adamw)} "
            f"({len(adamw)} leaves)"] if adamw else []))
        say(f"dryrun {arch} {shape} --mesh {mesh} ({c['devices']} ranks of "
            f"a fake process group): status ok, trace {c['trace_s']} s; "
            f"per device {c['flops_per_device']:.4g} flops, "
            f"{c['hbm_bytes_per_device']:.4g} HBM bytes (unfused), "
            f"{c['link_bytes_per_device']:.4g} link bytes; t_compute "
            f"{c['t_compute'] * 1e3:.2f} ms, t_memory "
            f"{c['t_memory'] * 1e3:.2f} ms, t_collective "
            f"{c['t_collective'] * 1e3:.2f} ms, bottleneck "
            f"{c['bottleneck']}; peak live "
            f"{c['memory_analysis']['peak_live_bytes'] / 1e9:.2f} GB; "
            f"explicit redistributions: {kinds or 'none'}; {consts}")
    c = cells[f"{LM_ARCH[0]}/train_4k/1x1"]
    say(f"dryrun {cfg_name(lm_config())} train {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"on a 1 x 1 mesh: t_compute {c['t_compute'] * 1e3:.1f} ms, "
        f"t_memory {c['t_memory'] * 1e3:.1f} ms (reported, not held) beside "
        f"phase 20's measured step {train_step_ms:.1f} ms (median, CUDA "
        f"events) on {card}; {consts}")
    say(f"sharded: {rec['wall_s']:.1f} s for the phase")
    return rec


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core import pim
    from repro_torch.kernels import _build
    from repro_torch.kernels.rowops import ops

    run_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # phase 24's dry-run cells need only the host's CPU: they run beside
    # the build
    dry = start_dryrun()

    # each phase's seconds, printed before the kernel table
    marks = record["phase_marks_s"] = {}
    last = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - last[0]
        last[0] = now

    # 1. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    record["ptxas"] = {name: _build.BUILD_LOG.get(name, "")
                       for name in SOURCES}
    for name, src in SOURCES.items():
        say(f"build {Path(src).name}: {build_s:.2f} s for all "
            f"{len(SOURCES)} in parallel (nvcc "
            f"{_build.BUILD_SECONDS.get(name, 0.0):.2f} s)")

    mark("1 build")
    # 2. the add latency; kernels against their plain versions
    fadd = record["fadd"] = fadd_latency(torch, device)
    kernel_rows = phase_kernels(torch, device, fadd)
    record["kernels"] = kernel_rows
    row_rows = record["row_kernels"] = phase_row_kernels(torch, device)

    # 3-4. the main path, with the launch counts reset just before it and
    # read just after it
    cfg = pim.paper_device(32, subarrays=2)
    steps = device_steps(cfg)
    ops.reset_launches()
    with FoldShapes() as folds:
        sub_results = run_subarray(torch, device)
        dev_results = run_device(torch, device, cfg, steps)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    by_op = dict(ops.ROWS_BY_OP)
    routes = dict(ops.SHIFT_ROUTES)

    check_subarray(torch, device, sub_results)
    m1 = sub_results["shift_workload(1)"].state.meter
    t_exec = {}
    state = subarray_state(torch, device)
    for name, prog, refresh in subarray_programs():
        times = []
        for _ in range(5):        # eager, capture, then three replays
            torch.cuda.synchronize()
            t = time.perf_counter()
            pim.execute(prog, state, refresh=refresh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        t_exec[name] = statistics.median(times[2:])
    record["execute_ms"] = t_exec
    say("subarray 512x2048: execute == eager ISA (card) == execute (CPU) "
        f"for {len(t_exec)} programs; shift x1 meter {float(m1.time_ns):.1f}"
        f" ns / {float(m1.total_energy_nj):.2f} nJ (DDR3 model output; "
        "paper 208.7 ns / 31.32 nJ); "
        "ms per warm execute on the card (replayed, median of 3): "
        + ", ".join(f"{k} {v:.2f}" for k, v in t_exec.items()))

    cpu_results = run_device(torch, "cpu", cfg, steps)
    check_device(torch, dev_results, cpu_results)
    t_steps = []
    for _ in range(2):
        dev = device_start(torch, device, cfg)
        for programs, flags in steps:
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev = pim.schedule(dev, programs, **flags).state
            torch.cuda.synchronize()
            t_steps.append((time.perf_counter() - t) * 1e3)
    t_steps = t_steps[len(steps):]            # the second, warm pass
    record["schedule_ms"] = t_steps
    record["device_steps"] = [
        {"wall_ns": float(r.wall_ns), "energy_nj": float(r.energy_nj),
         "copy_ns": r.copy_ns, "copy_queue_ns": r.copy_queue_ns,
         "bus_ns": r.bus_ns, "host_overlap_ns": r.host_overlap_ns}
        for r in dev_results]
    mib = dev_results[0].state.banks.bits.numel() * 4 / 2**20
    say(f"device paper_device(32, subarrays=2): {cfg.n_slots} slots, "
        f"{mib:.0f} MiB of rows on the card; 3 schedule() steps == CPU run "
        "(states, reads, wall_ns, energy_nj, copy and bus stats); "
        "ms per warm schedule() step on the card (replayed): "
        + ", ".join(f"{t:.2f}" for t in t_steps))

    # each PIM entry's warm call one CUDA-graph replay
    record["graphs"] = phase_graphs(torch, device, cfg, steps)

    mark("2-4 kernels, subarray, device, graphs")
    # 4b. refresh cycles past half the interval, card against CPU
    record["refresh"] = phase_refresh(torch, device)

    # where the time goes: one warm execute and one warm schedule step
    start = device_start(torch, device, cfg)
    prog1000 = pim.shift_workload_program(1000)
    prog_xor = pim.ambit_xor_program(512, 2048)
    for _ in range(2):                  # eager, then capture
        pim.execute(prog1000, state)
        pim.schedule(start, steps[0][0], **steps[0][1])
    shares = {
        "execute(shift_workload(1000))": device_share(
            torch, lambda: pim.execute(prog1000, state)),
        "schedule() step 1": device_share(
            torch, lambda: pim.schedule(start, steps[0][0], **steps[0][1])),
    }
    record["profile"] = shares
    for name, sh in shares.items():
        say_share(name, sh)

    mark("4b refresh")
    # 5. launches over the main path: each fused segment and residual
    # SHIFT/TRA/NOT row one launch of a row entry, the old out-of-place
    # entries not at all
    say("kernels " + json.dumps({
        **launches, **{f"bitwise_rows[{k}]": v for k, v in by_op.items()},
        **{f"shift_rows[{k}]": v for k, v in routes.items()}}))
    main_path = {"shift_rows": launches["shift_rows"],
                 "bitwise_rows[maj]": by_op["maj"],
                 "bitwise_rows[not]": by_op["not"],
                 "meter_fold": launches["meter_fold"]}
    missing = [k for k, v in main_path.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if launches["shift_cols"] or launches["bitwise"]:
        raise AssertionError("the main path launched the old out-of-place "
                             "entries")
    counts = record["launch_counts"] = {
        "execute(shift_workload(1000))": launch_count(
            torch, "execute(shift_workload(1000))",
            lambda: pim.execute(prog1000, state)),
        "execute(ambit_xor)": launch_count(
            torch, "execute(ambit_xor)",
            lambda: pim.execute(prog_xor, state)),
        "schedule() step 1": launch_count(
            torch, "schedule() step 1",
            lambda: pim.schedule(start, steps[0][0], **steps[0][1])),
    }

    mark("5 launches")
    # 6. the LM kernels against their plain versions
    t = time.perf_counter()
    lm_rows = phase_lm_kernels(torch, device)
    record["lm_kernels"] = lm_rows
    say(f"phase 6 rows: {time.perf_counter() - t:.1f} s")
    record["pim_routes"] = pim_routes_timed(torch, device)
    record["tc_ptxas"] = tc_ptxas()
    say("ptxas pim_matmul[tc]: " + (", ".join(
        f"{k}: {v['registers']} registers, {v['static_smem_bytes']} bytes "
        f"static smem, {v['spill_bytes']} spill bytes"
        for k, v in record["tc_ptxas"].items() if k.startswith("bits"))
        or "not measured (library not built in this process)")
        + f"; {record['tc_ptxas']['dynamic_smem_bytes']} bytes dynamic "
        "smem per block")
    record["flash_routes"] = flash_routes_timed(torch, device)
    record["flash_ptxas"] = flash_ptxas()
    say("ptxas flash_attn[split_kv]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in record["flash_ptxas"].items())
        or "not measured (library not built in this process)"))
    record["flash_tc_ptxas"] = flash_tc_ptxas()
    say("ptxas flash_attn[tensor_core]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in record["flash_tc_ptxas"].items()
        if k != "dynamic_smem_bytes")
        or "not measured (library not built in this process)")
        + "; dynamic smem per block " + ", ".join(
            f"{k} {v} bytes" for k, v in
            record["flash_tc_ptxas"]["dynamic_smem_bytes"].items()))
    spilled = {k: record["flash_tc_ptxas"][k]["spill_bytes"]
               for k in FLASH_TC_NO_SPILL if k in record["flash_tc_ptxas"]}
    if any(spilled.values()):
        raise AssertionError(f"flash tensor-core instances spill: {spilled}")
    record["tc_sass"] = tc_sass()
    say("sass pim_matmul[tc]: " + ", ".join(
        f"{k}: {v} HMMA" for k, v in sorted(record["tc_sass"].items())))
    if sorted(record["tc_sass"]) != ["bits0", "bits4", "bits8"] \
            or min(record["tc_sass"].values()) == 0:
        raise AssertionError(f"tensor-core kernel without HMMA: "
                             f"{record['tc_sass']}")
    swap_instances = [f"bits{b} mf{f}" for b in (0, 4, 8) for f in (1, 2)]
    record["swap_ptxas"] = swap_ptxas()
    say("ptxas pim_matmul[swap_ab]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['static_smem_bytes']} bytes "
        f"static smem, {v['spill_bytes']} spill bytes"
        for k, v in sorted(record["swap_ptxas"].items()))
        or "not measured (library not built in this process)"))
    spilled = {k: v["spill_bytes"] for k, v in record["swap_ptxas"].items()
               if v["spill_bytes"]}
    if spilled:
        raise AssertionError(f"swapped-operand instances spill: {spilled}")
    record["swap_sass"] = swap_sass()
    (m, k, n), codes = PIM_SHAPES[0], PIM_SHAPES[0][1] * PIM_SHAPES[0][2]
    for key, v in record["swap_sass"].items():
        v["integer_floor_ms"] = swap_integer_floor_ms(v["per_code"], codes)
    say("sass pim_matmul[swap_ab], per weight code: " + "; ".join(
        f"{key}: {v['HMMA']} HMMA, " + ", ".join(
            f"{c:.2f} {pipe}" for pipe, c in v["per_code"].items())
        + f", integer floor {v['integer_floor_ms'] * 1e3:.2f} us at "
        f"({m},{k})@({k},{n})"
        for key, v in sorted(record["swap_sass"].items())))
    if sorted(record["swap_sass"]) != sorted(swap_instances) \
            or min(v["HMMA"] for v in record["swap_sass"].values()) == 0:
        raise AssertionError(f"swapped-operand kernel without HMMA: "
                             f"{record['swap_sass']}")
    record["flash_tc_sass"] = flash_tc_sass()
    say("sass flash_attn[tensor_core]: " + ", ".join(
        f"{k}: {v} HMMA" for k, v in sorted(record["flash_tc_sass"].items())))
    if not set(FLASH_TC_NO_SPILL) <= set(record["flash_tc_sass"]) \
            or min(record["flash_tc_sass"].values()) == 0:
        raise AssertionError(f"flash tensor-core kernel without HMMA: "
                             f"{record['flash_tc_sass']}")

    mark("6 LM kernels")
    # 7. the serving path, one CUDA-graph replay per greedy_generate call,
    # with the launch counts reset just before a replayed call and read
    # just after it (inside run_serve)
    record["serve"], lm_launches, lm_routes, flash_routes = run_serve(
        torch, device, notes=True)
    say("kernels serve " + json.dumps(lm_launches) + " routes "
        + json.dumps(lm_routes) + " flash routes "
        + json.dumps(flash_routes))

    mark("7 serve")
    # 8. card against CPU at full width, 2 layers
    record["lm_parity"] = run_lm_parity(torch, device)

    mark("8 lm parity")
    # 9. ripple_add against its plain version; fused against composed
    ripple_rows, record["fused_vs_composed"] = phase_ripple(torch, device)
    record["ripple"] = ripple_rows
    record["ripple_sass"] = ripple_sass()
    say("kernels kernel_bench " + json.dumps(
        record["fused_vs_composed"]["launches"]))
    say("sass ripple_add[w32], per word: " + (
        "not measured (no cuobjdump)" if record["ripple_sass"] is None
        else ", ".join(f"{v:g} {k}"
                       for k, v in record["ripple_sass"].items())))

    mark("9 ripple")
    # 10. the bit-plane path, with the launch counts reset just before it
    # and read just after it
    ops.reset_launches()
    with FoldShapes() as bp_folds:
        bp_values, record["bitplane"] = run_bitplane(torch, device,
                                                     check_oracles=True)
    torch.cuda.synchronize()
    bp_launches = {**ops.LAUNCHES,
                   **{f"bitwise_rows[{k}]": v
                      for k, v in ops.ROWS_BY_OP.items()},
                   **{f"shift_rows[{k}]": v
                      for k, v in ops.SHIFT_ROUTES.items()}}
    check = record["bitplane"].pop("check_launches")
    bp_launches["ripple_add"] -= check
    say("kernels bitplane " + json.dumps(bp_launches)
        + f" (ripple_add {check} more in the check against add_ripple)")
    # The VM records PIM commands, as the reference's does, and never calls
    # ripple_add. Its shifts are chains of fewer than SHIFT_FUSE_MIN (32)
    # columns, which the compiler leaves to the residual interpreter, as
    # the reference's does: each hop is one shift_rows launch.
    missing = [k for k in ("bitwise_rows[maj]", "bitwise_rows[not]",
                           "shift_rows", "meter_fold")
               if bp_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bit-plane "
                             f"path: {missing}")
    say_bitplane(record["bitplane"])
    record["bitplane"]["profile"] = profile_vm(torch, device)
    say_share("bitplane mul_shift_add", record["bitplane"]["profile"])
    for name in VM_ROUTINES:
        counts[name] = launch_count(torch, name, vm_runs(torch, device, name))
    say_launches(counts)
    over = {k: (v["device_ops"], BEFORE_OPS[k]) for k, v in counts.items()
            if k in VM_ROUTINES and k in BEFORE_OPS
            and 2 * v["device_ops"] > BEFORE_OPS[k]}
    if over:
        raise AssertionError(f"launches not halved: {over}")

    mark("10 bitplane")
    # 11. the same path on the CPU: reads, counts and meters identical
    t = time.perf_counter()
    cpu_values, _ = run_bitplane(torch, "cpu")
    cpu_s = time.perf_counter() - t
    if not bitplane_equal(bp_values, cpu_values):
        raise AssertionError("bit-plane path: card and CPU differ")
    say(f"bitplane parity: card == CPU for {len(bp_values)} runs (reads, "
        f"counts, float32 meters); CPU run {cpu_s:.1f} s")

    mark("11 bitplane parity")
    # 12. meter_fold over table sizes, up to the largest the paths folded
    largest = max((f.largest for f in (folds, bp_folds)),
                  key=lambda t: t[0].shape[0])
    say(f"fold tables on the card: {folds.calls} on the PIM path, largest "
        f"{folds.largest[0].shape[0]} rows; {bp_folds.calls} on the "
        f"bit-plane path, largest {bp_folds.largest[0].shape[0]} rows")
    record["fold_sweep"] = phase_fold_sweep(torch, device, fadd, largest)

    mark("12 fold")
    # 13. the verify=True gates at full width
    record["gates"] = phase_gates(torch, device, cfg, steps)

    mark("13 gates")
    # 14. the serving front end at full width, with the launch counts reset
    # just before its measured run and read just after it
    record["front"], front_launches = phase_front(torch, device, cfg)
    say("kernels front " + json.dumps(front_launches) + "; a replayed run "
        "(kernel records in its profiler window) " + json.dumps(
            record["front"]["replayed_launches"]))
    missing = [k for k in ("shift_rows", "bitwise_rows[maj]",
                           "bitwise_rows[not]", "meter_fold")
               if front_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the front's "
                             f"path: {missing}")
    if front_launches["shift_cols"] or front_launches["bitwise"]:
        raise AssertionError("the front launched the old out-of-place "
                             "entries")
    record["front"]["launches"] = front_launches

    # the PIM path's graphs dropped before the LM phases: their memory back
    from repro_torch.core.pim import graphs as pim_graphs
    torch.cuda.synchronize()
    held = list(pim_graphs._entries.values())
    before = torch.cuda.memory_allocated()
    pinned = sum(g.nbytes for g in held)
    del held
    pim_graphs._entries.clear()
    pim_graphs._seen.clear()
    torch.cuda.synchronize()
    record["pim_graphs_freed"] = dict(
        pinned_bytes=pinned,
        freed_bytes=before - torch.cuda.memory_allocated())
    say(f"pim graphs dropped: {pinned} bytes of static inputs and outputs "
        f"pinned, {record['pim_graphs_freed']['freed_bytes']} bytes freed")

    mark("14 front")
    # 15. Tables 4 and 5
    record["tables"] = phase_tables(torch, device)

    mark("15 tables")
    # 16. the MLA and frontend families' pim_w4 serving paths at their
    # published widths, with the launch counts reset just before a
    # replayed call and read just after it
    families = record["families"] = {}
    family_counts = {}
    for label, arch, overrides, depth in FAMILIES:
        cut = {} if depth is None else {"n_layers": depth}
        families[label], f_launches, f_routes, f_flash = run_serve(
            torch, device, family_config(arch, overrides, **cut), label,
            eager_reps=1)
        family_counts[label] = (f_launches, f_routes, f_flash)
        say(f"kernels {label} " + json.dumps(f_launches) + " routes "
            + json.dumps(f_routes) + " flash routes " + json.dumps(f_flash))
    # the slice's main path: both routes of each LM kernel ran
    ds_launches, ds_routes, ds_flash = family_counts["serve-deepseek"]
    check_routes("deepseek", ds_routes, ds_flash)

    mark("16 families")
    # 17. each family's card against the CPU at full width, 2 layers
    record["families_parity"] = {
        label: run_lm_parity(torch, device, family_config(
            arch, overrides, n_layers=PARITY_LAYERS))
        for label, arch, overrides in FAMILIES_PARITY}

    mark("17 families parity")
    # 18. the recurrent families at their published widths and full
    # depths, with the launch counts reset just before a replayed call and
    # read just after it (inside run_serve); decode against prefill
    # measured here and held at the cut depth in phase 19
    recurrent = record["recurrent"] = {}
    recurrent_counts = {}
    for label, arch, overrides, _ in RECURRENT:
        cfg = family_config(arch, overrides)
        recurrent[label], r_launches, r_routes, r_flash = run_serve(
            torch, device, cfg, label, dvp_bound=None, eager_reps=1)
        recurrent_counts[label] = (r_launches, r_routes, r_flash)
        say(f"kernels {label} " + json.dumps(r_launches) + " routes "
            + json.dumps(r_routes) + " flash routes " + json.dumps(r_flash)
            + ("" if any(r_launches.values()) else
               " (the path bypasses both LM kernels, as the reference's "
               "does: its Mamba block computes every product with plain "
               "matmuls and it has no attention)"))

    mark("18 recurrent")
    # 19. each recurrent family's card against the CPU at full width and
    # the cut depth, and decode against prefill held on both
    record["recurrent_parity"] = {
        label: run_lm_parity(torch, device, family_config(
            arch, overrides, n_layers=depth), dvp_bound=RECURRENT_DECODE_REL)
        for label, arch, overrides, depth in RECURRENT}

    mark("19 recurrent parity")
    # 20. training's gradient path: Qwen3-4B pim_w4 at full width and
    # depth takes AdamW steps, the launch counts reset just before each
    # step and read just after it (inside run_train), then serves
    record["train"], train_shapes = run_train(torch, device)

    mark("20 train")
    # 21. one training pass's loss and gradients, card against CPU, at
    # full width with 2 layers
    record["train_parity"] = run_train_parity(torch, device)

    mark("21 train parity")
    # 22. training's CLI at full width and depth, the launch counts reset
    # just before it and read just after it; the loop's resume, bit for
    # bit, at full width with RESUME_LAYERS layers
    import shutil
    import tempfile
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        record["train_loop"] = run_train_loop(torch, device, keep)

        # 23. the examples on the card, the launch counts reset just
        # before each and read just after it
        record["examples"] = run_examples(torch)

        # 24. the sharded path, each process group in processes of its
        # own: psum_compressed, the elastic restore of phase 22's
        # checkpoint, the dry-run's production cells
        step_ms = statistics.median(h["ms"]
                                    for h in record["train"]["steps"][1:])
        record["sharded"] = run_sharded(torch, card, keep, step_ms, dry)
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    mark("22-24 train loop, examples, sharded")
    # 25. the dense configurations and Qwen3-4B's other quantizations at
    # published widths, with the launch counts reset just before a replayed
    # call and read just after it (inside run_serve)
    phase_s = record["phase_s"] = {}
    t = time.perf_counter()
    dense = record["dense"] = run_dense(torch, device)
    phase_s["25 dense"] = time.perf_counter() - t

    # 26. each of them card against CPU at full width, 2 layers
    t = time.perf_counter()
    record["dense_parity"] = {
        label: run_lm_parity(torch, device, family_config(
            arch, overrides, n_layers=PARITY_LAYERS))
        for label, arch, overrides, _ in DENSE}
    phase_s["26 dense parity"] = time.perf_counter() - t

    # 27. starcoder2-7b past its window, the launch counts reset just
    # before a replayed call and read just after it (inside run_serve); its
    # 2-layer model's kernels against their plain versions on the card
    t = time.perf_counter()
    ring = record["ring"] = run_ring(torch, device)
    phase_s["27 ring"] = time.perf_counter() - t
    say("phases 25-27: " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in phase_s.items()))

    # 28. each configuration's own default at published width and full
    # depth, the launch counts reset just before a replayed call and read
    # just after it (inside run_serve), and through the serving CLI
    new_s = record["phase_s_28_30"] = {}
    t = time.perf_counter()
    defaults = record["defaults"] = run_defaults(torch, device)
    new_s["28 defaults"] = time.perf_counter() - t

    # 29. the five that had never run bf16 at width, card against CPU
    t = time.perf_counter()
    record["defaults_parity"] = {
        arch: run_lm_parity(torch, device, family_config(
            arch, {}, n_layers=depth), label="lm parity default")
        for arch, depth in DEFAULTS_PARITY.items()}
    new_s["29 defaults parity"] = time.perf_counter() - t

    # 30. Qwen3-4B at 32,768 positions, the launch counts reset just before
    # a replayed call and read just after it (inside run_serve); its
    # 2-layer model's kernels against their plain versions on the card
    t = time.perf_counter()
    long_rec = record["long"] = run_long(torch, device)
    new_s["30 long"] = time.perf_counter() - t
    say("phases 28-30: " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in new_s.items())
        + f"; {sum(new_s.values()):.1f} s in all")

    mark("25-30")
    # the row entries at the full device's 64 slots, in place (as most of
    # the main path's segments run); every shape is in chip_smoke.json
    table = []
    for name in ("shift_rows", "bitwise_rows[maj]", "bitwise_rows[not]"):
        r = row_rows[f"{name} (64, {ROW_SHAPE[0]}, {ROW_SHAPE[1]}) in place"]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES["rowops"],
            "replaces": REPLACES[name.split("[")[0]],
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # meter_fold on the main path; the old out-of-place entries on the
    # kernel bench's composed adder (phase 9), their only path now
    bench = record["fused_vs_composed"]["launches"]
    bench_ops = record["fused_vs_composed"]["by_op"]
    for name, launched in (("meter_fold", main_path["meter_fold"]),
                           ("shift_cols", bench["shift_cols"]),
                           ("bitwise[and]", bench_ops["and"]),
                           ("bitwise[xor]", bench_ops["xor"])):
        r = kernel_rows[name]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES["rowops"],
            "replaces": REPLACES[name.split("[")[0]],
            "launches": launched, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # one row per LM kernel at each shape of the serving path it runs at,
    # each with the launches at its own shape (pim_matmul: decode's two on
    # the swapped operands, prefill's two on the tensor cores; flash_attn:
    # decode's split over the keys, prefill's on the tensor cores); every
    # other shape is in chip_smoke.json
    from repro_torch.kernels.pim_matmul.ops import TC_MIN_M

    def pim_rows(shapes, launches_by_shape):
        for m, k, n in shapes:
            route = "swap_ab" if m < TC_MIN_M else "tensor_core"
            yield ("pim_matmul",
                   f"pim_matmul[shift_add,w4] ({m},{k})@({k},{n})",
                   launches_by_shape.get(shape_key(route, k, n), 0))

    rows = [*pim_rows(PIM_SHAPES, record["serve"]["pim_shapes"]),
            ("flash_attn", "flash_attn[decode]", flash_routes["split_kv"]),
            ("flash_attn", "flash_attn[prefill]",
             flash_routes["tensor_core"])]
    # MLA's flash rows at the deepseek path's shapes (decode over its
    # 144-slot latent cache, prefill at 128 tokens), launched on phase 16's
    # deepseek path
    rows += [("flash_attn", "flash_attn[decode,mla,144]",
              ds_flash["split_kv"]),
             ("flash_attn", "flash_attn[prefill,mla]",
              ds_flash["tensor_core"])]
    # recurrentgemma-2b's rows at phase 18's serving shapes, each with the
    # launches at its own shape on its path: pim_matmul at its two decode
    # and two prefill shapes, flash_attn at decode over its 144-slot ring
    # and at prefill
    _, _, rg_flash = recurrent_counts["serve-recurrentgemma"]
    rows += [*pim_rows(PIM_SHAPES_RG,
                       recurrent["serve-recurrentgemma"]["pim_shapes"]),
             ("flash_attn", "flash_attn[decode,recurrentgemma,144]",
              rg_flash["split_kv"]),
             ("flash_attn", "flash_attn[prefill,recurrentgemma]",
              rg_flash["tensor_core"])]
    # training's rows at phase 20's shapes, each with the launches of the
    # measured steps (TRAIN_STEPS of them) at its own (route, K, N): each
    # pim_matmul shape is a forward, its recompute, the dscales
    # accumulator and the other shape's dx on the transposed codes; flash
    # with the log-sum-exp, forward and recompute
    train_flash = sum(h["launches"]["flash_lse"]
                      for h in record["train"]["steps"])
    rows += [*pim_rows(PIM_SHAPES_TRAIN, train_shapes),
             ("flash_attn", "flash_attn[prefill,lse]", train_flash)]
    # the dense configurations' rows at phase 25's and 27's shapes, each
    # with the launches at its own shape on its path: pim_matmul w4
    # shift_add at the three configs' FFN shapes (phase 25's M 4 and 512),
    # Qwen3-4B's four shapes in its other quantizations, flash_attn at
    # each config's prefill and decode over 144 slots, starcoder2-7b's at
    # 4,352 tokens and over the wrapped ring
    dense_shapes = {}
    for label in DENSE_BOTH_ROUTES:
        dense_shapes.update(dense[label]["pim_shapes"])
    rows += pim_rows(PIM_SHAPES_DENSE, dense_shapes)
    for label, _, overrides, _ in DENSE[len(DENSE_BOTH_ROUTES):]:
        kind = (f"{overrides['quant_mode']},"
                f"w{overrides['quant'].removeprefix('pim_w')}")
        rows += [("pim_matmul", name.replace("shift_add,w4", kind), n)
                 for _, name, n in pim_rows(PIM_SHAPES,
                                            dense[label]["pim_shapes"])]
    for label, name in (("serve-yi", "yi"), ("serve-qwen2.5", "qwen2.5"),
                        ("serve-starcoder2", "starcoder2")):
        flash = dense[label]["flash_routes"]
        rows += [("flash_attn", f"flash_attn[prefill,{name}]",
                  flash["tensor_core"]),
                 ("flash_attn", f"flash_attn[decode,{name},144]",
                  flash["split_kv"])]
    rows += [("flash_attn", "flash_attn[prefill,starcoder2,4352]",
              ring["flash_routes"]["tensor_core"]),
             ("flash_attn", "flash_attn[decode,starcoder2,ring]",
              ring["flash_routes"]["split_kv"])]
    # Qwen3-4B's heads at 32,768 positions, launched on phase 30's path
    rows += [("flash_attn", "flash_attn[prefill,32k]",
              long_rec["flash_routes"]["tensor_core"]),
             ("flash_attn", "flash_attn[decode,32k]",
              long_rec["flash_routes"]["split_kv"])]
    for kernel, row, launched in rows:
        r = lm_rows[row]
        table.append({
            "name": row, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launched,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # ripple_add at the bit-plane layer's width (byte lanes), launched on
    # the kernel bench's path; every width is in chip_smoke.json
    r = ripple_rows["ripple_add[w8]"]
    table.append({
        "name": "ripple_add[w8]", "route": "cuda", "source": SOURCES["rowops"],
        "replaces": REPLACES["ripple_add"],
        "launches": record["fused_vs_composed"]["launches"]["ripple_add"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    record["table"] = table
    record["elapsed_s"] = time.perf_counter() - run_start
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      marks.items()))
    say(f"chip_smoke: {record['elapsed_s']:.1f} s from the start to the "
        "kernel table")
    out = ROOT / "chiprun_out"
    try:
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    except OSError as e:
        print(f"chip_smoke: could not write {out}: {e}", file=sys.stderr)
    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
