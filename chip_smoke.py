"""Build and run the PyTorch port of FIGCache on one CUDA card: the DRAM
simulator (its controllers, streamed replay, chunk codec, checkpoints,
device workload generator and fault-tolerant sweep orchestrator too), the
FIGCache-KV serving path, the LM serving paths (dense; MoE with MLA;
the sliding-window ring cache; a VLM with the int8 KV cache; Whisper;
Mamba in Jamba and RWKV-6), training on one device, and the sharded
stack's train, prefill and decode steps on a 1 x 1 mesh.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. device: the card's name and power limit; build every CUDA kernel of the
   port from ``src/repro_torch/csrc`` with nvcc (sm_90a), and the
   latency probe beside them, one nvcc per source, all started together,
   timed;
2. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card (fts_lookup, figaro_reloc and figkv_tx bitwise,
   figcache_decode within f32 2e-5 / bf16 2e-2), at the main paths' shapes
   and at corner shapes (figcache_decode: L = 1, L below the split count,
   ragged and long L, D from 1 to 512, groups of 1 to 12 query heads;
   figkv_tx: all four policies on full, evicting stores at the figkv shape,
   hits whose slot the same step's insert takes included), then both
   timed with CUDA events (median of 25 samples), per eager call and as
   device time (CUDA-graph replay), beside the kernel's bound and, where
   one exists, one PyTorch call computing the same; figcache_decode's
   plan at the figkv shape (splits, grid, cluster, shared memory) and its
   device time by split count; figkv_tx's time (its state restored before
   each launch, the restore's own time taken off) beside its byte bound
   (the bytes of the branch each sequence's state takes, ``tx_bytes``),
   its chain bound (dependent round trips counted from the code,
   FIGKV_CHAIN, at the latency probe's measured latencies) and the
   unfused composition it replaces (the torch transaction, the repair and
   two figaro_reloc launches, returning new FTS leaves as the step did
   before they were updated in place);
3. golden pins: the six FCFS fingerprints of tests/test_obs.py:108-153 on
   the card, through the replay kernel (sim_scan), through the eager step
   loop with the lookup kernel and through the eager loop with the
   lookup's plain version (18 runs);
4. simulator main path: ``simulator.run_eight_core_batch`` over the fig-8
   workload set (benchmarks/common.py ALL_WL), 4 channels x 6144 requests,
   all six paper mechanisms, default configs, through the replay kernel
   (one sim_scan launch per static group, no fts_lookup launch); then the
   same grid through the eager loop (``dram._advance_eager`` patched in:
   one fts_lookup launch per cached step), every counter compared bitwise
   and both wall times printed; launch counts read just around each run;
   workload 15 rerun alone through the eager loop with the plain lookup,
   for the mechanisms with a cache, compared bitwise; then sim_scan's
   device time per static group (CUDA events) beside its byte bound and
   its chain bound: T x a step's dependent round trips (CHAIN, counted
   from the code) at the L1, L2, store-reload and shuffle latencies that
   the latency probe (csrc/latency_probe.cu) measures on the card; at
   figcache_fast the telemetry instantiation (period 64) timed in turns
   with the plain one, and ptxas's registers and spills of both;
5. FIGCache-KV path: ``serve.demo_figkv`` at Qwen2-7B's full attention
   width (28 query / 4 KV heads, head_dim 128, bf16, default FIGKVConfig),
   batch 8, a 32768-token prompt and 256 decode steps; launch counts read
   just around it (figkv_tx and figcache_decode once a step, figaro_reloc
   never); the same inputs rerun with the two kernels' plain versions
   patched in at the figkv module's call sites, every FTS leaf and pool
   compared bitwise, outputs within bf16 atol 2e-2; rerun with the unfused
   composition (the torch transaction and two figaro_reloc launches a
   step, the same repair, the new FTS leaves taking the old ones' place
   without a copy), state bitwise equal again; fused and unfused
   decode ms/step, and a profile of 16 steps of each (ms/step, device ops
   a step, idle share) in turns; then ``embed_cache_lookup`` over
   Qwen2-7B's embedding table, 256 steps of 64 Zipf-drawn tokens, every
   output equal to ``table[tokens]``, figaro_reloc launches counted
   around it;
6. profile: device busy and idle share of the simulator's replay at its
   shapes (torch.profiler): a whole 6144-step group through the replay
   kernel, and 128 steps through the eager loop; the device ops that take
   the time;
7. flash_attention kernel vs plain: the 18 cases of
   tests/test_kernels.py:20-37 (f32 / bf16 x causal, full, window 96), a
   ragged S (100, 1000), GQA (Hkv < H), the edges of the bf16 kernel's
   128-row tiles, the zero-padded head dims (8, 20, 160) and D 192, and
   Qwen2-7B's prefill (B 4, S 4096, 28 query / 4 KV heads, D 128, bf16),
   within f32 2e-5 / bf16 2e-2 and, per output row, within f32 1e-4 /
   bf16 1e-2 of the row's largest value; ptxas's registers and spills of
   the bf16 kernel (D 128 and 192) and how it rounds P; then at
   the Qwen2-7B shape the kernel, its plain version and SDPA (causal,
   GQA) timed as device time, beside the FLOP bound, with the kernel's
   TFLOP/s and share of the bound;
8. LM serving: ``serve.run("qwen2-7b", reduced=False)`` (all 28 layers at
   full width, random weights from seed 0), 4 requests of 4096 prompt
   tokens and 64 greedy tokens each; flash_attention launches read just
   around it (28, one per layer); finite logits; a warm prefill equal to
   the served one; the prefill rerun with the plain version patched in at
   its call site, every layer's kernel output held against the plain one
   on that layer's inputs (the bound and its reason are in ``phase_lm``);
   prefill ms, decode ms/step, tokens/s, peak device memory, and a profile
   of the decode step; then ``serve.run("stablelm-12b")`` reduced (head
   dim 20, which the kernel runs zero-padded to 32): one flash_attention
   launch per layer, finite logits, each layer's kernel output held
   against the plain version on its own inputs;
9. controllers: the 24 GOLDEN fingerprints of tests/test_obs.py:108-153
   (6 mechanisms x fcfs / frfcfs / drain / frfcfs+drain) and the two
   interior no-op goldens of tests/test_streaming.py:355-365, each through
   sim_scan monolithic (the trace scheduled on the host), streamed by
   ``streaming.simulate_stream`` at chunk lengths 1, 7, 64 and full (17 for
   the no-op trace), and by the wave route (``wavefront.run_channel_waves``:
   the linearized waves in one launch); the launches checked per route
   (one per segment, one per wave call); then the wave route held against
   the eager wave step on the card, every state leaf, six mechanisms under
   frfcfs+drain;
10. long trace: fig-8 workload 0 at 65536 requests per channel, 4
   channels, all six mechanisms under FCFS and under FR-FCFS (queue 16) +
   write drain (16): ``simulator.sweep`` monolithic and with
   ``chunk_len=8192``, ``simulate_stream`` over ``decoded_segments`` of
   ``encode_trace`` (the FCFS order encoded, decoded on the card,
   scheduled on the host), and a stream killed after its segment-3
   checkpoint and finished by ``resume_stream``; every counter bitwise
   equal to the monolithic run; each route's wall time, peak device memory
   and launches, and the host's shares (trace building, scheduling,
   encode, decode, checkpoint save and restore);
11. controller grid: fig 16's grid (benchmarks/fig16_scheduler.py, copied):
   5 controllers x {base, figcache_fast} on workloads 5 and 17 at 12288
   requests per channel through ``simulator.sweep`` (10 launches a
   workload), its speedup summary; one group of workload 5 at 1024
   requests per channel held against the eager loop, bitwise;
12. telemetry windows: the 24 GOLDEN combos and the interior no-op trace
   at period 32 (SLO 40 ns) through ``dram.resume_tel`` (one launch of
   sim_scan's telemetry instantiation, held against the eager loop on the
   card on every state, telemetry and frame leaf, filler rows included)
   and streamed by ``simulate_stream`` with an ``obs.WindowCollector`` at
   1, 7, 64 and full, counters at the golden and series, cumulative
   planes and final cursor equal across routes; then
   benchmarks/fig_tail_latency.py's parameters (period 64, SLO 150 ns,
   chunk 1024, base and figcache_fast) on phase 10's trace (W25-0, 4 x
   65536): streamed (64 launches) against monolithic, bitwise per
   channel, a 1024-request prefix against the eager loop, p50 / p90 /
   p99 / p999 with their bucket brackets, the SLO rate and
   figcache_fast's p99 gain; the tax at that trace's figcache_fast group
   (CUDA events, in turns) and on the monolithic route's wall;
13. workload engine: fig 17's grid (benchmarks/fig17_scenarios.py:21,
   common.scenario_specs, copied): the six families' presets at 8 cores x
   4 channels x 6144 requests, seed 2, generated on the card and replayed
   x 5 mechanisms through ``simulator.sweep_traces(specs, cfgs)`` (sim_scan
   launches counted from 0 around it), its speedup summary; the results
   bitwise equal to the same card-generated traces passed as Trace
   entries, ``generate_many`` bitwise equal to per-spec ``generate``, each
   family's streams before assembly and whole trace on the card bitwise
   equal to the CPU's, and
   figcache_fast on a 1024-request prefix against the eager loop; each
   family's ``generate`` wall (synchronised) and device launches
   (torch.profiler) and ``generate_many``'s peak device memory; then the
   eight fig-8 mixes as ``spec_from_apps(apps, 4, 6144, seed=2)`` through
   one ``generate_many`` on the card, in turns with ``traces.build_trace``
   on the host, and ``summarize(characterize(...))`` of each pair;
14. orchestration: fig 17's grid of phase 13 through
   ``launch.orchestrator`` (30 shards, 6 segments of 1024 requests each,
   checkpointed after every segment), uninterrupted and killed at shard 7
   segment 3 (``mode="raise"``) then resumed, each run's
   ``counters_by_config`` bitwise equal to ``sweep_traces(specs, cfgs,
   chunk_len=1024)`` on the card; each run's wall, sim_scan launches
   (counted from 0 around it), ``generate`` calls and their share of the
   wall, checkpoint saves and restores with their seconds, peak device
   memory, and the checkpoint bytes on disk; the CLI in fresh processes:
   ``run --kill 1:1 --kill-mode sigkill`` returns -9, ``run`` resumes,
   ``compare`` returns 0; ``xla_math``'s log1p and the Zipf inversion's
   pow / exp / log over all 2**23 uniforms at the presets' knobs, the
   card's bits equal to the CPU's;
15. sanitizer and flight recorder: the launch contracts
   (``analysis.contracts``) on the card, each contract's sim_scan
   launches (counted from 0 around it) equal to its count in
   ``dram.REPLAYS`` and within budget, ``sweep.warm-cache`` opening no library, with
   launches, builds and wall per contract; the lint and the aten-graph
   audit (``analysis.run_all(with_contracts=False)``) with zero findings;
   64 eager steps of the fig-8 figcache_fast group (32 lanes) under
   ``torch.cuda.set_sync_debug_mode("error")`` with no error, their
   counters equal to sim_scan's over the same requests; the ``dense`` body
   (eager on the card) equal to sim_scan's fused replay on every counter
   for the 18 mechanism x policy cells of tests/test_hotloop.py on a real
   512-request, 4-channel fig-8 trace; then ``python -m repro_torch.obs``
   in-process at full size (16384 requests, chunk 256, period 64, SLO 100
   ns), its chunked-vs-monolithic window series bitwise equal (a hard
   check), the telemetry tax with every round and the 1.25x tripwire's
   verdict (reported, not a failure), p50 / p99 / p999 and the over-SLO
   rate per capacity point, the phase_mix hit-rate range and the contract
   profile (cold / warm walls, builds, dispatches, sim_scan launches);
16. MoE + MLA serving: ``serve.run("deepseek-v2-lite", reduced=False)``
   (all 27 layers at full width, 64 routed experts top-6 + 2 shared,
   random weights from seed 0; ~29.3 GiB of bf16 weights) at phase 8's
   sizes (4 x 4096 prompt tokens, 64 greedy tokens): flash_attention
   launches read just around it (27, one per layer, at D 192, H = Hkv =
   16); tokens in range, finite logits; a warm prefill bitwise equal to
   the served one, recording each MoE layer's dropped share and input;
   ``moe_forward`` against ``moe_dense_ref`` on the card on the first MoE
   layer's prefill input (T 16384, C 3072) and on every MoE layer's input
   of one decode step (routing equal, within 2e-2 plus one bf16 ulp), one
   decode step under sync-debug mode "error", RoPE's sin / cos bitwise
   equal on the card and the CPU; the
   prefill rerun with the plain version at the call site, each layer's
   kernel output within 2e-2 plus one bf16 ulp of plain; prefill ms cold
   and warm, decode ms/step and tokens/s beside the step's expert-weight
   bound, peak memory against the weights, a profile of 4 decode steps;
   flash_attention at MLA's shape (B 4, S 4096, H = Hkv = 16, D 192, bf16,
   causal) and D-192 corners at H = Hkv against plain, then the kernel,
   plain and SDPA timed as device time beside the FLOP bound; then
   Mixtral-8x22B at full width cut to 2 of 56 layers, batch 2, prompt 8192
   (twice its window), 32 tokens: 2 flash_attention launches in the
   prefill, the prefill rerun with the plain version at the call site
   (each layer's kernel output within 2e-2 plus one bf16 ulp of plain), its
   first 4 ring decode steps (every one past the ring's wrap) held layer
   by layer against an 8232-slot window-masked cache on the same inputs,
   the other 28 timed, finite logits;
17. VLM and Whisper serving: Qwen2-VL-72B at full width cut to 4 of 80
   layers with the int8 KV cache (``Plan(kv_quant=True)``), served through
   ``serve.serve_batch`` at batch 4, 1024 zero vision embeddings before
   3072 prompt tokens, 64 greedy tokens: 4 flash_attention launches in the
   prefill (S 4096, H 64, Hkv 8, D 128, causal), tokens in range, finite
   logits; a warm prefill bitwise equal to the served one whose every
   layer's int8 codes and scales equal the CPU's ``_quant_kv`` of the same
   bf16 K / V bit for bit; the prefill rerun with the plain version at the
   call site (each layer's kernel output within 2e-2 plus one bf16 ulp of
   plain); a prefill with random vision embeddings and M-RoPE's
   ``positions3`` (a 32 x 32 grid) with finite logits other than the
   broadcast-position prefill's; the first 4 decode steps, every layer's
   attention through the int8-native route, the dequantized route and a
   bf16 cache on the same inputs, every ``attend`` of the three within
   2e-2 plus one bf16 ulp of the CPU's on the same inputs, the routes'
   and the caches' gaps printed; prefill ms cold and warm, decode ms/step,
   tokens/s, the cache's bytes against a bf16 cache's, peak memory; the
   kernel at that shape timed beside plain, SDPA and the bound; then
   ``serve.run("whisper-tiny", reduced=False)`` (4 + 4 layers, 1500
   frames) at batch 16, prompt 128, 64 tokens: 8 flash_attention launches
   in the prefill (4 non-causal at S 1500, 4 causal at S 128, shapes
   recorded in a warm prefill bitwise equal to the served one), each
   layer's kernel output within 2e-2 plus one bf16 ulp of plain, finite
   logits; encoder ms, prefill ms, decode ms/step, tokens/s; the kernel at
   the encoder's shape timed beside plain, SDPA and the bound;
18. attention-free mixers: Jamba-v0.1-52B at full width cut to one
   8-layer period of 32 (7 Mamba mixers, 1 RoPE-free attention mixer, 4
   dense and 4 MoE FFNs of 16 experts top-2; 24.76 GiB), served through
   ``serve.serve_batch`` at batch 4, prompt 2048, 64 greedy tokens: 1
   flash_attention launch in the prefill (H 32, Hkv 8, D 128, causal),
   tokens in range, finite logits, a warm prefill bitwise equal to the
   served one, the attention layer's kernel output within 2e-2 plus one
   bf16 ulp of plain on its inputs, each MoE layer's dropped share, the
   kernel at that shape timed; then RWKV6-3B whole through
   ``serve.run(reduced=False)`` at batch 4, prompt 1024, 64 tokens: no
   flash_attention launch, finite logits, a warm prefill bitwise equal.
   For each, one mixer of the served model (Jamba's Mamba layer 3, RWKV's
   block 16) on its first 256 prefill inputs: the card against the CPU on
   the same bf16 inputs and weights (within 2e-2 plus one bf16 ulp; the
   RWKV block's four stages, ln1, time mix, ln2, channel mix, each on the
   card's own input to it, the whole block's gap printed; the f32 ssm /
   wkv state's error relative to its largest entry printed), and 4
   decode steps after a 252-token prefill against the 256-token prefill
   (within 5e-2: Mamba's output, the RWKV block's time and channel
   mixes' outputs, the block's own printed); one decode step under
   sync-debug mode "error"; prefill ms cold and warm, decode ms/step against the weights' byte
   bound, tokens/s, peak memory, a profile of 4 decode steps, and the
   share of a prefill spent in the per-token recurrences
   (``mamba._recurrence``, ``rwkv6._wkv_scan``; synchronised around each
   chunk's);
19. training: one train step (``launch.steps.make_train_step``: value and
   grad of ``Model.loss``, AdamW, the bf16 weights written back) on the
   card and the loss and gradients on the CPU in f32 from the same
   weights and batch, for Qwen1.5-0.5B at full width cut to 2 of 24
   layers (B 1, S 512) and Whisper-tiny whole (B 2, prompt 128, f32 frame
   embeddings, so its encoder runs in f32), the weights seeded and the
   attention projections rescaled to the usual fan-in
   (``fan_in_attention``: the reference's initialiser saturates the
   softmax at full width, and then even f32 gradients of two correct
   computations differ O(1)): the bf16 step's loss within 2e-2 and every
   leaf's gradient (taken where AdamW receives it) finite, nonzero and
   within 0.1 relative L2 of the f32 CPU's; the same weights in f32 on
   the card, the loss within 1e-4 and every gradient within 1e-3
   (``TRAIN_*_TOL``); flash_attention's launches in the step (each
   layer's forward and, under remat, its recompute; the f32 loss and
   backward checked to launch it as often); then the bf16 loss
   and backward with the kernel called without
   ``kernels.flash_attention.ops.MHA`` (the port before its repair),
   whose q / k / v projections get no gradient (printed, and checked to
   be so); then Qwen1.5-0.5B whole (24 layers, vocab 151936, tied,
   the reference's initialiser) through ``train.run(reduced=False)`` on
   train_4k's S 4096 with the batch cut from 256 to 8 (remat, one
   microbatch, chunked CE, as ``make_plan`` gives), 6 steps: step ms
   (median after the first), tokens/s, peak memory, the loss first to
   last (finite; the last below the first, the last three's mean below
   the first three's), launches a step, and 6 N tokens / step / 989
   TFLOP/s; the kernel on the first attention call's own bf16 inputs
   from that run (layer 0, step 1: B 8, S 4096, 16 heads of 64, causal)
   within 2e-2 plus one bf16 ulp of plain; then a step profiled (device busy time and its top ops, the
   idle share against the median step) and one with the attention
   backward and the CE chunks synchronised around, their shares of the
   step;
20. the sharded LM stack on a 1 x 1 mesh of the one card
   (``launch.mesh.init_single("cuda")``, NCCL, ``make_test_mesh(1, 1)``):
   phase 19's whole Qwen1.5-0.5B step (S 4096, batch 8) once without a
   mesh and once through ``make_train_step(model, hyper, mesh)`` (the
   parameters, optimizer state and batch as ``DTensor``s laid out by
   ``launch.sharding``) from copies of one state, the loss and every
   updated leaf (bf16 parameters, m, v, f32 masters) expected bitwise
   equal, a difference printed with its first leaf and held within one
   bf16 ulp of that leaf's largest entry; flash_attention's launches in
   the step (48); the median of 3 more sharded steps against phase 19's
   median (the host cost of ``DTensor`` dispatch); ``make_prefill_fn`` /
   ``make_decode_fn`` on the mesh give the same 8 greedy tokens as
   ``serve.run`` for 4 prompts of 512 tokens, for Qwen1.5-0.5B and for
   DeepSeek-V2-Lite whole (the MoE's mesh path, MLA's 27 launches through
   ``spmd.local_call``, the check's seconds printed); then ``launch.dryrun``'s
   prediction for the same cell at (1, 1) (a subprocess on the CPU,
   started at the phase's start: the fake group, the meta device): FLOPs,
   bytes and the roofline bound at the H100's published peaks, and the
   measured step's share of that bound beside the nvidia-smi line;
21. summary: one ``{"kernels": [...]}`` JSON line (device times from
   CUDA-graph replay; sim_scan's from CUDA events around one launch, its
   plain version's the eager loop's group wall, with its chain bound
   beside the byte bound; fts_lookup's launches are the main path's, 0,
   since it runs inlined in sim_scan, and its launches through the eager
   loop a field apart; figaro_reloc's are the embedding cache's, its figkv
   launches, 0, a field apart; sim_scan's launches on each simulator path
   of phases 4 and 9-15, counted from 0 around it, in ``path_launches``,
   and its telemetry instantiation's time and tax, ``tel_ms`` /
   ``tel_tax``; flash_attention's launches on each LM path, counted from
   0 around its prefill, in ``path_launches``, and its times at MLA's,
   Qwen2-VL's and Whisper's encoder's shapes in ``mla``, ``qwen2_vl`` and
   ``whisper``, and at Jamba's in ``jamba``; RWKV6-3B's path launches it
   no time; the trainer's, ``train``, counted around phase 19's run, and
   phase 20's sharded step and prefills, ``train_mesh``, ``serve_mesh``
   and ``deepseek-v2-lite_mesh``),
   the nvidia-smi line, and
   last the
   ``{"ok": true, "device": ...}`` line.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import analysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import (dram, simulator, streaming, timing,  # noqa: E402
                              traces)
from repro_torch.core import workload  # noqa: E402
from repro_torch.core.sched import policies, wavefront  # noqa: E402
from repro_torch.core.workload import generators  # noqa: E402
from repro_torch.core import fts as fts_lib  # noqa: E402
from repro_torch.figkv import embed_cache, kv_cache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.figaro_reloc import \
    figaro_reloc as reloc_kernel  # noqa: E402
from repro_torch.kernels.figaro_reloc.ops import segment_rows  # noqa: E402
from repro_torch.kernels.figaro_reloc.ref import reloc_ref  # noqa: E402
from repro_torch.kernels.figcache_decode import \
    figcache_decode as decode_kernel  # noqa: E402
from repro_torch.kernels.figcache_decode.ref import \
    figcache_decode_ref  # noqa: E402
from repro_torch.kernels.figkv_tx import figkv_tx as tx_kernel  # noqa: E402
from repro_torch.kernels.figkv_tx import ops as tx_ops  # noqa: E402
from repro_torch.kernels.figkv_tx import ref as tx_ref  # noqa: E402
from repro_torch.kernels.figkv_tx.ref import figkv_tx_ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.kernels.fts_lookup import fts_lookup as fts_kernel  # noqa: E402
from repro_torch.kernels.fts_lookup.ref import fts_lookup_ref  # noqa: E402
from repro_torch.kernels.sim_scan import sim_scan as scan_kernel  # noqa: E402
from repro_torch.core.workload import xla_math  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.obs import __main__ as obs_cli  # noqa: E402
from repro_torch.launch import orchestrator as orch_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.faults import (FaultEvent, FaultPlan,  # noqa: E402
                                        InjectedKill)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models.sincosf import sincos_f32  # noqa: E402
from repro_torch.models import Plan, build_model  # noqa: E402
from repro_torch.models.transformer import \
    layer_def as model_layer_def  # noqa: E402
from repro_torch.models import whisper as whisper_mod  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import rwkv6 as rwkv_mod  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

FIG8_WORKLOADS = (0, 2, 5, 7, 10, 12, 15, 17)   # benchmarks/common.py ALL_WL
PER_CHANNEL = 6144                              # common.QUICK_REQS_8CORE
N_CHANNELS = 4
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12                        # dense tensor-core peak
KERNELS = ("fts_lookup", "figaro_reloc", "figcache_decode",
           "flash_attention", "sim_scan", "figkv_tx")
PROBES = ("latency_probe",)                     # a measurement, not a port
# the FIGCache-KV phase: Qwen2-7B (src/repro/configs/qwen2_7b.py), its 32k
# pretraining context (arXiv:2407.10671), 256 decode steps, batch 8
FIGKV_ARCH, FIGKV_BATCH, FIGKV_PROMPT, FIGKV_GEN = "qwen2-7b", 8, 32768, 256
FIGKV_N_SEL = 8                                 # demo_figkv's n_sel
EMBED_STEPS, EMBED_TOKENS, ZIPF_S = 256, 64, 1.1
# LM serving: Qwen2-7B at full width, 4 requests of 4096 prompt tokens and
# 64 generated tokens each
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2-7b", 4, 4096, 64
# the reduced StableLM-12B (head dim 20: the padded head-dim path)
PAD_ARCH = "stablelm-12b"
# MoE + MLA serving: DeepSeek-V2-Lite whole (src/repro/configs/
# deepseek_v2_lite.py, all 27 layers at full width) at phase 8's sizes; then
# Mixtral-8x22B at full width cut to 2 of its 56 layers (memory: 56 layers
# are ~282 GB), batch 2, a prompt of twice its 4096-token window (the
# window mask bites in the prefill, which keeps its last 4096 keys in the
# ring) and 32 tokens, so every decode step runs the ring past its wrap;
# its first 4 steps held against a plain window-masked cache of prompt +
# 40 slots
MLA_ARCH = "deepseek-v2-lite"
RING_ARCH, RING_LAYERS, RING_BATCH, RING_PROMPT, RING_GEN, RING_CHECK = \
    "mixtral-8x22b", 2, 2, 8192, 32, 4
# VLM serving: Qwen2-VL-72B (src/repro/configs/qwen2_vl_72b.py) at full
# width cut to 4 of its 80 layers (memory: 80 layers are 135.4 GiB; 4 are
# 11.18 GiB with both vocab tables, cut from 8 to keep the script near its
# 600 s aim once phase 18 came) with the int8 KV cache, the plan the
# JAX package's make_plan picks for the decode of a model over 30e9
# parameters (src/repro/launch/steps.py:35-38); batch 4, its 1024 vision
# tokens before 3072 prompt tokens (S 4096), 64 greedy tokens; the first 4
# decode steps held layer by layer
VLM_ARCH, VLM_LAYERS, VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_CHECK = \
    "qwen2-vl-72b", 4, 4, 3072, 64, 4
VLM_GRID = 32                                   # 32 x 32 vision tokens
# Whisper-tiny whole (src/repro/configs/whisper_tiny.py: 4 + 4 layers, its
# 1500 audio frames), batch 16, 128-token prompts, 64 greedy tokens
ASR_ARCH, ASR_BATCH, ASR_PROMPT, ASR_GEN = "whisper-tiny", 16, 128, 64

# attention-free mixers: Jamba-v0.1-52B (src/repro/configs/jamba_v0_1_52b.py)
# at full width cut to one 8-layer period of its 32 layers (memory: 32
# layers are 96.06 GiB, 8 are 24.76 GiB; the period holds 7 Mamba mixers, 1
# RoPE-free attention mixer, 4 dense and 4 MoE FFNs), batch 4, prompt 2048,
# 64 greedy tokens; then RWKV6-3B (src/repro/configs/rwkv6_3b.py) whole,
# batch 4, prompt 1024, 64 tokens; each recurrence held card against CPU on
# its layer's first SSM_CHECK prefill inputs, and a decode of SSM_DECODE
# tokens continuing SSM_CHECK - SSM_DECODE
JAMBA_ARCH, JAMBA_LAYERS, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = \
    "jamba-v0.1-52b", 8, 4, 2048, 64
RWKV_ARCH, RWKV_BATCH, RWKV_PROMPT, RWKV_GEN = "rwkv6-3b", 4, 1024, 64
SSM_CHECK, SSM_DECODE = 256, 4

# training (phase 19): one step on the card and on the CPU from the same
# weights and batch, Qwen1.5-0.5B at full width cut to 2 of 24 layers (B 1,
# S 512) and Whisper-tiny whole (B 2, prompt 128, f32 audio embeddings);
# the attention projections at the usual fan-in (``fan_in_attention``: the
# reference's initialiser saturates full-width softmaxes, which makes two
# correct computations' gradients O(1) apart); the bf16 step's loss within
# TRAIN_LOSS_TOL of the CPU's f32 loss and each leaf's gradient within
# TRAIN_BF16_GRAD_TOL relative L2 of the CPU's f32 one (bf16 rounding), the
# same weights in f32 on the card within TRAIN_F32_GRAD_TOL; then
# Qwen1.5-0.5B whole through
# ``train.run(reduced=False)`` on train_4k's S 4096 with the batch cut from
# 256 to TRAIN_BATCH
TRAIN_ARCH, TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = \
    "qwen1.5-0.5b", 2, 1, 512
TRAIN_ASR_B, TRAIN_ASR_S = 2, 128
TRAIN_F32_GRAD_TOL, TRAIN_BF16_GRAD_TOL = 1e-3, 0.1
TRAIN_LOSS_TOL = 2e-2
TRAIN_SHAPE, TRAIN_BATCH, TRAIN_STEPS = "train_4k", 8, 6
H100_BF16_FLOPS = 989e12                         # dense bf16, H100 SXM
# the sharded stack on a 1 x 1 mesh (phase 20): phase 19's whole
# Qwen1.5-0.5B train step (S 4096, batch TRAIN_BATCH) once without a mesh
# and MESH_STEPS + 1 times through the sharded step, from copies of one
# state; MESH_SERVE_B prompts of MESH_PROMPT tokens, MESH_GEN greedy tokens
MESH_STEPS, MESH_SERVE_B, MESH_PROMPT, MESH_GEN = 3, 4, 512, 8

# tests/test_obs.py's controllers
SCHEDS = {
    "fcfs": timing.SCHED_FCFS,
    "frfcfs": timing.SchedConfig("frfcfs", queue_depth=8, starve_cap=4),
    "drain": timing.SchedConfig(write_drain=True, drain_batch=4),
    "frfcfs+drain": timing.SchedConfig("frfcfs", queue_depth=8, starve_cap=4,
                                       write_drain=True, drain_batch=4),
}
# (acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks, row_hits,
#  cache_hits, insertions, sum(lat_sum_ns), sum(req_cnt), t_end): GOLDEN of
# tests/test_obs.py:108-153 (cache_rows=2 for the cached mechanisms, on that
# file's _reuse_trace()), per mechanism and controller
GOLDEN = {
    ("base", "fcfs"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    ("base", "frfcfs"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 203846, 320, 28920),
    ("base", "drain"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 204769, 320, 28968),
    ("base", "frfcfs+drain"): (320, 0, 256, 64, 0, 0, 0, 0, 0, 204769, 320,
                               28968),
    ("lldram", "fcfs"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320, 19118),
    ("lldram", "frfcfs"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 132798, 320,
                           19118),
    ("lldram", "drain"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 133624, 320,
                          19188),
    ("lldram", "frfcfs+drain"): (0, 320, 256, 64, 0, 0, 0, 0, 0, 133624,
                                 320, 19188),
    ("lisa_villa", "fcfs"): (296, 24, 256, 64, 37888, 7552, 0, 24, 296,
                             257761, 320, 36264),
    ("lisa_villa", "frfcfs"): (296, 24, 256, 64, 37888, 7552, 0, 24, 296,
                               257761, 320, 36264),
    ("lisa_villa", "drain"): (297, 23, 256, 64, 38016, 7552, 0, 23, 297,
                              257802, 320, 36262),
    ("lisa_villa", "frfcfs+drain"): (297, 23, 256, 64, 38016, 7552, 0, 23,
                                     297, 257802, 320, 36262),
    ("figcache_slow", "fcfs"): (295, 0, 256, 64, 4320, 752, 25, 50, 270,
                                299156, 320, 42932),
    ("figcache_slow", "frfcfs"): (295, 0, 256, 64, 4320, 752, 25, 50, 270,
                                  299156, 320, 42932),
    ("figcache_slow", "drain"): (291, 0, 256, 64, 4272, 768, 29, 53, 267,
                                 296726, 320, 42712),
    ("figcache_slow", "frfcfs+drain"): (291, 0, 256, 64, 4272, 768, 29, 53,
                                        267, 296726, 320, 42712),
    ("figcache_fast", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                291785, 320, 42012),
    ("figcache_fast", "frfcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                  291785, 320, 42012),
    ("figcache_fast", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                 290152, 320, 41884),
    ("figcache_fast", "frfcfs+drain"): (267, 24, 256, 64, 4272, 768, 29,
                                        53, 267, 290152, 320, 41884),
    ("figcache_ideal", "fcfs"): (270, 25, 256, 64, 4320, 752, 25, 50, 270,
                                 185359, 320, 26656),
    ("figcache_ideal", "frfcfs"): (270, 25, 256, 64, 4320, 752, 25, 50,
                                   270, 185359, 320, 26656),
    ("figcache_ideal", "drain"): (267, 24, 256, 64, 4272, 768, 29, 53, 267,
                                  184511, 320, 26528),
    ("figcache_ideal", "frfcfs+drain"): (267, 24, 256, 64, 4272, 768, 29,
                                         53, 267, 184511, 320, 26528),
}
# tests/test_streaming.py:355-365 _GOLDEN: counter sums of the interior
# no-op trace (three 40-request runs between two 8-deep no-op runs)
INTERIOR_GOLDEN = {
    "base": (120, 0, 90, 30, 0, 0, 0, 0, 0, 29935, 120, 6630),
    "figcache_fast": (120, 0, 90, 30, 1920, 160, 0, 0, 120, 50400, 120,
                      10050),
}
# the long trace: one fig-8 workload at 65536 requests per channel,
# replayed monolithic, in 8192-request segments, from the chunk codec and
# resumed from a checkpoint, under FCFS and the controller below
LONG_WORKLOAD, LONG_PER_CHANNEL, LONG_CHUNK, LONG_KILL = 0, 65536, 8192, 5
LONG_SCHED = timing.SchedConfig("frfcfs", queue_depth=16, write_drain=True,
                                drain_batch=16)
# fig 16's grid (benchmarks/fig16_scheduler.py:24-30 and :37-43): five
# controllers x {base, figcache_fast} on workloads 5 and 17 (common.WL_IDX
# [50][0], [100][1]) at common.LONG_REQS_8CORE requests per channel
FIG16_SCHEDS = (
    ("fcfs", timing.SchedConfig()),
    ("frfcfs_qd8", timing.SchedConfig("frfcfs", queue_depth=8)),
    ("frfcfs_qd16", timing.SchedConfig("frfcfs", queue_depth=16)),
    ("frfcfs_qd32", timing.SchedConfig("frfcfs", queue_depth=32)),
    ("frfcfs_qd16_drain", timing.SchedConfig("frfcfs", queue_depth=16,
                                             write_drain=True,
                                             drain_batch=16)),
)
FIG16_WORKLOADS, FIG16_PER_CHANNEL, FIG16_EAGER_PER_CHANNEL = \
    (5, 17), 12288, 1024
# telemetry windows: the GOLDEN combos at tests/test_obs.py's PERIOD (SLO
# 40 ns, inside that trace's latencies), then benchmarks/fig_tail_latency.py's
# PERIOD, SLO_NS, CHUNK and mechanisms on the long trace, a prefix of it
# held against the eager loop
TEL_GOLDEN_PERIOD, TEL_GOLDEN_SLO_NS = 32, 40
TAIL_PERIOD, TAIL_SLO_NS, TAIL_CHUNK = 64, 150, 1024
TAIL_MECHS, TAIL_EAGER_PREFIX = ("base", "figcache_fast"), 1024
# the workload engine: fig 17's grid (benchmarks/fig17_scenarios.py:21 and
# common.scenario_specs at QUICK_REQS_8CORE: every family's preset, 8 cores
# x 4 channels x 6144 requests, seed 2), a static group's prefix held
# against the eager loop, and the fig-8 mixes (common.ALL_WL) generated as
# spec_from_apps(apps, 4, 6144, seed=2) beside traces.build_trace
FIG17_MECHS = ("base", "lisa_villa", "figcache_fast", "figcache_ideal",
               "lldram")
FIG17_CORES, FIG17_SEED, GEN_EAGER_PREFIX = 8, 2, 1024
# orchestration: fig 17's grid (the specs and mechanisms above) as 30
# durable shards of 6 segments, checkpointed after every segment, run
# uninterrupted and killed at (shard, segment) then resumed; the CLI's
# ci_grid killed by a real SIGKILL at ORCH_CLI_KILL
ORCH_CHUNK, ORCH_KILL, ORCH_CLI_KILL = 1024, (7, 3), "1:1"
# the sanitizer phase: the fig-8 figcache_fast group's eager steps run
# under the sync-debug mode, and the dense body's real trace
SYNC_STEPS, DENSE_REQS = 64, 512
# the transcendentals' knob pairs held card against CPU over every uniform:
# zipf_a 1.1 / 1.2 x n_pages 1024 to 8192 (the presets' values)
XLA_KNOBS = [(n, a) for a in (1.1, 1.2) for n in (1024, 2048, 4096, 8192)]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=50, samples=25) -> float:
    """Median over ``samples`` CUDA-event windows of ``reps`` back-to-back
    calls, per call (ms)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def graph_ms(fn, reps=20, samples=25) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``samples`` times between CUDA events; median per call (ms).
    Replay removes the host's per-call cost, which ``time_ms`` includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


@contextlib.contextmanager
def patched(module, **attrs):
    """Swap module attributes (a call site's function) for the duration."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def plain_lookup_op(tags, score, bank, seg, limit):
    """``ops.fts_lookup_op`` with the plain version on the card."""
    out = fts_lookup_ref(tags, score, bank, seg, limit)
    return out[:, 0] != 0, out[:, 1], out[:, 2]


def plain_figkv_tx(sel, step, n_live, fts, seg_k, seg_v, fast_k, fast_v,
                   fig):
    """``ops.figkv_tx`` with the plain version on the card."""
    rows = [tx_ops.as_rows(x) for x in (seg_k, seg_v, fast_k, fast_v)]
    return figkv_tx_ref(sel, step, n_live, fts, *rows, fig)


def unfused_tx(sel, step, n_live, fts, pool_k, pool_v, fast_k, fast_v, fig):
    """The composition ``figkv_tx`` replaced, on (B, rows, E) rows: the
    torch transaction (``ref.fts_step``) and the repair, then one
    ``figaro_reloc`` launch each for K and V.  Returns the new FTS leaves,
    as the step took them before the leaves were updated in place, and
    (slots, ins_seg, ins_slot)."""
    steps = torch.full((sel.shape[0],), step, dtype=torch.int32,
                       device=sel.device)
    new, slots, ins_seg, ins_slot = tx_ref.fts_step(fts, sel, steps, fig,
                                                    n_live)
    slots = tx_ref.repair_slots(slots, sel, ins_seg, ins_slot)
    src, dst = ins_seg[:, None], ins_slot[:, None]
    reloc_kernel.reloc(pool_k, fast_k, src, dst)
    reloc_kernel.reloc(pool_v, fast_v, src, dst)
    return new, (slots, ins_seg, ins_slot)


def unfused_figkv_tx(sel, step, n_live, fts, seg_k, seg_v, fast_k, fast_v,
                     fig):
    """``ops.figkv_tx`` as the step ran before the fused kernel
    (``unfused_tx``).  The state's leaves take on the new ones' storage
    (``Tensor.set_``: no copy, no device op), as the step's returned state
    did, so the device work is the parent's step plus the repair."""
    rows = [tx_ops.as_rows(x) for x in (seg_k, seg_v, fast_k, fast_v)]
    new, out = unfused_tx(sel, step, n_live, fts, *rows, fig)
    for old, x in zip(fts, new):
        if x is not old:
            old.set_(x)
    return out


def plain_decode_attend(q, k, v, valid):
    """``ops.decode_attend`` with the plain version on the card."""
    return figcache_decode_ref(q[:, 0], k, v, valid)[:, None]


def plain_mha(q, k, v, *, causal=True, window=0):
    """``ops.mha`` with the plain version on the card."""
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def timed(name, kernel, plain, library, bound):
    """Device time per call (CUDA-graph replay) of the kernel, its plain
    version and the library call (or None), and the kernel's eager time."""
    k_call = time_ms(kernel)
    res = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
           "library_ms": graph_ms(library) if library else None,
           "bound_ms": bound}
    lib = "none" if library is None else f"{res['library_ms'] * 1e3:.3f} us"
    log(f"[kernels] {name}: device time (CUDA-graph replay) kernel "
        f"{res['ms'] * 1e3:.3f} us, plain {res['plain_ms'] * 1e3:.3f} us, "
        f"library {lib}; per eager call kernel {k_call * 1e3:.2f} us; bound "
        f"{bound * 1e3:.4f} us")
    return res


# ---------------------------------------------------------------------------
# phase 2: fts_lookup kernel vs plain

def lookup_case(n_lanes, n_banks, S, seed, dev, score_hi=8):
    """Random stores with many ties, all-miss lanes (seg 1000) and limits
    cycling {0, S/2, S} plus random values below and around S."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(-1, 40, (n_lanes, n_banks, S)).astype(np.int32)
    score = rng.integers(0, score_hi, (n_lanes, n_banks, S)).astype(np.int32)
    bank = rng.integers(0, n_banks, n_lanes).astype(np.int32)
    seg = rng.integers(-1, 41, n_lanes).astype(np.int32)
    seg[::5] = 1000
    limit = np.array([(0, S // 2, S)[i % 3] for i in range(n_lanes)],
                     np.int32)
    limit[3::7] = rng.integers(-2, S + 2, limit[3::7].shape)
    return [torch.from_numpy(x).to(dev)
            for x in (tags, score, bank, seg, limit)]


def lookup_bytes(n_lanes, S) -> int:
    """Bytes one lookup must move: the two selected rows and bank/seg/limit
    read once, the (N, 3) result written once."""
    return 4 * (2 * n_lanes * S + 3 * n_lanes + 3 * n_lanes)


def phase_kernels(dev):
    shapes = [(32, 16, 512), (32, 16, 1024), (32, 16, 2), (40, 4, 13),
              (33, 3, 100), (7, 1, 32)]
    max_err = 0
    for i, (n, nb, S) in enumerate(shapes):
        for score_hi in (8, 2):
            args = lookup_case(n, nb, S, seed=100 * i + score_hi, dev=dev,
                               score_hi=score_hi)
            got = fts_kernel.fts_lookup(*args)
            ref = fts_lookup_ref(*args)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, ref),
                  f"fts_lookup kernel != plain at N={n} banks={nb} S={S}")
            check(bool((got[:, 0] == 0).any()) and bool((args[4] <= 0).any()),
                  "case lacks an all-miss or a limit <= 0 lane")
    log(f"[kernels] fts_lookup == plain bitwise on {2 * len(shapes)} cases "
        f"(N, banks, S) in {shapes}; max_abs_err={max_err}")
    timings = {}
    for n, nb, S in ((32, 16, 512), (32, 16, 1024)):
        args = lookup_case(n, nb, S, seed=7, dev=dev)
        kernel = lambda: fts_kernel.fts_lookup(*args)  # noqa: E731
        plain = lambda: fts_lookup_ref(*args)  # noqa: E731
        k_call, p_call = time_ms(kernel), time_ms(plain)
        k_dev, p_dev = graph_ms(kernel), graph_ms(plain)
        bound = lookup_bytes(n, S) / HBM_BYTES_PER_S * 1e3
        timings[(n, nb, S)] = (k_dev, p_dev, bound)
        log(f"[kernels] fts_lookup N={n} banks={nb} S={S}: device time "
            f"(CUDA-graph replay) kernel {k_dev * 1e3:.3f} us, plain "
            f"{p_dev * 1e3:.3f} us; per eager call kernel "
            f"{k_call * 1e3:.2f} us, plain {p_call * 1e3:.2f} us; byte bound "
            f"{bound * 1e3:.4f} us")
    return max_err, timings


# ---------------------------------------------------------------------------
# phase 2: figaro_reloc kernel vs plain

def figkv_geometry():
    cfg = configs.get(FIGKV_ARCH)
    fig = cfg.figkv
    s_max = FIGKV_PROMPT + FIGKV_GEN + fig.seg_tokens
    return cfg, fig, s_max, s_max // fig.seg_tokens


def reloc_case(dtype, g, n_segs, n_slots, E, pad, seed, dev):
    """A pool seen through a strided view (group and segment strides padded
    by ``pad`` elements, as FIGCache-KV's slice of its slow pool), a fast
    pool, two moves per group with one masked (src -1, dst -1 or both)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randint(-100, 100, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    pool = rand(g, n_segs + 1, E + pad)[:, 1:, :E]
    fast = rand(g, n_slots, E)
    src = torch.randint(0, n_segs, (g, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.stack([torch.randperm(n_slots, generator=gen, device=dev)[:2]
                       for _ in range(g)]).to(torch.int32)
    src[0, 1] = -1
    dst[g - 1, 0] = -1
    return pool, fast, src, dst


def phase_reloc(dev):
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        # a 16-token Qwen2-7B KV segment, an embedding segment of 16 rows x
        # 3584, a ragged payload and a single element
        for E in (16 * 4 * 128, 3584 * 16, 100, 1):
            for pad in (0, 3):
                pool, fast, src, dst = reloc_case(dtype, 3, 7, 5, E, pad,
                                                  seed=E + pad, dev=dev)
                want = reloc_ref(pool, fast.clone(), src, dst)
                got = reloc_kernel.reloc(pool, fast, src, dst)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"figaro_reloc kernel != plain "
                      f"at {dtype} E={E} pad={pad}")
                n += 1
    log(f"[kernels] figaro_reloc == plain bitwise on {n} cases (f32/bf16/"
        "int8 x E in {8192, 57344, 100, 1} x aligned/strided pools, masked "
        "moves); max_abs_err=0")
    # one FIGCache-KV step's K relocation: a (B, n_segs, E) view of the
    # bf16 slow pool, one move per sequence
    cfg, fig, s_max, n_segs = figkv_geometry()
    B, st, hkv, d = FIGKV_BATCH, fig.seg_tokens, cfg.n_kv_heads, cfg.hd
    slots = fig.fast_rows * fig.segs_per_row
    pool = torch.randn((B, s_max, hkv, d), dtype=torch.bfloat16, device=dev)
    fast = torch.zeros((B, slots, st, hkv, d), dtype=torch.bfloat16,
                       device=dev)
    segs = pool[:, :n_segs * st].view(B, n_segs, st, hkv, d)
    src = torch.randint(0, n_segs, (B, 1), device=dev, dtype=torch.int32)
    dst = torch.randint(0, slots, (B, 1), device=dev, dtype=torch.int32)
    p3, f3, s2, d2 = segment_rows(segs, fast, src, dst)
    groups = torch.arange(B, device=dev)
    s_l, d_l = src[:, 0].long(), dst[:, 0].long()
    seg_bytes = st * hkv * d * 2
    bound = 2 * B * seg_bytes / HBM_BYTES_PER_S * 1e3       # read + write
    res = timed(f"figaro_reloc B={B} moves of {seg_bytes} bytes (one step's "
                "K; library = fast[g, dst] = pool[g, src], two ops)",
                lambda: reloc_kernel.reloc(p3, f3, s2, d2),
                lambda: reloc_ref(p3, f3, s2, d2),
                lambda: f3.index_put_((groups, d_l), p3[groups, s_l]), bound)
    log(f"[kernels] figaro_reloc byte bound of one decode step's K+V "
        f"relocation (2 launches, {2 * B * seg_bytes} bytes read and "
        f"written): {2 * bound * 1e3:.4f} us")
    res.update(max_abs_err=0, bound_by="bytes")
    return res


# ---------------------------------------------------------------------------
# phase 2: figkv_tx kernel vs plain

# Dependent round trips of one sequence's transaction (csrc/figkv_tx.cu with
# figkv_tx.cuh) on the figkv path (RowBenefit, a full store whose bitvector
# still marks a slot: 7 inserts in 8), counted from the code in issue
# order.  A floor: the launch, the two __syncthreads() and the bulk copies
# are left out, and so is the argmin over row_sum when the bitvector runs
# out.  The row_sum adds are atomics whose result nobody reads, and the
# block leaves once its bulk stores have read shared memory: neither is a
# round trip.
#   l2    the selected id with the row of tags and valid bits (independent
#         loads, one trip); the hit slot's benefit (touch); n_valid, then
#         the RowBenefit row and bitvector (victim_scan branches on the
#         first); the victim row's benefits (insert's gather);
#   l1    the selected id reread after the barrier (insert_candidate); the
#         victim slot's benefit (b0, after the in-row argmin);
#   shfl  the lookup's ballot and its shuffle.
FIGKV_CHAIN = {"l2": 5, "l1": 2, "shfl": 2}


def tx_state(policy, dev, mixed=True, seed=0):
    """A full, evicting FIGCache-KV tag store per sequence at the figkv
    shape (8 sequences, 512 slots in rows of 8, Qwen2-7B's 16-token bf16
    segments), with its fast pools, random slow pools seen through the
    strided segment views ``kv_cache`` makes, and one step's selection (8
    distinct ids a row: 4 hits, 4 misses).

    Each store holds 512 distinct live ids, benefits 2..benefit_max (the
    row sums theirs), LRU stamps below the step and a RowBenefit row with a
    bitvector.  Sequences 0-3 hit the very slot the step's insert takes (a
    benefit of 0 in the marked row, the SegmentBenefit minimum, or the
    Random hash's slot; under LRU a touched slot is never the victim);
    sequence 4's bitvector is exhausted (the row_sum argmin).  With
    ``mixed``, sequence 5 hits on all 8 ids (no insert), 6 has 3 free
    slots and 7's misses are all incomplete segments (no insert).
    Returns (fig, fts, (seg_k, seg_v, fast_k, fast_v) as (B, rows, E),
    sel, step, n_live)."""
    cfg, fig, s_max, n_segs = figkv_geometry()
    fig = dataclasses.replace(fig, policy=policy)
    B, st, hkv, d = FIGKV_BATCH, fig.seg_tokens, cfg.n_kv_heads, cfg.hd
    spr, S = fig.segs_per_row, fig.fast_rows * fig.segs_per_row
    bmax = (1 << fig.benefit_bits) - 1
    step, n_live = FIGKV_PROMPT + 100, n_segs - 8
    rng = np.random.default_rng(seed)
    tags = np.empty((B, S), np.int32)
    valid = np.ones((B, S), bool)
    benefit = rng.integers(2, bmax + 1, (B, S)).astype(np.int32)
    last_use = rng.integers(0, step, (B, S)).astype(np.int32)
    free_list = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    n_valid = np.full(B, S, np.int32)
    evict_row = rng.integers(0, fig.fast_rows, B).astype(np.int32)
    evict_mask = rng.random((B, spr)) < 0.5
    evict_mask[:, 3] = True
    evict_row[4] = -1
    h = ((step * 1103515245 + 12345) & 0x7FFFFFFF) % S
    sel = np.empty((B, FIGKV_N_SEL), np.int32)
    for b in range(B):
        perm = rng.permutation(n_live).astype(np.int32)
        tags[b] = perm[:S]
        hits = rng.choice(S, 8, replace=False)
        forced = {"row_benefit": evict_row[b] * spr + 3,
                  "segment_benefit": hits[0], "random": h,
                  "lru": hits[0]}[policy]
        if b < 4:
            if policy in ("row_benefit", "segment_benefit"):
                benefit[b, forced] = 0
            hits = np.concatenate([[forced], hits[hits != forced]])
        misses = perm[S:S + 4]
        if mixed and b == 6:
            free = hits[4:7]
            free_list[b] = np.concatenate(
                [np.setdiff1d(np.arange(S), free), free])
            n_valid[b] = S - 3
            valid[b, free], tags[b, free], benefit[b, free] = False, -1, 0
            hits = hits[:4]
        if mixed and b == 7:
            misses = np.arange(n_live, n_segs, 2, dtype=np.int32)[:4]
        row = tags[b, hits[:8 if mixed and b == 5 else 4]]
        ids = np.concatenate([row, misses])[:FIGKV_N_SEL]
        sel[b] = ids[rng.permutation(FIGKV_N_SEL)]
    row_sum = np.zeros((B, S), np.int32)
    row_sum[:, :S // spr] = benefit.reshape(B, S // spr, spr).sum(-1)
    fts = fts_lib.FTS(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                        for x in (tags, valid, np.zeros((B, S), bool),
                                  benefit, last_use, evict_row, evict_mask,
                                  np.full((B, 256), -1, np.int32),
                                  np.zeros((B, 256), np.int32), row_sum,
                                  free_list, n_valid)])
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for _ in range(2):
        pool = torch.randn((B, s_max, hkv, d), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        rows.append(pool[:, :n_segs * st].view(B, n_segs, st * hkv * d))
    for _ in range(2):
        rows.append(torch.randn((B, S, st * hkv * d), generator=gen,
                                device=dev, dtype=torch.bfloat16))
    return (fig, fts, tuple(rows), torch.from_numpy(sel).to(dev), step,
            n_live)


def tx_bytes(fts, sel, ins_seg, ins_slot, fig, seg_bytes) -> int:
    """Bytes one launch must move, counted for each sequence from the
    branch its pre-step state ``fts`` takes, each entry read once and each
    written once: the selection read and the slot map, ``ins_seg`` and
    ``ins_slot`` written; the tags and valid bits the lookups scan (the
    whole row once an id misses); each hit's benefit, LRU stamp and
    row_sum entry.  An insert adds the store's fill count, then the
    free-stack top (and the count written), or the policy's victim search:
    RowBenefit's marked row and the live part of its bitvector, the live
    row_sum entries only when the bitvector is exhausted, and the victim
    row's benefits; SegmentBenefit's benefit row; LRU's stamp row; Random
    reads nothing.  Then the slot's leaves and row_sum entry, and the K
    and V rows read and written."""
    f = fts_lib.FTS(*[x.cpu().numpy() for x in fts])
    sel, ins_seg, ins_slot = (x.cpu().numpy()
                              for x in (sel, ins_seg, ins_slot))
    B, S = f.tags.shape
    spr = fig.segs_per_row
    item = {name: x.dtype.itemsize for name, x in zip(f._fields, f)}
    total = 0
    for b in range(B):
        rd, wr = {k: set() for k in item}, {k: set() for k in item}
        hits = []
        for seg in sel[b]:
            m = np.flatnonzero((f.tags[b] == seg) & f.valid[b])
            if m.size:
                hits.append(int(m[0]))
        n_scan = S if len(hits) < len(sel[b]) else max(hits) + 1
        rd["tags"].update(range(n_scan))
        rd["valid"].update(range(n_scan))
        for s in hits:
            rd["benefit"].add(s)
            wr["benefit"].add(s)
            wr["last_use"].add(s)
            rd["row_sum"].add(s // spr)
            wr["row_sum"].add(s // spr)
        slot = int(ins_slot[b])
        if ins_seg[b] >= 0:
            nv = int(f.n_valid[b])
            rd["n_valid"].add(0)
            if nv < S:
                rd["free_list"].add(min(max(nv, 0), S - 1))
                wr["n_valid"].add(0)
            elif fig.policy == "row_benefit":
                rd["evict_row"].add(0)
                wr["evict_row"].add(0)
                rd["evict_mask"].update(range(spr))
                wr["evict_mask"].update(range(spr))
                if f.evict_row[b] < 0 or not f.evict_mask[b, :spr].any():
                    rd["row_sum"].update(range(-(-S // spr)))
                row = slot // spr
                rd["benefit"].update(min(max(row * spr + j, 0), S - 1)
                                     for j in range(spr))
            elif fig.policy == "segment_benefit":
                rd["benefit"].update(range(S))
            elif fig.policy == "lru":
                rd["last_use"].update(range(S))
            rd["benefit"].add(slot)
            for k in ("tags", "valid", "dirty", "benefit", "last_use"):
                wr[k].add(slot)
            rd["row_sum"].add(slot // spr)
            wr["row_sum"].add(slot // spr)
            total += 4 * seg_bytes
        total += sum(item[k] * (len(rd[k]) + len(wr[k])) for k in item)
        total += 4 * 2 * len(sel[b]) + 8
    return total


def flat_fts(fts):
    """A copy of ``fts`` whose leaves are views of one byte buffer (each
    leaf at a 16-byte offset), and the buffer: one copy restores them."""
    offs, n = [], 0
    for x in fts:
        offs.append(n)
        n += -(-x.numel() * x.element_size() // 16) * 16
    buf = torch.empty(n, dtype=torch.uint8, device=fts.tags.device)
    leaves = []
    for x, o in zip(fts, offs):
        v = buf[o:o + x.numel() * x.element_size()].view(x.dtype).view(
            x.shape)
        v.copy_(x)
        leaves.append(v)
    return fts_lib.FTS(*leaves), buf


def phase_figkv_tx(dev, lat):
    """figkv_tx against its plain version, bitwise, for each policy on the
    full stores of ``tx_state``: the crafted step, then 7 more steps with
    4 hits and 4 random live ids a row; then its device time at the figkv
    shape beside its bounds and the unfused composition's."""
    repaired, n_steps = {}, 8
    for policy in tx_kernel.POLICIES:
        fig, fts, rows, sel, step, n_live = tx_state(policy, dev)
        plain = fts_lib.FTS(*[x.clone() for x in fts])
        prow = rows[:2] + tuple(x.clone() for x in rows[2:])
        rng = np.random.default_rng(1)
        repaired[policy] = 0
        for t in range(n_steps):
            before = fts_lib.FTS(*[x.clone() for x in plain])
            got = tx_kernel.figkv_tx(sel, step + t, n_live, fts, *rows, fig)
            want = figkv_tx_ref(sel, step + t, n_live, plain, *prow, fig)
            torch.cuda.synchronize()
            ctx = f"figkv_tx {policy} step {t}"
            for name, x, y in zip(("slots", "ins_seg", "ins_slot"), got,
                                  want):
                check(torch.equal(x, y), f"{ctx}: {name} != plain")
            for name, x, y in zip(fts._fields, fts, plain):
                check(torch.equal(x, y), f"{ctx}: fts.{name} != plain")
            for i in (2, 3):
                check(torch.equal(rows[i], prow[i]),
                      f"{ctx}: fast pool {'KV'[i - 2]} != plain")
            hits, slots = fts_lib.lookup(before, sel)
            repaired[policy] += int((hits & (slots == want[2][:, None]))
                                    .sum())
            tags = plain.tags.cpu().numpy()
            sel = torch.from_numpy(np.stack([np.concatenate([
                rng.choice(tags[b][tags[b] >= 0], 4, replace=False),
                rng.choice(np.setdiff1d(np.arange(n_live), tags[b]), 4,
                           replace=False)]) for b in range(len(tags))]
            ).astype(np.int32)).to(dev)
        check((repaired[policy] > 0) == (policy != "lru"),
              f"figkv_tx {policy}: {repaired[policy]} hits whose slot the "
              "insert took (expected some, none under LRU)")
        del fts, rows, plain, prow
    log(f"[kernels] figkv_tx == plain bitwise (every FTS leaf, both fast "
        f"pools, slot map, inserted segment and slot) on {n_steps} steps "
        f"of full, evicting stores at the figkv shape for each policy; hits "
        f"whose slot the same step's insert took (read from the slow pool): "
        f"{repaired}; max_abs_err=0")

    # device time at the figkv shape, every sequence inserting: the FTS
    # leaves are restored before each launch (one copy of their flat
    # buffer), and the restore's own time is taken off
    fig, fts, rows, sel, step, n_live = tx_state("row_benefit", dev,
                                                 mixed=False)
    fts, buf = flat_fts(fts)
    saved = buf.clone()
    _, ins_seg, ins_slot = figkv_tx_ref(sel, step, n_live, fts, *rows, fig)
    n_insert = int((ins_seg >= 0).sum())
    buf.copy_(saved)
    seg_bytes = rows[0].shape[2] * rows[0].element_size()
    n_bytes = tx_bytes(fts, sel, ins_seg, ins_slot, fig, seg_bytes)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    chain_ns = sum(n * lat[k] for k, n in FIGKV_CHAIN.items())

    def run(tx):
        def fn():
            buf.copy_(saved)
            tx(sel, step, n_live, fts, *rows, fig)
        return fn

    restore = graph_ms(lambda: buf.copy_(saved))
    res = {"restore_ms": restore,
           "with_restore_ms": graph_ms(run(tx_kernel.figkv_tx)),
           "plain_with_restore_ms": graph_ms(run(figkv_tx_ref)),
           "unfused_with_restore_ms": graph_ms(run(unfused_tx)),
           "eager_call_ms": time_ms(run(tx_kernel.figkv_tx)) - time_ms(
               lambda: buf.copy_(saved))}
    res.update(ms=res["with_restore_ms"] - restore,
               plain_ms=res["plain_with_restore_ms"] - restore,
               unfused_ms=res["unfused_with_restore_ms"] - restore,
               bound_ms=bound, bound_by="bytes",
               chain_bound_ms=chain_ns * 1e-6, library_ms=None,
               max_abs_err=0, n_bytes=n_bytes, repaired=repaired)
    log(f"[kernels] figkv_tx B={FIGKV_BATCH} S={fts.tags.shape[1]} "
        f"n_sel={sel.shape[1]} rows of {seg_bytes} bytes, {n_insert} "
        f"inserts (RowBenefit, full stores): device time (CUDA-graph replay, "
        f"restore {restore * 1e3:.3f} us taken off) kernel "
        f"{res['ms'] * 1e3:.3f} us, plain {res['plain_ms'] * 1e3:.3f} us, "
        f"unfused composition (torch transaction + 2 figaro_reloc) "
        f"{res['unfused_ms'] * 1e3:.3f} us; per eager call kernel "
        f"{res['eager_call_ms'] * 1e3:.2f} us; byte bound "
        f"{bound * 1e3:.4f} us ({n_bytes} bytes); chain bound "
        f"{chain_ns / 1e3:.4f} us (" + " + ".join(
            f"{n} {k}" for k, n in FIGKV_CHAIN.items()) + ")")
    del fts, rows, buf, saved
    return res


# ---------------------------------------------------------------------------
# phase 2: figcache_decode kernel vs plain

def decode_case(B, H, hkv, L, D, dtype, seed, dev):
    """q/k/v from N(0, 1); ~60 % valid, entry 0 valid, except sequence 0
    (one valid entry) and the last sequence (fully masked) when B > 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    valid = torch.rand((B, L), generator=gen, device=dev) < 0.6
    valid[:, 0] = True
    if B > 1:
        valid[0] = False
        valid[0, L // 2] = True
        valid[B - 1] = False
    return rand(B, H, D), rand(B, L, hkv, D), rand(B, L, hkv, D), valid


def decode_bytes(B, H, hkv, L, D, item):
    """q read, K and V read once, the mask read, out written."""
    return 2 * B * H * D * item + 2 * B * L * hkv * D * item + B * L


def phase_decode(dev):
    cfg, fig, _, _ = figkv_geometry()
    H, hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = FIGKV_N_SEL * fig.seg_tokens + 2 * fig.seg_tokens   # 160
    # (B, H, Hkv, L, D, splits or None for the plan's): the figkv shape and
    # three older cases; L = 1; L < splits (forced); ragged L; long L (many
    # ring chunks per split); D 16 / 256 / 512; groups of 1, 7, 8 and 12
    # query heads (two head tiles); D whose rows are not whole 16-byte
    # vectors (plain copies in place of bulk copies)
    shapes = [(FIGKV_BATCH, H, hkv, L, D, None), (2, 4, 4, 512, 64, None),
              (1, 8, 8, 256, 128, None), (3, 2, 2, 384, 64, None),
              (2, 7, 1, 1, 128, None), (2, 8, 1, 3, 64, 8),
              (3, 7, 1, 37, 128, None), (FIGKV_BATCH, H, hkv, 161, D, None),
              (FIGKV_BATCH, H, hkv, 8192, D, None),
              (2, 8, 2, 300, 16, None), (2, 4, 1, 200, 256, None),
              (2, 8, 1, 100, 512, None), (1, 8, 1, 2048, 512, None),
              (2, 12, 1, 50, 64, None), (2, 4, 2, 70, 100, None),
              (2, 3, 1, 9, 1, None)]
    max_err = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for i, (B, h, g, length, d, splits) in enumerate(shapes):
            args = decode_case(B, h, g, length, d, dtype, seed=i, dev=dev)
            got = decode_kernel.figcache_decode(*args, splits=splits)
            want = figcache_decode_ref(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            p = decode_kernel.plan(B, h, g, length, d, args[0].element_size(),
                                   splits)
            check(err <= tol, f"figcache_decode kernel vs plain {err} > {tol}"
                  f" at {dtype} (B, H, Hkv, L, D)={(B, h, g, length, d)}, "
                  f"{p}")
            if B > 1:   # the one-valid row and the fully masked row
                v = args[2].float()
                one = v[0, length // 2].repeat_interleave(h // g, dim=0)
                mean = v[B - 1].mean(dim=0).repeat_interleave(h // g, dim=0)
                check(float((got[0].float() - one).abs().max()) <= tol
                      and float((got[B - 1].float() - mean).abs().max())
                      <= 2 * tol, "figcache_decode: one-valid / fully masked "
                      f"rows do not return v / mean(v) at {(B, h, g, length, d)}")
    log(f"[kernels] figcache_decode within f32 2e-5 / bf16 2e-2 of plain on "
        f"{2 * len(shapes)} cases (B, H, Hkv, L, D, forced splits) in "
        f"{shapes}, with a one-valid row (its valid key at L // 2) and a "
        f"fully masked row; max_abs_err={max_err:.3g}")
    B = FIGKV_BATCH
    q, k, v, valid = decode_case(B, H, hkv, L, D, torch.bfloat16, seed=7,
                                 dev=dev)
    valid[0, 0] = valid[B - 1, 0] = True    # SDPA needs a valid entry per row
    p = decode_kernel.plan(B, H, hkv, L, D, 2)
    log(f"[kernels] figcache_decode plan at the figkv shape: {p.splits} "
        f"splits of {L} keys (cluster size {p.splits}), {p.tiles} head "
        f"tile(s) of {H // hkv} query heads, grid {p.blocks} blocks of 256 "
        f"threads, {p.chunk} keys x {p.stages} ring stage(s), "
        f"{decode_kernel.smem_bytes(H, hkv, L, D, torch.bfloat16, p)} bytes "
        "of shared memory per block")
    qs = q[:, :, None]
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = decode_bytes(B, H, hkv, L, D, 2)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * L * D / BF16_FLOP_PER_S * 1e3
    res = timed(f"figcache_decode bf16 B={B} H={H} Hkv={hkv} L={L} D={D} "
                f"({n_bytes} bytes; library = SDPA, bool mask, GQA)",
                lambda: decode_kernel.figcache_decode(q, k, v, valid),
                lambda: figcache_decode_ref(q, k, v, valid),
                lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True),
                max(t_bytes, t_ops))
    sweep = {s: graph_ms(lambda s=s: decode_kernel.figcache_decode(
        q, k, v, valid, splits=s)) for s in range(1, 9)}
    log("[kernels] figcache_decode device time by split count at the figkv "
        "shape: " + ", ".join(f"{s}: {t * 1e3:.3f} us"
                              for s, t in sweep.items()))
    res.update(max_abs_err=max_err,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return res


# ---------------------------------------------------------------------------
# phase 3: golden pins

def reuse_trace(n=320):
    """tests/test_obs.py:_reuse_trace() as numpy arrays."""
    idx = np.arange(n)
    return dram.Trace(t_issue=(idx * 16).astype(np.int32),
                      bank=(idx % 3).astype(np.int32),
                      row=((idx * 7) % 13).astype(np.int32),
                      col=((idx * 13) % 128).astype(np.int32),
                      is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))


def golden_config(mech, sc):
    kw = {"cache_rows": 2} if timing.paper_config(mech).has_cache else {}
    return timing.paper_config(mech, sched=sc, **kw)


def interior_noop_trace():
    """tests/test_streaming.py:_interior_noop_trace() as numpy arrays."""
    parts = []
    for blk in range(3):
        idx = np.arange(40) + blk * 40
        parts.append(dram.Trace(t_issue=idx * 24, bank=idx % 5,
                                row=(idx * 11) % 97, col=(idx * 3) % 128,
                                is_write=idx % 4 == 0, core=idx % 8))
        if blk < 2:
            parts.append(dram.noop_pad(dram.Trace(*[np.zeros(0, int)] * 6),
                                       8))
    return dram.Trace(*[np.concatenate(xs).astype(
        bool if f == "is_write" else np.int32)
        for f, xs in zip(dram.Trace._fields, zip(*parts))])


def fingerprint(cnt):
    return tuple(int(x.sum()) for x in cnt)


def phase_golden(dev):
    tr = reuse_trace()
    t0 = time.perf_counter()
    eager = dram._advance_eager
    routes = (("replay kernel", {}),
              ("eager loop, lookup kernel", {"_advance": eager}),
              ("eager loop, plain lookup",
               {"_advance": eager, "fts_lookup_op": plain_lookup_op}))
    n = 0
    for mech in simulator.PAPER_MECHS:
        want = GOLDEN[(mech, "fcfs")]
        cfg = golden_config(mech, timing.SCHED_FCFS)
        for route, patch in routes:
            before = scan_kernel.COUNTER.launches
            with patched(dram, **patch):
                cnt = dram.run_channel(tr, cfg, device=dev)
            got = fingerprint(cnt)
            check(got == want, f"golden {mech} ({route}): {got} != {want}")
            check(scan_kernel.COUNTER.launches - before ==
                  (1 if route == "replay kernel" else 0),
                  f"golden {mech} ({route}): sim_scan launch count")
            n += 1
    log(f"[golden] {n}/18 FCFS fingerprints match tests/test_obs.py GOLDEN "
        f"through the replay kernel, the eager loop with the lookup kernel "
        f"and the eager loop with its plain version "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 4: the main path

def run_grid(wls, dev):
    """``run_eight_core_batch`` over ``wls``: the results, the wall time,
    each static group's (mechanism, trace shape, synchronised wall s) and
    the launches of the replay and lookup kernels, counted from 0 just
    before the run and read just after it."""
    groups = []
    real_run_sweep = dram.run_sweep

    def timed_run_sweep(trace, static, params, variant="fused", device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run_sweep(trace, static, params, variant, device)
        torch.cuda.synchronize()
        groups.append((static.mechanism, np.shape(trace.t_issue),
                       time.perf_counter() - t0))
        return out

    with patched(dram, run_sweep=timed_run_sweep):
        scan_kernel.COUNTER.launches = 0
        fts_kernel.COUNTER.launches = 0
        t0 = time.perf_counter()
        res = simulator.run_eight_core_batch(wls, per_channel=PER_CHANNEL,
                                             device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sim_scan": scan_kernel.COUNTER.launches,
                    "fts_lookup": fts_kernel.COUNTER.launches}
    return res, wall, groups, launches


def log_groups(label, groups):
    for mech, shape, secs in groups:
        lanes, steps = shape[0], shape[1]
        log(f"[main]   {label} group {mech:15s} lanes={lanes} steps={steps} "
            f"wall={secs:.4f} s  {steps / secs:.0f} steps/s  "
            f"{steps * lanes / secs:.0f} request-lanes/s")


def phase_main(dev):
    wl_idx = list(FIG8_WORKLOADS)
    all_wl = traces.eight_core_workloads()
    wls = [all_wl[i] for i in wl_idx]
    cached = [m for m in simulator.PAPER_MECHS
              if timing.paper_config(m).has_cache]
    n_mech = len(simulator.PAPER_MECHS)

    # the main path: one sim_scan launch per static group, no lookup launch
    res, wall, groups, launches = run_grid(wls, dev)
    log(f"[main] run_eight_core_batch through the replay kernel: "
        f"{len(wls)} workloads x {N_CHANNELS} channels x {PER_CHANNEL} "
        f"requests x {n_mech} mechanisms in {wall:.3f} s; launches "
        f"sim_scan {launches['sim_scan']}, fts_lookup "
        f"{launches['fts_lookup']}")
    check(launches == {"sim_scan": n_mech, "fts_lookup": 0},
          f"kernel run launched {launches}, expected sim_scan {n_mech} (one "
          f"per static group) and no fts_lookup")
    log_groups("kernel", groups)
    for w, r in zip(wl_idx, res):
        for m, x in r.items():
            check(x.ipc.shape == (8,) and np.isfinite(x.ipc).all()
                  and (x.ipc > 0).all() and np.isfinite(x.system_energy_nj),
                  f"workload {w} {m}: non-finite or empty result")
            n_req = int(x.counters.reads.sum() + x.counters.writes.sum())
            check(0 < n_req <= N_CHANNELS * PER_CHANNEL
                  and n_req == int(x.counters.req_cnt.sum()),
                  f"workload {w} {m}: request count {n_req}")
    avg = {m: float(np.mean([simulator.speedup_summary(r)[m] for r in res]))
           for m in simulator.PAPER_MECHS}
    log("[main] mean weighted speedup vs base over the workloads: " +
        ", ".join(f"{m}={v:.4f}" for m, v in avg.items()))

    # the same grid through the eager loop (the kernel's plain version, one
    # fts_lookup launch per cached step): every counter bitwise
    with patched(dram, _advance=dram._advance_eager):
        res_e, wall_e, groups_e, launches_e = run_grid(wls, dev)
    log(f"[main] the same grid through the eager loop: {wall_e:.3f} s "
        f"(replay kernel {wall:.3f} s, {wall_e / wall:.1f}x); launches "
        f"sim_scan {launches_e['sim_scan']}, fts_lookup "
        f"{launches_e['fts_lookup']}")
    check(launches_e == {"sim_scan": 0,
                         "fts_lookup": len(cached) * PER_CHANNEL},
          f"eager run launched {launches_e}, expected fts_lookup "
          f"{len(cached)} x {PER_CHANNEL} and no sim_scan")
    log_groups("eager ", groups_e)
    max_err = 0
    for w, a_r, b_r in zip(wl_idx, res, res_e):
        for m in simulator.PAPER_MECHS:
            for f, a, b in zip(dram.Counters._fields, a_r[m].counters,
                               b_r[m].counters):
                max_err = max(max_err, int(np.abs(
                    a.astype(np.int64) - b.astype(np.int64)).max()))
                check(np.array_equal(a, b), f"workload {w} {m} {f}: replay "
                      f"kernel differs from the eager loop")
    log(f"[main] replay kernel == eager loop bitwise on every counter of "
        f"{len(wls)} workloads x {n_mech} mechanisms; max_abs_err={max_err}")

    # workload 15 alone through the eager loop with the plain lookup:
    # bitwise equal to its slice of the kernel run.  Only the cached
    # mechanisms reach the lookup, so only they rerun.
    before = fts_kernel.COUNTER.launches, scan_kernel.COUNTER.launches
    t0 = time.perf_counter()
    with patched(dram, _advance=dram._advance_eager,
                 fts_lookup_op=plain_lookup_op):
        alone = simulator.run_eight_core(all_wl[15], mechanisms=cached,
                                         per_channel=PER_CHANNEL, device=dev)
    check((fts_kernel.COUNTER.launches, scan_kernel.COUNTER.launches) ==
          before, "plain-lookup rerun launched a kernel")
    batch = res[wl_idx.index(15)]
    for m in cached:
        for f, a, b in zip(dram.Counters._fields, alone[m].counters,
                           batch[m].counters):
            check(np.array_equal(a, b), f"wl15 {m} {f}: plain rerun "
                  "differs from the kernel batch")
    log(f"[main] workload 15 rerun alone through the eager loop with the "
        f"plain lookup for {cached}: counters bitwise equal to its slice of "
        f"the kernel run ({time.perf_counter() - t0:.1f} s)")
    eager_s = {m: secs for m, _, secs in groups_e}
    return {"launches": launches, "eager_launches": launches_e,
            "max_abs_err": max_err, "eager_group_s": eager_s,
            "kernel_wall": wall, "eager_wall": wall_e}


# The leaves one replay reads without writing them: the trace, the
# params and the free list (commit() never stores it); an uncached
# mechanism touches no FTS leaf at all.
READ_ONLY_STATE = ("fts.free_list",)


def state_bytes(tr, lp, bank, cnt, has_cache) -> int:
    """Bytes one replay must move: the trace, params and read-only leaves
    read once, every leaf it updates read once and written once."""
    n = 0
    for x in (*tr, *lp):
        n += x.numel() * x.element_size()
    for name, x in scan_kernel._leaves(bank, cnt):
        if name.startswith("fts.") and not has_cache:
            continue
        n += x.numel() * x.element_size() * (
            1 if name in READ_ONLY_STATE else 2)
    return n


# Dependent round trips of one replay step (csrc/sim_scan.cu with
# sim_step.cuh), counted from the code in issue order.  Only what every
# step does is counted, so the count is a floor: the RowBenefit victim
# row's mask rewrite on an insert into a full row and the first step's
# clamp of every core are left out.
#   l2    the step's trace row (six loads, one trip): each step is a new
#         line for every lane, which no other lane's SM has in its L1;
#   l1    cached (all four use RowBenefit): the bank row scan
#         (fts_lookup_warp), the gather of the victim row's benefit (it
#         needs the scan's argmin), the written slot's tag, valid, dirty,
#         benefit and last_use (they need the victim), and in commit() the
#         reload of segs_per_row that row_sum's index needs (the earlier
#         stores may alias it); uncached: mshr_idx, then the ring entry it
#         names;
#   shfl  cached: the lookup's five shuffle stages;
#   rmw   commit()'s read-modify-writes, each load kept below the previous
#         store (the pointers may alias): row_sum and n_valid (cached), then
#         lat_sum_ns, req_cnt and the ten per-lane counters.
CHAIN = {True: {"l2": 1, "l1": 4, "shfl": 5, "rmw": 14},
         False: {"l2": 1, "l1": 2, "shfl": 0, "rmw": 12}}


def probe_latencies(dev, samples=5):
    """ns per dependent round trip on this card (csrc/latency_probe.cu):
    an L1 hit (a 128-line cycle, 16 KB), an L2 hit (a 65536-line cycle,
    8 MB: over the 256 KB L1, under the 50 MB L2), a load of a line the
    thread stored one iteration before, and a warp shuffle.  Each is the
    median over ``samples`` of (time of 2k steps - time of k) / k."""
    lib = _build.load("latency_probe")
    fn = lib.latency_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def cycle(n_lines, seed):
        words = 32                                   # 128-byte lines
        order = np.random.default_rng(seed).permutation(n_lines)
        buf = np.zeros(n_lines * words, np.int32)
        buf[order * words] = np.roll(order, -1) * words
        return torch.from_numpy(buf).to(dev)

    def ns_per_step(buf, mode, k, per_step=1):
        def run(steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            check(fn(buf.data_ptr(), out.data_ptr(), steps, mode, stream)
                  == 0, f"latency probe mode {mode} failed to launch")
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        run(k)                                       # warm the lines
        per = [(run(2 * k) - run(k)) * 1e6 / k / per_step
               for _ in range(samples)]
        return statistics.median(per)

    words = torch.zeros(64, dtype=torch.int32, device=dev)
    lat = {"l1": ns_per_step(cycle(128, 0), 0, 1 << 16),
           "l2": ns_per_step(cycle(1 << 16, 1), 0, 1 << 14),
           "rmw": ns_per_step(words, 1, 1 << 15, per_step=2),
           "shfl": ns_per_step(words, 2, 1 << 16)}
    log("[scan] dependent round trips on this card (latency_probe, median "
        "of 5): " + ", ".join(f"{k} {v:.2f} ns" for k, v in lat.items()))
    return lat


def scan_launch_ms(flat, cfg, dev, tel_period=0):
    """Device ms of one sim_scan launch (CUDA events around the launch
    alone) replaying ``flat`` under ``cfg``, on a fresh clone of the
    initial state, with the telemetry instantiation at ``tel_period``
    (0: off).  Returns (ms, the lane-layout inputs)."""
    static = dataclasses.replace(cfg.static, telemetry=tel_period)
    params = timing.stack_params([cfg.params(device=dev)])
    state = dram.sim_init(static, channels=flat.t_issue.shape[0],
                          device=dev)
    tr, lp, st = dram._prepare(flat, params, state, dev)
    tel = dram._open(static, st, tr.t_issue.shape[0])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    scan_kernel.sim_scan(tr, lp, st.bank, st.cnt, static, dram.GEOM, tel)
    b.record()
    b.synchronize()
    return a.elapsed_time(b), (tr, lp, st, tel)


def tel_ring_bytes(tel) -> int:
    """Bytes the telemetry instantiation adds to a launch's traffic: the
    packed carry (open window, planes, closed count) read and written
    once, the ring written once."""
    n = sum(x.numel() * x.element_size() for x in tel)
    ring = sum(x.numel() * x.element_size()
               for x in (tel.buf_scalars, tel.buf_banks, tel.buf_hist))
    return 2 * (n - ring) + ring


def phase_scan_timing(dev, lat, samples=5):
    """sim_scan's device time per static group of the fig-8 grid (CUDA
    events around the launch alone, median of ``samples``, each launch on
    a fresh clone of the initial state), beside its byte bound and its
    chain bound (T x a step's dependent round trips, CHAIN, at the
    latencies ``lat`` that ``probe_latencies`` measured).  At
    figcache_fast the telemetry instantiation (period TAIL_PERIOD) is
    timed in turns with it (off, on, on, off, ...)."""
    all_wl = traces.eight_core_workloads()
    t0 = time.perf_counter()
    trs = [traces.build_trace(all_wl[i][2], N_CHANNELS, PER_CHANNEL, 2)
           for i in FIG8_WORKLOADS]
    log(f"[scan] the fig-8 grid's {len(trs)} traces built on the host (as "
        f"run_eight_core_batch builds them) in "
        f"{time.perf_counter() - t0:.3f} s")
    flat = dram.Trace(*[np.concatenate(xs) for xs in zip(*trs)])
    out = {}
    for mech in simulator.PAPER_MECHS:
        cfg = timing.paper_config(mech)
        static = cfg.static
        params = timing.stack_params([cfg.params(device=dev)])
        state = dram.sim_init(static, channels=flat.t_issue.shape[0],
                              device=dev)
        tr, lp, (bank0, cnt0, _) = dram._prepare(flat, params, state, dev)
        per = []
        for _ in range(samples):
            bank = dram.BankState(*[
                x.clone() if isinstance(x, torch.Tensor)
                else type(x)(*[y.clone() for y in x]) for x in bank0])
            cnt = dram.Counters(*[x.clone() for x in cnt0])
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            scan_kernel.sim_scan(tr, lp, bank, cnt, static, dram.GEOM)
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b))
        T, N = tr.t_issue.shape
        ms = statistics.median(per)
        n_bytes = state_bytes(tr, lp, bank0, cnt0, static.has_cache)
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        chain = CHAIN[static.has_cache]
        step_ns = sum(n * lat[k] for k, n in chain.items())
        chain_ms = T * step_ns * 1e-6
        out[mech] = {"ms": ms, "bound_ms": bound, "bytes": n_bytes,
                     "chain_ms": chain_ms, "T": T, "N": N, "samples": per}
        log(f"[scan] sim_scan {mech:15s} N={N} T={T} max_slots="
            f"{static.max_slots}: device time {ms:.4f} ms (samples "
            f"{min(per):.4f}-{max(per):.4f}), {ms / T * 1e3:.4f} us per step "
            f"per lane; byte bound {bound * 1e3:.3f} us ({n_bytes} bytes), "
            f"{ms / bound:.0f}x; chain bound {chain_ms:.4f} ms (T x "
            f"{step_ns:.1f} ns: " + " + ".join(
                f"{n} {k}" for k, n in chain.items() if n) +
            f"), {ms / chain_ms:.2f}x")
        del tr, lp, bank0, cnt0, bank, cnt
    cfg = timing.paper_config("figcache_fast")
    turns = {0: [], TAIL_PERIOD: []}
    for i in range(2 * samples):
        per = (0, TAIL_PERIOD, TAIL_PERIOD, 0)[i % 4]
        ms, (tr, _, _, tel) = scan_launch_ms(flat, cfg, dev, per)
        turns[per].append(ms)
        if per:
            ring = tel_ring_bytes(tel)
    fast = out["figcache_fast"]
    fast.update(off_turns_ms=statistics.median(turns[0]),
                tel_ms=statistics.median(turns[TAIL_PERIOD]),
                tel_samples=turns[TAIL_PERIOD], tel_bytes=ring,
                tel_bound_ms=(fast["bytes"] + ring) / HBM_BYTES_PER_S * 1e3)
    fast["tel_tax"] = fast["tel_ms"] / fast["off_turns_ms"] - 1
    log(f"[scan] sim_scan figcache_fast, telemetry at period {TAIL_PERIOD} "
        f"in turns with it off ({samples} each): on {fast['tel_ms']:.4f} ms "
        f"({min(turns[TAIL_PERIOD]):.4f}-{max(turns[TAIL_PERIOD]):.4f}), "
        f"off {fast['off_turns_ms']:.4f} ms ({min(turns[0]):.4f}-"
        f"{max(turns[0]):.4f}): tax {100 * fast['tel_tax']:.2f} %; the ring "
        f"and carry add {ring} bytes (byte bound "
        f"{fast['tel_bound_ms'] * 1e3:.3f} us); the chain bound is "
        f"unchanged (no step reads back what telemetry stores)")
    for inst in (0, 1):
        rep = _build.ptxas_report("sim_scan", f"sim_scan_kernelILb{inst}E")
        fast[f"ptxas_tel{inst}"] = rep
        log(f"[scan] ptxas, sim_scan telemetry "
            f"{'on' if inst else 'off'} instantiation: {rep['registers']} "
            f"registers, spill stores {rep['spill_stores']} B, spill loads "
            f"{rep['spill_loads']} B")
    return out


# ---------------------------------------------------------------------------
# phase 9: controllers, through sim_scan

def counted(fn, want, what):
    """``fn()``, checking that it launched sim_scan exactly ``want``
    times."""
    before = scan_kernel.COUNTER.launches
    out = fn()
    check(scan_kernel.COUNTER.launches - before == want,
          f"{what}: {scan_kernel.COUNTER.launches - before} sim_scan "
          f"launches, expected {want}")
    return out


def golden_routes(tr, cfg, dev, chunks, what):
    """The counters of ``tr`` under ``cfg`` through sim_scan, each way:
    the scheduled trace monolithic (one launch), streamed at each chunk
    length (one launch per segment) and by the wave route (one launch)."""
    n_real = int((tr.t_issue < dram.NOOP_ISSUE).sum())
    sched = policies.schedule(tr, cfg.sched)
    out = {"monolithic": counted(
        lambda: dram.run_channel(sched, cfg, device=dev), 1, what)}
    for L in chunks:
        # the scheduler re-packs the real requests into full segments, the
        # identity controller keeps the input's segments
        n_seg = -(-(n_real if not cfg.sched.is_identity
                    else tr.t_issue.shape[-1]) // L)
        out[f"chunk {L}"] = counted(lambda: streaming.simulate_stream(
            streaming.iter_chunks(tr, L), cfg, device=dev), n_seg,
            f"{what} chunk {L}")
    out["wave"] = counted(lambda: wavefront.run_channel_waves(
        sched, cfg, device=dev), 1, f"{what} wave")
    return out


def phase_controllers(dev):
    """The 24 GOLDEN fingerprints (6 mechanisms x 4 controllers) and the
    two interior no-op goldens through sim_scan, each monolithic, streamed
    and by the wave route; then the wave route held against the eager wave
    step on the card."""
    t0 = time.perf_counter()
    scan_kernel.COUNTER.launches = 0
    tr, n = reuse_trace(), 0
    for (mech, sid), want in GOLDEN.items():
        cfg = golden_config(mech, SCHEDS[sid])
        for route, cnt in golden_routes(tr, cfg, dev, (1, 7, 64, 320),
                                        (mech, sid)).items():
            check(fingerprint(cnt) == want,
                  f"golden {mech} {sid} ({route}): {fingerprint(cnt)}")
            n += 1
    holes = interior_noop_trace()
    for mech, want in INTERIOR_GOLDEN.items():
        cfg = golden_config(mech, timing.SCHED_FCFS)
        for route, cnt in golden_routes(holes, cfg, dev, (17,),
                                        mech).items():
            check(fingerprint(cnt) == want,
                  f"interior no-op golden {mech} ({route}): "
                  f"{fingerprint(cnt)}")
            n += 1
    torch.cuda.synchronize()
    launches = scan_kernel.COUNTER.launches
    secs = time.perf_counter() - t0
    log(f"[controllers] {n} fingerprints match (24 GOLDEN of "
        f"tests/test_obs.py x monolithic, streamed at 1/7/64/320 and the "
        f"wave route; 2 interior no-op goldens of tests/test_streaming.py x "
        f"monolithic, streamed at 17 and the wave route): {launches} "
        f"sim_scan launches in {secs:.1f} s")

    # the wave route (one sim_scan launch over the linearized waves)
    # against its plain version, the eager wave step, on the card
    t0 = time.perf_counter()
    sc = SCHEDS["frfcfs+drain"]
    for mech in simulator.PAPER_MECHS:
        cfg = golden_config(mech, sc)
        wtr = wavefront.form_waves(policies.schedule(tr, sc), lookahead=16)
        p = cfg.params(device=dev)
        state = dram.sim_init(cfg.static, device=dev)
        got = wavefront.resume_waves(wtr, cfg.static, p, state, device=dev)
        want = wavefront._advance_waves_eager(wtr, cfg.static, p, state, dev)
        for (name, a), (_, b) in zip(scan_kernel._leaves(got.bank, got.cnt),
                                     scan_kernel._leaves(want.bank,
                                                         want.cnt)):
            check(torch.equal(a, b), f"wave route {mech}: {name} differs "
                  "from the eager wave step")
    n_waves, width = wtr.t_issue.shape
    log(f"[controllers] wave route == eager wave step on every state leaf, "
        f"6 mechanisms under frfcfs+drain, {n_waves} waves of {width} "
        f"(lookahead 16) ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 10: a long trace, monolithic, streamed, decoded and resumed

class Killed(Exception):
    """Ends a streamed replay partway, as a killed process would."""


def killed_after(segments, n):
    for i, seg in enumerate(segments):
        if i == n:
            raise Killed
        yield seg


@contextlib.contextmanager
def host_timer(shares, key, module, name, sync=False):
    """Add the wall time of every call of ``module.name`` to
    ``shares[key]``; with ``sync``, synchronised on both sides (the call's
    device work included)."""
    fn = getattr(module, name)

    def timed(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            if sync:
                torch.cuda.synchronize()
            shares[key] = shares.get(key, 0.0) + time.perf_counter() - t0
    with patched(module, **{name: timed}):
        yield


def timed_route(fn):
    """(result, wall s, peak device bytes) of ``fn()``, synchronised; the
    peak counts what ``fn`` allocated on top of what was live before it
    (the earlier phases' tensors)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - live)


def phase_long_trace(dev):
    """One fig-8 workload at LONG_PER_CHANNEL requests per channel, all six
    mechanisms under FCFS and LONG_SCHED: ``simulator.sweep`` monolithic
    and with ``chunk_len``, ``simulate_stream`` over the decoded chunk
    codec, and a streamed run killed after its segment-3 checkpoint and
    finished by ``resume_stream``; every counter bitwise equal."""
    name, _, apps = traces.eight_core_workloads()[LONG_WORKLOAD]
    mechs = simulator.PAPER_MECHS
    cfgs = [timing.paper_config(m, sched=sc)
            for sc in (timing.SCHED_FCFS, LONG_SCHED) for m in mechs]
    t0 = time.perf_counter()
    tr = traces.build_trace(apps, N_CHANNELS, LONG_PER_CHANNEL, 2)
    build_s = time.perf_counter() - t0
    log(f"[long] workload {name}: {N_CHANNELS} channels x "
        f"{LONG_PER_CHANNEL} requests built on the host in {build_s:.3f} s")
    scan_kernel.COUNTER.launches = 0
    routes, shares = {}, {}

    with host_timer(shares, "schedule (monolithic route)", policies,
                    "schedule"):
        mono, wall, peak = timed_route(lambda: counted(
            lambda: simulator.sweep(tr, cfgs, apps, device=dev), len(cfgs),
            "long monolithic"))
    routes["monolithic"] = (wall, peak, len(cfgs))
    n_seg = LONG_PER_CHANNEL // LONG_CHUNK
    res, wall, peak = timed_route(lambda: counted(
        lambda: simulator.sweep(tr, cfgs, apps, chunk_len=LONG_CHUNK,
                                device=dev), len(cfgs) * n_seg,
        "long chunked"))
    routes[f"chunk_len={LONG_CHUNK}"] = (wall, peak, len(cfgs) * n_seg)
    got = {f"chunk_len={LONG_CHUNK}": [r.counters for r in res]}

    # the codec: each channel encoded once (the FCFS order: a scheduled
    # trace's negative deltas would end a chunk every few requests), then
    # decoded on the card segment by segment and scheduled on the host
    t0 = time.perf_counter()
    enc = [traces.encode_trace(dram.Trace(*[x[c] for x in tr]),
                               chunk_len=LONG_CHUNK)
           for c in range(N_CHANNELS)]
    shares["encode"] = time.perf_counter() - t0
    n_codec = max(len(e) for e in enc)
    (_, wall_dec, _) = timed_route(lambda: list(streaming.decoded_segments(
        enc, dev)))
    shares["decode (once)"] = wall_dec
    before = scan_kernel.COUNTER.launches
    out, wall, peak = timed_route(lambda: [dram.Counters(*[
        x.cpu().numpy() for x in streaming.simulate_stream(
            streaming.decoded_segments(enc, dev), cfg, device=dev)])
        for cfg in cfgs])
    routes["codec"] = (wall, peak, scan_kernel.COUNTER.launches - before)
    got["codec"] = out
    log(f"[long] codec: {n_codec} chunks of {LONG_CHUNK} on the longest "
        f"channel ({[len(e) for e in enc]}), "
        f"{traces.encoded_nbytes(sum(enc, []))} bytes encoded against "
        f"{sum(x.nbytes for x in tr)} raw")

    # killed after the segment-3 checkpoint, then resumed
    before = scan_kernel.COUNTER.launches
    out = []
    with host_timer(shares, "checkpoint save", checkpoint, "save_sim_state"), \
            host_timer(shares, "checkpoint restore", checkpoint,
                       "restore_sim_state"):
        def resumed():
            for cfg in cfgs:
                with tempfile.TemporaryDirectory() as d:
                    try:
                        streaming.simulate_stream(
                            killed_after(streaming.iter_chunks(
                                tr, LONG_CHUNK), LONG_KILL), cfg,
                            checkpoint_dir=d, checkpoint_every=3,
                            device=dev)
                    except Killed:
                        pass
                    else:
                        check(False, "the killed stream ran to its end")
                    check(checkpoint.committed_steps(d) == [3],
                          f"checkpoints {checkpoint.committed_steps(d)}")
                    out.append(dram.Counters(*[
                        x.cpu().numpy() for x in streaming.resume_stream(
                            streaming.iter_chunks(tr, LONG_CHUNK), cfg, d,
                            device=dev)]))
            return out
        _, wall, peak = timed_route(resumed)
    routes["killed + resumed"] = (wall, peak,
                                  scan_kernel.COUNTER.launches - before)
    got["killed + resumed"] = out
    launches = scan_kernel.COUNTER.launches

    for route, cnts in got.items():
        for cfg, ref, cnt in zip(cfgs, mono, cnts):
            for f, a, b in zip(dram.Counters._fields, ref.counters, cnt):
                check(np.array_equal(a, b), f"long {route} {cfg.mechanism} "
                      f"{cfg.sched.policy}: {f} differs from monolithic")
    for r in mono:
        check(np.isfinite(r.ipc).all() and (r.ipc > 0).all() and
              int(r.counters.req_cnt.sum()) == N_CHANNELS * LONG_PER_CHANNEL,
              f"long monolithic {r.mechanism}: empty or non-finite result")
    for route, (wall, peak, n) in routes.items():
        log(f"[long] {route:18s} wall {wall:.3f} s, peak device memory "
            f"{peak / 2**20:.2f} MiB above the live tensors before it, "
            f"sim_scan launches {n}")
    log("[long] host shares: trace build " + f"{build_s:.3f} s, " + ", ".join(
        f"{k} {v:.3f} s" for k, v in shares.items()))
    log(f"[long] monolithic, chunk_len={LONG_CHUNK}, codec and killed + "
        f"resumed routes bitwise equal on every counter of 6 mechanisms x "
        f"{{fcfs, frfcfs qd16 + drain 16}}; {launches} sim_scan launches")
    sp = {sc: simulator.speedup_summary(
        {c.mechanism: r for c, r in zip(cfgs, mono) if c.sched == sc})
        for sc in (timing.SCHED_FCFS, LONG_SCHED)}
    for sc, s in sp.items():
        log(f"[long] speedup vs base under {sc.policy}"
            f"{' + drain' if sc.write_drain else ''}: " +
            ", ".join(f"{m}={v:.4f}" for m, v in s.items()))
    return {"launches": launches, "routes": routes, "shares": shares,
            "build_s": build_s, "trace": tr}


# ---------------------------------------------------------------------------
# phase 11: fig 16's controller grid

def phase_controller_grid(dev):
    """Five controllers x {base, figcache_fast} on two workloads through
    ``simulator.sweep`` (one sim_scan launch per group); one group of one
    workload at FIG16_EAGER_PER_CHANNEL held against the eager loop."""
    all_wl = traces.eight_core_workloads()
    cfgs = [timing.paper_config(m, sched=sc) for _, sc in FIG16_SCHEDS
            for m in ("base", "figcache_fast")]
    t0 = time.perf_counter()
    trs = {w: traces.build_trace(all_wl[w][2], N_CHANNELS, FIG16_PER_CHANNEL,
                                 2) for w in FIG16_WORKLOADS}
    build_s = time.perf_counter() - t0
    shares = {}
    scan_kernel.COUNTER.launches = 0
    with host_timer(shares, "schedule", policies, "schedule"):
        res, wall, _ = timed_route(lambda: {w: simulator.sweep(
            trs[w], cfgs, all_wl[w][2], device=dev) for w in trs})
    launches = scan_kernel.COUNTER.launches
    check(launches == len(cfgs) * len(trs),
          f"fig-16 grid launched sim_scan {launches} times, expected "
          f"{len(cfgs) * len(trs)}")
    for w, r in res.items():
        for x in r:
            check(np.isfinite(x.ipc).all() and (x.ipc > 0).all(),
                  f"fig-16 workload {w} {x.mechanism}: non-finite result")
    log(f"[fig16] {len(FIG16_SCHEDS)} controllers x {{base, figcache_fast}} x "
        f"workloads {FIG16_WORKLOADS} at {FIG16_PER_CHANNEL} requests per "
        f"channel: {wall:.3f} s through sim_scan ({launches} launches; "
        f"scheduling on the host {shares['schedule']:.3f} s), traces built "
        f"in {build_s:.3f} s")
    summary = {}
    for k, (label, _) in enumerate(FIG16_SCHEDS):
        sp = [simulator.speedup(r[2 * k + 1], r[2 * k]) for r in res.values()]
        rh = [r[2 * k].row_hit_rate for r in res.values()]
        summary[label] = (float(np.mean(sp)), float(np.mean(rh)))
        log(f"[fig16]   {label:18s} figcache_fast weighted speedup "
            f"{summary[label][0]:.4f}, base row-hit rate "
            f"{summary[label][1]:.4f}")

    # one group (figcache_fast under the last controller) of one workload,
    # smaller, through the eager loop: counters bitwise
    w = FIG16_WORKLOADS[0]
    small = traces.build_trace(all_wl[w][2], N_CHANNELS,
                               FIG16_EAGER_PER_CHANNEL, 2)
    cfg = [cfgs[-1]]
    t0 = time.perf_counter()
    kern = simulator.sweep(small, cfg, all_wl[w][2], device=dev)[0]
    with patched(dram, _advance=dram._advance_eager):
        eager = simulator.sweep(small, cfg, all_wl[w][2], device=dev)[0]
    for f, a, b in zip(dram.Counters._fields, kern.counters, eager.counters):
        check(np.array_equal(a, b), f"fig-16 group {f}: sim_scan differs "
              "from the eager loop")
    log(f"[fig16] workload {w}, figcache_fast under {FIG16_SCHEDS[-1][0]} at "
        f"{FIG16_EAGER_PER_CHANNEL} requests per channel: sim_scan == eager "
        f"loop on every counter ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "wall": wall, "summary": summary}


# ---------------------------------------------------------------------------
# phase 12: telemetry windows on the card

def tel_leaves(tree):
    out = []
    dram._map(out.append, tree)
    return out


def collected(state, frames):
    """A collector holding one replay's frames and final state."""
    col = obs.WindowCollector()
    col.add(frames)
    col.close(state)
    return col


def same_collected(a, b, what, index=()):
    """Two collectors' masked series, cumulative planes and final cursor,
    bitwise (NaN for NaN in the derived rates)."""
    sa, sb = a.series(index), b.series(index)
    for k in sa:
        check(np.array_equal(sa[k], sb[k], equal_nan=True),
              f"{what}: series {k} differs")
    for k, v in a.cumulative(index).items():
        check(np.array_equal(v, b.cumulative(index)[k]),
              f"{what}: cumulative {k} differs")
    for x, y in zip(tel_leaves(a._final), tel_leaves(b._final)):
        check(torch.equal(x, y), f"{what}: final telemetry cursor differs")


def same_as_eager(trace, cfg, dev, lead, what):
    """resume_tel (one sim_scan launch) against the eager loop on the
    card: every state, telemetry and frame leaf, filler rows included.
    Returns the kernel's (state, frames)."""
    p = cfg.params(device=dev)
    state0 = dram.sim_init(cfg.static, channels=lead[0] if lead else None,
                           device=dev)
    got = counted(lambda: dram.resume_tel(trace, cfg.static, p, state0,
                                          device=dev), 1, what)
    es, ef = dram._advance_eager(trace, cfg.static, p, state0, device=dev,
                                 with_frames=True)
    want = (es, dram._unlane(ef, lead))
    for x, y in zip(tel_leaves(got), tel_leaves(want)):
        check(x.shape == y.shape and torch.equal(x, y),
              f"{what}: sim_scan's telemetry differs from the eager loop")
    return got


def phase_telemetry(dev, long_trace):
    """Telemetry windows through sim_scan's telemetry instantiation: the
    24 GOLDEN combos and the interior no-op trace monolithic (held against
    the eager loop on the card) and streamed at 1/7/64/full, every series,
    cursor and plane equal across routes and the counters at the golden;
    then fig_tail_latency's parameters on the long trace, streamed at
    TAIL_CHUNK and monolithic, its prefix against the eager loop, its
    tail percentiles; then the telemetry tax at the long trace's
    figcache_fast group and on the monolithic route's wall."""
    t0 = time.perf_counter()
    scan_kernel.COUNTER.launches = 0
    routes = {}
    combos = [(reuse_trace(), m, sid, want, (1, 7, 64, 320))
              for (m, sid), want in GOLDEN.items()]
    combos += [(interior_noop_trace(), m, "fcfs", want, (1, 7, 64, 136))
               for m, want in INTERIOR_GOLDEN.items()]
    t_eager = 0.0
    for tr, mech, sid, want, chunks in combos:
        cfg = dataclasses.replace(golden_config(mech, SCHEDS[sid]),
                                  telemetry=TEL_GOLDEN_PERIOD,
                                  slo_ns=TEL_GOLDEN_SLO_NS)
        what = f"telemetry {mech} {sid}"
        before = scan_kernel.COUNTER.launches
        t1 = time.perf_counter()
        state, frames = same_as_eager(policies.schedule(tr, cfg.sched), cfg,
                                      dev, (), what)
        t_eager += time.perf_counter() - t1
        routes["monolithic"] = routes.get("monolithic", 0) + \
            scan_kernel.COUNTER.launches - before
        check(fingerprint(state.cnt) == want,
              f"{what}: counters {fingerprint(state.cnt)} != golden")
        mono = collected(state, frames)
        n_real = int((tr.t_issue < dram.NOOP_ISSUE).sum())
        for L in chunks:
            col = obs.WindowCollector()
            n_seg = -(-(n_real if not cfg.sched.is_identity
                        else tr.t_issue.shape[-1]) // L)
            before = scan_kernel.COUNTER.launches
            cnt = counted(lambda: streaming.simulate_stream(
                streaming.iter_chunks(tr, L), cfg, telemetry=col,
                device=dev), n_seg, f"{what} chunk {L}")
            routes[f"chunk {L}"] = routes.get(f"chunk {L}", 0) + \
                scan_kernel.COUNTER.launches - before
            check(fingerprint(cnt) == want, f"{what} chunk {L}: counters")
            same_collected(mono, col, f"{what} chunk {L}")
    torch.cuda.synchronize()
    golden_s = time.perf_counter() - t0
    log(f"[telemetry] {len(combos)} combos (24 GOLDEN of tests/test_obs.py, "
        f"2 interior no-op) at period {TEL_GOLDEN_PERIOD}, SLO "
        f"{TEL_GOLDEN_SLO_NS} ns: counters at the telemetry-off golden; "
        f"monolithic == eager loop on the card on every state, telemetry "
        f"and frame leaf ({t_eager:.1f} s of it); series, cumulative planes "
        f"and final cursor equal at chunk 1/7/64/full; sim_scan launches "
        f"{routes} in {golden_s:.1f} s")

    # fig_tail_latency's parameters on the long trace (W25-0, 4 x 65536)
    ltr, lead = long_trace, (N_CHANNELS,)
    n_seg = LONG_PER_CHANNEL // TAIL_CHUNK
    tails, walls = {}, {}
    for mech in TAIL_MECHS:
        cfg = timing.paper_config(mech, telemetry=TAIL_PERIOD,
                                  slo_ns=TAIL_SLO_NS)
        off = timing.paper_config(mech)
        col = obs.WindowCollector()
        before = scan_kernel.COUNTER.launches
        _, stream_s, stream_peak = timed_route(lambda: counted(
            lambda: streaming.simulate_stream(
                streaming.iter_chunks(ltr, TAIL_CHUNK), cfg, telemetry=col,
                device=dev), n_seg, f"tail {mech} streamed"))
        routes[f"tail {mech} chunk {TAIL_CHUNK}"] = \
            scan_kernel.COUNTER.launches - before
        # the monolithic route with telemetry and without, in turns
        runs = {"off": [], "on": []}
        before = scan_kernel.COUNTER.launches
        for which in ("off", "on", "on", "off"):
            c = off if which == "off" else cfg
            p = c.params(device=dev)
            state0 = dram.sim_init(c.static, channels=N_CHANNELS, device=dev)
            run = (lambda: dram.resume(ltr, c.static, p, state0, device=dev)) \
                if which == "off" else \
                (lambda: dram.resume_tel(ltr, c.static, p, state0, device=dev))
            out, wall, peak = timed_route(lambda: counted(
                run, 1, f"tail {mech} monolithic {which}"))
            runs[which].append(wall)
            if which == "on":
                mono_out, mono_peak = out, peak
        routes[f"tail {mech} monolithic (off, on, on, off)"] = \
            scan_kernel.COUNTER.launches - before
        mono = collected(*mono_out)
        for c in range(N_CHANNELS):
            same_collected(mono, col, f"tail {mech} channel {c}", (c,))
        pre = dram.Trace(*[x[:, :TAIL_EAGER_PREFIX] for x in ltr])
        same_as_eager(pre, cfg, dev, lead, f"tail {mech} prefix")
        cum = col.cumulative()
        hist = cum["hist"].sum(axis=(0, 1, 2))
        reqs, viol = int(hist.sum()), int(cum["slo"].sum())
        check(reqs == N_CHANNELS * LONG_PER_CHANNEL,
              f"tail {mech}: histogram mass {reqs}")
        pct = obs.latency.percentiles(hist)
        n_win = sum(len(col.series((c,))["win_idx"])
                    for c in range(N_CHANNELS))
        tails[mech] = {"pct": pct, "slo_rate": viol / reqs,
                       "violations": viol, "windows": n_win}
        walls[mech] = {"stream_s": stream_s, "stream_peak": stream_peak,
                       "mono_on_s": runs["on"], "mono_off_s": runs["off"],
                       "mono_peak": mono_peak}
        log(f"[telemetry] tail {mech} (W25-0, {N_CHANNELS} x "
            f"{LONG_PER_CHANNEL}, period {TAIL_PERIOD}, SLO {TAIL_SLO_NS} "
            f"ns): " + ", ".join(f"{q} {v.value:.1f} ns [{v.lo}, {v.hi}]"
                                 for q, v in pct.items()) +
            f"; over SLO {viol} of {reqs} ({viol / reqs:.6f}); {n_win} "
            f"windows; streamed at {TAIL_CHUNK} == monolithic on every "
            f"series, plane and cursor, the {TAIL_EAGER_PREFIX}-request "
            f"prefix == the eager loop")
        log(f"[telemetry] tail {mech} walls: streamed ({n_seg} launches) "
            f"{stream_s:.3f} s, peak {stream_peak / 2**20:.2f} MiB; "
            f"monolithic with telemetry {runs['on'][0]:.4f} / "
            f"{runs['on'][1]:.4f} s (peak {mono_peak / 2**20:.2f} MiB), "
            f"without {runs['off'][0]:.4f} / {runs['off'][1]:.4f} s")
    gain = {q: tails["base"]["pct"][q].value /
            tails["figcache_fast"]["pct"][q].value for q in ("p99", "p999")}
    log(f"[telemetry] figcache_fast over base: p99 gain {gain['p99']:.4f}, "
        f"p999 gain {gain['p999']:.4f}")

    # the tax at the long trace's figcache_fast group (4 lanes x 65536
    # steps), one launch each, in turns
    fast = timing.paper_config("figcache_fast")
    turns = {0: [], TAIL_PERIOD: []}
    for per in (0, TAIL_PERIOD, TAIL_PERIOD, 0, 0, TAIL_PERIOD):
        turns[per].append(scan_launch_ms(ltr, fast, dev, per)[0])
    long_tax = {"off_ms": statistics.median(turns[0]),
                "tel_ms": statistics.median(turns[TAIL_PERIOD])}
    long_tax["tax"] = long_tax["tel_ms"] / long_tax["off_ms"] - 1
    log(f"[telemetry] sim_scan at W25-0's figcache_fast group (N "
        f"{N_CHANNELS}, T {LONG_PER_CHANNEL}), 3 launches each in turns: "
        f"telemetry {long_tax['tel_ms']:.4f} ms {turns[TAIL_PERIOD]}, off "
        f"{long_tax['off_ms']:.4f} ms {turns[0]}: tax "
        f"{100 * long_tax['tax']:.2f} %")
    torch.cuda.synchronize()
    launches = scan_kernel.COUNTER.launches
    secs = time.perf_counter() - t0
    log(f"[telemetry] phase 12: {launches} sim_scan launches in "
        f"{secs:.1f} s")
    return {"launches": launches, "seconds": secs, "routes": routes,
            "tails": tails, "gain": gain, "walls": walls,
            "long_tax": long_tax}


# ---------------------------------------------------------------------------
# phase 13: the workload engine on the card

def device_launches(fn):
    """Device kernels launched by ``fn()`` (torch.profiler, CUPTI); None
    when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or None


def synced_s(fn, reps=3):
    """Median synchronised wall of ``fn()`` over ``reps`` runs (s)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def streams_equal(family, cpu, card):
    """(c)'s contract of tests/test_torch_workload.py: every stream before
    assembly (the f32 clock, pages, columns, write flags) bitwise."""
    for name, a, b in zip(("clock", "pages", "columns", "write flags"), cpu,
                          [dram.host_array(x) for x in card]):
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        check(np.array_equal(a, b), f"{family}: card {name} differ from "
              "the CPU's")


def same_counters(a, b, what):
    for f, x, y in zip(dram.Counters._fields, a.counters, b.counters):
        check(np.array_equal(x, y), f"{what} {f} differs")


def phase_workloads(dev):
    """Fig 17's grid generated on the card and replayed through sim_scan by
    ``simulator.sweep_traces(specs, cfgs)``, held against the same traces
    passed as Trace entries, ``generate_many`` against per-spec
    ``generate``, the card's streams and whole traces against the CPU's,
    and one group's prefix against the eager loop; generation times,
    launches and peak memory; then the fig-8 mixes generated on the card
    in turns with ``traces.build_trace`` on the host."""
    t_phase = time.perf_counter()
    specs = [workload.preset(f, n_cores=FIG17_CORES, n_channels=N_CHANNELS,
                             per_channel=PER_CHANNEL, seed=FIG17_SEED)
             for f in workload.FAMILIES]
    cfgs = simulator.mech_grid(FIG17_MECHS, None)
    scan_kernel.COUNTER.launches = 0
    res, wall, peak = timed_route(
        lambda: simulator.sweep_traces(specs, cfgs, device=dev))
    launches = scan_kernel.COUNTER.launches
    check(launches > 0, "fig 17's grid launched sim_scan no time")
    log(f"[workload] fig 17: {len(specs)} families x {FIG17_CORES} cores x "
        f"{N_CHANNELS} channels x {PER_CHANNEL} requests generated on the "
        f"card, x {len(cfgs)} mechanisms through sim_scan: {wall:.3f} s, "
        f"{launches} sim_scan launches, peak {peak / 2**20:.1f} MiB")
    summary = {}
    for spec, per_cfg in zip(specs, res):
        for x in per_cfg:
            check(np.isfinite(x.ipc).all() and (x.ipc > 0).all(),
                  f"fig 17 {spec.family} {x.mechanism}: non-finite result")
        sp = simulator.speedup_summary(dict(zip(FIG17_MECHS, per_cfg)))
        summary[spec.family] = {m: v for m, v in sp.items() if m != "base"}
        log(f"[workload]   {spec.family:14s} " + ", ".join(
            f"{m}={v:.4f}" for m, v in summary[spec.family].items()))

    # the same card-generated traces as Trace entries: bitwise
    many = workload.generate_many(specs, device=dev)
    ref = simulator.sweep_traces(many, cfgs, [s.apps() for s in specs],
                                 device=dev)
    for spec, a, b in zip(specs, res, ref):
        for x, y in zip(a, b):
            same_counters(x, y, f"fig 17 {spec.family} {x.mechanism}: spec "
                          "entry vs Trace entry")
    # generate_many against per-spec generate, on the card
    for spec, tr in zip(specs, many):
        one = workload.generate(spec, device=dev)
        for f, x, y in zip(dram.Trace._fields, one, tr):
            check(torch.equal(x, y), f"{spec.family} {f}: generate_many "
                  "differs from generate")
    log("[workload] spec entries == Trace entries on every counter; "
        "generate_many == per-spec generate on every leaf")

    # each family's streams before assembly: card against CPU
    gen_ms, gen_launches = {}, {}
    for spec in specs:
        fam = spec.family
        cpu = [x.numpy() for x in generators.family_streams(spec, "cpu")]
        streams_equal(fam, cpu, generators.family_streams(spec, dev))
        # channel assembly (sorts, bincount, gathers) on the card against
        # the CPU's, on every leaf of the whole trace
        host = workload.generate(spec, device="cpu")
        card = workload.generate(spec, device=dev)
        for f, x, y in zip(dram.Trace._fields, host, card):
            check(torch.equal(x, y.cpu()), f"{fam} {f}: the card's generate "
                  "differs from the CPU's")
        gen_ms[fam] = synced_s(
            lambda: workload.generate(spec, device=dev), reps=5) * 1e3
        gen_launches[fam] = device_launches(
            lambda: workload.generate(spec, device=dev))
        log(f"[workload]   {fam:14s} generate {gen_ms[fam]:.3f} ms "
            f"(synchronised, median of 5), {gen_launches[fam]} device "
            f"launches; card vs CPU: streams == and generate == on every "
            "leaf")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    workload.generate_many(specs, device=dev)
    torch.cuda.synchronize()
    gen_peak = torch.cuda.max_memory_allocated() - live
    log(f"[workload] generate_many of the six specs: peak device memory "
        f"{gen_peak / 2**20:.1f} MiB above the live {live / 2**20:.1f} MiB")

    # one static group on a prefix: sim_scan against the eager loop
    spec = specs[0]
    small = dram.Trace(*[x[:, :GEN_EAGER_PREFIX] for x in many[0]])
    cfg = [timing.paper_config("figcache_fast")]
    kern = simulator.sweep(small, cfg, spec.apps(), device=dev)[0]
    with patched(dram, _advance=dram._advance_eager):
        eager = simulator.sweep(small, cfg, spec.apps(), device=dev)[0]
    same_counters(kern, eager, f"{spec.family} figcache_fast prefix: "
                  "sim_scan vs eager loop")
    log(f"[workload] {spec.family} figcache_fast at a {GEN_EAGER_PREFIX}-"
        "request prefix: sim_scan == eager loop on every counter")

    # the fig-8 mixes: one generate_many on the card, in turns with the
    # numpy oracle's build_trace on the host
    all_wl = traces.eight_core_workloads()
    apps = [all_wl[i][2] for i in FIG8_WORKLOADS]
    mix = [workload.spec_from_apps(a, N_CHANNELS, PER_CHANNEL, FIG17_SEED)
           for a in apps]
    routes = {"generate_many": lambda: workload.generate_many(mix,
                                                               device=dev),
              "build_trace": lambda: [traces.build_trace(
                  a, N_CHANNELS, PER_CHANNEL, FIG17_SEED) for a in apps]}
    walls = {k: [] for k in routes}
    out = {}
    for k in ("generate_many", "build_trace", "build_trace",
              "generate_many"):
        out[k], secs, _ = timed_route(routes[k])
        walls[k].append(secs)
    mix_launches = device_launches(routes["generate_many"])
    log(f"[workload] fig-8 mixes ({len(mix)} x {FIG17_CORES} cores x "
        f"{N_CHANNELS} x {PER_CHANNEL}), in turns: generate_many on the "
        f"card {walls['generate_many']} s ({mix_launches} device launches), "
        f"build_trace on the host {walls['build_trace']} s")
    for w, g, b in zip(FIG8_WORKLOADS, out["generate_many"],
                       out["build_trace"]):
        for label, tr in (("card", g), ("host", b)):
            log(f"[workload]   W{w} {label} "
                f"{workload.summarize(workload.characterize(tr))}")
    log(f"[workload] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "wall": wall, "summary": summary,
            "gen_ms": gen_ms, "gen_launches": gen_launches,
            "gen_peak": gen_peak,
            "mix_walls": walls, "mix_launches": mix_launches}


# ---------------------------------------------------------------------------
# phase 14: fault-tolerant orchestration of fig 17's grid

def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def same_by_config(got, oracle, what):
    """``counters_by_config`` against ``sweep_traces`` results, bitwise."""
    check(len(got) == sum(len(r) for r in oracle),
          f"{what}: {len(got)} configs, want {sum(len(r) for r in oracle)}")
    for (w, i), cnt in got.items():
        for f, x, y in zip(dram.Counters._fields, cnt,
                           oracle[w][i].counters):
            check(np.array_equal(x, y), f"{what}: w={w} cfg={i} {f} "
                  "differs from sweep_traces")


def orchestrated(plan, run_dir, dev, fault_plan=None):
    """Run ``plan`` under ``run_dir`` on ``dev``; returns the orchestrator,
    the synchronised wall, the sim_scan launches counted from 0, the
    ``generate`` calls and seconds, the checkpoint save and restore
    seconds, and the peak device memory above what was live.  An injected
    kill ends the run early (the kill is recorded, not raised)."""
    acct = {"generate": [0, 0.0], "save": [0, 0.0], "restore": [0, 0.0]}

    def clocked(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acct[key][0] += 1
                acct[key][1] += time.perf_counter() - t0
        return run
    o = orch_mod.Orchestrator(plan, str(run_dir), checkpoint_every=1,
                              backoff_s=0.0, fault_plan=fault_plan,
                              devices=[dev])
    status, killed = None, False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    scan_kernel.COUNTER.launches = 0
    t0 = time.perf_counter()
    with patched(workload, generate=clocked("generate", workload.generate)), \
            patched(checkpoint,
                    save_checkpoint=clocked("save",
                                            checkpoint.save_checkpoint),
                    restore_latest=clocked("restore",
                                           checkpoint.restore_latest)):
        try:
            status = o.run()
        except InjectedKill:
            killed = True
    torch.cuda.synchronize()
    return dict(orch=o, status=status, wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated() - live, killed=killed,
                launches=scan_kernel.COUNTER.launches, acct=acct)


def cli(*args):
    """The orchestrator's CLI in a fresh process on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.orchestrator", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)


def phase_orchestration(dev):
    """Fig 17's grid as 30 durable shards on the card, uninterrupted and
    killed + resumed, each bitwise equal to ``sweep_traces``; the CLI's
    real SIGKILL round trip; the transcendentals card against CPU over
    every uniform."""
    import shutil
    t_phase = time.perf_counter()
    specs = [workload.preset(f, n_cores=FIG17_CORES, n_channels=N_CHANNELS,
                             per_channel=PER_CHANNEL, seed=FIG17_SEED)
             for f in workload.FAMILIES]
    cfgs = simulator.mech_grid(FIG17_MECHS, None)
    plan = orch_mod.make_plan(specs, cfgs, chunk_len=ORCH_CHUNK)
    n_seg = -(-PER_CHANNEL // ORCH_CHUNK)
    check(len(plan.shards) == len(specs) * len(cfgs) == 30,
          f"fig 17's plan has {len(plan.shards)} shards, want 30")
    scan_kernel.COUNTER.launches = 0
    oracle, mono_wall, mono_peak = timed_route(lambda: simulator.sweep_traces(
        specs, cfgs, chunk_len=ORCH_CHUNK, device=dev))
    mono_launches = scan_kernel.COUNTER.launches
    log(f"[orch] fig 17 plan: {len(plan.shards)} shards x {n_seg} segments "
        f"of {ORCH_CHUNK}, grid {plan.grid_hash}; sweep_traces(chunk_len="
        f"{ORCH_CHUNK}) on the card: {mono_wall:.3f} s, {mono_launches} "
        f"sim_scan launches, peak {mono_peak / 2**20:.1f} MiB")

    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_orch_"))
    runs = {}
    try:
        run = orchestrated(plan, root / "whole", dev)
        check(run["status"] == {"done": len(plan.shards)},
              f"orchestrated run ended {run['status']}")
        same_by_config(run["orch"].counters_by_config(), oracle,
                       "orchestrated fig 17")
        runs["orchestrated"] = run
        fp = FaultPlan([FaultEvent(kind="kill", shard=ORCH_KILL[0],
                                   segment=ORCH_KILL[1], mode="raise")])
        first = orchestrated(plan, root / "killed", dev, fp)
        check(first["killed"], "the injected kill did not fire")
        resumed = orchestrated(plan, root / "killed", dev, fp)
        check(resumed["status"] == {"done": len(plan.shards)},
              f"resumed run ended {resumed['status']}")
        same_by_config(resumed["orch"].counters_by_config(), oracle,
                       "killed + resumed fig 17")
        runs["killed"], runs["resumed"] = first, resumed
        for name, r in runs.items():
            a = r["acct"]
            log(f"[orch] {name}: wall {r['wall']} s, {r['launches']} sim_scan"
                f" launches, {a['generate'][0]} generate calls "
                f"{a['generate'][1]} s ({a['generate'][1] / r['wall']} of the "
                f"wall), {a['save'][0]} checkpoint saves {a['save'][1]} s, "
                f"{a['restore'][0]} restore calls {a['restore'][1]} s, peak "
                f"device memory {r['peak'] / 2**20:.1f} MiB")
        ckpt_bytes = dir_bytes(root / "whole" / "shards")
        log(f"[orch] checkpoints + results of the uninterrupted run: "
            f"{ckpt_bytes} bytes on disk; counters_by_config == "
            "sweep_traces on every field of all 30 configs, uninterrupted "
            f"and killed at shard {ORCH_KILL[0]} segment {ORCH_KILL[1]} + "
            "resumed")
        check(runs["killed"]["launches"] + runs["resumed"]["launches"] ==
              runs["orchestrated"]["launches"] == len(plan.shards) * n_seg,
              "the killed + resumed run replayed a segment twice or "
              "skipped one")

        # the CLI: a real SIGKILL, a resume, and compare
        d = str(root / "cli")
        t0 = time.perf_counter()
        r = cli("run", "--run-dir", d, "--kill", ORCH_CLI_KILL,
                "--kill-mode", "sigkill")
        check(r.returncode == -9, f"CLI run with SIGKILL returned "
              f"{r.returncode}: {r.stderr[-2000:]}")
        r2 = cli("run", "--run-dir", d)
        check(r2.returncode == 0, f"CLI resume returned {r2.returncode}: "
              f"{r2.stderr[-2000:]}")
        r3 = cli("compare", "--run-dir", d)
        check(r3.returncode == 0 and "bitwise equal" in r3.stdout,
              f"CLI compare returned {r3.returncode}: {r3.stdout[-2000:]}")
        cli_s = time.perf_counter() - t0
        log(f"[orch] CLI: run --kill {ORCH_CLI_KILL} --kill-mode sigkill -> "
            f"{r.returncode}; run -> {r2.stdout.strip()}; compare -> "
            f"{r3.stdout.strip()} "
            f"({cli_s:.1f} s, three processes)")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the transcendentals: the card's bits are the CPU's over every u
    t0 = time.perf_counter()
    u = torch.arange(2 ** 23, dtype=torch.int64).float() * 2.0 ** -23
    ud = u.to(dev)

    def zipf_k(x, n_pages, a):
        n = torch.tensor(n_pages, dtype=torch.int32, device=x.device).float()
        safe = 1.0 - torch.tensor(a, dtype=torch.float32, device=x.device)
        return (xla_math.pow_f32(xla_math.fma_f32(
                    x, xla_math.pow_f32(n, safe) - 1.0, 1.0), 1.0 / safe),
                xla_math.exp_f32(x * xla_math.log_f32(n)))
    arg = -torch.clamp_max(u, 0.999999)
    check(torch.equal(xla_math.log1p_f32(arg),
                      xla_math.log1p_f32(arg.to(dev)).cpu()),
          "log1p_f32: the card differs from the CPU")
    for n, a in XLA_KNOBS:
        for name, x, y in zip(("pow", "exp/log"), zipf_k(u, n, a),
                              zipf_k(ud, n, a)):
            check(torch.equal(x, y.cpu()), f"{name} at n={n} a={a}: the "
                  "card differs from the CPU")
    log(f"[orch] xla_math on the card == the CPU over all 2**23 u: log1p, "
        f"and pow / exp / log at {len(XLA_KNOBS)} knob pairs "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"[orch] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": runs["orchestrated"]["launches"],
            "mono_wall": mono_wall, "mono_launches": mono_launches,
            "walls": {k: r["wall"] for k, r in runs.items()},
            "ckpt_bytes": ckpt_bytes}


# ---------------------------------------------------------------------------
# phase 5: the FIGCache-KV path

def phase_figkv(dev):
    cfg, fig, s_max, n_segs = figkv_geometry()
    log(f"[figkv] {cfg.name}: H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"D={cfg.hd} bf16, batch {FIGKV_BATCH}, prompt {FIGKV_PROMPT}, "
        f"{FIGKV_GEN} decode steps, s_max {s_max} ({n_segs} segments of "
        f"{fig.seg_tokens}), fast pool {fig.fast_rows}x{fig.segs_per_row}")
    kernels = {"figkv_tx": tx_kernel, "figaro_reloc": reloc_kernel,
               "figcache_decode": decode_kernel}

    def run(**patch):
        """demo_figkv with ``patch`` at the figkv module's call sites; its
        result, peak device memory and the launches it made, counted from
        0 just before it."""
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.COUNTER.launches = 0
        with patched(kv_cache, **patch):
            out = serve.demo_figkv(cfg, gen, FIGKV_PROMPT, FIGKV_GEN,
                                   FIGKV_BATCH, device=dev)
        return out, torch.cuda.max_memory_allocated(dev), {
            n: k.COUNTER.launches for n, k in kernels.items()}

    def same_state(a, b, what):
        for name, x, y in zip(a.fts._fields, a.fts, b.fts):
            check(torch.equal(x, y), f"figkv: FTS leaf {name} differs from "
                  f"the {what}")
        for name in ("fast_k", "fast_v", "pool_k", "pool_v", "seg_key"):
            check(torch.equal(getattr(a, name), getattr(b, name)),
                  f"figkv: {name} differs from the {what}")

    # warm-up at a small size: the first calls of cuBLAS, sort and friends
    serve.demo_figkv(cfg, torch.Generator(device=dev).manual_seed(2), 256, 4,
                     FIGKV_BATCH, device=dev)
    kern, peak, launches = run()
    want = {"figkv_tx": FIGKV_GEN, "figaro_reloc": 0,
            "figcache_decode": FIGKV_GEN}
    check(launches == want, f"figkv launches {launches}, expected {want}: "
          f"one transaction and one decode a step, no separate relocation")
    check(kern.out.shape == (FIGKV_GEN, FIGKV_BATCH, 1, cfg.n_heads, cfg.hd)
          and bool(torch.isfinite(kern.out.float()).all()),
          "figkv: outputs not finite or of the wrong shape")
    plain, _, plain_launches = run(figkv_tx=plain_figkv_tx,
                                   decode_attend=plain_decode_attend)
    check(not any(plain_launches.values()),
          f"the plain rerun launched a kernel: {plain_launches}")
    same_state(kern.state, plain.state, "plain rerun")
    err = float((kern.out.float() - plain.out.float()).abs().max())
    check(err <= 2e-2, f"figkv: outputs differ from the plain rerun by {err}")
    unfused, _, unfused_launches = run(figkv_tx=unfused_figkv_tx)
    want_u = {"figkv_tx": 0, "figaro_reloc": 2 * FIGKV_GEN,
              "figcache_decode": FIGKV_GEN}
    check(unfused_launches == want_u, f"unfused rerun launches "
          f"{unfused_launches}, expected {want_u}")
    same_state(kern.state, unfused.state, "unfused rerun")
    check(torch.equal(kern.out, unfused.out),
          "figkv: outputs differ from the unfused rerun")
    again, _, _ = run()
    slots = fig.fast_rows * fig.segs_per_row
    log(f"[figkv] launches {launches}; every FTS leaf, both fast pools and "
        f"both slow pools bitwise equal to the plain rerun (outputs within "
        f"{err:.3g}, bf16 atol 2e-2) and to the unfused rerun (launches "
        f"{unfused_launches}; outputs bitwise)")
    tok_s = FIGKV_BATCH * FIGKV_GEN / kern.timings["decode_s"]
    log(f"[figkv] decode ms/step wall over {FIGKV_GEN} steps, in this order: "
        f"fused {kern.timings['ms_per_step']:.3f} ({tok_s:.0f} tokens/s), "
        f"plain {plain.timings['ms_per_step']:.3f}, unfused "
        f"{unfused.timings['ms_per_step']:.3f}, fused "
        f"{again.timings['ms_per_step']:.3f}; prefill "
        f"{kern.timings['prefill_s'] * 1e3:.1f} ms; fast pool warm "
        f"{kern.warm}/{FIGKV_BATCH * slots} slots; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    res = {"launches": launches,
           "ms_per_step": {"fused": [kern.timings["ms_per_step"],
                                     again.timings["ms_per_step"]],
                           "plain": plain.timings["ms_per_step"],
                           "unfused": unfused.timings["ms_per_step"]}}
    del kern, plain, unfused, again
    torch.cuda.empty_cache()

    # where a decode step's time goes: 16 steps at the same shapes, q/k/v
    # drawn beforehand, on a fresh 32k-token state (3 replays of 16 steps),
    # fused and unfused in turns
    steps, st = 16, fig.seg_tokens
    B, H, hkv, d = FIGKV_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(3)

    def draw(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                           device=dev)

    state = kv_cache.figkv_init(B, FIGKV_PROMPT + 12 * steps + st, hkv, d,
                                fig, device=dev)
    state = kv_cache.figkv_prefill(state, draw(B, FIGKV_PROMPT, hkv, d),
                                   draw(B, FIGKV_PROMPT, hkv, d))
    qkv = [(draw(B, 1, H, d), draw(B, 1, hkv, d), draw(B, 1, hkv, d))
           for _ in range(steps)]
    box = [state]

    def replay():
        for q, kn, vn in qkv:
            box[0], _ = kv_cache.figkv_decode_step(
                box[0], q, kn, vn, fig, n_sel=FIGKV_N_SEL, recent=2 * st)
        torch.cuda.synchronize()

    profiles = {"fused": [], "unfused": []}
    for label in ("fused", "unfused", "unfused", "fused"):
        patch = {"figkv_tx": unfused_figkv_tx} if label == "unfused" else {}
        with patched(kv_cache, **patch):
            profiles[label].append(profile_replay(
                f"figkv decode B={B} ({label})", replay, steps))
    res["profile"] = profiles
    del state, box
    torch.cuda.empty_cache()

    # FIGCache for the embedding gather over Qwen2-7B's table
    V, d = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((V, d), generator=gen, dtype=torch.bfloat16,
                        device=dev)
    zipf = torch.arange(1, V + 1, device=dev, dtype=torch.float64) ** -ZIPF_S
    toks = torch.multinomial(zipf.float(), EMBED_STEPS * EMBED_TOKENS,
                             replacement=True, generator=gen).view(
        EMBED_STEPS, EMBED_TOKENS)
    cache = embed_cache.embed_cache_init(d, fig, device=dev)
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    reloc_kernel.COUNTER.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(EMBED_STEPS):
        cache, out = embed_cache.embed_cache_lookup(cache, table, toks[i], fig,
                                                    i)
        wrong += (out != table[toks[i]]).sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["embed_reloc_launches"] = reloc_kernel.COUNTER.launches
    hits, lookups = int(cache.hits), int(cache.lookups)
    check(int(wrong) == 0, f"embed cache: {int(wrong)} output elements differ "
          "from table[tokens]")
    check(hits > 0 and lookups == EMBED_STEPS * EMBED_TOKENS,
          f"embed cache: hits {hits}, lookups {lookups}")
    check(res["embed_reloc_launches"] > 0,
          "embed cache: figaro_reloc was not launched")
    log(f"[figkv] embed_cache_lookup: table {V}x{d} bf16, {EMBED_STEPS} steps "
        f"of {EMBED_TOKENS} Zipf({ZIPF_S}) tokens in {wall * 1e3:.1f} ms "
        f"({wall / EMBED_STEPS * 1e3:.3f} ms/step); outputs == table[tokens] "
        f"bitwise; hits {hits}/{lookups}; figaro_reloc launches "
        f"{res['embed_reloc_launches']}")
    return res


# ---------------------------------------------------------------------------
# phase 6: where a simulator step's time goes

def profile_replay(label, replay, steps, wall=None):
    """Device busy time of ``replay()`` (``steps`` steps, ending in a
    synchronise) from CUPTI, against the wall time of the same replay run
    unprofiled (``wall`` seconds where the caller has measured it, else
    timed here after a warm-up run); the device ops that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if wall is None:
        replay()
        t0 = time.perf_counter()
        replay()
        wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log(f"[profile] {label}: the profiler saw no device activity; device "
            "busy share not measured")
        return {"ms_per_step": wall / steps * 1e3}
    busy = sum(e.time_range.elapsed_us() for e in kern) * 1e-6
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"[profile] {label} steps={steps}: wall {wall * 1e3:.3f} ms "
        f"({wall / steps * 1e3:.4f} ms/step) unprofiled, device busy "
        f"{busy * 1e3:.3f} ms ({busy / steps * 1e3:.4f} ms/step) over "
        f"{len(kern)} device ops ({len(kern) / steps:.2f}/step), device idle "
        f"share {1 - busy / wall:.4f}")
    for name, (us, c) in top:
        log(f"[profile]   {us / c:8.3f} us x {c / steps:5.1f}/step  "
            f"{name[:90]}")
    return {"ms_per_step": wall / steps * 1e3,
            "busy_ms_per_step": busy / steps * 1e3,
            "ops_per_step": len(kern) / steps, "idle_share": 1 - busy / wall}


def phase_profile(dev, eager_steps=128):
    """Profile the simulator's replay at its shapes (the workloads x 4
    channels as lanes, S = 512): a whole group of ``PER_CHANNEL`` steps
    through the replay kernel (``run_sweep``, host layout included), and
    ``eager_steps`` steps through the eager loop."""
    all_wl = traces.eight_core_workloads()
    for label, steps, advance in (("replay kernel", PER_CHANNEL, None),
                                  ("eager loop", eager_steps,
                                   dram._advance_eager)):
        trs = [traces.build_trace(all_wl[i][2], N_CHANNELS, steps, 2)
               for i in FIG8_WORKLOADS]
        flat = dram.Trace(*[np.concatenate(xs) for xs in zip(*trs)])
        for mech in ("figcache_fast", "base"):
            cfg = timing.paper_config(mech)
            params = timing.stack_params([cfg.params(device=dev)])

            def replay():
                with patched(dram, **({"_advance": advance} if advance
                                      else {})):
                    dram.run_sweep(flat, cfg.static, params, device=dev)
                torch.cuda.synchronize()

            profile_replay(f"{label} {mech} lanes={flat.t_issue.shape[0]}",
                           replay, steps)


# ---------------------------------------------------------------------------
# phase 7: flash_attention kernel vs plain

def flash_case(B, S, H, hkv, D, dtype, seed, dev):
    """q (B, S, H, D), k/v (B, S, Hkv, D) from N(0, 1) in ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, S, H, D), (B, S, hkv, D), (B, S, hkv, D))]


def flash_work(B, S, H, hkv, D, item, causal, window):
    """(FLOP, bytes) one prefill attention needs: 4 D FLOP (two products)
    for every (query, key) pair the masks leave open, summed over rows;
    q, k, v read once and the output written once, K/V at Hkv heads."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    return 4 * D * B * H * pairs, item * (2 * B * S * H * D +
                                         2 * B * S * hkv * D)


def row_rel_err(got, want):
    """Largest over (sequence, position, head) rows of max|got - want| /
    max|want|: the error against the size of each output row.  At the
    Qwen2-7B shape a row averages ~2000 keys and its outputs are ~0.03, the
    size of the absolute bf16 bar, which a dropped or doubled key tile or a
    wrong rescale would pass; against the row's own size they stand out."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def phase_flash(dev):
    cases = []
    for BH, S, D in ((2, 128, 64), (4, 256, 64), (1, 256, 128)):
        for causal, window in ((True, 0), (False, 0), (True, 96)):
            cases.append((BH, S, 1, 1, D, causal, window))
    cases += [(2, 100, 4, 4, 64, True, 0), (2, 100, 2, 2, 128, False, 30),
              (1, 1000, 2, 2, 128, True, 96), (2, 1000, 2, 1, 64, False, 0),
              (2, 256, 8, 2, 64, True, 0), (2, 77, 28, 4, 128, True, 40),
              (1, 300, 4, 1, 16, False, 0), (2, 129, 4, 2, 32, True, 50)]
    # the edges of the bf16 kernel's 128-query blocks and 128-key tiles, as
    # in tests/test_torch_flash_attention.py: S 1, 127, 129, 257 and 203,
    # window 1 and windows shorter than a tile, D 16 and 32 with GQA 7/1
    edges = [(1, 1, 2, 1, 128, True, 0), (2, 127, 4, 2, 128, True, 0),
             (2, 129, 4, 2, 128, False, 0), (1, 257, 2, 1, 128, True, 0),
             (1, 203, 4, 1, 64, True, 30), (2, 300, 4, 4, 64, True, 1),
             (1, 200, 2, 1, 128, False, 1), (1, 500, 4, 2, 128, True, 50),
             (1, 500, 2, 2, 128, False, 100), (2, 200, 7, 1, 16, True, 0),
             (2, 200, 7, 1, 32, False, 0)]
    # head dims that run zero-padded (the reduced DeepSeek-67B's 8, the
    # reduced StableLM-12B's 20, StableLM-12B's 160 at its 32 / 8 heads)
    # and D 192 itself, whose bf16 kernel runs 64-key tiles
    edges += [(2, 100, 4, 2, 8, True, 0), (2, 77, 4, 1, 20, False, 30),
              (2, 1000, 32, 8, 160, True, 0), (1, 129, 4, 4, 160, False, 0),
              (1, 65, 2, 1, 192, True, 0), (1, 300, 4, 2, 192, True, 50)]
    big = (LM_BATCH, LM_PROMPT, 28, 4, 128, True, 0)
    # absolute bars as tests/test_kernels.py; relative to each output row's
    # largest value, f32 1e-4 (summation order) and bf16 1e-2 (a one-ulp
    # disagreement of the two bf16 roundings is at most 2^-7 = 0.0078)
    max_err, max_rel, n = 0.0, 0.0, 0
    for dtype, tol, rel_tol in ((torch.float32, 2e-5, 1e-4),
                                (torch.bfloat16, 2e-2, 1e-2)):
        for i, (B, S, H, hkv, D, causal, window) in enumerate(
                cases + edges + ([big] if dtype == torch.bfloat16 else [])):
            q, k, v = flash_case(B, S, H, hkv, D, dtype, seed=i, dev=dev)
            mask = dict(causal=causal, window=window)
            got = flash_kernel.flash_attention(q, k, v, **mask)
            want = flash_attention_ref(q, k, v, **mask)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = row_rel_err(got, want)
            max_err, max_rel = max(max_err, err), max(max_rel, rel)
            n += 1
            check(err <= tol and rel <= rel_tol, f"flash_attention kernel vs "
                  f"plain: abs {err} (bar {tol}), row-relative {rel} (bar "
                  f"{rel_tol}) at {dtype} (B, S, H, Hkv, D, causal, window)="
                  f"{(B, S, H, hkv, D, causal, window)}")
            del q, k, v, got, want
    log(f"[flash] flash_attention within f32 2e-5 / bf16 2e-2 of plain, and "
        f"within f32 1e-4 / bf16 1e-2 of each output row's largest value, on "
        f"{n} cases: the 18 of tests/test_kernels.py, ragged S (100, 77, "
        f"129, 300, 1000), GQA (28/4, 8/2, 4/1, 2/1), the tile edges (S 1, "
        f"127, 129, 203, 257, window 1, 30, 50, 100, D 16/32 at GQA 7/1), "
        f"padded D 8/20/160, D 192, and "
        f"the Qwen2-7B prefill {big}; max_abs_err={max_err:.3g}, "
        f"row-relative {max_rel:.3g}")
    p_mode = flash_kernel.p_mode()
    log(f"[flash] P mode of the bf16 kernel (read from its source): "
        f"{p_mode}")
    for d in (128, 192):
        rep = _build.ptxas_report("flash_attention",
                                  f"flash_tma_kernelILi{d}E")
        log(f"[flash] ptxas, bf16 kernel at D {d}: {rep['registers']} "
            f"registers, spill stores {rep['spill_stores']} B, spill loads "
            f"{rep['spill_loads']} B, {rep['perf_notes']} performance-loss "
            f"notes")
        if d == 128:
            ptxas = rep
    B, S, H, hkv, D, causal, window = big
    q, k, v = flash_case(B, S, H, hkv, D, torch.bfloat16, seed=99, dev=dev)
    qt, kt, vt = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flop, n_bytes = flash_work(B, S, H, hkv, D, 2, causal, window)
    t_ops = flop / BF16_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    kernel = lambda: flash_kernel.flash_attention(q, k, v)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v)  # noqa: E731
    library = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                           enable_gqa=True)
    k_call = time_ms(kernel, reps=3, samples=5)
    res = {"ms": graph_ms(kernel, reps=3, samples=7),
           "plain_ms": graph_ms(plain, reps=1, samples=5),
           "library_ms": graph_ms(library, reps=3, samples=7),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "max_abs_err": max_err, "p_mode": p_mode, "ptxas": ptxas}
    res["tflops"] = flop / res["ms"] * 1e-9
    res["bound_share"] = res["bound_ms"] / res["ms"]
    log(f"[flash] Qwen2-7B prefill B={B} S={S} H={H} Hkv={hkv} D={D} bf16 "
        f"causal ({flop:.3e} FLOP, {n_bytes} bytes): device time (CUDA-graph "
        f"replay) kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"SDPA {res['library_ms']:.4f} ms; per eager call kernel "
        f"{k_call:.4f} ms; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}; FLOP {t_ops:.4f} ms at 989 TFLOP/s, bytes "
        f"{t_bytes:.4f} ms at 3.35 TB/s); kernel at {res['tflops']:.1f} "
        f"TFLOP/s, {res['bound_share']:.3f} of the bound (the earlier "
        f"mma.sync kernel: 3.1620 ms)")
    return res


# ---------------------------------------------------------------------------
# phase 8: LM serving at full width

def ulp_excess(got, want):
    """How far ``got`` strays beyond one bf16 ulp of ``want`` (2^-7 of its
    magnitude), elementwise max."""
    want = want.float()
    return float(((got.float() - want).abs() - want.abs() * 2 ** -7).max())


def checked_mha(real, err, excess):
    """``attention.mha`` that runs the plain version and the kernel on the
    same inputs, records the kernel's error and returns the plain output."""
    def checked(q, k, v, *, causal=True, window=0, scale=None):
        want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
        got = real(q, k, v, causal=causal, window=window, scale=scale)
        err.append(float((got.float() - want.float()).abs().max()))
        excess.append(ulp_excess(got, want))
        return want
    return checked


def phase_lm(dev):
    cfg = configs.get(LM_ARCH)
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_GEN} greedy tokens; random weights from seed 0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_kernel.COUNTER.launches = 0
    res = serve.run(LM_ARCH, reduced=False, prompt_len=LM_PROMPT, gen=LM_GEN,
                    batch=LM_BATCH, seed=0, device=dev)
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches == cfg.n_layers, f"flash_attention launched {launches} "
          f"times in one prefill, expected {cfg.n_layers} (one per layer)")
    v = cfg.vocab_size
    check(res.tokens.shape == (LM_BATCH, LM_GEN)
          and 0 <= res.tokens.min() and res.tokens.max() < v,
          f"lm: generated tokens {res.tokens.shape} out of range")
    for name, lg in (("prefill", res.prefill_logits), ("decode", res.logits)):
        check(lg.shape == (LM_BATCH, 1, res.model.plan.padded_vocab(v))
              and bool(torch.isfinite(lg[..., :v]).all()),
              f"lm: {name} logits not finite or of the wrong shape")
    weights = sum(p.numel() * p.element_size()
                  for p in res.model.parameters())
    caches = 2 * cfg.n_layers * LM_BATCH * (LM_PROMPT + LM_GEN + 8) * \
        cfg.n_kv_heads * cfg.hd * 2
    t = res.timings
    log(f"[lm] launches flash_attention={launches} (one per layer); prefill "
        f"{t['prefill_s'] * 1e3:.1f} ms (first, cold); decode "
        f"{t['ms_per_step']:.3f} ms/step over {LM_GEN} steps "
        f"({t['tok_s']:.1f} tokens/s); peak device memory "
        f"{peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f} GiB, KV "
        f"cache {caches / 2**30:.2f} GiB)")

    model, batch = res.model, {"tokens": res.prompt}
    real_mha = attention.mha

    def prefill(mha=None):
        """A fresh prefill of the same prompts, with ``mha`` at the call
        site if given; the real-vocab logits and the wall time."""
        caches = model.init_decode(LM_BATCH, LM_PROMPT + LM_GEN + 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(attention, **({"mha": mha} if mha else {})):
            _, logits = model.prefill(batch, caches)
        torch.cuda.synchronize()
        return logits[:, 0, :v], time.perf_counter() - t0

    # warm prefill with the kernel, timed; it equals serve.run's prefill
    kern, t_kern = prefill()
    check(torch.equal(kern, res.prefill_logits[:, 0, :v]),
          "lm: two kernel prefills differ")
    # The prefill rerun with the plain version patched in at the call site.
    # Its bound: at every layer the kernel, run on that layer's own inputs,
    # stays within phase 7's 2e-2 plus one bf16 ulp of the plain output
    # (2^-7 of it), since these outputs reach ~100 (v has std ~30 under the
    # reference's init), where one ulp is 0.5.  The logits are printed, not
    # bounded: the init (std 1/sqrt(fan_in), fan_in = shape[-2], i.e. 28 q
    # heads and 4 KV heads) gives scores of std ~300, so a one-ulp change in
    # the residual stream flips attention patterns in the layers above.
    layer_err, layer_excess = [], []
    plain, t_plain = prefill(checked_mha(real_mha, layer_err, layer_excess))
    check(len(layer_err) == cfg.n_layers and bool(torch.isfinite(plain).all())
          and max(layer_excess) <= 2e-2, f"lm: kernel vs plain on the "
          f"layers' own inputs beyond one bf16 ulp: {layer_excess} (max abs "
          f"{layer_err})")
    diff = float((kern - plain).abs().max())
    rms = float(plain.pow(2).mean().sqrt())
    log(f"[lm] prefill rerun with the plain version patched in: each layer's "
        f"kernel output vs plain on its own inputs max abs "
        f"{max(layer_err):.4g}, beyond one bf16 ulp {max(layer_excess):.4g} "
        f"over {len(layer_err)} layers (held to 2e-2); max logit difference "
        f"{diff:.4g} (logit RMS {rms:.4g}; not bounded); warm prefill kernel "
        f"{t_kern * 1e3:.1f} ms (the earlier mma.sync kernel: 563-567 ms), "
        f"plain with the kernel beside it "
        f"{t_plain * 1e3:.1f} ms")

    # where a decode step's time goes: 4 steps from the prefilled caches
    caches, _ = model.prefill(batch, model.init_decode(
        LM_BATCH, LM_PROMPT + LM_GEN + 8))
    tok = torch.from_numpy(res.tokens[:, :1]).to(dev)

    def replay():
        c = caches
        for i in range(4):
            c, _ = model.decode_step(c, tok, LM_PROMPT + i)
        torch.cuda.synchronize()

    profile_replay(f"{LM_ARCH} decode B={LM_BATCH}", replay, 4)
    del caches
    del res, model, kern, plain
    torch.cuda.empty_cache()
    return launches


def phase_lm_padded(dev):
    """``serve.run`` of the reduced StableLM-12B (head dim 20, run
    zero-padded to 32) on the card: one flash_attention launch per layer,
    finite logits, and each layer's kernel output within phase 7's 2e-2
    plus one bf16 ulp of the plain version on that layer's inputs."""
    cfg = configs.get_reduced(PAD_ARCH)
    flash_kernel.COUNTER.launches = 0
    res = serve.run(PAD_ARCH, prompt_len=64, gen=8, batch=2, seed=0,
                    device=dev)
    launches = flash_kernel.COUNTER.launches
    check(launches == cfg.n_layers, f"{PAD_ARCH}: flash_attention launched "
          f"{launches} times in one prefill, expected {cfg.n_layers}")
    v = cfg.vocab_size
    check(res.tokens.shape == (2, 8) and bool(torch.isfinite(
        res.logits[..., :v]).all()) and bool(torch.isfinite(
            res.prefill_logits[..., :v]).all()),
          f"{PAD_ARCH}: tokens {res.tokens.shape} or logits not finite")
    excess, err = [], []
    with patched(attention, mha=checked_mha(attention.mha, err, excess)):
        res.model.prefill({"tokens": res.prompt},
                          res.model.init_decode(2, 64 + 8 + 8))
    torch.cuda.synchronize()
    check(len(excess) == cfg.n_layers and max(excess) <= 2e-2,
          f"{PAD_ARCH}: kernel vs plain per layer beyond one bf16 ulp "
          f"{excess} (max abs {err})")
    log(f"[lm] {PAD_ARCH} reduced (D={cfg.hd}, padded to "
        f"{flash_kernel.padded_head_dim(cfg.hd)}; {cfg.n_layers} layers, "
        f"H={cfg.n_heads} Hkv={cfg.n_kv_heads}): served batch 2, prompt 64, "
        f"8 tokens; flash_attention launches {launches}; each layer's "
        f"kernel output vs plain max abs {max(err):.4g}, beyond one bf16 ulp "
        f"{max(excess):.4g} (held to 2e-2)")
    return launches


# ---------------------------------------------------------------------------
# phase 16: MoE + MLA serving, and the sliding-window ring

def moe_vs_dense(p, x, cfg, plan, what):
    """``moe_forward`` (routing returned) against ``moe_dense_ref`` on the
    card on one layer input: routing (idx, keep, slot) equal, outputs
    within 2e-2 plus one bf16 ulp; (max abs error, ulp excess, C)."""
    y, _, r = moe_mod.moe_forward(p, x, cfg, plan, routing=True)
    want, q = moe_mod.moe_dense_ref(p, x, cfg, plan)
    for name in ("idx", "keep", "slot"):
        check(torch.equal(getattr(r, name), getattr(q, name)),
              f"moe vs dense reference: {name} differs ({what})")
    err = float((y.float() - want.float()).abs().max())
    excess = ulp_excess(y, want)
    check(excess <= 2e-2, f"moe vs dense reference beyond 2e-2 plus one bf16 "
          f"ulp ({what}): {excess} (max abs {err})")
    return err, excess, moe_mod.capacity(cfg, plan, *x.shape[:2])


def recording_moe(store):
    """``moe.moe_forward`` that keeps each call's input, parameters and
    dropped share (no host read)."""
    real = moe_mod.moe_forward

    def rec(p, x, cfg, plan, **kw):
        out = real(p, x, cfg, plan, **kw)
        store.append((p, x, out[1]["dropped_frac"]))
        return out
    return rec


def phase_mla_flash(dev, cfg):
    """flash_attention at MLA's shape (B 4, S 4096, H = Hkv = 16, D 192,
    bf16, causal) against the plain version, and D-192 corners at H =
    Hkv; then timed as phase 7 times Qwen2-7B's."""
    d = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    h = cfg.n_heads
    shape = (LM_BATCH, LM_PROMPT, h, h, d, True, 0)
    max_err = 0.0
    for dtype, tol, rel_tol in ((torch.float32, 2e-5, 1e-4),
                                (torch.bfloat16, 2e-2, 1e-2)):
        cases = [(1, 65, 2, 2, d, True, 0), (1, 300, 4, 4, d, True, 50),
                 (2, 129, 16, 16, d, True, 0)]
        if dtype == torch.bfloat16:
            cases.append(shape)
        for i, (B, S, H, hkv, D, causal, window) in enumerate(cases):
            q, k, v = flash_case(B, S, H, hkv, D, dtype, seed=300 + i,
                                 dev=dev)
            got = flash_kernel.flash_attention(q, k, v, causal=causal,
                                               window=window)
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            rel = row_rel_err(got, want)
            max_err = max(max_err, err)
            check(err <= tol and rel <= rel_tol, f"flash_attention at D {D} "
                  f"H = Hkv: abs {err} (bar {tol}), row-relative {rel} (bar "
                  f"{rel_tol}) at {dtype} {(B, S, H, hkv, D, causal, window)}")
            del q, k, v, got, want
    log(f"[mla] flash_attention at D {d} corners at H = Hkv (S 65, 129, 300, "
        f"window 50) and MLA's prefill {shape[:5]}, f32 and bf16: within f32 "
        f"2e-5 / bf16 2e-2 of plain, max_abs_err={max_err:.3g}")
    res = time_flash(dev, shape[:6], 399, "[mla]")
    res["max_abs_err"] = max(max_err, res["max_abs_err"])
    res["shape"] = list(shape[:5])
    return res


def phase_lm_moe(dev):
    """DeepSeek-V2-Lite served whole through ``serve.run(reduced=False)``
    (MLA prefill through the D-192 kernel, MoE FFNs), checked and timed;
    then Mixtral-8x22B's ring decode at full width, 2 layers."""
    t_phase = time.perf_counter()
    cfg = configs.get(MLA_ARCH)
    m = cfg.moe
    log(f"[mla] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"H={cfg.n_heads} MLA (rank {cfg.mla.kv_lora_rank}, nope "
        f"{cfg.mla.qk_nope_head_dim}, rope {cfg.mla.qk_rope_head_dim}, v "
        f"{cfg.mla.v_head_dim}), {m.n_experts} routed experts top-{m.top_k} + "
        f"{m.n_shared} shared, d_expert {m.d_expert}, layer 0 dense d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {LM_GEN} greedy tokens; random weights from seed 0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_kernel.COUNTER.launches = 0
    res = serve.run(MLA_ARCH, reduced=False, prompt_len=LM_PROMPT, gen=LM_GEN,
                    batch=LM_BATCH, seed=0, device=dev)
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches == cfg.n_layers, f"{MLA_ARCH}: flash_attention launched "
          f"{launches} times in one prefill, expected {cfg.n_layers}")
    v = cfg.vocab_size
    check(res.tokens.shape == (LM_BATCH, LM_GEN)
          and 0 <= res.tokens.min() and res.tokens.max() < v,
          f"{MLA_ARCH}: generated tokens {res.tokens.shape} out of range")
    for name, lg in (("prefill", res.prefill_logits), ("decode", res.logits)):
        check(lg.shape == (LM_BATCH, 1, res.model.plan.padded_vocab(v))
              and bool(torch.isfinite(lg[..., :v]).all()),
              f"{MLA_ARCH}: {name} logits not finite or of the wrong shape")
    model, batch, plan = res.model, {"tokens": res.prompt}, res.model.plan
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    moe_layers = [lay.ffn for lay in model.stack.layers if "router" in
                  lay.ffn]
    expert_bytes = sum((f.wi.numel() + f.wo.numel()) * 2 for f in moe_layers)
    t = res.timings
    step_bound = expert_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[mla] launches flash_attention={launches} (one per layer, D "
        f"{flash_kernel.padded_head_dim(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)}); "
        f"prefill {t['prefill_s'] * 1e3:.1f} ms (first, cold); decode "
        f"{t['ms_per_step']:.3f} ms/step over {LM_GEN} steps "
        f"({t['tok_s']:.1f} tokens/s); each step reads all {m.n_experts} "
        f"experts of the {len(moe_layers)} MoE layers (C = T k = "
        f"{LM_BATCH * m.top_k} <= 8192), {expert_bytes / 1e9:.2f} GB: at "
        f"least {step_bound:.3f} ms/step at 3.35 TB/s; peak device memory "
        f"{peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f} GiB)")

    def prefill(**patch):
        caches = model.init_decode(LM_BATCH, LM_PROMPT + LM_GEN + 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for module, attrs in patch.values():
                stack.enter_context(patched(module, **attrs))
            _, logits = model.prefill(batch, caches)
        torch.cuda.synchronize()
        return logits[:, 0, :v], time.perf_counter() - t0

    # a warm prefill, its MoE layers' inputs and dropped shares recorded:
    # bitwise equal to the served one (the combine adds in a fixed order)
    store = []
    warm, t_warm = prefill(moe=(moe_mod, {"moe_forward": recording_moe(store)}))
    check(torch.equal(warm, res.prefill_logits[:, 0, :v]),
          f"{MLA_ARCH}: two prefills of the same prompts differ")
    drops = [float(d) for _, _, d in store]
    check(len(store) == len(moe_layers), f"{MLA_ARCH}: {len(store)} MoE "
          f"calls in a prefill, expected {len(moe_layers)}")
    p1, x1, _ = store[0]
    del store
    err, excess, cap = moe_vs_dense(p1, x1, cfg, plan, "first MoE layer's "
                                    "prefill input")
    del x1
    log(f"[mla] warm prefill {t_warm * 1e3:.1f} ms, bitwise equal to the "
        f"served one; dropped_frac per MoE layer at prefill (C = {cap} of "
        f"T k = {LM_BATCH * LM_PROMPT * m.top_k}): "
        f"{[round(d, 5) for d in drops]}; MoE vs moe_dense_ref on the first "
        f"MoE layer's prefill input (T = {LM_BATCH * LM_PROMPT}): routing "
        f"equal, max abs {err:.4g}, beyond one bf16 ulp {excess:.4g}")

    # the prefill rerun with the plain version at the call site: each
    # layer's kernel output on that layer's own inputs
    layer_err, layer_excess = [], []
    plain, t_plain = prefill(attn=(attention, {"mha": checked_mha(
        attention.mha, layer_err, layer_excess)}))
    check(len(layer_err) == cfg.n_layers and bool(torch.isfinite(plain).all())
          and max(layer_excess) <= 2e-2, f"{MLA_ARCH}: kernel vs plain on "
          f"the layers' own inputs beyond one bf16 ulp: {layer_excess} (max "
          f"abs {layer_err})")
    log(f"[mla] prefill rerun with the plain version patched in: each layer's "
        f"kernel output vs plain on its own inputs max abs "
        f"{max(layer_err):.4g}, beyond one bf16 ulp {max(layer_excess):.4g} "
        f"over {len(layer_err)} layers (held to 2e-2); max logit difference "
        f"{float((warm - plain).abs().max()):.4g} (not bounded); plain with "
        f"the kernel beside it {t_plain * 1e3:.1f} ms")
    del warm, plain

    # one decode step from the prefilled caches: every MoE layer's input
    # against the dense reference; then where 4 steps' time goes
    caches, _ = model.prefill(batch, model.init_decode(
        LM_BATCH, LM_PROMPT + LM_GEN + 8))
    tok = torch.from_numpy(res.tokens[:, :1]).to(dev)
    store = []
    with patched(moe_mod, moe_forward=recording_moe(store)):
        model.decode_step(caches, tok, LM_PROMPT)
    dec = [moe_vs_dense(p, x, cfg, plan, f"decode, MoE layer {i}")
           for i, (p, x, _) in enumerate(store)]
    check(len(dec) == len(moe_layers), f"{MLA_ARCH}: {len(dec)} MoE calls "
          "in a decode step")
    log(f"[mla] MoE vs moe_dense_ref on every MoE layer's input of one "
        f"decode step ({len(dec)} layers, T = {LM_BATCH}, C = {dec[0][2]}): "
        f"routing equal, max abs {max(e for e, _, _ in dec):.4g}, beyond one "
        f"bf16 ulp {max(x for _, x, _ in dec):.4g}")
    del store

    # the decode step reads nothing back to the host: sync-debug "error"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(caches, tok, LM_PROMPT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # RoPE's sinf / cosf (float64 torch ops) give the CPU's bits on the card
    ang = layers_mod.rope_angles(torch.arange(LM_PROMPT + LM_GEN),
                                 cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    want_sc = sincos_f32(ang)
    got_sc = sincos_f32(ang.to(dev))
    check(all(torch.equal(a, b.cpu()) for a, b in zip(want_sc, got_sc)),
          f"{MLA_ARCH}: RoPE sin / cos on the card differ from the CPU's")
    log(f"[mla] one decode step under sync-debug mode 'error': no "
        f"synchronising call; RoPE sin / cos of {ang.numel()} angles "
        f"bitwise equal on the card and the CPU")

    def replay():
        c = caches
        for i in range(4):
            c, _ = model.decode_step(c, tok, LM_PROMPT + i)
        torch.cuda.synchronize()

    prof = profile_replay(f"{MLA_ARCH} decode B={LM_BATCH}", replay, 4)
    del caches, res, model
    torch.cuda.empty_cache()
    flash = phase_mla_flash(dev, cfg)
    out = {"launches": launches, "prefill_ms": t["prefill_s"] * 1e3,
           "warm_prefill_ms": t_warm * 1e3,
           "ms_per_step": t["ms_per_step"], "tok_s": t["tok_s"],
           "step_bound_ms": step_bound, "peak_gib": peak / 2**30,
           "weights_gib": weights / 2**30, "dropped_frac": drops,
           "profile": prof, "flash": flash}
    out["ring"] = phase_ring(dev)
    log(f"[mla] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_ring(dev):
    """Mixtral-8x22B at full width, 2 layers: prefill of its window, the
    ring's first decode steps held layer by layer against a plain
    window-masked cache on the same inputs, then the rest timed."""
    cfg = dataclasses.replace(configs.get(RING_ARCH), n_layers=RING_LAYERS)
    model = build_model(cfg, Plan(moe_capacity=0), device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    model.init_params(rng)
    prompt = torch.randint(0, cfg.vocab_size, (RING_BATCH, RING_PROMPT),
                           generator=rng, device=dev)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    batch, v = {"tokens": prompt}, cfg.vocab_size
    ring = model.init_decode(RING_BATCH, RING_PROMPT + RING_GEN + 8)
    check(ring[0].k.shape[1] == cfg.sliding_window, "mixtral: the cache is "
          "not a ring of the window")
    torch.cuda.synchronize()
    flash_kernel.COUNTER.launches = 0
    t0 = time.perf_counter()
    ring, logits = model.prefill(batch, ring)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = flash_kernel.COUNTER.launches
    check(launches == cfg.n_layers, f"mixtral: flash_attention launched "
          f"{launches} times in one prefill, expected {cfg.n_layers}")
    check(bool(torch.isfinite(logits[..., :v]).all()), "mixtral: prefill "
          "logits not finite")
    check(ring[0].length == RING_PROMPT, "mixtral: the ring's length after "
          "the prefill is wrong")
    # the prefill rerun with the plain version at the call site: each
    # layer's kernel output (GQA 48 / 8, window mask biting) on its inputs
    attn_err, attn_excess = [], []
    with patched(attention, mha=checked_mha(attention.mha, attn_err,
                                            attn_excess)):
        model.prefill(batch, model.init_decode(RING_BATCH, RING_PROMPT))
    check(len(attn_err) == cfg.n_layers and max(attn_excess) <= 2e-2,
          f"mixtral: kernel vs plain on the layers' own inputs beyond one "
          f"bf16 ulp: {attn_excess} (max abs {attn_err})")
    log(f"[ring] prefill rerun with the plain version patched in: each "
        f"layer's kernel output (B={RING_BATCH} S={RING_PROMPT} "
        f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.hd}, window "
        f"{cfg.sliding_window}) vs plain on its own inputs max abs "
        f"{max(attn_err):.4g}, beyond one bf16 ulp {max(attn_excess):.4g} "
        f"over {len(attn_err)} layers (held to 2e-2)")
    hkv = model.plan.padded_kv_heads(cfg.n_kv_heads)
    full = [attention.init_kv_cache(RING_BATCH, RING_PROMPT + 40, hkv, cfg.hd,
                                    False, device=dev)
            for _ in range(cfg.n_layers)]
    full, _ = model.prefill(batch, full)
    real, calls, excess, errs = attention.gqa_forward, [0], [], []

    def both(p, h, cfg_, plan, *, cache, decode, **kw):
        i = calls[0] % cfg_.n_layers
        calls[0] += 1
        y, c = real(p, h, cfg_, plan, cache=cache, decode=decode, **kw)
        want, full[i] = real(p, h, cfg_, plan, cache=full[i], decode=decode,
                             **kw)
        errs.append(float((y.float() - want.float()).abs().max()))
        excess.append(ulp_excess(y, want))
        return y, c

    tok = logits[:, -1].argmax(-1)[:, None]
    finite = True
    with patched(attention, gqa_forward=both):
        for i in range(RING_CHECK):
            ring, logits = model.decode_step(ring, tok, RING_PROMPT + i)
            finite &= bool(torch.isfinite(logits[..., :v]).all())
            tok = logits[:, -1].argmax(-1)[:, None]
    check(len(excess) == RING_CHECK * cfg.n_layers and max(excess) <= 2e-2,
          f"mixtral: ring vs window-masked full cache per layer beyond 2e-2 "
          f"plus one bf16 ulp: {excess} (max abs {errs})")
    del full
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RING_CHECK, RING_GEN):
        ring, logits = model.decode_step(ring, tok, RING_PROMPT + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    steps = RING_GEN - RING_CHECK
    ms = (time.perf_counter() - t0) / steps * 1e3
    finite &= bool(torch.isfinite(logits[..., :v]).all())
    check(finite and ring[0].length == RING_PROMPT + RING_GEN,
          "mixtral: decode logits not finite or the ring's length wrong")
    log(f"[ring] {cfg.name} at full width, {cfg.n_layers} of "
        f"{configs.get(RING_ARCH).n_layers} layers "
        f"(weights {weights / 2**30:.2f} GiB), window {cfg.sliding_window}: "
        f"batch {RING_BATCH}, prompt {RING_PROMPT} (the ring keeps its last "
        f"{cfg.sliding_window}); flash_attention "
        f"launches {launches} in the prefill ({t_prefill * 1e3:.1f} ms, "
        f"cold); {RING_CHECK} ring decode steps past the wrap vs a "
        f"{RING_PROMPT + 40}-slot window-masked cache, each layer's "
        f"attention output on the same inputs: max abs {max(errs):.4g}, "
        f"beyond one bf16 ulp {max(excess):.4g} (held to 2e-2); then "
        f"{steps} steps {ms:.3f} ms/step; finite logits")
    del model, ring
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": t_prefill * 1e3,
            "ms_per_step": ms, "max_excess": max(excess),
            "attn_max_excess": max(attn_excess)}


# ---------------------------------------------------------------------------
# phase 17: VLM serving with the int8 KV cache, and Whisper

def time_flash(dev, shape, seed, tag):
    """flash_attention at ``shape`` = (B, S, H, Hkv, D, causal) in bf16:
    within 2e-2 of plain, then the kernel, plain and SDPA timed as device
    time (CUDA-graph replay) beside the FLOP / byte bound; logged under
    ``tag``."""
    B, S, H, hkv, D, causal = shape
    q, k, v = flash_case(B, S, H, hkv, D, torch.bfloat16, seed=seed, dev=dev)
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    check(err <= 2e-2, f"flash_attention at {shape}: abs {err} (bar 2e-2)")
    del got, want
    qt, kt, vt = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flop, n_bytes = flash_work(B, S, H, hkv, D, 2, causal, 0)
    t_ops = flop / BF16_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {"shape": list(shape), "max_abs_err": err,
           "ms": graph_ms(lambda: flash_kernel.flash_attention(
               q, k, v, causal=causal), reps=3, samples=7),
           "plain_ms": graph_ms(lambda: flash_attention_ref(
               q, k, v, causal=causal), reps=1, samples=5),
           "library_ms": graph_ms(lambda: sdpa(
               qt, kt, vt, is_causal=causal, enable_gqa=hkv < H), reps=3,
               samples=7),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    res["tflops"] = flop / res["ms"] * 1e-9
    res["bound_share"] = res["bound_ms"] / res["ms"]
    log(f"{tag} flash_attention B={B} S={S} H={H} Hkv={hkv} D={D} bf16 "
        f"{'causal' if causal else 'non-causal'}: within 2e-2 of plain "
        f"({err:.3g}); device time (CUDA-graph replay) kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, SDPA "
        f"{res['library_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}; {flop:.3e} FLOP at 989 TFLOP/s {t_ops:.4f} ms, "
        f"{n_bytes} bytes at 3.35 TB/s {t_bytes:.4f} ms); kernel at "
        f"{res['tflops']:.1f} TFLOP/s, {res['bound_share']:.3f} of the bound")
    return res


def vlm_positions3(dev):
    """Qwen2-VL's (t, h, w) streams for phase 17's prompt: the 32 x 32
    vision grid (t 0, h the row, w the column), then the text from 32 on
    all three streams; (3, B, S) int64."""
    n = VLM_GRID * VLM_GRID
    idx = torch.arange(n, device=dev)
    text = VLM_GRID + torch.arange(VLM_PROMPT, device=dev)
    streams = [torch.cat([v, text]) for v in
               (torch.zeros_like(idx), idx // VLM_GRID, idx % VLM_GRID)]
    return torch.stack(streams)[:, None].expand(3, VLM_BATCH, n + VLM_PROMPT)


def recording_attend(errs):
    """``attention.attend`` that also runs the same call on the CPU copies
    of its inputs and records how far the card's output strays beyond one
    bf16 ulp of the CPU's; returns the card's."""
    real = attention.attend

    def rec(q, k, v, **kw):
        out = real(q, k, v, **kw)
        cpu = {n: (x.cpu() if isinstance(x, torch.Tensor) else x)
               for n, x in kw.items()}
        want = real(q.cpu(), k.cpu(), v.cpu(), **cpu)
        errs.append(ulp_excess(out.cpu(), want))
        return out
    return rec


def phase_vlm(dev):
    """Qwen2-VL-72B at full width, 4 layers, int8 KV cache: served through
    ``serve.serve_batch`` (the entry ``serve.run`` calls), checked and
    timed; its prefill with M-RoPE's (t, h, w) streams; then Whisper-tiny
    whole through ``serve.run``."""
    t_phase = time.perf_counter()
    full = configs.get(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    plan = Plan(kv_quant=True, moe_capacity=0)
    nv, v = cfg.n_vision_tokens, cfg.vocab_size
    s_all = nv + VLM_PROMPT
    s_max = s_all + VLM_GEN + 8
    log(f"[vlm] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"D={cfg.hd} (QKV bias, M-RoPE sections {cfg.mrope_sections}), d_ff "
        f"{cfg.d_ff}, vocab {v}; int8 KV cache; batch {VLM_BATCH}, {nv} "
        f"vision + {VLM_PROMPT} prompt tokens, {VLM_GEN} greedy tokens into "
        f"{s_max} cache slots; random weights from seed 0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, plan, device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    model.init_params(rng)
    prompt = torch.randint(0, v, (VLM_BATCH, VLM_PROMPT), generator=rng,
                           device=dev)
    batch = {"tokens": prompt, "vision_embeds": torch.zeros(
        (VLM_BATCH, nv, cfg.d_model), dtype=torch.bfloat16, device=dev)}
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    flash_kernel.COUNTER.launches = 0
    toks, served, logits, t = serve.serve_batch(model, batch, VLM_GEN)
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches == cfg.n_layers, f"{VLM_ARCH}: flash_attention launched "
          f"{launches} times in one prefill, expected {cfg.n_layers}")
    check(toks.shape == (VLM_BATCH, VLM_GEN) and 0 <= toks.min()
          and toks.max() < v, f"{VLM_ARCH}: tokens {toks.shape} out of range")
    for name, lg in (("prefill", served), ("decode", logits)):
        check(bool(torch.isfinite(lg[..., :v]).all()),
              f"{VLM_ARCH}: {name} logits not finite")
    caches = model.init_decode(VLM_BATCH, s_max)
    c0 = caches[0]
    int8_bytes = sum(x.numel() * x.element_size() for c in caches
                     for x in c[:4])
    bf16_bytes = 2 * cfg.n_layers * c0.k.numel() * 2
    log(f"[vlm] launches flash_attention={launches} (one per layer, B "
        f"{VLM_BATCH} S {s_all} H {cfg.n_heads} Hkv {cfg.n_kv_heads} D "
        f"{cfg.hd}); prefill {t['prefill_s'] * 1e3:.1f} ms (first, cold); "
        f"decode {t['ms_per_step']:.3f} ms/step over {VLM_GEN} steps "
        f"({t['tok_s']:.1f} tokens/s); KV cache {int8_bytes} bytes int8 + "
        f"scales against {bf16_bytes} in bf16 ({int8_bytes / bf16_bytes:.4f}"
        f"x); peak device memory {peak / 2**30:.2f} GiB (weights "
        f"{weights / 2**30:.2f} GiB)")

    # a warm prefill into fresh int8 caches, recording each layer's bf16
    # K / V: its logits equal the served prefill's, and each cache's codes
    # and scales equal the CPU's _quant_kv of the same K / V, bit for bit
    kv_in = []
    real_update = attention.cache_update

    def rec_update(cache, k_new, v_new, pos):
        kv_in.append((k_new, v_new))
        return real_update(cache, k_new, v_new, pos)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(attention, cache_update=rec_update):
        caches, warm = model.prefill(batch, caches)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(torch.equal(warm, served), f"{VLM_ARCH}: two prefills differ")
    check(len(kv_in) == cfg.n_layers, f"{VLM_ARCH}: {len(kv_in)} cache "
          "writes in a prefill")
    for i, ((k_new, v_new), c) in enumerate(zip(kv_in, caches)):
        for x, codes, scales in ((k_new, c.k, c.k_scale),
                                 (v_new, c.v, c.v_scale)):
            q_cpu, s_cpu = attention._quant_kv(x.cpu())
            check(torch.equal(codes[:, :s_all].cpu(), q_cpu)
                  and torch.equal(scales[:, :s_all].cpu().view(torch.int32),
                                  s_cpu.view(torch.int32)),
                  f"{VLM_ARCH}: layer {i}'s int8 codes or scales differ from "
                  f"the CPU's _quant_kv of the same K / V")
    del kv_in
    log(f"[vlm] warm prefill {t_warm * 1e3:.1f} ms, bitwise equal to the "
        f"served one; every layer's int8 codes and f32 scales ({s_all} "
        f"tokens x {cfg.n_kv_heads} heads, K and V) bitwise equal to the "
        f"CPU's _quant_kv of the same bf16 K / V")

    # the prefill rerun with the plain version at the call site: each
    # layer's kernel output on its own inputs (q scaled in bf16, scale 1)
    layer_err, layer_excess = [], []
    with patched(attention, mha=checked_mha(attention.mha, layer_err,
                                            layer_excess)):
        _, plain = model.prefill(batch, model.init_decode(VLM_BATCH, s_all))
    check(len(layer_err) == cfg.n_layers and max(layer_excess) <= 2e-2,
          f"{VLM_ARCH}: kernel vs plain on the layers' own inputs beyond one "
          f"bf16 ulp: {layer_excess} (max abs {layer_err})")
    log(f"[vlm] prefill rerun with the plain version patched in: each "
        f"layer's kernel output vs plain on its own inputs max abs "
        f"{max(layer_err):.4g}, beyond one bf16 ulp {max(layer_excess):.4g} "
        f"over {len(layer_err)} layers (held to 2e-2); max logit difference "
        f"{float((warm - plain).abs().max()):.4g} (not bounded)")
    del plain

    # M-RoPE's streams: random vision embeddings, prefilled with the 32 x
    # 32 grid's positions3 and with broadcast positions
    vis = torch.randn((VLM_BATCH, nv, cfg.d_model), generator=rng,
                      device=dev).to(torch.bfloat16)
    grid = dict(batch, vision_embeds=vis, positions3=vlm_positions3(dev))
    _, lg3 = model.prefill(grid, model.init_decode(VLM_BATCH, s_all))
    _, lg1 = model.prefill(dict(batch, vision_embeds=vis),
                           model.init_decode(VLM_BATCH, s_all))
    moved = float((lg3[..., :v] - lg1[..., :v]).abs().max())
    check(bool(torch.isfinite(lg3[..., :v]).all()) and moved > 0,
          f"{VLM_ARCH}: the positions3 prefill's logits are not finite or "
          f"equal the broadcast-position prefill's")
    log(f"[vlm] prefill with random vision embeddings and positions3 (a "
        f"{VLM_GRID} x {VLM_GRID} grid, text from {VLM_GRID}): finite "
        f"logits, max {moved:.4g} from the broadcast-position prefill's")
    del lg3, lg1, vis, grid

    # the first decode steps from the warm prefill's int8 caches, each
    # layer's attention output beside a bf16 cache prefilled from the same
    # prompt; every attend of both held against the CPU's attend on the
    # same inputs
    hkv = plan.padded_kv_heads(cfg.n_kv_heads)
    bf16 = [attention.init_kv_cache(VLM_BATCH, s_max, hkv, cfg.hd, False,
                                    device=dev) for _ in range(cfg.n_layers)]
    bf16, _ = model.prefill(batch, bf16)
    real, calls, gaps, cpu_excess = attention.gqa_forward, [0], [], []

    def both(p, h, cfg_, plan_, *, cache, decode, **kw):
        i = calls[0] % cfg_.n_layers
        calls[0] += 1
        y, c = real(p, h, cfg_, plan_, cache=cache, decode=decode, **kw)
        y_bf, bf16[i] = real(p, h, cfg_, plan_, cache=bf16[i],
                             decode=decode, **kw)
        gaps.append((ulp_excess(y, y_bf), float(
            (y.float() - y_bf.float()).norm() / y_bf.float().norm())))
        return y, c

    tok = served[:, -1].argmax(-1)[:, None]
    with patched(attention, gqa_forward=both,
                 attend=recording_attend(cpu_excess)):
        for i in range(VLM_CHECK):
            caches, lg = model.decode_step(caches, tok, s_all + i)
            check(bool(torch.isfinite(lg[..., :v]).all()),
                  f"{VLM_ARCH}: decode logits not finite")
            tok = lg[:, -1].argmax(-1)[:, None]
    n = VLM_CHECK * cfg.n_layers
    check(len(gaps) == n and len(cpu_excess) == 2 * n
          and max(cpu_excess) <= 2e-2, f"{VLM_ARCH}: decode attention on the "
          f"card vs the CPU beyond 2e-2 plus one bf16 ulp: {cpu_excess}")
    g = list(zip(*gaps))
    log(f"[vlm] {VLM_CHECK} decode steps x {cfg.n_layers} layers from the "
        f"int8 caches: every attend (int8 and bf16 cache; "
        f"{len(cpu_excess)} calls) on the card within "
        f"{max(cpu_excess):.4g} beyond one bf16 ulp of the CPU's attend on "
        f"the same inputs (held to 2e-2); int8 vs bf16 cache beyond one bf16 "
        f"ulp {max(g[0]):.4g} (relative L2 {max(g[1]):.4g}; not bounded)")
    del bf16

    # one more int8 decode step reads nothing back to the host (sync-debug
    # "error"); then where 4 steps' time goes
    pos = s_all + VLM_CHECK
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        caches, _ = model.decode_step(caches, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[vlm] one int8 decode step under sync-debug mode 'error': no "
        f"synchronising call")

    def replay():
        c = caches
        for i in range(4):
            c, _ = model.decode_step(c, tok, pos + 1 + i)
        torch.cuda.synchronize()

    prof = profile_replay(f"{VLM_ARCH} int8 decode B={VLM_BATCH}", replay, 4)
    del caches, model
    torch.cuda.empty_cache()
    flash = time_flash(dev, (VLM_BATCH, s_all, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, True), 400, "[vlm]")
    out = {"launches": launches, "prefill_ms": t["prefill_s"] * 1e3,
           "warm_prefill_ms": t_warm * 1e3, "ms_per_step": t["ms_per_step"],
           "tok_s": t["tok_s"], "peak_gib": peak / 2**30,
           "weights_gib": weights / 2**30,
           "cache_ratio": int8_bytes / bf16_bytes, "bf16_gap": max(g[0]),
           "profile": prof, "flash": flash}
    out["whisper"] = phase_whisper(dev)
    log(f"[vlm] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_whisper(dev):
    """Whisper-tiny whole through ``serve.run(reduced=False)``: 4 encoder
    layers non-causal at S 1500 and 4 decoder layers causal at the prompt's
    length, each a flash_attention launch; each layer's kernel output
    against plain, a warm prefill bitwise equal to the served one; a
    decode step with no synchronising call; the encoder, its GELU, prefill
    and decode timed, the encoder and decode profiled."""
    flash_kernel.COUNTER.launches = 0
    res = serve.run(ASR_ARCH, reduced=False, prompt_len=ASR_PROMPT,
                    gen=ASR_GEN, batch=ASR_BATCH, seed=0, device=dev)
    launches = flash_kernel.COUNTER.launches
    cfg = res.model.cfg
    v = cfg.vocab_size
    n_attn = cfg.encoder_layers + cfg.n_layers
    check(launches == n_attn, f"{ASR_ARCH}: flash_attention launched "
          f"{launches} times in one prefill, expected {n_attn}")
    check(res.tokens.shape == (ASR_BATCH, ASR_GEN) and 0 <= res.tokens.min()
          and res.tokens.max() < v and bool(torch.isfinite(
              res.logits[..., :v]).all()) and bool(torch.isfinite(
                  res.prefill_logits[..., :v]).all()),
          f"{ASR_ARCH}: tokens out of range or logits not finite")
    model = res.model
    s_max = ASR_PROMPT + ASR_GEN + 8
    # a warm prefill, the shape and mask of every mha call recorded
    shapes = []
    real_mha = attention.mha

    def rec_mha(q, k, v_, *, causal=True, window=0, scale=None):
        shapes.append((tuple(q.shape), causal))
        return real_mha(q, k, v_, causal=causal, window=window, scale=scale)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(attention, mha=rec_mha):
        _, warm = model.prefill(res.batch, model.init_decode(ASR_BATCH,
                                                             s_max))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    d_enc = (ASR_BATCH, cfg.n_audio_frames, cfg.n_heads, cfg.hd)
    d_dec = (ASR_BATCH, ASR_PROMPT, cfg.n_heads, cfg.hd)
    check(shapes == [(d_enc, False)] * cfg.encoder_layers +
          [(d_dec, True)] * cfg.n_layers, f"{ASR_ARCH}: prefill attention "
          f"calls {shapes}")
    check(torch.equal(warm, res.prefill_logits), f"{ASR_ARCH}: two prefills "
          "differ")
    layer_err, layer_excess = [], []
    with patched(attention, mha=checked_mha(real_mha, layer_err,
                                            layer_excess)):
        _, plain = model.prefill(res.batch, model.init_decode(ASR_BATCH,
                                                              s_max))
    check(len(layer_err) == n_attn and max(layer_excess) <= 2e-2,
          f"{ASR_ARCH}: kernel vs plain on the layers' own inputs beyond one "
          f"bf16 ulp: {layer_excess} (max abs {layer_err})")
    audio = res.batch["audio_embeds"]
    for _ in range(2):
        whisper_mod.encode(model, audio, cfg, model.plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        whisper_mod.encode(model, audio, cfg, model.plan)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) / 5 * 1e3

    def encode_once():
        whisper_mod.encode(model, audio, cfg, model.plan)
        torch.cuda.synchronize()

    enc_prof = profile_replay(f"{ASR_ARCH} encoder B={ASR_BATCH}",
                              encode_once, 1)
    gelu = whisper_gelu(dev, cfg, enc_ms)

    # a decode step reads nothing back to the host (sync-debug "error");
    # then where 4 steps' time goes
    state, _ = model.prefill(res.batch, model.init_decode(ASR_BATCH, s_max))
    tok = torch.from_numpy(res.tokens[:, :1]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(state, tok, ASR_PROMPT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[whisper] one decode step under sync-debug mode 'error': no "
        f"synchronising call")

    def replay():
        c = state
        for i in range(4):
            c, _ = model.decode_step(c, tok, ASR_PROMPT + i)
        torch.cuda.synchronize()

    dec_prof = profile_replay(f"{ASR_ARCH} decode B={ASR_BATCH}", replay, 4)
    t = res.timings
    log(f"[whisper] {cfg.name} whole ({cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, d {cfg.d_model}, H {cfg.n_heads}, D {cfg.hd}, "
        f"{cfg.n_audio_frames} frames, vocab {v}): batch {ASR_BATCH}, prompt "
        f"{ASR_PROMPT}, {ASR_GEN} greedy tokens; flash_attention launches "
        f"{launches} ({cfg.encoder_layers} non-causal at S "
        f"{cfg.n_audio_frames}, {cfg.n_layers} causal at S {ASR_PROMPT}); "
        f"each layer's kernel output vs plain on its own inputs max abs "
        f"{max(layer_err):.4g}, beyond one bf16 ulp {max(layer_excess):.4g} "
        f"(held to 2e-2); max logit difference "
        f"{float((warm - plain).abs().max()):.4g} (not bounded); encoder "
        f"{enc_ms:.2f} ms (warm, synchronised, mean of 5); prefill "
        f"{t['prefill_s'] * 1e3:.1f} ms first, {t_warm * 1e3:.1f} warm, "
        f"bitwise equal; decode {t['ms_per_step']:.3f} ms/step "
        f"({t['tok_s']:.1f} tokens/s)")
    del res, model, warm, plain, state
    torch.cuda.empty_cache()
    flash = time_flash(dev, d_enc[:3] + (cfg.n_heads, cfg.hd, False), 401,
                       "[whisper]")
    return {"launches": launches, "encoder_ms": enc_ms,
            "prefill_ms": t["prefill_s"] * 1e3, "warm_prefill_ms": t_warm * 1e3,
            "ms_per_step": t["ms_per_step"], "tok_s": t["tok_s"],
            "encoder_profile": enc_prof, "decode_profile": dec_prof,
            "gelu": gelu, "flash": flash}


def whisper_gelu(dev, cfg, enc_ms):
    """The encoder MLP's GELU alone at its shape (B, frames, d_ff) f32:
    ``layers.gelu_tanh`` (XLA's tanh emulated in float64) bitwise equal on
    the card and the CPU on the first batch row, then timed as device time
    beside torch's ``gelu(approximate="tanh")``; its share of the encoder
    (one GELU per encoder layer)."""
    gen = torch.Generator(device=dev).manual_seed(402)
    h = torch.randn((ASR_BATCH, cfg.n_audio_frames, cfg.d_ff), generator=gen,
                    device=dev)
    check(torch.equal(layers_mod.gelu_tanh(h[0]).cpu(),
                      layers_mod.gelu_tanh(h[0].cpu())),
          f"{ASR_ARCH}: gelu_tanh on the card differs from the CPU's")
    ms = graph_ms(lambda: layers_mod.gelu_tanh(h), reps=3, samples=7)
    lib = graph_ms(lambda: torch.nn.functional.gelu(h, approximate="tanh"),
                   reps=3, samples=7)
    share = cfg.encoder_layers * ms / enc_ms
    log(f"[whisper] encoder GELU alone at ({ASR_BATCH}, "
        f"{cfg.n_audio_frames}, {cfg.d_ff}) f32: gelu_tanh bitwise equal on "
        f"the card and the CPU (first row); device time (CUDA-graph replay) "
        f"{ms:.4f} ms, torch gelu(approximate='tanh') {lib:.4f} ms; "
        f"{cfg.encoder_layers} of them are {share:.4f} of the encoder's "
        f"{enc_ms:.2f} ms")
    return {"ms": ms, "library_ms": lib, "encoder_share": share}


# ---------------------------------------------------------------------------
# phase 18: the attention-free mixers (Mamba in Jamba, RWKV-6)

def recording(module, name, store, n_tokens):
    """``module.name`` (a mixer ``(p, x, cfg, plan, **kw)``) that keeps
    each call's parameters and the first ``n_tokens`` of its input."""
    real = getattr(module, name)

    def rec(p, x, *a, **kw):
        store.append((p, x[:, :n_tokens].clone()))
        return real(p, x, *a, **kw)
    return patched(module, **{name: rec})


def cpu_tree(params):
    """A ``ParamTree``'s parameters as nested dicts of CPU tensors."""
    out = {}
    for name, t in params.named_parameters():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = t.detach().cpu()
    return out


def state_rel(got, want):
    """Max abs difference of two f32 states, over the reference's largest
    magnitude."""
    want = want.float()
    return float((got.cpu().float() - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


def card_vs_cpu(tag, what, got, want):
    """A bf16 output of the card against the CPU's on the same inputs:
    within 2e-2 plus one bf16 ulp; (max abs, beyond one ulp)."""
    err = float((got.cpu().float() - want.float()).abs().max())
    excess = ulp_excess(got.cpu(), want)
    check(excess <= 2e-2, f"{tag}: {what} on the card vs the CPU beyond 2e-2 "
          f"plus one bf16 ulp: {excess} (max abs {err})")
    return err, excess


def mamba_holds(tag, p, x, cfg, plan):
    """One Mamba layer of the served model on its recorded inputs x (B,
    SSM_CHECK, D): the card against the CPU on the same bf16 inputs and
    weights, the f32 ssm state's error relative to its largest entry
    printed; then a decode continuing a shorter prefill."""
    b, dev = x.shape[0], x.device
    out, st = mamba_mod.mamba_forward(
        p, x, cfg, plan, state=mamba_mod.init_state(cfg, b, device=dev))
    t0 = time.perf_counter()
    want, wst = mamba_mod.mamba_forward(
        cpu_tree(p), x.cpu(), cfg, plan,
        state=mamba_mod.init_state(cfg, b, device="cpu"))
    t_cpu = time.perf_counter() - t0
    err, excess = card_vs_cpu(tag, "the output", out, want)
    rel = state_rel(st.ssm, wst.ssm)
    conv = float((st.conv.cpu().float() - wst.conv.float()).abs().max())
    # the decode continuing a shorter prefill, against the whole prefill
    n0 = SSM_CHECK - SSM_DECODE
    _, st = mamba_mod.mamba_forward(
        p, x[:, :n0], cfg, plan, state=mamba_mod.init_state(cfg, b,
                                                             device=dev))
    dec = []
    for t in range(n0, SSM_CHECK):
        o, st = mamba_mod.mamba_forward(p, x[:, t:t + 1], cfg, plan,
                                        state=st, decode=True)
        dec.append(float((o.float() - out[:, t:t + 1].float()).abs().max()))
    check(max(dec) < 5e-2, f"{tag}: decode continuing a {n0}-token prefill "
          f"vs the {SSM_CHECK}-token prefill: {dec}")
    dec = max(dec)
    log(f"{tag} on the layer's first {SSM_CHECK} prefill inputs (B {b}): "
        f"card vs CPU on the same bf16 inputs and weights max abs "
        f"{err:.4g}, beyond one bf16 ulp {excess:.4g} (held to 2e-2); f32 "
        f"ssm state max abs error relative to its largest entry {rel:.4g}; "
        f"conv state max abs {conv:.4g}; CPU {t_cpu:.1f} s; "
        f"{SSM_DECODE} decode steps after a {n0}-token prefill vs the "
        f"{SSM_CHECK}-token prefill max abs {dec:.4g} (held to 5e-2)")
    return {"max_abs_err": err, "ulp_excess": excess, "state_rel": rel,
            "decode_err": dec}


def rwkv_holds(tag, p, x, cfg, plan):
    """One RWKV block of the served model on its recorded inputs x (B,
    SSM_CHECK, D): each of its four stages (ln1, the time mix, ln2, the
    channel mix) against the CPU on the card's own input to it, as phase
    8 holds each attention layer's output on its own inputs (a residual
    add, x + y in bf16, rounds alike given alike inputs, but at the
    stream's magnitude, up to ~25 here, its one more rounding can put a
    device's last-bit differences in y past one ulp of the sum); the whole
    block's card-vs-CPU gap and the f32 wkv state's error relative to its
    largest entry printed; then a decode continuing a shorter prefill."""
    b, dev = x.shape[0], x.device
    cp = cpu_tree(p)

    def ln(q, h, w):
        return layers_mod.layer_norm(h, {"w": q[w], "b": q[w + "_b"]}, 1e-5)

    t0 = time.perf_counter()
    held = {}
    xn1 = ln(p, x, "ln1")
    held["ln1"] = card_vs_cpu(tag, "ln1", xn1, ln(cp, x.cpu(), "ln1"))
    y_tm, (_, wkv) = rwkv_mod.time_mix(p["tm"], xn1, cfg)
    want, (_, wwkv) = rwkv_mod.time_mix(cp["tm"], xn1.cpu(), cfg)
    held["time_mix"] = card_vs_cpu(tag, "the time mix", y_tm, want)
    x2 = x + y_tm
    xn2 = ln(p, x2, "ln2")
    held["ln2"] = card_vs_cpu(tag, "ln2", xn2, ln(cp, x2.cpu(), "ln2"))
    y_cm, _ = rwkv_mod.channel_mix(p["cm"], xn2)
    want, _ = rwkv_mod.channel_mix(cp["cm"], xn2.cpu())
    held["channel_mix"] = card_vs_cpu(tag, "the channel mix", y_cm, want)
    out = x2 + y_cm
    block, _ = rwkv_mod.rwkv_block(cp, x.cpu(), cfg, plan)
    t_cpu = time.perf_counter() - t0
    gap = float((out.cpu().float() - block.float()).abs().max())
    gap_ex = ulp_excess(out.cpu(), block)
    rel = state_rel(wkv, wwkv)
    # the decode continuing a shorter prefill, held on the two mixers'
    # outputs (the time mix carries wkv and x_tm, the channel mix x_cm)
    # against the whole prefill's; the block's output printed
    mixed = {"time_mix": [], "channel_mix": []}

    def recorder(name):
        real = getattr(rwkv_mod, name)

        def rec(*a, **kw):
            res = real(*a, **kw)
            mixed[name].append(res[0])
            return res
        return rec

    st = rwkv_mod.init_state(cfg, b, device=dev)
    n0 = SSM_CHECK - SSM_DECODE
    dec, dec_out = [], []
    with patched(rwkv_mod, time_mix=recorder("time_mix"),
                 channel_mix=recorder("channel_mix")):
        full, _ = rwkv_mod.rwkv_block(p, x, cfg, plan, state=st)
        _, st = rwkv_mod.rwkv_block(p, x[:, :n0], cfg, plan, state=st)
        for t in range(n0, SSM_CHECK):
            o, st = rwkv_mod.rwkv_block(p, x[:, t:t + 1], cfg, plan,
                                        state=st)
            dec.append(max(float((mixed[k][-1].float() - mixed[k][0][
                :, t:t + 1].float()).abs().max()) for k in mixed))
            dec_out.append(float((o.float() - full[:, t:t + 1].float())
                                 .abs().max()))
    check(torch.equal(full, out) and max(dec) < 5e-2, f"{tag}: the mixers' "
          f"outputs decoding after a {n0}-token prefill vs the "
          f"{SSM_CHECK}-token prefill: {dec}")
    dec = max(dec)
    stages = "; ".join(f"{k} max abs {e:.4g}, beyond one bf16 ulp {x_:.4g}"
                       for k, (e, x_) in held.items())
    log(f"{tag} on the block's first {SSM_CHECK} prefill inputs (B {b}): "
        f"card vs CPU on the same bf16 inputs and weights, each stage on "
        f"the card's own input to it: {stages} (held to 2e-2); the whole "
        f"block vs the CPU's whole block max abs {gap:.4g}, beyond one bf16 "
        f"ulp {gap_ex:.4g} (not bounded); f32 wkv state max abs error "
        f"relative to its largest entry {rel:.4g}; card and CPU "
        f"{t_cpu:.1f} s; {SSM_DECODE} decode steps after a {n0}-token "
        f"prefill vs the {SSM_CHECK}-token prefill: the time and channel "
        f"mixes' outputs max abs {dec:.4g} (held to 5e-2), the block's "
        f"{max(dec_out):.4g} (not bounded)")
    return {"max_abs_err": max(e for e, _ in held.values()),
            "ulp_excess": max(x_ for _, x_ in held.values()),
            "block_gap": gap, "block_ulp_excess": gap_ex, "state_rel": rel,
            "decode_err": dec, "block_decode_err": max(dec_out)}


def ssm_prefill_share(model, batch, n, s_max, module, name):
    """A prefill with ``module.name`` (the per-token recurrence) timed
    synchronised on both sides: (its wall s, the recurrences' s)."""
    shares = {}
    caches = model.init_decode(n, s_max)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with host_timer(shares, "rec", module, name, sync=True):
        model.prefill(batch, caches)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, shares["rec"]


def ssm_decode_checks(tag, model, caches, pos, tok):
    """One decode step from a prefill's ``caches`` under sync-debug mode
    "error", then a profile of 4 steps."""
    n = tok.shape[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(caches, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"{tag} one decode step under sync-debug mode 'error': no "
        f"synchronising call")

    def replay():
        c = caches
        for i in range(4):
            c, _ = model.decode_step(c, tok, pos + i)
        torch.cuda.synchronize()

    return profile_replay(f"{model.cfg.name} decode B={n}", replay, 4)


def phase_jamba(dev):
    """Jamba-v0.1-52B at full width, one 8-layer period, served through
    ``serve.serve_batch``: one flash_attention launch a prefill (H 32, Hkv
    8, no RoPE), checked and timed."""
    full = configs.get(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    plan = Plan(moe_capacity=0)
    v, n, s = cfg.vocab_size, JAMBA_BATCH, JAMBA_PROMPT
    s_max = s + JAMBA_GEN + 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, plan, device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    model.init_params(rng)
    prompt = torch.randint(0, v, (n, s), generator=rng, device=dev)
    batch = {"tokens": prompt}
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kinds = [f"{d.mixer}+{d.ffn}" for d in
             (model_layer_def(cfg, i) for i in range(cfg.n_layers))]
    log(f"[jamba] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
        f"({', '.join(kinds)}), d_model {cfg.d_model}, Mamba d_state "
        f"{cfg.mamba.d_state} d_conv {cfg.mamba.d_conv} expand "
        f"{cfg.mamba.expand}, attention H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
        f"D={cfg.hd} (no RoPE), {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab {v}; weights "
        f"{weights / 2**30:.2f} GiB; batch {n}, prompt {s}, {JAMBA_GEN} "
        f"greedy tokens; random weights from seed 0")
    flash_kernel.COUNTER.launches = 0
    toks, served, logits, t = serve.serve_batch(model, batch, JAMBA_GEN)
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev)
    n_attn = kinds.count("attn+dense") + kinds.count("attn+moe")
    check(launches == n_attn == 1, f"{JAMBA_ARCH}: flash_attention launched "
          f"{launches} times in one prefill, expected {n_attn}")
    check(toks.shape == (n, JAMBA_GEN) and 0 <= toks.min() and toks.max() < v,
          f"{JAMBA_ARCH}: tokens {toks.shape} out of range")
    for name, lg in (("prefill", served), ("decode", logits)):
        check(bool(torch.isfinite(lg[..., :v]).all()),
              f"{JAMBA_ARCH}: {name} logits not finite")

    # a warm prefill recording the attention call's shapes, each MoE
    # layer's dropped share and each Mamba layer's first inputs: bitwise
    # equal to the served one
    shapes, moe_store, mamba_store = [], [], []
    real_mha = attention.mha

    def rec_mha(q, k, v_, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real_mha(q, k, v_, **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(attention, mha=rec_mha), \
            patched(moe_mod, moe_forward=recording_moe(moe_store)), \
            recording(mamba_mod, "mamba_forward", mamba_store, SSM_CHECK):
        caches, warm = model.prefill(batch, model.init_decode(n, s_max))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(torch.equal(warm, served), f"{JAMBA_ARCH}: two prefills differ")
    want_q = (n, s, cfg.n_heads, cfg.hd)
    want_k = (n, s, cfg.n_kv_heads, cfg.hd)
    check(shapes == [(want_q, want_k)], f"{JAMBA_ARCH}: prefill attention "
          f"calls {shapes}, expected one at q {want_q}, k {want_k}")
    drops = [round(float(d), 5) for _, _, d in moe_store]
    del moe_store
    check(len(drops) == kinds.count("mamba+moe") + kinds.count("attn+moe")
          and len(mamba_store) == kinds.count("mamba+dense") +
          kinds.count("mamba+moe"), f"{JAMBA_ARCH}: {len(drops)} MoE and "
          f"{len(mamba_store)} Mamba calls in a prefill")

    layer_err, layer_excess = [], []
    with patched(attention, mha=checked_mha(real_mha, layer_err,
                                            layer_excess)):
        _, plain = model.prefill(batch, model.init_decode(n, s_max))
    check(len(layer_err) == n_attn and max(layer_excess) <= 2e-2,
          f"{JAMBA_ARCH}: kernel vs plain on the layer's own inputs beyond "
          f"one bf16 ulp: {layer_excess} (max abs {layer_err})")
    log(f"[jamba] launches flash_attention={launches} (q {want_q}, k "
        f"{want_k}, causal, no RoPE); prefill {t['prefill_s'] * 1e3:.1f} ms "
        f"first (cold), {t_warm * 1e3:.1f} ms warm, bitwise equal; decode "
        f"{t['ms_per_step']:.3f} ms/step over {JAMBA_GEN} steps "
        f"({t['tok_s']:.1f} tokens/s); peak device memory "
        f"{peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f} GiB); "
        f"dropped_frac per MoE layer at prefill (C = "
        f"{moe_mod.capacity(cfg, plan, n, s)} of T k = "
        f"{n * s * cfg.moe.top_k}): {drops}; the attention layer's kernel "
        f"output vs plain on its own inputs max abs {max(layer_err):.4g}, "
        f"beyond one bf16 ulp {max(layer_excess):.4g} (held to 2e-2); max "
        f"logit difference {float((warm - plain).abs().max()):.4g} (not "
        f"bounded)")
    del warm, plain

    # the recurrence of the Mamba layer just before the attention layer
    mamba_layers = [i for i, k in enumerate(kinds) if k.startswith("mamba")]
    layer = kinds.index("attn+dense") - 1
    p, x = mamba_store[mamba_layers.index(layer)]
    del mamba_store
    held = mamba_holds(f"[jamba] mamba_forward (layer {layer})", p, x, cfg,
                       plan)
    del p, x
    wall, rec = ssm_prefill_share(model, batch, n, s_max, mamba_mod,
                                  "_recurrence")
    log(f"[jamba] prefill with the per-token recurrences timed (synchronised "
        f"around each chunk's): {wall * 1e3:.1f} ms, of which the "
        f"recurrences {rec * 1e3:.1f} ms, share {rec / wall:.4f}")
    prof = ssm_decode_checks("[jamba]", model, caches, s,
                             torch.from_numpy(toks[:, :1]).to(dev))
    del caches
    # a decode step reads every layer's weights: all 16 experts' (the
    # (E, C, D) buffers), the dense FFNs, the mixers, the head
    step_bytes = weights - model.tok_embed.numel() * 2
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[jamba] a decode step reads {step_bytes / 1e9:.2f} GB of weights "
        f"(all but the embedding table): at least {step_bound:.3f} ms/step "
        f"at 3.35 TB/s against {t['ms_per_step']:.3f}")
    del model
    torch.cuda.empty_cache()
    flash = time_flash(dev, (n, s, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                             True), 403, "[jamba]")
    return {"launches": launches, "prefill_ms": t["prefill_s"] * 1e3,
            "warm_prefill_ms": t_warm * 1e3, "ms_per_step": t["ms_per_step"],
            "tok_s": t["tok_s"], "peak_gib": peak / 2**30,
            "weights_gib": weights / 2**30, "dropped_frac": drops,
            "step_bound_ms": step_bound, "recurrence_share": rec / wall,
            "held": held, "profile": prof, "flash": flash}


def phase_rwkv(dev):
    """RWKV6-3B whole through ``serve.run(reduced=False)``: no kernel
    launch, checked and timed."""
    cfg = configs.get(RWKV_ARCH)
    n, s = RWKV_BATCH, RWKV_PROMPT
    s_max = s + RWKV_GEN + 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_kernel.COUNTER.launches = 0
    res = serve.run(RWKV_ARCH, reduced=False, prompt_len=s, gen=RWKV_GEN,
                    batch=n, seed=0, device=dev)
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev)
    model, batch, plan = res.model, res.batch, res.model.plan
    v = cfg.vocab_size
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    check(launches == 0, f"{RWKV_ARCH}: flash_attention launched {launches} "
          f"times; the model has no attention")
    check(res.tokens.shape == (n, RWKV_GEN) and 0 <= res.tokens.min()
          and res.tokens.max() < v and bool(torch.isfinite(
              res.logits[..., :v]).all()) and bool(torch.isfinite(
                  res.prefill_logits[..., :v]).all()),
          f"{RWKV_ARCH}: tokens out of range or logits not finite")
    store = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(rwkv_mod, "rwkv_block", store, SSM_CHECK):
        caches, warm = model.prefill(batch, model.init_decode(n, s_max))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(torch.equal(warm, res.prefill_logits), f"{RWKV_ARCH}: two "
          "prefills differ")
    check(len(store) == cfg.n_layers, f"{RWKV_ARCH}: {len(store)} RWKV "
          f"blocks in a prefill")
    t = res.timings
    log(f"[rwkv] {cfg.name} whole ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {v}; weights {weights / 2**30:.2f} GiB): batch {n}, prompt "
        f"{s}, {RWKV_GEN} greedy tokens; flash_attention launches "
        f"{launches}; prefill {t['prefill_s'] * 1e3:.1f} ms first (cold), "
        f"{t_warm * 1e3:.1f} ms warm, bitwise equal; decode "
        f"{t['ms_per_step']:.3f} ms/step ({t['tok_s']:.1f} tokens/s); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    p, x = store[cfg.n_layers // 2]
    del store
    held = rwkv_holds(f"[rwkv] rwkv_block (layer {cfg.n_layers // 2})", p,
                      x, cfg, plan)
    del p, x
    wall, rec = ssm_prefill_share(model, batch, n, s_max, rwkv_mod,
                                  "_wkv_scan")
    log(f"[rwkv] prefill with the per-token recurrences timed (synchronised "
        f"around each chunk's): {wall * 1e3:.1f} ms, of which the "
        f"recurrences {rec * 1e3:.1f} ms, share {rec / wall:.4f}")
    prof = ssm_decode_checks("[rwkv]", model, caches, s,
                             torch.from_numpy(res.tokens[:, :1]).to(dev))
    del caches
    step_bytes = weights - model.tok_embed.numel() * 2
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[rwkv] a decode step reads {step_bytes / 1e9:.2f} GB of weights "
        f"(all but the embedding table): at least {step_bound:.3f} ms/step "
        f"at 3.35 TB/s against {t['ms_per_step']:.3f}")
    del res, model, warm
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": t["prefill_s"] * 1e3,
            "warm_prefill_ms": t_warm * 1e3, "ms_per_step": t["ms_per_step"],
            "tok_s": t["tok_s"], "peak_gib": peak / 2**30,
            "weights_gib": weights / 2**30, "step_bound_ms": step_bound,
            "recurrence_share": rec / wall, "held": held, "profile": prof}


def phase_ssm(dev):
    """Phase 18: Jamba (one 8-layer period at full width), its 24.76 GiB
    freed, then RWKV6-3B whole."""
    t_phase = time.perf_counter()
    out = {"jamba": phase_jamba(dev)}
    out["rwkv"] = phase_rwkv(dev)
    log(f"[ssm] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: training on one device

def train_batch(cfg, seq, batch, dev):
    """The data pipeline's first batch (seed 0) as tensors on ``dev``."""
    shape = configs.ShapeConfig("check", "train", seq, batch)
    nb = DataPipeline(cfg, shape, seed=0).get()
    return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}


def cpu_grads(cfg, plan, state, batch):
    """Loss and every parameter's gradient of ``cfg`` on the CPU in f32,
    from the card model's weights (``state``, their bf16 values held in
    f32) and the same batch."""
    model = build_model(cfg, plan, device="cpu").float()
    model.load_state_dict({k: v.cpu() for k, v in state.items()})
    model.trainable()
    t0 = time.perf_counter()
    loss, _ = model.loss({k: v.cpu() for k, v in batch.items()})
    loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    return loss.item(), grads, time.perf_counter() - t0


def rel_l2(got, want) -> float:
    return float((got.float().cpu() - want).norm() /
                 want.norm().clamp_min(1e-30))


@torch.no_grad()
def fan_in_attention(model):
    """Rescale the attention projections to the usual fan-in, std
    d_in^-0.5: wq / wk / wv (d, H, D) read d inputs and wo (H, D, d) H * D,
    where the reference's initialiser takes ``shape[-2]`` (H, D).  Its
    std makes full-width scores large enough to saturate the softmax, and
    a saturated softmax turns the card's and the CPU's last-bit
    differences into O(1) gradient differences, in f32 too (Whisper-tiny:
    every attention op within 1.2e-5 of the CPU's on the same inputs, its
    f32 loss 0.0074 and its gradients 1.45 relative L2 apart; PERF.md
    §6)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 3 and leaf in ("wq", "wk", "wv", "wo"):
            fan = p.shape[0] * (p.shape[1] if leaf == "wo" else 1)
            p.mul_((p.shape[-2] / fan) ** 0.5)


def train_card_vs_cpu(dev, cfg, batch_n, seq):
    """One bf16 train step of ``cfg`` on the card from seeded weights with
    the attention projections at the usual fan-in (``fan_in_attention``):
    its gradients, taken where AdamW receives them, finite, nonzero and
    within ``TRAIN_BF16_GRAD_TOL`` relative L2 of the CPU's f32 gradients
    from the same weights and batch, its loss within ``TRAIN_LOSS_TOL``;
    flash_attention's launches counted around it.  Then the same weights
    held in f32 on the card: the loss within 1e-4 and every gradient (the
    f32 kernel inside ``ops.MHA``, the reference's backward, remat, the CE)
    within ``TRAIN_F32_GRAD_TOL`` of the CPU's.  Last, the bf16 loss and
    backward with the kernel called straight, not through ``ops.MHA`` (the
    port before its repair): the attention projections then get no
    gradient (fault 1's regression check)."""
    plan = steps_lib.make_plan(cfg, configs.ShapeConfig("check", "train",
                                                        seq, batch_n))
    model = build_model(cfg, plan, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(7))
    fan_in_attention(model)
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=10, total_steps=10)
    state = steps_lib.init_train_state(model, None, hyper)
    batch = train_batch(cfg, seq, batch_n, dev)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    seen = []
    real_update = steps_lib.adamw_update

    def spy(grads, opt, **kw):
        seen.append(grads)
        return real_update(grads, opt, **kw)

    step = steps_lib.make_train_step(model, hyper)
    flash_kernel.COUNTER.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(steps_lib, adamw_update=spy):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = flash_kernel.COUNTER.launches
    loss = metrics["loss"].item()
    for n, g in seen[0].items():
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"{cfg.name}: {n}'s gradient on the card is zero or not finite")
    del state
    cpu_loss, exact, cpu_s = cpu_grads(cfg, plan, weights, batch)
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_TOL and np.isfinite(loss),
          f"{cfg.name}: bf16 train loss on the card {loss} vs the f32 "
          f"CPU's {cpu_loss}")

    # the same weights in f32 on the card
    m32 = build_model(cfg, plan, device=dev).float()
    m32.load_state_dict(weights)
    m32.trainable()
    flash_kernel.COUNTER.launches = 0
    loss32 = m32.loss(batch)[0]
    loss32.backward()
    launches32 = flash_kernel.COUNTER.launches
    rows = []                 # (card f32 vs CPU f32, card bf16 vs CPU f32)
    for n, p in m32.named_parameters():
        check(bool(torch.isfinite(p.grad).all()), f"{cfg.name}: {n}'s f32 "
              "gradient on the card is not finite")
        rows.append((rel_l2(p.grad, exact[n]), rel_l2(seen[0][n], exact[n]),
                     n))
    del m32
    worst = max(rows)
    log(f"[train] {cfg.name} ({cfg.n_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''}, "
        f"d {cfg.d_model}, vocab {cfg.vocab_size}) B {batch_n} S {seq}: "
        f"one bf16 step on the card {card_s * 1e3:.1f} ms (first call), "
        f"loss {loss:.6f}, the f32 CPU's {cpu_loss:.6f} (|diff| "
        f"{abs(loss - cpu_loss):.3g}, tolerance {TRAIN_LOSS_TOL}); "
        f"flash_attention launches in the step {launches} (f32 forward and "
        f"backward {launches32}); f32 on the card: loss {loss32.item():.6f} "
        f"(|diff| {abs(loss32.item() - cpu_loss):.3g}), {len(rows)} leaves' "
        f"gradients within max {worst[0]:.4g} ({worst[2]}), median "
        f"{statistics.median(r[0] for r in rows):.4g} relative L2 of the "
        f"CPU's (tolerance {TRAIN_F32_GRAD_TOL}); the bf16 step's gradients "
        f"median {statistics.median(r[1] for r in rows):.4g}, max "
        f"{max(r[1] for r in rows):.4g} from them (tolerance "
        f"{TRAIN_BF16_GRAD_TOL}); CPU f32 forward + backward {cpu_s:.1f} s")
    check(abs(loss32.item() - cpu_loss) <= 1e-4, f"{cfg.name}: f32 loss on "
          f"the card {loss32.item()} vs the CPU's {cpu_loss}")
    check(launches32 == launches, f"{cfg.name}: flash_attention launched "
          f"{launches32} times in the f32 loss and backward, {launches} in "
          f"the bf16 step (the same plan)")
    for a, b, n in rows:
        check(a <= TRAIN_F32_GRAD_TOL and b <= TRAIN_BF16_GRAD_TOL,
              f"{cfg.name}: {n}'s gradient on the card is {a:.4g} (f32) / "
              f"{b:.4g} (bf16 step) relative L2 from the CPU's f32 one")

    # fault 1: the kernel straight, as before ``ops.MHA``
    def bypass(q, k, v, *, causal=True, window=0, scale=None):
        return flash_kernel.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=causal,
                                            window=window, scale=scale)

    model.load_state_dict(weights)
    for p in model.parameters():
        p.grad = None
    with patched(attention, mha=bypass):
        model.loss(batch)[0].backward()
    lost = [n for n, p in model.named_parameters()
            if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "bq", "bk", "bv")
            and ".xattn." not in n
            and (p.grad is None or float(p.grad.abs().max()) == 0)]
    kept = [n for n, p in model.named_parameters()
            if n.endswith("attn.wo") and p.grad is not None
            and float(p.grad.abs().max()) > 0]
    n_self = sum(1 for n, _ in model.named_parameters()
                 if n.endswith(".wq") and ".xattn." not in n)
    log(f"[train] {cfg.name} fault-1 check, the kernel called without "
        f"ops.MHA: {len(lost)} q/k/v projection leaves of {n_self} "
        f"self-attention layers got no gradient (None or zero), {len(kept)} "
        f"output projections still did")
    check(len(lost) >= 3 * n_self, f"{cfg.name}: without ops.MHA the q/k/v "
          f"projections still got gradients ({lost})")
    del model, seen, exact
    torch.cuda.empty_cache()
    return {"launches": launches, "loss": loss, "cpu_loss": cpu_loss,
            "f32_max_rel": worst[0], "worst": worst[2],
            "bypass_lost": len(lost)}


def phase_train(dev):
    """Phase 19: training.  (a) Qwen1.5-0.5B at full width, 2 layers, and
    Whisper-tiny whole, one step each on the card against the CPU; (b)
    Qwen1.5-0.5B whole through ``train.run(reduced=False)`` on train_4k's
    sequence length with the batch cut to TRAIN_BATCH."""
    t_phase = time.perf_counter()
    out = {}
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    out["qwen_check"] = train_card_vs_cpu(dev, cfg, TRAIN_CHECK_B,
                                          TRAIN_CHECK_S)
    check(out["qwen_check"]["launches"] == 2 * TRAIN_CHECK_LAYERS,
          f"{TRAIN_ARCH}: flash_attention launched "
          f"{out['qwen_check']['launches']} times in a step, expected "
          f"{2 * TRAIN_CHECK_LAYERS} (each layer's forward and its remat "
          f"recompute)")
    asr = configs.get(ASR_ARCH)
    out["whisper_check"] = train_card_vs_cpu(dev, asr, TRAIN_ASR_B,
                                             TRAIN_ASR_S)
    n_asr = asr.encoder_layers + asr.n_layers
    check(out["whisper_check"]["launches"] == n_asr,
          f"{ASR_ARCH}: flash_attention launched "
          f"{out['whisper_check']['launches']} times in a step, expected "
          f"{n_asr}")

    # (b) the whole model through the trainer's entry point
    full = configs.get(TRAIN_ARCH)
    shape = configs.SHAPES[TRAIN_SHAPE]
    plan = steps_lib.make_plan(full, configs.ShapeConfig(
        shape.name, shape.kind, shape.seq_len, TRAIN_BATCH))
    check(plan.remat == "full" and plan.microbatches == 1 and
          plan.opt_chunked_ce and shape.seq_len >= 2048,
          f"{TRAIN_ARCH}: make_plan gave {plan}")
    # the first attention call's inputs (layer 0, step 1) are kept, so
    # that the kernel is held against plain at the trainer's own shape
    inputs = []
    real_mha = attention.mha

    def recording(q, k, v, **kw):
        if not inputs:
            inputs.append(([x.detach().clone() for x in (q, k, v)], kw))
        return real_mha(q, k, v, **kw)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_kernel.COUNTER.launches = 0
    t0 = time.perf_counter()
    with patched(attention, mha=recording):
        run = train_lib.run(TRAIN_ARCH, TRAIN_SHAPE, steps=TRAIN_STEPS,
                            reduced=False, batch_override=TRAIN_BATCH,
                            log_every=1, device=dev)
    wall = time.perf_counter() - t0
    launches = flash_kernel.COUNTER.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = [l for _, l in run.losses]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and
          losses[-1] < losses[0] and np.mean(losses[-3:]) <
          np.mean(losses[:3]), f"{TRAIN_ARCH}: losses {losses}")
    check(launches == TRAIN_STEPS * 2 * full.n_layers,
          f"{TRAIN_ARCH}: flash_attention launched {launches} times in "
          f"{TRAIN_STEPS} steps, expected {TRAIN_STEPS * 2 * full.n_layers}")
    (q, k, v), kw = inputs.pop()
    with torch.no_grad():
        got = real_mha(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    excess = ulp_excess(got, want)
    log(f"[train] {TRAIN_ARCH}: the kernel on layer 0's attention inputs "
        f"from the first step, q {tuple(q.shape)} {q.dtype}, k/v "
        f"{tuple(k.shape)}, {kw}: max abs {err:.4g} from plain, beyond one "
        f"bf16 ulp {excess:.4g} (held to 2e-2)")
    check(q.dtype == torch.bfloat16 and kw.get("causal") and
          tuple(q.shape) == (TRAIN_BATCH, shape.seq_len, full.n_heads,
                             full.hd) and excess <= 2e-2,
          f"{TRAIN_ARCH}: kernel vs plain on the trainer's attention inputs "
          f"q {tuple(q.shape)} {q.dtype} {kw}: max abs {err}, beyond one "
          f"bf16 ulp {excess}")
    del q, k, v, got, want
    step_ms = statistics.median(run.step_s[1:]) * 1e3
    tokens = TRAIN_BATCH * shape.seq_len
    n_params = full.n_params()
    flop = 6 * n_params * tokens
    mfu = flop / (step_ms / 1e3) / H100_BF16_FLOPS
    log(f"[train] {TRAIN_ARCH} whole ({full.n_layers} layers, d "
        f"{full.d_model}, vocab {full.vocab_size}, tied, {n_params / 1e6:.1f}M "
        f"parameters) on {TRAIN_SHAPE}'s S {shape.seq_len}, batch "
        f"{TRAIN_BATCH} (cut from {shape.global_batch}), {plan.remat} remat, "
        f"{plan.microbatches} microbatch, chunked CE: {TRAIN_STEPS} steps "
        f"through train.run in {wall:.1f} s; step ms first "
        f"{run.step_s[0] * 1e3:.1f}, median after "
        f"{step_ms:.1f} ({[round(x * 1e3, 1) for x in run.step_s]}); "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s; peak "
        f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({[round(x, 4) for x in losses]}); flash_attention launches "
        f"{launches / TRAIN_STEPS:.0f} a step; 6 N tokens / step / 989 "
        f"TFLOP/s = {mfu:.4f}")
    out["run"] = {"launches": launches, "step_ms": step_ms,
                  "kernel_err": err, "kernel_ulp_excess": excess,
                  "first_step_ms": run.step_s[0] * 1e3,
                  "tok_s": tokens / (step_ms / 1e3), "peak_gib": peak,
                  "losses": losses, "mfu": mfu}
    out["profile"] = train_step_profile(dev, full, plan, shape.seq_len,
                                        step_ms / 1e3)
    log(f"[train] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return out


def train_step_profile(dev, cfg, plan, seq, step_s):
    """Where a full-width train step's time goes: a step profiled (device
    busy time and the ops that take it, the idle share against
    ``step_s``, the trainer's median step), then one step with
    ``ops.MHA``'s backward (the reference's plain attention backward) and
    the CE chunks' forwards (``layers._ce_chunk``, run again in the
    backward's recompute) each synchronised around, their shares of that
    step."""
    model = build_model(cfg, plan, device=dev)
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=10, total_steps=10)
    state = [steps_lib.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), hyper)]
    step = steps_lib.make_train_step(model, hyper)
    batch = train_batch(cfg, seq, TRAIN_BATCH, dev)

    def one():
        state[0], _ = step(state[0], batch)
        torch.cuda.synchronize()

    prof = profile_replay(f"{cfg.name} train step B={TRAIN_BATCH} S={seq}",
                          one, 1, wall=step_s)
    spent = {"attention backward": 0.0, "CE chunks": 0.0}

    def synced(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return res
        return wrapper

    backward = flash_ops.MHA.__dict__["backward"]
    flash_ops.MHA.backward = staticmethod(
        synced("attention backward", backward.__func__))
    try:
        with patched(layers_mod, _ce_chunk=synced("CE chunks",
                                                  layers_mod._ce_chunk)):
            t0 = time.perf_counter()
            one()
            wall = time.perf_counter() - t0
    finally:
        flash_ops.MHA.backward = backward
    shares = {k: v / wall for k, v in spent.items()}
    log(f"[train] one synchronised step {wall * 1e3:.1f} ms: "
        + ", ".join(f"{k} {spent[k] * 1e3:.1f} ms ({shares[k]:.4f})"
                    for k in spent)
        + f"; a CE chunk's f32 logits {TRAIN_BATCH} x 1024 x "
        f"{plan.padded_vocab(cfg.vocab_size)} are "
        f"{TRAIN_BATCH * 1024 * plan.padded_vocab(cfg.vocab_size) * 4 / 2 ** 30:.2f} GiB")
    del model, state, step
    torch.cuda.empty_cache()
    return dict(prof, synced_step_ms=wall * 1e3, shares=shares)


# ---------------------------------------------------------------------------
# phase 20: the sharded stack on a 1 x 1 mesh

def bf16_ulp(x) -> float:
    """One bf16 ulp of x's largest magnitude."""
    m = float(x.detach().float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def first_difference(a, b):
    """(name, max abs difference, one bf16 ulp of a's largest entry) of the
    first leaf of two dicts of tensors that differs, or None."""
    for n in a:
        x, y = steps_lib.full(a[n]), steps_lib.full(b[n])
        if not torch.equal(x, y):
            return n, float((x.float() - y.float()).abs().max()), bf16_ulp(x)
    return None


def dryrun_prediction(shape):
    """Start ``launch.dryrun.lower_cell`` for the trainer's cell on a (1, 1)
    mesh in a subprocess (the fake group, the meta device, the CPU), so it
    runs beside the card's steps; -> the process and its output path."""
    out = pathlib.Path(tempfile.mkdtemp()) / "cell.json"
    code = (
        "import json, sys, torch; torch.set_num_threads(1)\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "mesh.init_fake(1)\n"
        "m = mesh.make_test_mesh(1, 1, device_type='cpu')\n"
        f"shape = configs.ShapeConfig({shape.name!r}, {shape.kind!r}, "
        f"{shape.seq_len}, {shape.global_batch})\n"
        f"r = dryrun.lower_cell({TRAIN_ARCH!r}, None, m, shape=shape)\n"
        f"json.dump(r, open({str(out)!r}, 'w'))\n")
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out


def mesh_serving(arch, mesh, dev):
    """``serve.run`` of ``arch`` whole (``MESH_SERVE_B`` prompts of
    ``MESH_PROMPT`` tokens, ``MESH_GEN`` greedy tokens, random weights from
    seed 0), then the same model and prompts through ``make_prefill_fn`` /
    ``make_decode_fn`` on ``mesh`` -> (the tokens equal, flash_attention
    launches in the mesh's prefill, seconds taken)."""
    t0 = time.perf_counter()
    run = serve.run(arch, reduced=False, prompt_len=MESH_PROMPT,
                    gen=MESH_GEN, batch=MESH_SERVE_B, device=dev)
    s_max = MESH_PROMPT + MESH_GEN + 8
    pre_shape = configs.ShapeConfig("serve", "prefill", s_max, MESH_SERVE_B)
    dec_shape = configs.ShapeConfig("serve", "decode", s_max, MESH_SERVE_B)
    prefill, _ = steps_lib.make_prefill_fn(run.model, mesh, pre_shape)
    decode, *_ = steps_lib.make_decode_fn(run.model, mesh, dec_shape)
    flash_kernel.COUNTER.launches = 0
    caches, logits = prefill(run.batch,
                             run.model.init_decode(MESH_SERVE_B, s_max))
    launches = flash_kernel.COUNTER.launches
    toks = []
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(MESH_GEN):
        toks.append(tok)
        caches, logits = decode(caches, tok, MESH_PROMPT + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    equal = np.array_equal(torch.cat(toks, 1).cpu().numpy(), run.tokens)
    del run, caches, prefill, decode
    torch.cuda.empty_cache()
    return equal, launches, time.perf_counter() - t0


def phase_mesh(dev, train_step_ms):
    """Phase 20: the sharded LM stack (``launch.sharding`` /
    ``launch.steps``' mesh path) on a 1 x 1 mesh of the one card, NCCL."""
    t_phase = time.perf_counter()
    full = configs.get(TRAIN_ARCH)
    shape = configs.SHAPES[TRAIN_SHAPE]
    cell = configs.ShapeConfig(shape.name, shape.kind, shape.seq_len,
                               TRAIN_BATCH)
    proc, pred_path = dryrun_prediction(cell)
    mesh_lib.init_single("cuda")
    mesh = mesh_lib.make_test_mesh(1, 1)
    check(mesh_lib.mesh_axes(mesh) == {"data": 1, "model": 1} and
          mesh_lib.dp_axes(mesh) == ("data",), f"mesh {mesh}")
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=10, total_steps=10)
    batch = train_batch(full, shape.seq_len, TRAIN_BATCH, dev)

    # the mesh-less step, from the state drawn from seed 0
    plan = steps_lib.make_plan(full, cell)
    model = build_model(full, plan, device=dev)
    state = steps_lib.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), hyper)
    state, met = steps_lib.make_train_step(model, hyper)(state, batch)
    want = {"loss": met["loss"], "params": dict(state["params"]),
            "m": state["opt"].m, "v": state["opt"].v,
            "master": state["opt"].master}
    del model, state
    torch.cuda.empty_cache()

    # the sharded step from the same state
    mplan = steps_lib.make_plan(full, cell, mesh)
    check(mplan.tp == 1 and mplan.dp == 1 and mplan.hint_dp is None and
          mplan.act_pspec is None and not mplan.fsdp,
          f"make_plan on the 1 x 1 mesh gave {mplan}")
    model = build_model(full, mplan, device=dev)
    state = steps_lib.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), hyper)
    step = steps_lib.make_train_step(model, hyper, mesh)
    state = steps_lib.shard_train_state(
        state, steps_lib.train_state_shardings(model, mesh, hyper))
    flash_kernel.COUNTER.launches = 0
    state, met2 = step(state, batch)
    torch.cuda.synchronize()
    launches = flash_kernel.COUNTER.launches
    got = {"loss": met2["loss"], "params": state["params"],
           "m": state["opt"].m, "v": state["opt"].v,
           "master": state["opt"].master}
    loss_equal = torch.equal(want["loss"], got["loss"])
    diffs = {k: first_difference(want[k], got[k])
             for k in ("params", "m", "v", "master")}
    log(f"[mesh] {TRAIN_ARCH} whole, S {shape.seq_len}, batch {TRAIN_BATCH}, "
        f"1 x 1 mesh: sharded step loss {float(got['loss']):.6f}, mesh-less "
        f"{float(want['loss']):.6f} ({'bitwise equal' if loss_equal else 'differ'}); "
        + "; ".join(f"{k}: " + ("every leaf bitwise equal" if d is None else
                               f"first differing leaf {d[0]}, max abs "
                               f"{d[1]:.4g} (one bf16 ulp of its largest "
                               f"entry {d[2]:.4g})")
                    for k, d in diffs.items()))
    check(abs(float(got["loss"]) - float(want["loss"])) <=
          bf16_ulp(want["loss"]), f"mesh loss {got['loss']} vs {want['loss']}")
    for k, d in diffs.items():
        check(d is None or d[1] <= d[2], f"mesh step {k}: {d}")
    check(launches == 2 * full.n_layers,
          f"mesh step: flash_attention launched {launches} times, expected "
          f"{2 * full.n_layers}")
    del want
    ms = []
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms)
    log(f"[mesh] sharded step ms {[round(x, 1) for x in ms]}, median "
        f"{step_ms:.1f} against phase 19's mesh-less median "
        f"{train_step_ms:.1f} ({step_ms / train_step_ms:.4f}x: the host "
        f"cost of DTensor dispatch); flash_attention launches a step "
        f"{launches}")
    del model, state, step, batch
    torch.cuda.empty_cache()

    # serving: make_prefill_fn / make_decode_fn against serve's tokens
    equal, serve_launches, _ = mesh_serving(TRAIN_ARCH, mesh, dev)
    log(f"[mesh] serving through make_prefill_fn / make_decode_fn: "
        f"{MESH_GEN} greedy tokens of {MESH_SERVE_B} prompts of "
        f"{MESH_PROMPT} equal serve's: {equal}; flash_attention launches "
        f"in the prefill {serve_launches}")
    check(equal, f"{TRAIN_ARCH}: mesh serving tokens differ from serve's")
    check(serve_launches == full.n_layers,
          f"mesh prefill launched flash_attention {serve_launches} times")
    # DeepSeek-V2-Lite whole the same way: the MoE's mesh path
    # (moe._local_groups) and MLA's launches through spmd.local_call
    mla_cfg = configs.get(MLA_ARCH)
    mla_equal, mla_launches, mla_s = mesh_serving(MLA_ARCH, mesh, dev)
    log(f"[mesh] {MLA_ARCH} whole through make_prefill_fn / make_decode_fn: "
        f"{MESH_GEN} greedy tokens of {MESH_SERVE_B} prompts of "
        f"{MESH_PROMPT} equal serve's: {mla_equal}; flash_attention "
        f"launches in the prefill {mla_launches}; the check took "
        f"{mla_s:.1f} s (weights drawn, serve.run, the mesh's prefill and "
        f"decode)")
    check(mla_equal, f"{MLA_ARCH}: mesh serving tokens differ from serve's")
    check(mla_launches == mla_cfg.n_layers, f"{MLA_ARCH}: mesh prefill "
          f"launched flash_attention {mla_launches} times, expected "
          f"{mla_cfg.n_layers}")

    # the dry run's prediction for the trainer's cell at (1, 1)
    out, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"dry run: {out[-3000:]}")
    pred = json.loads(pred_path.read_text())
    roof = pred["roofline"]
    share = roof["roofline_bound_s"] * 1e3 / step_ms
    log(f"[mesh] dry run of {TRAIN_ARCH} {TRAIN_SHAPE} batch {TRAIN_BATCH} "
        f"at (1, 1), predicted from the H100's published peaks (989 TFLOP/s "
        f"bf16, 3.35 TB/s, 450 GB/s): {roof['hlo_flops_per_dev']:.4e} FLOPs, "
        f"{roof['hlo_bytes_per_dev']:.4e} bytes (each op's inputs and "
        f"outputs), {roof['collective_bytes_per_dev']:.0f} collective bytes, "
        f"arguments {pred['memory']['argument_size_in_bytes'] / 2 ** 30:.3f} "
        f"GiB; bound {roof['roofline_bound_s'] * 1e3:.1f} ms by "
        f"{roof['bottleneck']} (compute {roof['compute_s'] * 1e3:.1f} ms, "
        f"memory {roof['memory_s'] * 1e3:.1f} ms); the measured sharded "
        f"step {step_ms:.1f} ms is {1 / share:.3f}x the bound (bound share "
        f"{share:.4f}) on {nvidia_smi_line()}; traced in {pred['trace_s']} s")
    import torch.distributed as dist
    dist.destroy_process_group()
    log(f"[mesh] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "serve_launches": serve_launches,
            "mla_serve_launches": mla_launches, "mla_check_s": mla_s,
            "step_ms": step_ms, "loss_equal": loss_equal,
            "diffs": diffs, "prediction": roof, "bound_share": share}


# ---------------------------------------------------------------------------
# phase 15: sanitizer and flight recorder

def stacked_fig8(per_channel):
    """The fig-8 workloads' traces stacked on the channel axis, as
    ``simulator.sweep_traces`` lays them out: (8 x 4, per_channel)."""
    all_wl = traces.eight_core_workloads()
    trs = [traces.build_trace(all_wl[w][2], N_CHANNELS, per_channel, 2)
           for w in FIG8_WORKLOADS]
    return dram.Trace(*[np.concatenate(xs) for xs in zip(*trs)])


def counters_equal(a, b, what):
    for f, x, y in zip(dram.Counters._fields, a, b):
        check(torch.equal(x.cpu(), y.cpu()), f"{what}: {f} differs")


def phase_sanitizer(dev):
    """Launch contracts, lint + graph audit, the step's host syncs, the
    dense body and ``python -m repro_torch.obs`` on the card; returns the
    phase's sim_scan launches and the report's tax."""
    t_phase = time.perf_counter()
    total = 0
    # (a) contracts: sim_scan launches counted from 0 around each grid
    for name, c in contracts.REGISTRY.items():
        got = {}
        scan_kernel.COUNTER.launches = 0
        r0 = dram.replay_count()
        t0 = time.perf_counter()
        found = contracts.check_contract(name, dev, got)
        wall = time.perf_counter() - t0
        launches = scan_kernel.COUNTER.launches
        replays = dram.replay_count() - r0
        total += launches
        check(not found, f"contract {name}: "
              f"{[f.render() for f in found]}")
        obs = got[name]
        check(launches == replays, f"contract {name}: sim_scan launched "
              f"{launches} times, dram.replay_count counted {replays}")
        log(f"[sanitizer] contract {name}: launches {obs.launches} (budget "
            f"{c.max_launches}), sim_scan {launches}, builds {obs.builds} "
            f"(budget {c.max_builds}), wall {wall:.4f} s")
    # (b) lint + graph audit
    t0 = time.perf_counter()
    rep = analysis.run_all(repo_root=str(ROOT), with_contracts=False)
    check(not rep.findings, "sanitizer findings:\n" + rep.render_text())
    log(f"[sanitizer] lint + graph audit: {len(rep.scanned)} files and "
        f"entries, 0 findings ({time.perf_counter() - t0:.1f} s)")

    # (c) the eager step reads nothing back: sync-debug mode "error"
    stacked = stacked_fig8(PER_CHANNEL)
    cfg = timing.paper_config("figcache_fast")
    head = dram.Trace(*[x[:, :SYNC_STEPS] for x in stacked])
    lanes = int(head.t_issue.shape[0])
    params = cfg.params(device=dev)
    tr, lp, st = dram._prepare(head, params, dram.sim_init(
        cfg.static, channels=lanes, device=dev), dev)
    step = dram.make_step(cfg.static)
    carry = (st.bank, st.cnt, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SYNC_STEPS):
            carry = step(lp, carry, dram.Trace(*(f[t] for f in tr)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    scan_kernel.COUNTER.launches = 0
    ref = dram.resume(head, cfg.static, params, dram.sim_init(
        cfg.static, channels=lanes, device=dev), device=dev)
    total += scan_kernel.COUNTER.launches
    counters_equal(ref.cnt, carry[1], "sync-debug eager steps vs sim_scan")
    log(f"[sanitizer] {SYNC_STEPS} eager steps of the fig-8 figcache_fast "
        f"group ({lanes} lanes) under sync-debug mode 'error': no "
        f"synchronising call; counters == sim_scan's")

    # (d) the dense body (eager) == sim_scan's fused replay
    t0 = time.perf_counter()
    real = dram.Trace(*[x[:N_CHANNELS, :DENSE_REQS] for x in stacked])
    check(bool((real.t_issue < dram.NOOP_ISSUE).all()),
          "the dense check's trace holds no-ops")
    cells = [(m, "row_benefit") for m in ("base", "lldram")] + [
        (m, p) for m in simulator.PAPER_MECHS
        if timing.paper_config(m).has_cache
        for p in ("row_benefit", "segment_benefit", "lru", "random")]
    scan_kernel.COUNTER.launches = 0
    for mech, policy in cells:
        c = timing.paper_config(mech, policy=policy)
        pr = c.params(device=dev)
        fused = dram.simulate(real, c.static, pr, device=dev)
        dense = dram.simulate(real, c.static, pr, variant="dense",
                              device=dev)
        counters_equal(fused, dense, f"dense vs sim_scan {mech}/{policy}")
    dense_launches = scan_kernel.COUNTER.launches
    total += dense_launches
    check(dense_launches == len(cells), f"dense check: sim_scan launched "
          f"{dense_launches} times for {len(cells)} fused replays")
    log(f"[sanitizer] dense body (eager on the card) == sim_scan on every "
        f"counter: {len(cells)} mechanism x policy cells, {N_CHANNELS} x "
        f"{DENSE_REQS} requests ({time.perf_counter() - t0:.1f} s)")

    # (e) python -m repro_torch.obs at full size
    scan_kernel.COUNTER.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rc = obs_cli.main(["--json", f"{d}/BENCH_obs.json", "--outdir", d,
                           "--device", "cuda"])
        rec = json.loads(pathlib.Path(f"{d}/BENCH_obs.json").read_text())
    obs_s = time.perf_counter() - t0
    obs_launches = scan_kernel.COUNTER.launches
    total += obs_launches
    check(rec["windows_bitwise_chunked_vs_monolithic"],
          "obs: chunked window series differ from monolithic")
    tax = rec["telemetry_tax"]
    tripped = tax > obs_cli.TAX_TRIPWIRE
    check(rc == (1 if tripped else 0), f"obs CLI returned {rc}")
    log(f"[sanitizer] obs report ({obs_s:.1f} s, {obs_launches} sim_scan "
        f"launches) on {rec['device']}: tax {tax}x (rounds "
        f"{rec['telemetry_tax_rounds']}; off {rec['telemetry_off_s']} s, on "
        f"{rec['telemetry_on_s']} s) -> tripwire {obs_cli.TAX_TRIPWIRE}x "
        f"{'TRIPPED' if tripped else 'held'}; chunked == monolithic bitwise")
    for pt in rec["tail_latency"]["per_point"]:
        log(f"[sanitizer]   cache_rows={pt['cache_rows']:<3d} p50 "
            f"{pt['p50']} p99 {pt['p99']} {pt['p99_bracket_ns']} p999 "
            f"{pt['p999']} {pt['p999_bracket_ns']} ns, over-SLO "
            f"{pt['slo_rate']}")
    pm = rec["phase_mix"]
    log(f"[sanitizer]   phase_mix: {pm['n_windows']} windows, hit rate "
        f"{pm['min_hit_rate']}..{pm['max_hit_rate']}")
    for name, r in rec["profile"].items():
        log(f"[sanitizer]   profile {name}: cold {r['cold_s']} s warm "
            f"{r['warm_s']} s, builds {r['builds_cold']}/{r['builds_warm']}"
            f" ({r['build_s']} s), launches {r['launches_warm']}, sim_scan "
            f"{r['sim_scan_launches_warm']}, dispatches "
            f"{r['dispatches_warm']}")
    log(f"[sanitizer] phase 15: {total} sim_scan launches, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "tax": tax, "tripped": tripped}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    _build.build_all(KERNELS + PROBES)
    for name in KERNELS:
        _build.load(name)
    log(f"[build] {len(KERNELS)} kernels built in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (secs, report) in _build.BUILD_LOG.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    lat = probe_latencies(dev)
    max_err, timings = phase_kernels(dev)
    reloc = phase_reloc(dev)
    tx = phase_figkv_tx(dev, lat)
    decode = phase_decode(dev)
    phase_golden(dev)
    main_run = phase_main(dev)
    scan = phase_scan_timing(dev, lat)
    ctl = phase_controllers(dev)
    long_run = phase_long_trace(dev)
    grid16 = phase_controller_grid(dev)
    telem = phase_telemetry(dev, long_run.pop("trace"))
    gen = phase_workloads(dev)
    orch = phase_orchestration(dev)
    sanitizer = phase_sanitizer(dev)
    figkv = phase_figkv(dev)
    phase_profile(dev)
    flash = phase_flash(dev)
    lm_launches = phase_lm(dev)
    phase_lm_padded(dev)
    mla = phase_lm_moe(dev)
    vlm = phase_vlm(dev)
    ssm = phase_ssm(dev)
    trained = phase_train(dev)
    meshed = phase_mesh(dev, trained["run"]["step_ms"])

    k_ms, p_ms, bound = timings[(32, 16, 512)]
    # on the main path the lookup runs inlined in sim_scan, so the
    # standalone kernel launches there no time; its launches through the
    # eager loop (the replay's plain version, phase 4) are a field apart
    rows = [{
        "name": "fts_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/fts_lookup.cu",
        "replaces": "src/repro/kernels/fts_lookup/fts_lookup.py:50",
        "launches": main_run["launches"]["fts_lookup"],
        "inlined_in": "src/repro_torch/csrc/sim_scan.cu",
        "eager_loop_launches": main_run["eager_launches"]["fts_lookup"],
        "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None}]
    # sim_scan carries the lookup's TPU kernel inlined, and replaces the
    # fused lax.scan (src/repro/core/dram.py:1028) that called it
    fast = scan["figcache_fast"]
    rows.append({
        "name": "sim_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_scan.cu",
        "replaces": "src/repro/kernels/fts_lookup/fts_lookup.py:50",
        "launches": main_run["launches"]["sim_scan"],
        "max_abs_err": main_run["max_abs_err"], "ms": fast["ms"],
        "plain_ms": main_run["eager_group_s"]["figcache_fast"] * 1e3,
        "bound_ms": fast["bound_ms"], "bound_by": "bytes",
        "chain_bound_ms": fast["chain_ms"], "library_ms": None,
        # the telemetry instantiation at period TAIL_PERIOD, timed in turns
        # with the launch above; its byte bound counts the ring and carry
        "tel_ms": fast["tel_ms"], "tel_tax": fast["tel_tax"],
        "tel_bound_ms": fast["tel_bound_ms"],
        "tel_long_ms": telem["long_tax"]["tel_ms"],
        "tel_long_tax": telem["long_tax"]["tax"],
        # each simulator path's launches, counted from 0 around it
        "path_launches": {"fig8_grid": main_run["launches"]["sim_scan"],
                          "controllers": ctl["launches"],
                          "long_trace": long_run["launches"],
                          "controller_grid": grid16["launches"],
                          "telemetry": telem["launches"],
                          "workloads": gen["launches"],
                          "orchestration": orch["launches"],
                          "sanitizer": sanitizer["launches"]}})
    for path, n in rows[-1]["path_launches"].items():
        check(n > 0, f"the {path} path launched sim_scan no time")
    # figaro_reloc's path is now the embedding cache's (the figkv step
    # launches figkv_tx instead: its figkv launches, 0, a field apart);
    # figkv_tx takes in the figkv step's two figaro_reloc launches
    launches = {"figaro_reloc": figkv["embed_reloc_launches"],
                "figcache_decode": figkv["launches"]["figcache_decode"],
                "figkv_tx": figkv["launches"]["figkv_tx"]}
    reloc_tpu = "src/repro/kernels/figaro_reloc/figaro_reloc.py:38"
    for name, res, replaces in (
            ("figaro_reloc", reloc, reloc_tpu),
            ("figcache_decode", decode,
             "src/repro/kernels/figcache_decode/figcache_decode.py:59"),
            ("figkv_tx", tx, reloc_tpu)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"]})
    rows[-3]["figkv_launches"] = figkv["launches"]["figaro_reloc"]
    rows[-1].update(chain_bound_ms=tx["chain_bound_ms"],
                    unfused_ms=tx["unfused_ms"],
                    decode_ms_per_step=figkv["ms_per_step"],
                    decode_profile=figkv["profile"])
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82",
        "launches": lm_launches, "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        # each LM path's launches, counted from 0 around its prefill, and
        # the kernel at MLA's shape (D 192, H = Hkv = 16)
        "path_launches": {LM_ARCH: lm_launches, MLA_ARCH: mla["launches"],
                          f"{RING_ARCH}-{RING_LAYERS}l":
                              mla["ring"]["launches"],
                          "qwen2_vl": vlm["launches"],
                          "whisper": vlm["whisper"]["launches"],
                          f"{JAMBA_ARCH}-{JAMBA_LAYERS}l":
                              ssm["jamba"]["launches"],
                          RWKV_ARCH: ssm["rwkv"]["launches"],
                          "train": trained["run"]["launches"],
                          "train_mesh": meshed["launches"],
                          "serve_mesh": meshed["serve_launches"],
                          f"{MLA_ARCH}_mesh": meshed["mla_serve_launches"]},
        "mla": {k: mla["flash"][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share", "max_abs_err")},
        # the kernel at Qwen2-VL's prefill (GQA 64 / 8, causal) and at
        # Whisper's encoder (non-causal, S 1500, D 64)
        "qwen2_vl": {k: vlm["flash"][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share", "max_abs_err")},
        "whisper": {k: vlm["whisper"]["flash"][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share", "max_abs_err")},
        # and at Jamba's attention layer (GQA 32 / 8, causal, no RoPE)
        "jamba": {k: ssm["jamba"]["flash"][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share", "max_abs_err")}})
    # RWKV6-3B has no attention layer: its path launches the kernel no
    # time (checked in phase 18)
    for path, n in rows[-1]["path_launches"].items():
        check(n > 0 or path == RWKV_ARCH,
              f"the {path} path launched flash_attention no time")
    print(json.dumps({"kernels": rows}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
