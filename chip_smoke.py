#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device  — card name, count, and nvidia-smi's name and power limit;
  2. build   — the Hopper kernels of src/repro_torch/csrc, built with nvcc
               (build seconds and -Xptxas -v output, and a line per K1 v3
               and v4, K2 v4 / K3 v3 / K4 v3 (split and combine; the int8
               split instantiations labelled K4) and K5 (bf16 v2's three
               passes, float32 v3's chunk-state and outputs passes) kernel
               with its registers, shared memory and spills; a spill in K1
               v3 or v4, in any K5 kernel or in a four-row bf16 K4 split
               kernel (the int8 serving paths', D 64 and 128) fails;
               K1-bwd's four kernels and K5-bwd's six (v2) are listed too,
               and a spill there fails; then the threads, dynamic shared
               memory and blocks an SM of K5 v3's and K5-bwd v2's
               micro-tile kernels at the training shapes);
  3. kernels — K1 flash prefill, K2 dense decode and K3 paged decode held
               against their plain versions at mistral-7b's attention shapes,
               and K1 and K2 at zamba2-1.2b's shared block's (32 heads, no
               grouping, D = 64, window 8192) (tolerances bf16 2e-2, f32
               2e-5, rows with a valid key only): K1 bf16 (v3, wgmma) and
               f32 (v4, FMA micro-tiles) at Sq 37/300/512, q_offset 64, -4
               and -70, softcap, window 17/33/4096, sk_valid < Sk, D
               64/128, Hkv 8/32 and every tile each takes, and each row's
               lse from both (the forward's output to K1-bwd) against
               flash_attention_lse_ref, +inf exactly on rows with no
               valid key; K2 (v4,
               split-KV) at kv_len on both sides of a split edge, both
               dtypes, D 64/128, captured into a CUDA graph, one count per
               call; the tiles each K1 kernel refuses; K3 (v3, split-KV
               through the block tables) at pool blocks of 16 and 128, and
               at kv_len 0 and on both sides of a split edge for block_k
               32/64/128, pool blocks of 16 and 32, G = 1 and 4, a window
               of 71, captured into a CUDA graph; K5 (three passes: bf16
               v2, float32 v3), the SSD chunked scan, against its chunked
               plain version and the
               sequential oracle at mamba2-130m's and zamba2-1.2b's shapes
               (chunk 128, S = 512 and a ragged 300) and at their reduced
               shapes (P = N = 32, chunk 32), f32 2e-5, bf16 5e-2, y and the
               final state, and captured into a CUDA graph; then
               K4 (v3, K3's split-KV over int8 rows), the int8 paged
               decode, against its plain version (the scale-folded read) at
               mistral-7b's serving shape and a reduced D = 64 one (f32
               2e-5, bf16 2e-2) and against the gather oracle (f32 3e-5),
               at kv_len 0 and on both sides of a split edge for block_k
               32/64/128, G = 4 and 1, a window of 71 and a softcap, and
               captured into a CUDA graph; then the new families' shapes:
               K1 non-causal at whisper-base's encoder (8 heads, D 64,
               Sq = Sk = 1500 and a ragged 300, every bf16 tile) and cross
               prefill (Sq 24 on Sk 1500), K1 at qwen2-vl-7b's G = 7 (28 on
               4 heads, D 128, Sq = Sk = 768) and phi3.5-moe's prefill, K2
               at G = 7 and at G = 1 / D 64 on both sides of a split edge
               (block_k 32/64/128), K3 at phi3.5-moe's serving shape; then
               K6, the paged chunk attention, at mistral-7b's prefill
               chunk (C 256, a 384-entry table of blocks of 16, window
               4096, bf16; 38 and 256 valid rows after 0 and 1,024 prior
               rows, the table shuffled, the null block full of garbage):
               each row within 2e-2 of that row's largest output, padded
               rows 0; then
               each timed at each serving path's shapes beside the plain
               version, one PyTorch library call where one computes the
               same function (SDPA, K/V expanded when grouped), and the
               card's bound (K4 also beside the gather composition; K1 by
               tile, K2, K3 and K4 by block_k, K5 by pass);
  3s. K3 at the mistral7b cells' decode shapes — 128 lane slots of
               384-entry tables, window 4096; chat 21 live lanes of 40-300
               keys, longprompt 9 of 1,500-4,200, the rest dead at kv_len 1
               and one at 0 — against its plain version, timed, beside its
               bytes' bound and the blocks each of its two kernels launches
               (a torch.profiler trace's grids). ``python3 chip_smoke.py
               --phase k3 [--parent DIR]`` runs phases 1, 2 and 3s alone,
               then K2, K3 and K4 at PERF.md's kernel-table shapes (K2 also
               at qwen2-vl-7b's and whisper-base's, K3 also without the
               window, as phi3.5-moe's paged batchers run it); with
               ``--parent`` it also times DIR's kernels (another checkout,
               built in its own build/) on the same calls in turns (parent,
               this, this, parent), with their blocks and the largest
               difference between the two outputs;
  3t. K1-bwd — K1 with its lse (v4 in f32, v3 in bf16), then the
               gradient of K1 on that lse, against their plain versions and
               torch.autograd of K1's: the output and lse within f32 2e-5 /
               bf16 2e-2, dq, dk and dv each within that times max(1,
               |ref|inf), both dtypes, at smollm-360m's training shape (B
               8, 15 on 5 heads, D 64, S 128 and 512, and a ragged 300),
               zamba2-1.2b's (B 2, 32 heads, D 64, S 512, window 8192),
               mistral-7b's (32 on 8, D 128, S 512, window 17 and 4096),
               whisper-base's encoder (8 heads, D 64, 1500², non-causal)
               and cross shape (24 on 1500), qwen2-vl-7b's G = 7 (768²) and
               grok-1's heads with a softcap of 30; a second call gives the
               same bits; then, at smollm's and zamba2's training shapes in
               float32, K1-bwd timed beside its plain version and the
               backward of one SDPA call (K/V expanded; a yardstick the
               port never calls) and by kernel (a torch.profiler trace),
               and K1's float32 forward (v4, with its lse) beside its plain
               version and SDPA, and by tile; then K5-bwd (v2), the gradient
               of K5, against torch.autograd of its plain version, dx, ddt,
               dA, dB and dC each within f32 2e-5 / bf16 5e-2 times
               max(1, |ref|inf), both dtypes, with and without a
               final-state gradient, at mamba2-130m's training shape (B 8,
               S 512, H 24, P 64, N 128, chunk 128), zamba2-1.2b's (B 2, H
               64, N 64), each ragged (S 300), and the reduced one (P = N =
               32, chunk 32, S 64 and 45); a second call gives the same
               bits; then, in float32, K5-bwd timed beside its plain
               version at both training shapes (no single library call:
               library_ms null) and by kernel (a torch.profiler trace),
               and K5's float32 forward (v3) beside its plain version and
               by pass at both; bounds at the float32 peak (67e12, no TF32);
  3c. tune   — the port's autotuner on the card (backend "cuda") over its
               default shapes and the int8 serving bucket b4c1024; the cache
               is written under build/ and not installed;
  4. parity  — full-width mistral-7b cut to 2 layers, float32, same seeded
               weights: the kernel path against the plain path over prefill
               plus 8 decode steps, through the dense engine and the paged
               batcher (logits within 1e-3, greedy tokens identical);
  4b. parity — the same for full-width mamba2-130m (24 layers) and
               zamba2-1.2b cut to 7 layers (one segment with its shared
               attention block, and a tail), through the engine and the
               dense ContinuousBatcher;
  4c. parity — phase 4 with an int8 KV cache (kv_quant), once with no
               autotune cache (the int8 paged read gathers and runs K2) and
               once with a cache that routes it to K4 ("fused"); the fused
               run's logits also within 1e-3 of the gather run's;
  4d. parity — the MoE, VLM and audio families, float32, the kernel path
               against the plain path over prefill plus 8 decode steps:
               phi3.5-moe-42b-a6.6b at full width cut to 2 layers through
               the engine, the paged cache and both batchers; qwen2-vl-7b
               at full width cut to 2 layers and whisper-base in full (6 +
               6 layers) through the engine with 256 seeded vision / 1500
               seeded frame embeddings; K1 and K2 (and K3 for the MoE)
               must launch;
  4t. train parity — smollm-360m at full width cut to 2 layers (B 8, S
               512), whisper-base in full (B 2, 1500 seeded frames, 64
               tokens), mamba2-130m at full width cut to 2 layers (B 8, S
               512) and zamba2-1.2b at full width cut to 7 layers (one
               segment with its shared attention block, then a tail; B 2, S
               512), float32, the same seeded weights: the kernel path (K1
               and K5 under their autograd Functions, K1-bwd and K5-bwd)
               against the plain path: the loss within 1e-5, every gradient
               leaf non-zero and within 1e-4 of max(1, |g|inf), the losses
               of 5 AdamW steps within 1e-4; the model's kernels launch on
               the kernel path only;
  5. serve   — full mistral-7b (32 layers, bf16, random weights from a seed)
               behind FleetRouter(capacity_aware) over paper_fleet(): 8
               requests through paged batchers and 2 through the engine-only
               path; every kernel's launch count in this phase must be > 0
               (K1, K2, K3 and K6, the paged chunk attention of the
               batchers' chunked prefill);
  6. serve   — full mamba2-130m and full zamba2-1.2b (bf16, random weights
               from a seed) the same way through dense batchers: K5 must
               launch for both, K1 and K2 for zamba2;
  7. serve   — phase 5 with an int8 KV cache, with an autotune cache
               installed that routes the paged batchers' int8 read (bucket
               b4c1024) to K4: K4, K1 and K2 must launch;
  8. disagg  — disaggregated prefill and decode through
               FleetRouter(policy="disaggregated") over the probe pool pair
               (a slow, near-dark eff pool and a fast, high-idle perf pool
               joined by a 400 Gb/s link, priced with mistral-7b's config),
               with KV handoff between the paged pools:
               8a. migrate_kv_blocks on the card between two pools of
                   mistral-7b's geometry (2 layers, Hkv 8, D 128, blocks of
                   16), bf16, float32 and int8 with its scale pools: a
                   ragged set of blocks bit for bit equal to the source,
                   the source unchanged, the other destination blocks
                   untouched, the payload bytes as counted; then K3 (K4 for
                   int8) at kv_len 40/130/300/528 over the destination
                   pool and tables bit for bit equal to K3 (K4) over the
                   source's, and within the plain version's tolerance;
               8b. parity — phase 4's full-width 2-layer mistral-7b
                   (float32, the same seeded weights) with 4 of the mix's
                   prompts through the disaggregated router, paged batchers
                   of 4 slots and blocks of 16: every request held and
                   handed off, greedy tokens identical to solo generation
                   and to one paged batcher with no handoff, on the kernel
                   and on the plain path; queries booked at their prefill
                   pool, decode tokens at their decode pool; every block
                   returned on both ends;
               8c. serve   — full mistral-7b (32 layers, bf16, random
                   weights built anew from the seed) with phase 5's 8
                   requests through the disaggregated router, 1024 blocks
                   of 16 on both pools: every request handed off and done,
                   K3 launched (its count on a line of its own), every
                   block returned; the migrated bytes beside the pricing
                   model's booked bytes, wall seconds and peak memory.
  9. serve   — the new families (bf16 random weights built on the card from
               the seed, each freed before the next): phi3.5-moe-42b-a6.6b
               at full width cut to 16 of its 32 layers (the full depth
               needs ~83 GB) behind FleetRouter as phase 5 (K1, K2, K3 and
               K6 must launch); qwen2-vl-7b in full, the mix's first 4 prompts each
               with 256 seeded vision embeddings, through
               InferenceEngine.generate (K1, K2); whisper-base in full, 4
               requests of 1500 seeded frames with prompts of at most 64
               tokens (K2, and K1 as many times as the encoder layers and
               cross prefills, non-causal, and the decoder prefills,
               causal, need).
  10. train  — full smollm-360m (32 layers) and full mamba2-130m (24
               layers), float32, random weights from the seed, through
               ``repro_torch.launch.train``'s code path: batch 8 of 512
               tokens of the arithmetic stream, 20 steps, lr 3e-3, warmup
               5; every logged loss and gradient norm finite and the last
               loss below the first; tok/s, wall, peak memory, and the
               launches (smollm K1 / K1-bwd 32 each per step, mamba2 K5 /
               K5-bwd 24 each); one step with --remat on each (loss within
               1e-5 of the plain step; the forward kernel twice per layer,
               the backward one once); smollm's checkpoint, restored on the
               card bit for bit; then full zamba2-1.2b (38 layers, ~24 GB
               of parameters and AdamW state), batch 2 of 512, 5 steps:
               finite losses and gradient norms, K5 / K5-bwd 38 launches a
               step and K1 / K1-bwd 6; and one more zamba2-1.2b step under
               torch.profiler: its wall against its kernels' device time,
               the kernels and host operators that took the most.
  11. dryrun — the dry run's structures built for real, no kernel on this
               path: 11a. at full width, mistral-7b decode (B 8, S 4096)
               with a bf16 and with an int8 KV cache (REPRO_KV_QUANT=1),
               zamba2-1.2b train (B 2, S 512: params and AdamW state) and
               whisper-base prefill (B 4, S 448), each built by
               ``repro_torch.launch.input_specs`` on the meta device and
               again on the card: every leaf's shape and dtype equal, the
               card's storage bytes equal to ``launch.dryrun``'s
               ``argument_size_in_bytes`` on a 1x1 mesh exactly, the
               allocator's requested bytes grown by that sum exactly, and
               ``torch.cuda.memory_allocated()`` by that sum plus at most
               512 bytes a leaf, and 1 MiB more a leaf over 1 MiB (the
               rest of a free block the caching allocator does not split
               off); each case printed and freed before the next.
               11b. a 1-rank NCCL process group (a file:// store under
               build/) and ``make_debug_mesh(1, 1)`` on "cuda": full
               smollm-360m's bf16 params distributed as DTensors with the
               placements of ``params_shardings``, each local shape the
               spec's ``shard_shape``, ``full_tensor()`` back bit for bit;
               the group destroyed.
  12. dry-run cost — phase 11a's four cases: ``launch.dryrun.analyze``
               for one device (a 1x1 mesh of DTensors; on a torch older
               than the mesh path is held on, ``analyze`` refuses the mesh,
               the phase prints why and predicts from plain meta tensors)
               predicts the step's FLOPs and temporary bytes; the same
               step then runs on the card (``launch.dryrun.measure_step``:
               arguments from ``input_specs`` on "cuda", one warm-up on
               the ref path, then one under FlopCounterMode after the
               peak counters are reset): FLOPs equal exactly, and the
               allocator's requested-bytes peak less the bytes in use
               before within 2% + 64 MiB of ``temp_size_in_bytes``, every
               case printed before a miss fails; the walls of the ref and
               kernel paths (median of 3, CUDA events), and the
               prediction's FLOPs over the kernel path's wall in TFLOP/s
               and as a share of the bf16 peak (989e12).
  13. graphs — the engine's serve steps replayed as CUDA graphs
               (``InferenceEngine(..., graphs=True)``, the default, which
               phases 4-9 use) against the eager steps (``graphs=False``),
               full mistral-7b, bf16: 13a. one eager and one replayed
               decode step at phase 12's case (B 8, a 4096-row cache
               filled to 4032 rows with seeded values; bf16, then int8 KV)
               under torch.profiler: host ms, wall ms, device ms, device
               ops and the device's idle share; the same for one decode
               tick of phase 5's paged batcher (4 lanes); 13b. the decode
               step's wall, eager against replayed, the median of 20
               between CUDA events, the first replayed call (warm-up and
               capture) on its own, the logits' max |d| against the eager
               step and the greedy tokens (equal, or the phase fails);
               13c. the serve walls of phases 5 and 7 (the mix through
               FleetRouter, paged, bf16 and int8 KV with the fused read)
               and 4 whisper-base requests through ``generate``, eager,
               replayed, replayed, eager in one call: the ticks, the
               captures and the replays; tokens and ``fleet_report()``
               bookings identical in all four turns, or the phase fails.
  14. price  — the card priced from its own kernel timings, as the
               reference calibrates the hardware it runs on
               (``repro_torch.launch.calibrate``): 14a. power.draw at rest
               (nvidia-smi every 100 ms for about 1 s, the card idle) and
               while a bf16 K1 serving call runs back to back, beside
               ``H100_SXM``'s wattages (no gate); 14b. the reference's
               recipe, ``run_measured`` (``kernel_phase_samples(iters=10)``
               at its defaults: float32, 4/2 heads of 64) fitted to
               ``H100_SXM``; 14c. the serving fit: bf16 at mistral-7b's
               heads (32/8, D 128), the same lengths, paged int8 contexts
               256/1024/4096 and KV migrations of 8 and 64 blocks, the SSD
               cells at mamba2-130m's H 24, P 64, N 128, its artifact under
               build/ read back equal by ``CalibratedOracle.load``; each
               fit fails at a rel-RMSE of 0.35 or more and prints every
               constant and each sample's residual; 14d. phase 3c's cache
               through ``TableOracle.from_autotune(llama2-7b, H100_SXM)``,
               every entry re-measured at seed + 1 with its winner pinned
               (the int8 serving bucket at mistral-7b's heads), the
               re-measured rel-RMSE below 0.35 or the phase fails; 14e.
               ``price_fleet`` with 14c's calibration: the headline rows
               and both axes' optimal thresholds, M1-Pro + this card
               beside the paper's hand-tuned M1-Pro + A100 node. Every
               kernel's launches are counted from 0 over 14b, 14c and
               14d, and each step's kernels must have launched.

Every serve phase collects garbage and restarts the peak memory count
first, and prints the bytes still allocated. Phases 5, 6 and 9 run with no
autotune cache installed.

The line before the last is one JSON object with each kernel's numbers, one
row per kernel and serving path: ``name@arch`` is the kernel on that model's
path (plain ``name`` is mistral-7b's for K1-K4 and K6 — K3's and K6's
launches from phase 5, K4's from phase 7 — and mamba2-130m's for K5;
``@zamba2-1.2b`` rows count phase 6, the whisper-base, qwen2-vl-7b and phi3.5-moe rows phase 9;
``flash_attention_bwd`` and ``flash_attention@smollm-360m`` count phase
10's smollm-360m steps, ``ssd_scan_bwd`` and ``ssd_scan@mamba2-130m-train``
(K5's float32 forward) its mamba2-130m steps, and
``flash_attention_bwd@zamba2-1.2b``, ``flash_attention@zamba2-1.2b-train``,
``ssd_scan_bwd@zamba2-1.2b`` and ``ssd_scan@zamba2-1.2b-train`` its
zamba2-1.2b steps, and each carries phase 3t's float32 times and errors at
its model's training shape),
with that path's launches and its own shapes' times and errors; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}   # tests/test_kernels.py
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
# mistral-7b attention: 32 query heads, 8 KV heads, head dim 128
HQ, HKV, D = 32, 8, 128
# zamba2-1.2b's shared attention block: 32 heads, no grouping, head dim 64
ZAMBA = "zamba2-1.2b"
ZHQ, ZD, ZWINDOW = 32, 64, 8192
M_CAP, N_CAP = 512, 32        # serve phase: prompt and output caps
MAX_LEN = M_CAP + N_CAP       # engine context on the serving path
# (H, P, N, chunk) of the SSD scan: the full configs serve through phase 6,
# the reduced ones through ``repro_torch.launch.serve``
SSD_SHAPES = {"mamba2-130m": (24, 64, 128, 128), ZAMBA: (64, 64, 64, 128),
              "reduced": (16, 32, 32, 32)}
GATHER_TOL = 3e-5     # int8 fused vs the gather oracle (tests/test_autotune.py)
SERVE_KV_LEN = [40, 130, 300, 528]    # paged decode lanes at serving shape
# K6 at mistral-7b's prefill chunk in the benchmark's chat cell: C 256,
# blocks of 16, a 384-entry table (max_len 6144), window 4096; (valid rows,
# prior rows): chat's ~38-token prompts and a full chunk, from the first
# row and after 1,024 rows of context
CHUNK, CHUNK_BLOCKS, CHUNK_BS, WINDOW = 256, 384, 16, 4096
CHUNK_CASES = ((38, 0), (256, 0), (38, 1024), (256, 1024))
# the MoE, VLM and audio families' attention shapes
PHI = "phi3.5-moe-42b-a6.6b"          # 32 query heads on 8 KV heads, D 128
PHI_LAYERS = 16                       # of 32: the full depth needs ~83 GB
QWEN = "qwen2-vl-7b"                  # 28 query heads on 4 KV heads, D 128
QHQ, QHKV, QVIS = 28, 4, 256          # G = 7; 256 vision embeddings
QWEN_MAX_LEN = 800                    # 256 vision + a 512 prompt + 32 out
WHISPER = "whisper-base"              # 8 heads, no grouping, D 64
WHQ, WD, WENC = 8, 64, 1500           # 1500 encoder frames
W_PROMPT, W_MAX_LEN = 64, 96          # decoder prompt cap, engine context


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------- phase 1
def phase_device(torch):
    say("== phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"device: {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    say(f"nvidia-smi: {card}")
    return name, count, card


# --------------------------------------------------------------------- phase 2
def phase_build():
    say("== phase 2: build")
    from repro_torch.kernels import _build
    info = _build.build_info()
    say(f"library: {info.path} built={info.built} "
        f"build_seconds={info.seconds:.2f}")
    if info.log:
        say(info.log.rstrip())
    spills, int8 = [], []
    for kern, regs, smem, spill in _ptxas_report(info.log):
        k4 = _int8_split(kern)
        label = f"K4 {k4[0]} D={k4[1]} R={k4[2]} " if k4 else ""
        say(f"  ptxas {label}{kern}: {regs} registers, {smem} bytes smem, "
            f"spill stores/loads {spill} bytes")
        if k4:
            int8.append(k4)
        if spill != "0/0" and ("flash_fwd_" in kern or "bwd_" in kern
                               or "ssd_" in kern or "paged_chunk_" in kern
                               or "moe_gemm" in kern
                               or (k4 and k4[0] == "bf16" and k4[2] == 4)):
            spills.append(kern)
    # K4's split kernel: q float32 or bf16 x D 64 or 128 x R 1 or 4 (a
    # library found on disk was built by an earlier run: no ptxas output)
    if info.built and len(int8) != 8:
        fail(f"ptxas lists {len(int8)} int8 split instantiations, not 8")
    if not info.built:
        say("  ptxas: library found on disk, not rebuilt; no compiler "
            "report in this run")
    if spills:
        fail(f"ptxas reports spills in K1 v3 or v4, K1-bwd, K5, K5-bwd, K6, "
             f"K7 or a four-row bf16 K4 split kernel: {spills}")
    from repro_torch.kernels import ssm_scan as SS
    for arch, (_, _, _, P, N, L) in SSD_TRAIN.items():
        say(f"  layout {arch} P={P} N={N} chunk={L}: " + " ".join(
            f"{k}={t}thr/{b}B/{SS.blocks_per_sm(b)}per-SM"
            for k, (t, b) in SS.layouts(P, N, L).items()))


REPORTED_KERNELS = ("flash_fwd_wgmma", "flash_fwd_f32", "decode_split_kernel",
                    "decode_combine_kernel", "ssd_chunk_state_kernel",
                    "ssd_chunk_state_f32", "ssd_state_scan_kernel",
                    "ssd_output_kernel", "ssd_output_f32",
                    "bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel",
                    "bwd_group_sum_kernel", "ssd_bwd_", "paged_chunk_",
                    "moe_gemm")


def _int8_split(kern):
    """(q's type, D, R) of an int8 instantiation of decode_split_kernel
    <T, int8_t, D, R, PAGED> (K4) from its mangled name, else None."""
    import re
    m = re.search(r"decode_split_kernelI(f|13__nv_bfloat16)aLi(\d+)ELi(\d+)E",
                  kern)
    if m is None:
        return None
    return ("f32" if m.group(1) == "f" else "bf16", int(m.group(2)),
            int(m.group(3)))


def _ptxas_report(log):
    """(kernel, registers, static smem bytes, "stores/loads" spill bytes) of
    every K1 v3 and v4, K2 v4 / K3 v3 / K4 v3, K5 v2 and v3, K1-bwd,
    K5-bwd and K6 instantiation in nvcc's -Xptxas -v output."""
    import re
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in REPORTED_KERNELS) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, spill))
            name, spill = None, "?"
    return out


# --------------------------------------------------------------------- phase 3
def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err_on_valid(torch, got, want, rows_valid, tol):
    """max |got - want| over rows with a valid key; fails beyond tol."""
    g = got.float()[rows_valid]
    w = want.float()[rows_valid]
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        return err, False
    return err, True


def _flash_valid_rows(torch, B, hq, Sq, q_offset, window, sk_valid):
    """(B, Hq, Sq) bool: query rows with at least one valid key (causal)."""
    qpos = torch.arange(Sq, device="cuda") + q_offset
    nearest = torch.clamp(qpos, max=sk_valid - 1)    # closest key at or left
    ok = nearest >= 0
    if window is not None:
        ok &= (qpos - nearest) < window
    return ok[None, None, :].expand(B, hq, Sq)


def check_flash(torch, gen):
    """K1 at mistral-7b's heads, and at zamba2-1.2b's, whisper-base's,
    qwen2-vl-7b's and phi3.5-moe's serving shapes (a row each)."""
    from repro_torch.kernels import flash_attention as FA
    worst = {f"flash_attention{a}": 0.0 for a in
             ("", f"@{ZAMBA}", f"@{WHISPER}", f"@{QWEN}", f"@{PHI}")}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt, Sq=37, Sk=37), dict(dtype=dt, Sq=512, Sk=512),
                  dict(dtype=dt, Sq=512, Sk=512, window=100)]
    cases += [dict(dtype=torch.float32, Sq=37, Sk=37, softcap=30.0),
              dict(dtype=torch.float32, Sq=37, Sk=101, q_offset=64),
              dict(dtype=torch.bfloat16, Sq=200, Sk=200, d=64),
              dict(dtype=torch.float32, Sq=200, Sk=200, d=64, window=17)]
    z = dict(hq=ZHQ, hkv=ZHQ, d=ZD, window=ZWINDOW, arch=ZAMBA)
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt, Sq=512, Sk=512, **z),
                  dict(dtype=dt, Sq=200, Sk=200, **z)]
    # v3 (bf16, wgmma) at its edges: ragged Sq, q offsets, softcap, window,
    # sk_valid, both head dims and both GQA layouts, every tile at one shape
    bf = torch.bfloat16
    cases += [dict(dtype=bf, Sq=300, Sk=300),
              dict(dtype=bf, Sq=37, Sk=101, q_offset=64),
              dict(dtype=bf, Sq=40, Sk=40, q_offset=-4, d=64),
              dict(dtype=bf, Sq=64, Sk=64, softcap=30.0),
              dict(dtype=bf, Sq=200, Sk=200, d=64, window=17),
              dict(dtype=bf, Sq=100, Sk=100, sk_valid=77),
              dict(dtype=bf, Sq=128, Sk=128, hkv=32)]
    cases += [dict(dtype=bf, Sq=300, Sk=300, d=d, block_q=bq, block_k=bk)
              for d in (64, 128) for bq in FA.TILES[bf][0]
              for bk in FA.TILES[bf][1]]
    # the new families: whisper's encoder (non-causal, 1500 = 23 * 64 + 28,
    # and a ragged 300) and cross prefill (24 queries on 1500 keys),
    # qwen2-vl's G = 7 over 256 vision + 512 text, phi3.5-moe's prefill
    w = dict(hq=WHQ, hkv=WHQ, d=WD, causal=False, arch=WHISPER)
    for dt in (torch.float32, bf):
        cases += [dict(dtype=dt, Sq=WENC, Sk=WENC, **w),
                  dict(dtype=dt, Sq=300, Sk=300, **w),
                  dict(dtype=dt, Sq=24, Sk=WENC, **w),
                  dict(dtype=dt, Sq=QVIS + M_CAP, Sk=QVIS + M_CAP, hq=QHQ,
                       hkv=QHKV, arch=QWEN),
                  dict(dtype=dt, Sq=M_CAP, Sk=M_CAP, arch=PHI)]
    cases += [dict(dtype=bf, Sq=WENC, Sk=WENC, block_q=bq, block_k=bk, **w)
              for bq in FA.TILES[bf][0] for bk in FA.TILES[bf][1]]
    # v4 (f32, FMA micro-tiles) at the same edges, and every tile it takes
    f32 = torch.float32
    cases += [dict(dtype=f32, Sq=300, Sk=300),
              dict(dtype=f32, Sq=40, Sk=40, q_offset=-4, d=64),
              dict(dtype=f32, Sq=300, Sk=300, q_offset=-70, window=33),
              dict(dtype=f32, Sq=100, Sk=100, sk_valid=77),
              dict(dtype=f32, Sq=128, Sk=128, hkv=32),
              dict(dtype=f32, Sq=512, Sk=512, window=4096, d=64)]
    cases += [dict(dtype=f32, Sq=300, Sk=300, d=d, block_q=bq, block_k=bk)
              for d in (64, 128) for bq in FA.TILES[f32][0]
              for bk in FA.TILES[f32][1]
              if FA.smem_bytes(bq, bk, d) <= FA.SMEM_BYTES]
    lse_worst = {"float32": 0.0, "bfloat16": 0.0}
    for c in cases:
        dt, Sq, Sk, d = c["dtype"], c["Sq"], c["Sk"], c.get("d", D)
        hq, hkv = c.get("hq", HQ), c.get("hkv", HKV)
        q = _rand(torch, gen, (1, hq, Sq, d), dt)
        k = _rand(torch, gen, (1, hkv, Sk, d), dt)
        v = _rand(torch, gen, (1, hkv, Sk, d), dt)
        kw = dict(causal=c.get("causal", True), window=c.get("window"),
                  softcap=c.get("softcap"), q_offset=c.get("q_offset", 0),
                  sk_valid=c.get("sk_valid"))
        tiles = {t: c[t] for t in ("block_q", "block_k") if t in c}
        got = FA.flash_attention(q, k, v, **kw, **tiles)
        got_l, lse = FA._flash_attention_fwd(q, k, v, **kw, **tiles)
        want = FA.flash_attention_ref(q, k, v, **kw)
        want_lse = FA.flash_attention_lse_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        valid = Sk if kw["sk_valid"] is None else kw["sk_valid"]
        if kw["causal"]:
            rows = _flash_valid_rows(torch, 1, hq, Sq, kw["q_offset"],
                                     kw["window"], valid)
        else:                          # every row sees every valid key
            rows = torch.full((1, hq, Sq), valid > 0, dtype=torch.bool,
                              device="cuda")
        name = str(dt).split(".")[1]
        tol = TOL[name]
        err, ok = _err_on_valid(torch, got, want, rows, tol)
        ok = ok and torch.count_nonzero(got[~rows]).item() == 0
        # the lse the forward hands K1-bwd: close on rows with a key, +inf
        # exactly on the others; asking for it leaves the output's bits
        lse_err, lse_ok = _err_on_valid(torch, lse, want_lse, rows, tol)
        lse_ok = lse_ok and torch.equal(lse == torch.inf, ~rows) \
            and torch.equal(got, got_l)
        lse_worst[name] = max(lse_worst[name], lse_err)
        say(f"  K1 flash {name[:8]:8s} Hq={hq} Hkv={hkv} Sq={Sq:4d} "
            f"Sk={Sk:4d} D={d:3d} causal={kw['causal']} window={kw['window']} "
            f"softcap={kw['softcap']} q_offset={kw['q_offset']} "
            f"sk_valid={kw['sk_valid']} tiles={tiles or 'default'}: "
            f"max_abs_err={err:.3e} lse_err={lse_err:.3e} "
            f"{'ok' if ok and lse_ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 flash_attention disagrees with its plain version (or a "
                 f"row with no valid key is not 0): {c}")
        if not lse_ok:
            fail(f"K1's lse disagrees with flash_attention_lse_ref, is not "
                 f"+inf exactly on rows with no valid key, or changed the "
                 f"output: {c}")
        key = "flash_attention" + (f"@{c['arch']}" if "arch" in c else "")
        worst[key] = max(worst[key], err)
    say(f"  K1 lse worst |err| on rows with a key: v4 (float32) "
        f"{lse_worst['float32']:.3e}, v3 (bfloat16) "
        f"{lse_worst['bfloat16']:.3e}")
    _check_flash_refusals(torch, FA)
    return worst


def _check_flash_refusals(torch, FA):
    """Each K1 kernel refuses the tiles it does not take, before a launch."""
    q = torch.zeros((1, 2, 128, D), device="cuda")
    refusals = [(q.bfloat16(), dict(block_q=32), "takes block_q"),
                (q.bfloat16(), dict(block_k=96), "takes block_q"),
                (q, dict(block_q=128, block_k=128), "shared memory")]
    before = FA.flash_attention.launches
    for t, tiles, match in refusals:
        try:
            FA.flash_attention(t, t, t, **tiles)
        except ValueError as e:
            if match not in str(e):
                fail(f"K1 refused {tiles} ({t.dtype}) for another reason: {e}")
        else:
            fail(f"K1 took a tile its {t.dtype} kernel does not: {tiles}")
    if FA.flash_attention.launches != before:
        fail("a refused K1 call counted a launch")
    say(f"  K1 refusals ok: {[(str(t.dtype)[6:], k) for t, k, _ in refusals]}")


def _decode_inputs(torch, gen, dt, B, Smax, d, kv_len, hq=HQ, hkv=HKV):
    q = _rand(torch, gen, (B, hq, 1, d), dt)
    kc = _rand(torch, gen, (B, hkv, Smax, d), dt)
    vc = _rand(torch, gen, (B, hkv, Smax, d), dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kc, vc, kvl


def check_decode(torch, gen):
    """K2 at mistral-7b's heads, and at zamba2-1.2b's, qwen2-vl-7b's (G = 7)
    and whisper-base's (G = 1, D 64) (a row each)."""
    from repro_torch.kernels import decode_attention as DA
    worst = {f"decode_attention{a}": 0.0 for a in
             ("", f"@{ZAMBA}", f"@{QWEN}", f"@{WHISPER}")}
    kv_len = [1, 37, 300, MAX_LEN]          # ragged; 300 > the window below
    cases = [dict(dtype=torch.float32), dict(dtype=torch.bfloat16),
             dict(dtype=torch.float32, window=64),
             dict(dtype=torch.bfloat16, window=64),
             dict(dtype=torch.float32, softcap=20.0),
             dict(dtype=torch.bfloat16, d=64)]
    cases += [dict(dtype=dt, hq=ZHQ, hkv=ZHQ, d=ZD, window=ZWINDOW,
                   arch=ZAMBA) for dt in (torch.float32, torch.bfloat16)]
    for c in cases:
        dt, d = c["dtype"], c.get("d", D)
        hq, hkv = c.get("hq", HQ), c.get("hkv", HKV)
        q, kc, vc, kvl = _decode_inputs(torch, gen, dt, 4, MAX_LEN, d, kv_len,
                                        hq, hkv)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.decode_attention(q, kc, vc, kvl, **kw)
        want = DA.decode_attention_ref(q, kc, vc, kvl, **kw)
        torch.cuda.synchronize()
        rows = (kvl > 0)[:, None, None].expand(4, hq, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K2 decode {str(dt)[6:]:8s} B=4 Hq={hq} Hkv={hkv} "
            f"Smax={MAX_LEN} D={d:3d} kv_len={kv_len} window={kw['window']} "
            f"softcap={kw['softcap']}: max_abs_err={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 decode_attention disagrees with its plain version: {c}")
        key = "decode_attention" + (f"@{c['arch']}" if "arch" in c else "")
        worst[key] = max(worst[key], err)
    # v3's split edges: kv_len on both sides of a split of block_k keys
    for dt in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for bk in (32, 64, 128):
                edges = [1, bk - 1, bk, bk + 1, MAX_LEN]
                q, kc, vc, kvl = _decode_inputs(torch, gen, dt, len(edges),
                                                MAX_LEN, d, edges)
                for kw in ({}, {"window": 64}, {"softcap": 20.0}):
                    got = DA.decode_attention(q, kc, vc, kvl, block_k=bk,
                                              **kw)
                    want = DA.decode_attention_ref(q, kc, vc, kvl, **kw)
                    torch.cuda.synchronize()
                    rows = (kvl > 0)[:, None, None].expand(len(edges), HQ, 1)
                    err, ok = _err_on_valid(torch, got, want, rows,
                                            TOL[str(dt)[6:]])
                    say(f"  K2 edges  {str(dt)[6:]:8s} D={d:3d} "
                        f"block_k={bk:3d} kv_len={edges} {kw}: "
                        f"max_abs_err={err:.3e} "
                        f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"K2 split edges disagree: {dt} D={d} "
                             f"block_k={bk} {kw}")
                    worst["decode_attention"] = max(
                        worst["decode_attention"], err)
    # qwen2-vl's G = 7 (two passes of R = 4 and 3 rows) and whisper's G = 1
    # at D 64, each at its engine context, on both sides of a split edge
    for arch, hq, hkv, d, smax in ((QWEN, QHQ, QHKV, D, QWEN_MAX_LEN),
                                   (WHISPER, WHQ, WHQ, WD, W_MAX_LEN)):
        for dt in (torch.float32, torch.bfloat16):
            for bk in (32, 64, 128):
                edges = [n for n in (1, bk - 1, bk, bk + 1) if n < smax]
                edges.append(smax)
                q, kc, vc, kvl = _decode_inputs(torch, gen, dt, len(edges),
                                                smax, d, edges, hq, hkv)
                got = DA.decode_attention(q, kc, vc, kvl, block_k=bk)
                want = DA.decode_attention_ref(q, kc, vc, kvl)
                torch.cuda.synchronize()
                rows = (kvl > 0)[:, None, None].expand(len(edges), hq, 1)
                err, ok = _err_on_valid(torch, got, want, rows,
                                        TOL[str(dt)[6:]])
                say(f"  K2 {arch:12s} {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} "
                    f"D={d:3d} Smax={smax} block_k={bk:3d} kv_len={edges}: "
                    f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"K2 at {arch}'s grouping disagrees: {dt} "
                         f"block_k={bk}")
                worst[f"decode_attention@{arch}"] = max(
                    worst[f"decode_attention@{arch}"], err)
    q, kc, vc, kvl = _decode_inputs(torch, gen, torch.bfloat16, 4, MAX_LEN, D,
                                    SERVE_KV_LEN)
    _check_split_graph(torch, "K2", DA.decode_attention,
                       DA.decode_attention_ref, (q, kc, vc), kvl,
                       [n + 1 for n in SERVE_KV_LEN])
    return worst


def _check_split_graph(torch, label, fn, ref_fn, args, kvl, new_kv):
    """K2, K3 or K4 (split and combine, one call) captured into a CUDA graph:
    replays equal the eager call, kv_len is read on the device at replay
    (set to new_kv), and the count moves by one per call."""
    before = fn.launches
    eager = fn(*args, kvl)
    if fn.launches != before + 1:
        fail(f"{label}'s count did not move by one for one call")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*args, kvl)
    g.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    kvl.copy_(torch.tensor(new_kv, dtype=torch.int32))
    g.replay()
    want = ref_fn(*args, kvl)
    torch.cuda.synchronize()
    err, ok = _err_on_valid(torch, out, want,
                            torch.ones(out.shape[:3], dtype=torch.bool,
                                       device="cuda"), TOL["bfloat16"])
    say(f"  {label} graph: replay equals eager {same}; after kv_len -> "
        f"{new_kv} max_abs_err={err:.3e}; launches {fn.launches - before} "
        f"for 2 calls {'ok' if same and ok else 'MISMATCH'}")
    if not (same and ok) or fn.launches != before + 2:
        fail(f"{label} under CUDA graph capture")


def _paged_inputs(torch, gen, dt, bs, d, kv_len, num_blocks, max_blocks,
                  hq=HQ, hkv=HKV):
    """Pools with random contents and tables whose live entries are distinct
    random blocks (never the null block 0) and whose dead entries are 0."""
    B = len(kv_len)
    q = _rand(torch, gen, (B, hq, 1, d), dt)
    kp = _rand(torch, gen, (num_blocks, hkv, bs, d), dt)
    vp = _rand(torch, gen, (num_blocks, hkv, bs, d), dt)
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, max_blocks), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, kvl


def check_paged(torch, gen):
    """K3 at mistral-7b's serving shapes and edges; then at phi3.5-moe's
    (its own row: the same heads, no window). Returns both worst errors."""
    from repro_torch.kernels import decode_attention as DA
    worst = 0.0
    kv_len = [1, 37, 300, MAX_LEN]
    cases = []
    for bs in (16, 128):
        cases += [dict(dtype=torch.float32, bs=bs),
                  dict(dtype=torch.bfloat16, bs=bs),
                  dict(dtype=torch.float32, bs=bs, window=64)]
    cases += [dict(dtype=torch.float32, bs=16, softcap=20.0),
              dict(dtype=torch.bfloat16, bs=16, d=64)]
    for c in cases:
        dt, bs, d = c["dtype"], c["bs"], c.get("d", D)
        mb = -(-MAX_LEN // bs)
        q, kp, vp, tables, kvl = _paged_inputs(torch, gen, dt, bs, d, kv_len,
                                               4 * mb + 8, mb)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.paged_decode_attention(q, kp, vp, tables, kvl, **kw)
        want = DA.paged_decode_attention_ref(q, kp, vp, tables, kvl, **kw)
        torch.cuda.synchronize()
        rows = (kvl > 0)[:, None, None].expand(4, HQ, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K3 paged  {str(dt)[6:]:8s} B=4 bs={bs:3d} D={d:3d} "
            f"kv_len={kv_len} window={kw['window']} softcap={kw['softcap']}: "
            f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K3 paged_decode_attention disagrees with its plain "
                 f"version: {c}")
        worst = max(worst, err)
    # v2's split edges: kv_len 0 and on both sides of a split of block_k
    # keys, through pool blocks of 16 and 32, G = 4 (mistral-7b) and 1
    for dt in (torch.float32, torch.bfloat16):
        for bs in (16, 32):
            for bk in (32, 64, 128):
                for hq, hkv, d in ((HQ, HKV, D), (4, 4, 64)):
                    mb = -(-(2 * bk + 9) // bs)
                    edges = [0, 1, bk - 1, bk, bk + 1, bs * mb]
                    q, kp, vp, tables, kvl = _paged_inputs(
                        torch, gen, dt, bs, d, edges,
                        1 + sum(-(-n // bs) for n in edges), mb, hq, hkv)
                    rows = (kvl > 0)[:, None, None].expand(len(edges), hq, 1)
                    for kw in ({}, {"window": 71}, {"softcap": 20.0}):
                        got = DA.paged_decode_attention(
                            q, kp, vp, tables, kvl, block_k=bk, **kw)
                        want = DA.paged_decode_attention_ref(
                            q, kp, vp, tables, kvl, **kw)
                        torch.cuda.synchronize()
                        err, ok = _err_on_valid(torch, got, want, rows,
                                                TOL[str(dt)[6:]])
                        ok = ok and torch.count_nonzero(got[~rows]).item() == 0
                        say(f"  K3 edges  {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} "
                            f"D={d:3d} bs={bs} block_k={bk:3d} "
                            f"kv_len={edges} {kw}: max_abs_err={err:.3e} "
                            f"{'ok' if ok else 'MISMATCH'}")
                        if not ok:
                            fail(f"K3 split edges disagree (or a lane with "
                                 f"no key is not 0): {dt} bs={bs} "
                                 f"block_k={bk} Hq={hq} {kw}")
                        worst = max(worst, err)
    q, kp, vp, tables, kvl = _paged_inputs(torch, gen, torch.bfloat16, 16, D,
                                           SERVE_KV_LEN, 1024,
                                           -(-MAX_LEN // 16))
    _check_split_graph(torch, "K3", DA.paged_decode_attention,
                       DA.paged_decode_attention_ref, (q, kp, vp, tables),
                       kvl, [n - 7 for n in SERVE_KV_LEN])
    phi = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp, tables, kvl = _paged_inputs(torch, gen, dt, 16, D,
                                               SERVE_KV_LEN, 1024,
                                               -(-MAX_LEN // 16))
        got = DA.paged_decode_attention(q, kp, vp, tables, kvl)
        want = DA.paged_decode_attention_ref(q, kp, vp, tables, kvl)
        torch.cuda.synchronize()
        rows = torch.ones(got.shape[:3], dtype=torch.bool, device="cuda")
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K3 {PHI} {str(dt)[6:]:8s} B=4 pool=1024x16 D={D} "
            f"kv_len={SERVE_KV_LEN}: max_abs_err={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K3 at {PHI}'s serving shape disagrees: {dt}")
        phi = max(phi, err)
    return {"paged_decode_attention": worst,
            f"paged_decode_attention@{PHI}": phi}


def _chunk_inputs(torch, gen, n_valid, prior):
    """One lane's bf16 chunk at mistral-7b's shape: q (1, HQ, CHUNK, D) at
    q_offset ``prior``; pools holding the lane's blocks 1.. (the null block
    0 full of garbage), its table listing them shuffled, the rest 0; kv_len
    prior + n_valid."""
    kv = prior + n_valid
    used = -(-kv // CHUNK_BS)
    kp, vp = (_rand(torch, gen, (used + 1, HKV, CHUNK_BS, D), torch.bfloat16)
              for _ in range(2))
    kp[0], vp[0] = 1e4, -1e4
    table = torch.zeros(CHUNK_BLOCKS, dtype=torch.int32, device="cuda")
    table[:used] = (torch.randperm(used, generator=gen, device="cuda")
                    + 1).to(torch.int32)
    q = _rand(torch, gen, (1, HQ, CHUNK, D), torch.bfloat16)
    return (q, kp, vp, table,
            torch.tensor([kv], dtype=torch.int32, device="cuda"),
            torch.tensor(prior, dtype=torch.int32, device="cuda"))


def check_chunk(torch, gen):
    """K6 against its plain version at mistral-7b's chunk, bf16, for each
    of CHUNK_CASES: on valid rows each row's error within bf16's 2e-2 of
    that row's largest output (after 1,024 prior rows an output is ~0.05,
    so an absolute 2e-2 would pass a wrong answer), padded rows exactly 0.
    Returns the worst absolute error."""
    from repro_torch.kernels import chunk_attention as CA
    worst = 0.0
    for n_valid, prior in CHUNK_CASES:
        inp = _chunk_inputs(torch, gen, n_valid, prior)
        got = CA.paged_chunk_attention(*inp, window=WINDOW).float()
        want = CA.paged_chunk_attention_ref(*inp, window=WINDOW).float()
        torch.cuda.synchronize()
        g, w = got[:, :, :n_valid], want[:, :, :n_valid]
        err = (g - w).abs()
        row = w.abs().amax(-1, keepdim=True)
        rel = (err / row).max().item()
        ok = rel <= TOL["bfloat16"] and \
            torch.count_nonzero(got[:, :, n_valid:]).item() == 0
        say(f"  K6 chunk  bfloat16 C={CHUNK} Hq={HQ} Hkv={HKV} D={D} "
            f"table={CHUNK_BLOCKS}x{CHUNK_BS} window={WINDOW} valid="
            f"{n_valid} prior={prior}: max_abs_err={err.max().item():.3e} "
            f"max_err/row_max={rel:.3e} output rms="
            f"{w.pow(2).mean().sqrt().item():.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K6 paged_chunk_attention disagrees with its plain version "
                 f"(or a padded row is not 0): valid {n_valid} prior {prior}")
        worst = max(worst, err.max().item())
    return worst


def _int8_inputs(torch, gen, dt, bs, d, kv_len, num_blocks, max_blocks,
                 hq=HQ, hkv=HKV):
    """int8 pools, float32 scale pools in [0.005, 0.02), and tables whose
    live entries are distinct random blocks (never the null block 0)."""
    B = len(kv_len)
    q = _rand(torch, gen, (B, hq, 1, d), dt)
    shape = (num_blocks, hkv, bs, d)
    kp = torch.randint(-127, 128, shape, generator=gen,
                       device="cuda").to(torch.int8)
    vp = torch.randint(-127, 128, shape, generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand(shape[:3] + (1,), generator=gen, device="cuda") \
        * 0.015 + 0.005
    vs = torch.rand(shape[:3] + (1,), generator=gen, device="cuda") \
        * 0.015 + 0.005
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, max_blocks), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kp, vp, ks, vs, tables, kvl


def check_int8(torch, gen):
    """K4 against its plain version at mistral-7b's serving shape (B = 4,
    pool 1024 x 16) and a reduced D = 64 one, and in f32 against the gather
    oracle. Returns the worst error against the plain version."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    worst = 0.0
    mb = -(-MAX_LEN // 16)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt), dict(dtype=dt, softcap=30.0),
                  dict(dtype=dt, window=64),
                  dict(dtype=dt, softcap=20.0, window=200)]
        cases += [dict(dtype=dt, d=64, hq=4, hkv=1, kv_len=[1, 45, 96, 130],
                       nb=64)]
    for c in cases:
        dt, d = c["dtype"], c.get("d", D)
        hq, hkv = c.get("hq", HQ), c.get("hkv", HKV)
        kv_len = c.get("kv_len", SERVE_KV_LEN)
        inp = _int8_inputs(torch, gen, dt, 16, d, kv_len, c.get("nb", 1024),
                           mb, hq, hkv)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.paged_decode_attention_int8(*inp, **kw)
        want = DA.paged_decode_attention_int8_ref(*inp, **kw)
        torch.cuda.synchronize()
        rows = (inp[6] > 0)[:, None, None].expand(len(kv_len), hq, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        line = (f"  K4 int8   {str(dt)[6:]:8s} B={len(kv_len)} Hq={hq} "
                f"Hkv={hkv} bs=16 D={d:3d} kv_len={kv_len} "
                f"window={kw['window']} softcap={kw['softcap']}: "
                f"max_abs_err={err:.3e}")
        if dt == torch.float32:
            oracle = ref.paged_decode_attention_quant(*inp[:6],
                                                      kv_len=inp[6], **kw)
            g_err, g_ok = _err_on_valid(torch, got, oracle, rows, GATHER_TOL)
            line += f" vs_gather={g_err:.3e}"
            ok = ok and g_ok
        say(f"{line} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K4 paged_decode_attention_int8 disagrees with its plain "
                 f"version or the gather oracle: {c}")
        worst = max(worst, err)
    # v2's split edges: kv_len 0 and on both sides of a split of block_k
    # keys, G = 4 (mistral-7b) and 1, through pool blocks of 16
    for dt in (torch.float32, torch.bfloat16):
        for bk in (32, 64, 128):
            for hq, hkv, d in ((HQ, HKV, D), (4, 4, 64)):
                edges = [0, 1, bk - 1, bk, bk + 1, 2 * bk + 9]
                inp = _int8_inputs(torch, gen, dt, 16, d, edges,
                                   1 + sum(-(-n // 16) for n in edges),
                                   -(-edges[-1] // 16), hq, hkv)
                rows = (inp[6] > 0)[:, None, None].expand(len(edges), hq, 1)
                for kw in ({}, {"window": 71}, {"softcap": 20.0}):
                    got = DA.paged_decode_attention_int8(*inp, block_k=bk,
                                                         **kw)
                    want = DA.paged_decode_attention_int8_ref(*inp, **kw)
                    torch.cuda.synchronize()
                    err, ok = _err_on_valid(torch, got, want, rows,
                                            TOL[str(dt)[6:]])
                    ok = ok and torch.count_nonzero(got[~rows]).item() == 0
                    line = (f"  K4 edges  {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} "
                            f"D={d:3d} bs=16 block_k={bk:3d} kv_len={edges} "
                            f"{kw}: max_abs_err={err:.3e}")
                    if dt == torch.float32:
                        oracle = ref.paged_decode_attention_quant(
                            *inp[:6], kv_len=inp[6], **kw)
                        g_err, g_ok = _err_on_valid(torch, got, oracle, rows,
                                                    GATHER_TOL)
                        line += f" vs_gather={g_err:.3e}"
                        ok = ok and g_ok
                    say(f"{line} {'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"K4 split edges disagree (or a lane with no key "
                             f"is not 0): {dt} block_k={bk} Hq={hq} {kw}")
                    worst = max(worst, err)
    inp = _int8_inputs(torch, gen, torch.bfloat16, 16, D, SERVE_KV_LEN, 1024,
                       mb)
    _check_split_graph(torch, "K4", DA.paged_decode_attention_int8,
                       DA.paged_decode_attention_int8_ref, inp[:6], inp[6],
                       [n - 7 for n in SERVE_KV_LEN])
    return worst


def _ssd_inputs(torch, gen, dt_type, B, H, S, P, N):
    x = _rand(torch, gen, (B, H, S, P), dt_type)
    dt = torch.rand((B, H, S), generator=gen, device="cuda") * 0.2 + 0.001
    A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
    Bm = _rand(torch, gen, (B, S, N), dt_type)
    Cm = _rand(torch, gen, (B, S, N), dt_type)
    return x, dt, A, Bm, Cm


def check_ssd(torch, gen):
    """K5 against the chunked plain version and the sequential oracle: y and
    the final state, S a multiple of the chunk and ragged. Returns the worst
    error against the chunked version per kernels-line row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as SS
    worst = {"ssd_scan": 0.0, f"ssd_scan@{ZAMBA}": 0.0}
    for arch, (H, P, N, L) in SSD_SHAPES.items():
        for dt_type in (torch.float32, torch.bfloat16):
            for S in ((512, 300) if L == 128 else (64, 45)):
                inp = _ssd_inputs(torch, gen, dt_type, 2, H, S, P, N)
                y, fs = SS.ssd_scan(*inp, chunk=L)
                torch.cuda.synchronize()
                tol = SSD_TOL[str(dt_type)[6:]]
                errs, ok = [], True
                for want_y, want_fs in (SS.ssd_scan_ref(*inp, chunk=L),
                                        ref.ssd_scan(*inp)):
                    for g, w in ((y.float(), want_y.float()), (fs, want_fs)):
                        errs.append((g - w).abs().max().item())
                        ok = ok and torch.allclose(g, w, atol=tol, rtol=tol)
                say(f"  K5 ssd    {str(dt_type)[6:]:8s} {arch:12s} B=2 H={H} "
                    f"P={P} N={N} S={S} chunk={L}: max_abs_err y/state "
                    f"chunked={errs[0]:.3e}/{errs[1]:.3e} "
                    f"sequential={errs[2]:.3e}/{errs[3]:.3e} "
                    f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"K5 ssd_scan disagrees with its plain versions: "
                         f"{arch} {dt_type} S={S}")
                key = "ssd_scan" if arch == "mamba2-130m" else \
                    f"ssd_scan@{arch}"
                if key in worst:
                    worst[key] = max(worst[key], errs[0], errs[1])
    _check_ssd_graph(torch, gen, SS)
    return worst


def _check_ssd_graph(torch, gen, SS):
    """K5 (three passes, one call) captured into a CUDA graph at
    mamba2-130m's shape: replays equal the eager call, a replay on new
    inputs gives their scan, and the count moves by one per call."""
    H, P, N, L = SSD_SHAPES["mamba2-130m"]
    inp = _ssd_inputs(torch, gen, torch.bfloat16, 1, H, M_CAP, P, N)
    before = SS.ssd_scan.launches
    eager = SS.ssd_scan(*inp, chunk=L)
    if SS.ssd_scan.launches != before + 1:
        fail("K5's count did not move by one for one call")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, fs = SS.ssd_scan(*inp, chunk=L)
    g.replay()
    torch.cuda.synchronize()
    same = torch.equal(y, eager[0]) and torch.equal(fs, eager[1])
    for t, new in zip(inp, _ssd_inputs(torch, gen, torch.bfloat16, 1, H,
                                       M_CAP, P, N)):
        t.copy_(new)
    g.replay()
    want_y, want_fs = SS.ssd_scan_ref(*inp, chunk=L)
    torch.cuda.synchronize()
    tol = SSD_TOL["bfloat16"]
    err = max((y.float() - want_y.float()).abs().max().item(),
              (fs - want_fs).abs().max().item())
    ok = torch.allclose(y.float(), want_y.float(), atol=tol, rtol=tol) and \
        torch.allclose(fs, want_fs, atol=tol, rtol=tol)
    say(f"  K5 graph: replay equals eager {same}; on new inputs "
        f"max_abs_err={err:.3e}; launches {SS.ssd_scan.launches - before} "
        f"for 2 calls {'ok' if same and ok else 'MISMATCH'}")
    if not (same and ok) or SS.ssd_scan.launches != before + 2:
        fail("K5 under CUDA graph capture")


def time_ms(torch, fn, calls=20, replays=10):
    """Device time of one call: ``calls`` calls captured into a CUDA graph,
    replayed ``replays`` times between CUDA events (so host launch overhead
    is not counted). L2 is warm: inputs are re-read every call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels(torch, gen):
    """Each kernel at the serving path's shapes, bf16: kernel, plain version,
    library call where one exists, and the card's bound for this input."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    dt, isz = torch.bfloat16, 2
    out = {}

    # K1: one 512-token prompt prefill (engine path), causal, window 4096
    S = M_CAP
    q = _rand(torch, gen, (1, HQ, S, D), dt)
    k = _rand(torch, gen, (1, HKV, S, D), dt)
    v = _rand(torch, gen, (1, HKV, S, D), dt)
    kw = dict(causal=True, window=4096)
    k_rep = k.repeat_interleave(HQ // HKV, dim=1)
    v_rep = v.repeat_interleave(HQ // HKV, dim=1)
    pairs = S * (S + 1) // 2                       # causal (q, k) pairs
    flops = 4 * HQ * D * pairs
    nbytes = (2 * HQ * S * D + 2 * HKV * S * D) * isz
    b_ms, b_by = _bound(flops, nbytes)
    out["flash_attention"] = dict(
        ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_flash_tiles(torch, FA, q, k, v, kw),
        shape=f"B=1 Hq={HQ} Hkv={HKV} Sq=Sk={S} D={D} bf16 causal window=4096")

    # K1 at zamba2-1.2b's shared block: 32 heads, no grouping, D = 64
    q = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    k = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    v = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    kw = dict(causal=True, window=ZWINDOW)
    b_ms, b_by = _bound(4 * ZHQ * ZD * pairs, 4 * ZHQ * S * ZD * isz)
    out[f"flash_attention@{ZAMBA}"] = dict(
        ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_flash_tiles(torch, FA, q, k, v, kw),
        shape=f"B=1 Hq=Hkv={ZHQ} Sq=Sk={S} D={ZD} bf16 causal "
              f"window={ZWINDOW}")

    # K2: engine-path decode, one lane, a 512-token prompt 16 steps in
    kvl_n = M_CAP + 16
    qd, kc, vc, kvl = _decode_inputs(torch, gen, dt, 1, MAX_LEN, D, [kvl_n])
    k_live = kc[:, :, :kvl_n].repeat_interleave(HQ // HKV, dim=1)
    v_live = vc[:, :, :kvl_n].repeat_interleave(HQ // HKV, dim=1)
    flops = 4 * HQ * D * kvl_n
    nbytes = (2 * HQ * D + 2 * HKV * kvl_n * D) * isz + 4
    b_ms, b_by = _bound(flops, nbytes)
    out["decode_attention"] = dict(
        ms=time_ms(torch, lambda: DA.decode_attention(qd, kc, vc, kvl,
                                                      window=4096)),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_ref(
            qd, kc, vc, kvl, window=4096)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, k_live, v_live)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.decode_attention, qd, kc, vc, kvl,
                          window=4096),
        shape=f"B=1 Hq={HQ} Hkv={HKV} Smax={MAX_LEN} kv_len={kvl_n} D={D} "
              f"bf16")

    # K2 at zamba2-1.2b's shared block
    qz, kz, vz, kvlz = _decode_inputs(torch, gen, dt, 1, MAX_LEN, ZD, [kvl_n],
                                      ZHQ, ZHQ)
    kz_live, vz_live = kz[:, :, :kvl_n], vz[:, :, :kvl_n]
    b_ms, b_by = _bound(4 * ZHQ * ZD * kvl_n,
                        (2 * ZHQ * ZD + 2 * ZHQ * kvl_n * ZD) * isz + 4)
    out[f"decode_attention@{ZAMBA}"] = dict(
        ms=time_ms(torch, lambda: DA.decode_attention(qz, kz, vz, kvlz,
                                                      window=ZWINDOW)),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_ref(
            qz, kz, vz, kvlz, window=ZWINDOW)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qz, kz_live, vz_live)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.decode_attention, qz, kz, vz, kvlz,
                          window=ZWINDOW),
        shape=f"B=1 Hq=Hkv={ZHQ} Smax={MAX_LEN} kv_len={kvl_n} D={ZD} bf16")

    # K3: paged-batcher decode, 4 lanes of a 1024-block pool, block 16
    kv_len = [40, 130, 300, 528]
    mb = -(-MAX_LEN // 16)
    qp, kp, vp, tables, kvlp = _paged_inputs(torch, gen, dt, 16, D, kv_len,
                                             1024, mb)
    n_kv = sum(kv_len)
    flops = 4 * HQ * D * n_kv
    nbytes = (2 * 4 * HQ * D + 2 * HKV * n_kv * D) * isz + 4 * 4 \
        + sum(-(-n // 16) for n in kv_len) * 4
    b_ms, b_by = _bound(flops, nbytes)
    out["paged_decode_attention"] = dict(
        ms=time_ms(torch, lambda: DA.paged_decode_attention(
            qp, kp, vp, tables, kvlp, window=4096)),
        plain_ms=time_ms(torch, lambda: DA.paged_decode_attention_ref(
            qp, kp, vp, tables, kvlp, window=4096)),
        library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.paged_decode_attention, qp, kp, vp,
                          tables, kvlp, window=4096),
        shape=f"B=4 Hq={HQ} Hkv={HKV} pool=1024x16 kv_len={kv_len} D={D} bf16")

    # K4: the int8 paged batchers' decode, the same lanes and pool; no
    # single PyTorch call computes it (library_ms null). Beside it, the
    # gather composition (impl="gather": gather, dequantize, K2)
    from repro_torch.kernels import ops
    inp = _int8_inputs(torch, gen, dt, 16, D, kv_len, 1024, mb)
    flops = 4 * HQ * D * n_kv
    nbytes = 2 * HKV * n_kv * D + 2 * HKV * n_kv * 4 + 2 * 4 * HQ * D * isz \
        + 4 * 4 + sum(-(-n // 16) for n in kv_len) * 4
    b_ms, b_by = _bound(flops, nbytes)
    out["paged_decode_attention_int8"] = dict(
        ms=time_ms(torch, lambda: DA.paged_decode_attention_int8(
            *inp, window=4096)),
        plain_ms=time_ms(torch, lambda: DA.paged_decode_attention_int8_ref(
            *inp, window=4096)),
        gather_ms=time_ms(torch, lambda: ops.paged_decode_attention_quant(
            *inp, window=4096, impl="gather")),
        library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.paged_decode_attention_int8, *inp,
                           window=4096),
        shape=f"B=4 Hq={HQ} Hkv={HKV} pool=1024x16 int8 kv_len={kv_len} "
              f"D={D} q bf16")

    # K5: one 512-token prompt prefill of one Mamba layer (engine path);
    # no single PyTorch call computes the SSD scan, so library_ms is null
    from repro_torch.kernels import ssm_scan as SS
    S = M_CAP
    for arch in ("mamba2-130m", ZAMBA):
        H, P, N, L = SSD_SHAPES[arch]
        inp = _ssd_inputs(torch, gen, dt, 1, H, S, P, N)
        nc = -(-S // L)
        pairs = nc * L * (L + 1) // 2            # causal (i, j) per chunk
        flops = 2 * H * (pairs * (N + P) + nc * 2 * L * P * N)
        nbytes = (2 * H * S * P + 2 * S * N) * isz + (H * S + H) * 4 \
            + H * P * N * 4
        b_ms, b_by = _bound(flops, nbytes)
        key = "ssd_scan" if arch == "mamba2-130m" else f"ssd_scan@{arch}"
        out[key] = dict(
            ms=time_ms(torch, lambda: SS.ssd_scan(*inp, chunk=L)),
            plain_ms=time_ms(torch, lambda: SS.ssd_scan_ref(*inp, chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            tiles=_ssd_passes(torch, SS, inp, N, L),
            shape=f"{arch} B=1 H={H} S={S} P={P} N={N} chunk={L} bf16")
    out.update(_time_families(torch, gen, F, FA, DA))

    # K6: one lane's prefill chunk (the paged batchers), each of
    # CHUNK_CASES; the row is chat's (38 valid rows, none before)
    cases = {f"{n}@{prior}": _chunk_row(torch, F, gen, n, prior)
             for n, prior in CHUNK_CASES}
    out["paged_chunk_attention"] = dict(
        cases["38@0"], cases=cases,
        shape=f"C={CHUNK} valid=38 prior=0 Hq={HQ} Hkv={HKV} D={D} "
              f"table={CHUNK_BLOCKS}x{CHUNK_BS} window={WINDOW} bf16")
    for name, r in out.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = f" gather_ms={r['gather_ms']:.4f}" if "gather_ms" in r else ""
        say(f"  time {name:34s} {r['shape']}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib}{extra} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
        if "tiles" in r:
            what = "pass" if name.startswith("ssd_scan") else "tile"
            say(f"  tiles {name:33s} ms by {what}: " + " ".join(
                f"{t}={ms:.4f}" for t, ms in r["tiles"].items()))
        for case, c in r.get("cases", {}).items():
            say(f"  case {name} valid@prior={case}: ms={c['ms']:.5f} "
                f"plain_ms={c['plain_ms']:.4f} library_ms="
                f"{c['library_ms']:.4f} bound_ms={c['bound_ms']:.5f} "
                f"({c['bound_by']})")
    return out


def _chunk_row(torch, F, gen, n_valid, prior):
    """K6 at one of CHUNK_CASES beside its plain version (the path it
    replaced: the whole table gathered, then the dense float32 attention)
    and, as a yardstick the port never calls, one SDPA call on the gathered
    table (K/V expanded, a boolean mask). Bound over the valid (query, key)
    pairs, each byte once: the valid rows of q and o, the K/V rows they
    reach, their table entries and the two lengths."""
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import ref
    inp = _chunk_inputs(torch, gen, n_valid, prior)
    q, kp, vp, table = inp[:4]
    kv = prior + n_valid
    k, v = (ref.gather_paged_kv(pool, table[None]).repeat_interleave(
        HQ // HKV, dim=1) for pool in (kp, vp))
    qpos = prior + torch.arange(CHUNK, device="cuda")[:, None]
    kpos = torch.arange(k.shape[2], device="cuda")[None]
    mask = (kpos <= qpos) & (qpos - kpos < WINDOW) & (kpos < kv)
    pairs = sum(min(prior + i + 1, WINDOW) for i in range(n_valid))
    first = max(0, prior - WINDOW + 1)
    nbytes = (2 * HQ * n_valid * D + 2 * HKV * (kv - first) * D) * 2 \
        + 4 * -(-kv // CHUNK_BS) + 8
    b_ms, b_by = _bound(4 * HQ * D * pairs, nbytes)
    return dict(
        ms=time_ms(torch, lambda: CA.paged_chunk_attention(*inp,
                                                           window=WINDOW)),
        plain_ms=time_ms(torch, lambda: CA.paged_chunk_attention_ref(
            *inp, window=WINDOW)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)


def _flash_row(torch, F, FA, q, k, v, *, causal, shape):
    """One K1 row: kernel, plain version, one SDPA call (K/V expanded to the
    query heads when grouped) and the bound for these inputs, bf16."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    k_rep = k.repeat_interleave(hq // hkv, dim=1)
    v_rep = v.repeat_interleave(hq // hkv, dim=1)
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    b_ms, b_by = _bound(4 * hq * d * pairs,
                        (2 * hq * sq * d + 2 * hkv * sk * d) * 2)
    kw = dict(causal=causal)
    return dict(
        ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=causal)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_flash_tiles(torch, FA, q, k, v, kw), shape=shape)


def _decode_row(torch, F, DA, gen, hq, hkv, d, smax, kv_len, shape):
    """One K2 row at one lane's engine decode, bf16."""
    q, kc, vc, kvl = _decode_inputs(torch, gen, torch.bfloat16, 1, smax, d,
                                    [kv_len], hq, hkv)
    k_live = kc[:, :, :kv_len].repeat_interleave(hq // hkv, dim=1)
    v_live = vc[:, :, :kv_len].repeat_interleave(hq // hkv, dim=1)
    b_ms, b_by = _bound(4 * hq * d * kv_len,
                        (2 * hq * d + 2 * hkv * kv_len * d) * 2 + 4)
    return dict(
        ms=time_ms(torch, lambda: DA.decode_attention(q, kc, vc, kvl)),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_ref(q, kc, vc,
                                                                kvl)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k_live, v_live)),
        bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.decode_attention, q, kc, vc, kvl,
                           window=None), shape=shape)


def _time_families(torch, gen, F, FA, DA):
    """The MoE, VLM and audio families' rows: each kernel at its serving
    path's shapes, bf16, one request (B = 1) unless batched."""
    bf, out = torch.bfloat16, {}
    # K1, whisper's encoder: 1500 frames, non-causal, 8 heads of 64
    qkv = [_rand(torch, gen, (1, WHQ, WENC, WD), bf) for _ in range(3)]
    out[f"flash_attention@{WHISPER}"] = _flash_row(
        torch, F, FA, *qkv, causal=False,
        shape=f"B=1 Hq=Hkv={WHQ} Sq=Sk={WENC} D={WD} bf16 non-causal")
    # K1, qwen2-vl: 256 vision + 512 text, causal, G = 7
    S = QVIS + M_CAP
    q = _rand(torch, gen, (1, QHQ, S, D), bf)
    k, v = (_rand(torch, gen, (1, QHKV, S, D), bf) for _ in range(2))
    out[f"flash_attention@{QWEN}"] = _flash_row(
        torch, F, FA, q, k, v, causal=True,
        shape=f"B=1 Hq={QHQ} Hkv={QHKV} Sq=Sk={S} D={D} bf16 causal")
    # K1, phi3.5-moe: a 512-token prompt, causal, no window
    q = _rand(torch, gen, (1, HQ, M_CAP, D), bf)
    k, v = (_rand(torch, gen, (1, HKV, M_CAP, D), bf) for _ in range(2))
    out[f"flash_attention@{PHI}"] = _flash_row(
        torch, F, FA, q, k, v, causal=True,
        shape=f"B=1 Hq={HQ} Hkv={HKV} Sq=Sk={M_CAP} D={D} bf16 causal")
    # K2: one lane 16 steps into decode
    n = QVIS + M_CAP + 16
    out[f"decode_attention@{QWEN}"] = _decode_row(
        torch, F, DA, gen, QHQ, QHKV, D, QWEN_MAX_LEN, n,
        f"B=1 Hq={QHQ} Hkv={QHKV} Smax={QWEN_MAX_LEN} kv_len={n} D={D} bf16")
    n = W_PROMPT + 16
    out[f"decode_attention@{WHISPER}"] = _decode_row(
        torch, F, DA, gen, WHQ, WHQ, WD, W_MAX_LEN, n,
        f"B=1 Hq=Hkv={WHQ} Smax={W_MAX_LEN} kv_len={n} D={WD} bf16")
    # K3: phi3.5-moe's paged batchers, 4 lanes of a 1024-block pool
    mb = -(-MAX_LEN // 16)
    qp, kp, vp, tables, kvlp = _paged_inputs(torch, gen, bf, 16, D,
                                             SERVE_KV_LEN, 1024, mb)
    n_kv = sum(SERVE_KV_LEN)
    b_ms, b_by = _bound(4 * HQ * D * n_kv,
                        (2 * 4 * HQ * D + 2 * HKV * n_kv * D) * 2 + 4 * 4
                        + sum(-(-n // 16) for n in SERVE_KV_LEN) * 4)
    out[f"paged_decode_attention@{PHI}"] = dict(
        ms=time_ms(torch, lambda: DA.paged_decode_attention(
            qp, kp, vp, tables, kvlp)),
        plain_ms=time_ms(torch, lambda: DA.paged_decode_attention_ref(
            qp, kp, vp, tables, kvlp)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        tiles=_split_tiles(torch, DA.paged_decode_attention, qp, kp, vp,
                           tables, kvlp, window=None),
        shape=f"B=4 Hq={HQ} Hkv={HKV} pool=1024x16 kv_len={SERVE_KV_LEN} "
              f"D={D} bf16")
    return out


def _ssd_passes(torch, SS, inp, N, L):
    """K5 one pass at a time on a workspace that a full call filled (the
    scan rewrites it in place, so later values are not the scan's; the
    times are)."""
    ws = SS.workspace(inp[0], N, L)
    SS.launch_passes(*inp, chunk=L, ws=ws)
    times = {name: time_ms(torch, lambda: SS.launch_passes(
        *inp, chunk=L, passes=bit, ws=ws)) for name, bit in SS.PASSES.items()}
    times["sum"] = sum(times.values())
    return times


def _flash_tiles(torch, FA, q, k, v, kw):
    """K1 bf16 at every (block_q, block_k) its kernel takes."""
    tq, tk = FA.TILES[torch.bfloat16]
    return {f"{bq}x{bk}": time_ms(torch, lambda: FA.flash_attention(
        q, k, v, block_q=bq, block_k=bk, **kw)) for bq in tq for bk in tk}


def _split_tiles(torch, fn, *args, window):
    """K2, K3 or K4 at each split size block_k."""
    return {f"block_k={bk}": time_ms(torch, lambda: fn(
        *args, window=window, block_k=bk)) for bk in (32, 64, 128)}


# K3 at the mistral7b cells' decode shape: 128 lane slots, 384-entry tables
# of 16-row blocks, 32 query heads on 8 KV heads of 128, bf16, window 4096;
# (live lanes, their least and most kv_len), the other slots dead at kv_len
# 1 and one at 0, the live ones scattered among them
K3_SERVING = {"chat": (21, 40, 300), "longprompt": (9, 1500, 4200)}


def serving_lanes(torch, name, seed=3):
    """kv_len of the 128 lane slots of ``K3_SERVING[name]``."""
    g = torch.Generator().manual_seed(seed)
    n, lo, hi = K3_SERVING[name]
    kv = [1] * 128
    kv[int(torch.randint(0, 128, (1,), generator=g))] = 0
    for slot in torch.randperm(128, generator=g)[:n].tolist():
        kv[slot] = int(torch.randint(lo, hi + 1, (1,), generator=g))
    return kv


def parent_library(tree):
    """The kernel library of another checkout ``tree`` (built there by a
    process of its own, into its own build/), loaded with this checkout's
    C signatures, which its entry points must have."""
    from repro_torch.kernels import _build
    path = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import _build; "
         "print(_build.library()._name)"],
        cwd=tree, check=True, capture_output=True, text=True).stdout.split()[-1]
    return _build.bind(path)


def _blocks_launched(torch, fn):
    """{kernel name: blocks} of one call of ``fn``, from the grid of each
    kernel in torch.profiler's trace; None if the trace has no grids."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=ROOT / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    blocks = {}
    for e in events:
        grid = e.get("args", {}).get("grid")
        if e.get("cat") == "kernel" and grid:
            name = e["name"].split("<")[0].split("::")[-1]
            blocks[name] = blocks.get(name, 0) + grid[0] * grid[1] * grid[2]
    return blocks or None


def _against_parent(torch, call, got, parent):
    """{ms} of ``call(lib)`` (``lib`` None: this checkout's kernels) by graph
    replay; with ``parent`` (another checkout's kernel library) also its ms
    on the same call, in turns (parent, this, this, parent), and the largest
    difference between the outputs."""
    if parent is None:
        return dict(ms=time_ms(torch, call))
    old = call(parent)
    turns = [time_ms(torch, lambda: call(parent)), time_ms(torch, call),
             time_ms(torch, call), time_ms(torch, lambda: call(parent))]
    return dict(ms=(turns[1] + turns[2]) / 2,
                parent_ms=(turns[0] + turns[3]) / 2, turns_ms=turns,
                max_abs_diff_to_parent=(got.float() - old.float()).abs()
                .max().item(), bit_identical=torch.equal(got, old))


def decode_table_rows(torch, gen, parent=None):
    """K2, K3 and K4 at the shapes of PERF.md's kernel table (K2: one lane
    528 keys into a 544-row cache, at mistral-7b's heads and at zamba2's
    shared block, and one lane 16 steps into decode at qwen2-vl-7b's G = 7
    and at whisper-base's G = 1, D 64; K3, K4: 4 lanes of a 1024-block pool,
    blocks of 16, with mistral-7b's window and without, as phi3.5-moe's
    paged batchers serve them), bf16, with the parent's ms on the same calls
    where ``parent`` is given."""
    from repro_torch.kernels import decode_attention as DA
    dt, n = torch.bfloat16, M_CAP + 16
    mb = -(-MAX_LEN // 16)
    k2 = _decode_inputs(torch, gen, dt, 1, MAX_LEN, D, [n])
    kz = _decode_inputs(torch, gen, dt, 1, MAX_LEN, ZD, [n], ZHQ, ZHQ)
    kq = _decode_inputs(torch, gen, dt, 1, QWEN_MAX_LEN, D,
                        [QVIS + M_CAP + 16], QHQ, QHKV)
    kw = _decode_inputs(torch, gen, dt, 1, W_MAX_LEN, WD, [W_PROMPT + 16],
                        WHQ, WHQ)
    k3 = _paged_inputs(torch, gen, dt, 16, D, SERVE_KV_LEN, 1024, mb)
    k4 = _int8_inputs(torch, gen, dt, 16, D, SERVE_KV_LEN, 1024, mb)
    calls = {
        "decode_attention": lambda lib=None: DA.decode_attention(
            *k2, window=4096, lib=lib),
        f"decode_attention@{ZAMBA}": lambda lib=None: DA.decode_attention(
            *kz, window=ZWINDOW, lib=lib),
        f"decode_attention@{QWEN}": lambda lib=None: DA.decode_attention(
            *kq, lib=lib),
        f"decode_attention@{WHISPER}": lambda lib=None: DA.decode_attention(
            *kw, lib=lib),
        "paged_decode_attention": lambda lib=None: DA.paged_decode_attention(
            *k3, window=4096, lib=lib),
        f"paged_decode_attention@{PHI}":
            lambda lib=None: DA.paged_decode_attention(*k3, lib=lib),
        "paged_decode_attention_int8":
            lambda lib=None: DA.paged_decode_attention_int8(
                *k4, window=4096, lib=lib)}
    rows = {}
    for name, call in calls.items():
        rows[name] = _against_parent(torch, call, call(), parent)
        say(f"  {name} at the kernel table's shape: {rows[name]}")
    return rows


def k3_serving(torch, gen, parent=None):
    """K3 at the mistral7b cells' two decode shapes (``K3_SERVING``): ms by
    graph replay, the bytes' bound, the blocks launched and, where
    ``parent`` (another checkout's kernel library) is given, its ms on the
    same call, in turns (parent, this, this, parent), its blocks, and the
    largest difference between the two outputs. One row a shape."""
    from repro_torch.kernels import decode_attention as DA
    rows = {}
    for name in K3_SERVING:
        kv_len = serving_lanes(torch, name)
        nb = 1 + sum(-(-n // CHUNK_BS) for n in kv_len)
        q, kp, vp, tables, kvl = _paged_inputs(torch, gen, torch.bfloat16,
                                               CHUNK_BS, D, kv_len, nb,
                                               CHUNK_BLOCKS)

        def call(lib=None):
            return DA.paged_decode_attention(q, kp, vp, tables, kvl,
                                             window=WINDOW, lib=lib)
        ks = [min(n, WINDOW) for n in kv_len]
        b_ms, b_by = _bound(4 * HQ * D * sum(ks),
                            (2 * len(ks) * HQ * D + 2 * HKV * D * sum(ks)) * 2
                            + 4 * len(ks)
                            + 4 * sum(-(-k // CHUNK_BS) for k in ks))
        got = call()
        want = DA.paged_decode_attention_ref(q, kp, vp, tables, kvl,
                                             window=WINDOW)
        err, ok = _err_on_valid(torch, got, want, (kvl > 0)[:, None, None]
                                .expand_as(got[..., 0]), TOL["bfloat16"])
        if not ok:
            fail(f"K3 at {name}'s serving shape disagrees with its plain "
                 f"version: {err:.3e}")
        by_kernel = r"(decode_split_kernel|decode_combine_kernel)"
        row = dict(parent_ms=None, bound_ms=b_ms, bound_by=b_by,
                   blocks=_blocks_launched(torch, call), parent_blocks=None,
                   kernel_ms=_kernel_split(torch, call, by_kernel),
                   parent_kernel_ms=None, max_abs_diff_to_parent=None,
                   err=err, live_lanes=sum(n > 1 for n in kv_len),
                   keys=sum(kv_len))
        row.update(_against_parent(torch, call, got, parent))
        if parent is not None:
            row["parent_blocks"] = _blocks_launched(
                torch, lambda: call(parent))
            row["parent_kernel_ms"] = _kernel_split(
                torch, lambda: call(parent), by_kernel)
        say(f"  K3 serve {name:10s} B=128 live={row['live_lanes']} "
            f"keys={row['keys']} table={CHUNK_BLOCKS}x{CHUNK_BS}: "
            f"ms={row['ms']:.4f} parent_ms={row['parent_ms']} "
            f"bound_ms={b_ms:.5f} ({b_by}) blocks={row['blocks']} "
            f"parent_blocks={row['parent_blocks']} "
            f"kernel_ms={row['kernel_ms']} "
            f"parent_kernel_ms={row['parent_kernel_ms']} "
            f"max_abs_diff_to_parent={row['max_abs_diff_to_parent']} "
            f"err={err:.3e}")
        rows[f"paged_decode_attention@{name}"] = row
        del q, kp, vp, tables, kvl, got, want
    torch.cuda.empty_cache()
    return rows


def phase_kernels(torch):
    say("== phase 3: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {**check_flash(torch, gen), **check_decode(torch, gen),
            **check_paged(torch, gen),
            "paged_decode_attention_int8": check_int8(torch, gen),
            **check_ssd(torch, gen),
            "paged_chunk_attention": check_chunk(torch, gen)}
    times = time_kernels(torch, gen)
    k3 = k3_serving(torch, gen)
    say(json.dumps({"k3_serving": k3}))
    times.update(k3)
    return errs, times


# --------------------------------------------------------------- phase 3c
def phase_autotune(torch, card):
    """The port's autotuner on the card over its default shapes (the
    reference's grid, at the timer's default 4/2 heads of 64) and the int8
    serving bucket at mistral-7b's heads (4 lanes x 34 blocks of 16 =
    b4c1024). Written under build/, not installed."""
    say("== phase 3c: autotune on the card (backend cuda)")
    import functools

    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import timing
    t0 = time.perf_counter()
    cache = AT.autotune(profile="h100", backend="cuda", seed=SEED)
    serving = AT.autotune(
        {"paged_decode_quant": [{"b": 4, "c": MAX_LEN}]}, profile="h100",
        backend="cuda", seed=SEED,
        timer=functools.partial(timing.time_kernel, heads=HQ, kv_heads=HKV,
                                head_dim=D))
    for e in serving.entries.values():
        cache.add(e)
    for key, e in sorted(cache.entries.items()):
        say(f"  tuned {key:36s} shape={e.shape} winner={e.params} "
            f"t_s={e.t_s:.3e} t_default_s={e.t_default_s:.3e} "
            f"speedup={e.speedup:.3f} noise_frac={e.noise_frac:.3f}")
    path = cache.dump(AT.cache_path("h100", "cuda"))
    say(f"  autotune cache: {path} ({len(cache.entries)} entries, not "
        f"installed) geomean_speedup={cache.geomean_speedup():.3f} "
        f"seconds={time.perf_counter() - t0:.2f} card={card}")
    if AT.installed() is not None:
        fail("phase 3c left an autotune cache installed")


def _fused_cache(buckets):
    """An autotune cache that routes the int8 paged read of each bucket to
    ``fused`` on both lookup keys: K4 on the kernel path, its plain version
    on the plain path."""
    from repro_torch.kernels import autotune as AT
    entries = [AT.TunedEntry(kernel="paged_decode_quant", backend=b,
                             bucket=bucket, params={"impl": "fused"},
                             t_s=1.0, t_default_s=1.0, noise_frac=0.0,
                             flops=0.0, bytes=0.0, ctx=0.0)
               for bucket in buckets for b in ("cuda", "ref")]
    return AT.AutotuneCache("chip-smoke", "cuda", entries=entries)


def _paged_bucket(lanes, max_len, block_size):
    """The int8 paged read's bucket for an engine's paged cache."""
    from repro_torch.core.scheduler import kv_blocks_needed
    from repro_torch.kernels import autotune as AT
    return AT.shape_bucket("paged_decode_quant", b=lanes,
                           c=kv_blocks_needed(max_len, block_size) * block_size)


# --------------------------------------------------------------- phases 4, 4b
def _parity_engines(torch, cfg, max_len, kv_quant=False):
    """Two engines on one set of seeded float32 weights: the kernel path
    ("auto") and the plain path ("ref")."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.float32, "cuda")
    return {b: InferenceEngine(cfg, params, max_len=max_len, backend=b,
                               device="cuda", kv_quant=kv_quant)
            for b in ("auto", "ref")}


def _compare(torch, what, a, b):
    """max |a - b| of the two paths' logits; fails past 1e-3 or when their
    greedy tokens differ. Returns (error, greedy tokens)."""
    err = (a.float() - b.float()).abs().max().item()
    ta, tb = a.argmax(-1), b.argmax(-1)
    say(f"  {what}: max_abs_logit_err={err:.3e} greedy "
        f"{'equal' if torch.equal(ta, tb) else 'DIFFER'}")
    if err > 1e-3 or not torch.equal(ta, tb):
        fail(f"model parity: {what}")
    return err, ta


def _engine_parity(torch, label, eng, prompts, extra=None):
    """Prefill plus 8 decode steps on both paths, the same tokens (and the
    ``extra`` batch inputs: vision or frames embeddings) fed to both.
    Returns the worst logit error, the caches and the kernel path's logits
    of every step."""
    toks = torch.from_numpy(prompts).cuda()
    caches, logits = {}, {}
    for b, e in eng.items():
        logits[b], caches[b] = e.prefill({"tokens": toks, **(extra or {})})
    worst, tok = _compare(torch, f"{label} prefill", logits["auto"],
                          logits["ref"])
    seen = [logits["auto"]]
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode(tok[:, None].to(torch.int32),
                                            caches[b])
        err, tok = _compare(torch, f"{label} decode {step}", logits["auto"],
                            logits["ref"])
        worst = max(worst, err)
        seen.append(logits["auto"])
    return worst, caches, seen


def _batcher_parity(label, eng, make_batcher, prompts):
    """A batcher end to end on both paths: the same tokens."""
    from repro_torch.serving.batching import Request
    outs = {}
    for b, e in eng.items():
        cb = make_batcher(e)
        reqs = [Request(i, p, max_new_tokens=8) for i, p in
                enumerate([prompts[0], prompts[1], prompts[0][:70]])]
        for r in reqs:
            cb.submit(r)
        cb.run()
        outs[b] = [r.out_tokens for r in reqs]
        stats = f" stats={cb.stats()}" if hasattr(cb, "stats") else ""
        say(f"  {label} backend={b}: tokens={outs[b]}{stats}")
    if outs["auto"] != outs["ref"]:
        fail(f"{label}: kernel path tokens differ from the plain path")
    return outs["auto"]


def _dense_and_paged_parity(torch, label, eng, prompts):
    """Kernel path vs plain path through the dense engine (prefill on K1,
    8 decode steps on K2), then a paged cache: chunked prefill (K6, or the
    plain gather path for an int8 cache) and 8 paged decode steps (K3, or
    the int8 read for an int8 cache) over two lanes of one pool, then the
    paged batcher. Returns the worst logit error, the kernel path's logits
    of every step and the batcher's tokens."""
    import numpy as np
    from repro_torch.serving.batching import PagedContinuousBatcher
    worst, caches, seen = _engine_parity(torch, f"{label}dense", eng, prompts)
    if "k_scale" in caches["auto"]:
        # int8 rows the two paths quantized differently (a rounding step at
        # a half-way point moved by float noise upstream)
        d = (caches["auto"]["k"].int() - caches["ref"]["k"].int()).abs()
        say(f"  {label}dense int8 K cache: {int((d > 0).sum())} of "
            f"{d.numel()} entries differ between the paths, by at most "
            f"{int(d.max())}")

    bs, chunk = 16, 32
    for b in eng:
        caches[b] = eng[b].new_paged_cache(2, 32, bs)
        for lane in range(2):
            blocks = torch.arange(1 + lane * 10, 1 + (lane + 1) * 10,
                                  dtype=torch.int32, device="cuda")
            caches[b]["block_tables"][lane, :10] = blocks
    last = {b: [None, None] for b in eng}
    for lane in range(2):
        for s in range(0, prompts.shape[1], chunk):
            c = min(chunk, prompts.shape[1] - s)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :c] = prompts[lane, s:s + c]
            for b, e in eng.items():
                lg, caches[b] = e.prefill_chunk(torch.from_numpy(buf).cuda(),
                                                caches[b], lane, c)
                last[b][lane] = lg
    err, tok = _compare(torch, f"{label}paged prefill",
                        torch.cat(last["auto"]), torch.cat(last["ref"]))
    worst = max(worst, err)
    seen.append(torch.cat(last["auto"]))
    lanes = torch.arange(2, device="cuda")
    logits = {}
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode_paged(
                tok[:, None].to(torch.int32), caches[b], lanes)
        err, tok = _compare(torch, f"{label}paged decode {step}",
                            logits["auto"], logits["ref"])
        worst = max(worst, err)
        seen.append(logits["auto"])
    if "kp_scale" in caches["auto"]:
        # the live rows only (positions below each lane's pos): rows past
        # it, such as a padded chunk's, are never read
        c = caches["auto"]
        blk, off = [], []
        for lane, n in enumerate(c["pos"].tolist()):
            p = torch.arange(n, device="cuda")
            blk.append(c["block_tables"][lane, p // bs].long())
            off.append(p % bs)
        blk, off = torch.cat(blk), torch.cat(off)
        d = torch.cat([(caches["auto"][n][:, blk, :, off].int()
                        - caches["ref"][n][:, blk, :, off].int())
                       .abs().flatten() for n in ("kp", "vp")])
        say(f"  {label}paged int8 K/V pools, live rows: "
            f"{int((d > 0).sum())} of {d.numel()} entries differ between "
            f"the paths, by at most {int(d.max())}")

    tokens = _batcher_parity(f"{label}paged batcher", eng,
                             lambda e: PagedContinuousBatcher(
                                 e, slots=2, num_blocks=48, block_size=bs),
                             prompts)
    return worst, seen, tokens


PARITY_MAX_LEN = 160


def _parity_setup(torch, kv_quant):
    import numpy as np
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=2)
    eng = _parity_engines(torch, cfg, PARITY_MAX_LEN, kv_quant)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 100)).astype(np.int32)
    return eng, prompts


def phase_parity(torch):
    """Kernel path vs plain path on one model and one set of weights."""
    say("== phase 4: model parity, mistral-7b full width, 2 layers, float32")
    eng, prompts = _parity_setup(torch, False)
    worst, _, _ = _dense_and_paged_parity(torch, "", eng, prompts)
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    del eng
    torch.cuda.empty_cache()
    return worst


def phase_parity_int8(torch):
    """Phase 4 with an int8 KV cache: once with no autotune cache (the int8
    paged read gathers, dequantizes and runs K2) and once with a cache that
    routes it to "fused" (K4 on the kernel path, its plain version on the
    plain path); the fused run's kernel-path logits within 1e-3 of the
    gather run's, step by step."""
    say("== phase 4c: int8 KV parity, mistral-7b full width, 2 layers, "
        "float32")
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import decode_attention as DA
    eng, prompts = _parity_setup(torch, True)
    if eng["auto"].new_cache(1)["k"].dtype != torch.int8:
        fail("phase 4c: the kv_quant engine's cache is not int8")
    runs, worst = {}, 0.0
    for impl in ("gather", "fused"):
        AT.install(None if impl == "gather" else _fused_cache(
            {_paged_bucket(2, PARITY_MAX_LEN, 16)}))
        k4 = DA.paged_decode_attention_int8.launches
        try:
            err, seen, tokens = _dense_and_paged_parity(
                torch, f"int8 {impl} ", eng, prompts)
        finally:
            AT.install(None)
        launched = DA.paged_decode_attention_int8.launches - k4
        say(f"  int8 {impl}: K4 launches {launched}")
        if (launched > 0) != (impl == "fused"):
            fail(f"phase 4c: K4 launched {launched} times under {impl}")
        runs[impl] = (seen, tokens)
        worst = max(worst, err)
    cross = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(runs["fused"][0], runs["gather"][0]))
    say(f"  int8 fused vs gather (kernel path): max_abs_logit_err="
        f"{cross:.3e} batcher tokens "
        f"{'equal' if runs['fused'][1] == runs['gather'][1] else 'differ'}")
    if cross > 1e-3:
        fail("phase 4c: the fused int8 read's logits differ from the gather "
             "read's past 1e-3")
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    del eng
    torch.cuda.empty_cache()
    return worst


def phase_parity_ssm(torch):
    """Kernel path vs plain path for the SSM and hybrid families, through
    the engine and the dense batcher."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.batching import ContinuousBatcher

    worst = 0.0
    for arch, layers in (("mamba2-130m", None), ("zamba2-1.2b", 7)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        say(f"== phase 4b: model parity, {arch} full width, "
            f"{cfg.num_layers} layers, float32")
        eng = _parity_engines(torch, cfg, 224)
        rng = np.random.default_rng(SEED)
        # 200 tokens: one full chunk of 128 and a ragged one
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(2, 200)).astype(np.int32)
        err, _, _ = _engine_parity(torch, arch, eng, prompts)
        worst = max(worst, err)
        _batcher_parity(f"{arch} dense batcher", eng,
                        lambda e: ContinuousBatcher(e, slots=2), prompts)
        del eng
        torch.cuda.empty_cache()
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    return worst


# --------------------------------------------------------------- phases 5, 6
def _mix(cfg):
    """The fixed serve mix: 8 (m, n) from sample_workload(8, seed), m and n
    capped, with seeded random prompts of m tokens."""
    import numpy as np
    from repro_torch.core.workload import sample_workload
    rng = np.random.default_rng(SEED)
    work = [(min(q.m, M_CAP), min(q.n, N_CAP))
            for q in sample_workload(8, seed=SEED)]
    return work, [rng.integers(0, cfg.vocab_size, size=m) for m, _ in work]


def _count_ticks(router, ticks):
    """Counts every batcher tick of ``router`` in ``ticks[0]``."""
    for cb in router.batchers.values():
        def step(inner=cb.step):
            ticks[0] += 1
            inner()
        cb.step = step


def _serve_mix(torch, cfg, engine, kernels, *, paged, verbose=True):
    """The fixed mix: 8 requests from sample_workload(8, seed) (m and n
    capped) behind FleetRouter(capacity_aware) over paper_fleet() with
    batchers (paged or dense, 4 slots), then the first 2 again through the
    engine-only path. Checks every output; returns each kernel's launches in
    the mix, counted from 0, the wall seconds, the served tokens and
    {"reports": both routers' fleet_report(), "ticks": batcher ticks}.
    ``verbose=False`` prints no line per request and pool."""
    from repro_torch.core.systems import paper_fleet
    from repro_torch.serving.router import FleetRouter

    eff, perf = paper_fleet()
    pools = {eff.name: eff, perf.name: perf}
    engines = {eff.name: engine, perf.name: engine}
    counts = {eff.name: 4, perf.name: 1}
    work, prompts = _mix(cfg)
    work += work[:2]
    prompts += prompts[:2]

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batched = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                          counts=counts)
    if paged:
        batched.attach_batchers(slots=4, paged=True, num_blocks=1024,
                                block_size=16)
    else:
        batched.attach_batchers(slots=4, paged=False)
    ticks = [0]
    _count_ticks(batched, ticks)
    routed = [batched.submit(p, n) for p, (_, n) in zip(prompts[:8], work[:8])]
    batched.drain()
    direct = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                         counts=counts)
    routed += [direct.submit(p, n) for p, (_, n) in zip(prompts[8:], work[8:])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in kernels}

    kind = "paged" if paged else "dense"
    for rr, (m, n) in zip(routed, work):
        toks = rr.request.out_tokens if rr.request is not None \
            else list(rr.output)
        path = kind if rr.request is not None else "engine"
        if verbose:
            say(f"  req{rr.rid:3d} [{path:6s}] m={m:4d} n={n:3d} -> "
                f"{rr.pool:10s} E={rr.energy_j:9.3f}J R={rr.runtime_s:7.4f}s"
                f" tokens[:8]={[int(t) for t in toks[:8]]}")
        if len(toks) != n or not all(0 <= int(t) < cfg.vocab_size
                                     for t in toks):
            fail(f"{cfg.name} request {rr.rid}: {len(toks)} tokens for a "
                 f"budget of {n}, or a token outside the vocabulary")
        if rr.request is not None and not rr.request.done:
            fail(f"{cfg.name} request {rr.rid} not done after drain()")
    reports = {name: router.fleet_report()
               for name, router in ((kind, batched), ("engine", direct))}
    for name, rep in reports.items():
        for pool, st in rep.items():
            if verbose:
                say(f"  fleet_report[{name}] {pool:10s} queries="
                    f"{st['queries']} tokens={st['tokens']} energy_j="
                    f"{st['energy_j']:.3f} runtime_s={st['runtime_s']:.4f}")
    if paged and verbose:
        for pool, cb in batched.batchers.items():
            say(f"  batcher {pool}: {cb.stats()}")
    served = sum(st["queries"] for r in (batched, direct)
                 for st in r.fleet_report().values())
    if served != 10:
        fail(f"{cfg.name}: fleet reports count {served} queries, expected 10")
    if verbose:
        say(f"  launches in this run: {launches}")
    tokens = [list(map(int, rr.request.out_tokens if rr.request is not None
                       else rr.output)) for rr in routed]
    return launches, wall, tokens, {"reports": reports, "ticks": ticks[0]}


def _fresh_peak(torch):
    """Frees what earlier phases left (objects in reference cycles wait for
    the collector) and restarts the peak count. Returns the bytes still
    allocated, the base of the next peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    say(f"  allocated before this phase: {base / 1e9:.3f} GB")
    return base


def _serve(torch, card, arch, kernels, needed, *, paged, kv_quant=False,
           layers=None):
    """Full-size ``arch`` (bf16 random weights from the seed; ``layers``
    cuts the depth) through the fixed mix; fails if a kernel in ``needed``
    never launched. Returns the launches and the served tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    _fresh_peak(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    say(f"  weights: {M.param_count(params) / 1e9:.3f}B params bf16, "
        f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda",
                             kv_quant=kv_quant)
    launches, wall, tokens, _ = _serve_mix(torch, cfg, engine, kernels,
                                           paged=paged)
    if not all(launches[k] > 0 for k in needed):
        fail(f"{arch}: a kernel of the serving path never launched "
             f"(needs {needed}): {launches}")
    say(f"  {arch} serve wall_s={wall:.3f} max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} card={card}")
    del params, engine
    torch.cuda.empty_cache()
    return launches, tokens


def phase_serve(torch, card):
    say("== phase 5: serve mistral-7b (32 layers, bf16) through FleetRouter")
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, CA.paged_chunk_attention)
    return _serve(torch, card, "mistral-7b", kernels,
                  [fn.__name__ for fn in kernels], paged=True)


def phase_serve_int8(torch, card, bf16_tokens):
    """Phase 5 with an int8 KV cache, with an autotune cache installed that
    routes the paged batchers' int8 read (4 lanes, bucket b4c1024) to K4.
    K4 must launch (paged decode), K1 (prefill) and K2 (the engine-only
    path's int8 decode) too. Returns the launches."""
    say("== phase 7: serve mistral-7b (32 layers, bf16) with an int8 KV "
        "cache through FleetRouter, int8 paged read routed to K4")
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, DA.paged_decode_attention_int8)
    bucket = _paged_bucket(4, MAX_LEN, 16)
    say(f"  installed: paged_decode_quant/cuda/{bucket} -> fused")
    AT.install(_fused_cache({bucket}))
    try:
        launches, tokens = _serve(
            torch, card, "mistral-7b", kernels,
            ["paged_decode_attention_int8", "flash_attention",
             "decode_attention"], paged=True, kv_quant=True)
    finally:
        AT.install(None)
    same = sum(a == b for ta, tb in zip(tokens, bf16_tokens)
               for a, b in zip(ta, tb))
    total = sum(len(t) for t in bf16_tokens)
    say(f"  int8 vs bf16 KV (phase 5) served tokens equal: {same}/{total} "
        f"(information only: random weights give near-flat logits)")
    return launches


def phase_serve_ssm(torch, card):
    """Full mamba2-130m and zamba2-1.2b through dense batchers (their lanes
    are not pageable), each from counts set to 0. Returns the launches of
    each model's kernels under their kernels-line names."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, SS.ssd_scan)
    out = {}
    for arch, needed, key in (
            ("mamba2-130m", ("ssd_scan",), "{}"),
            (ZAMBA, ("ssd_scan", "flash_attention", "decode_attention"),
             "{}@" + ZAMBA)):
        say(f"== phase 6: serve {arch} (full, bf16) through FleetRouter")
        launches, _ = _serve(torch, card, arch, kernels, needed, paged=False)
        out.update({key.format(k): launches[k] for k in needed})
    return out


# --------------------------------------------------------------- phase 4d
def _seeded_embeddings(torch, gen, shape):
    """Stub frontend output (vision patches or audio frames), scaled as the
    token embeddings are."""
    return torch.randn(shape, generator=gen, device="cuda") * 0.02


def _launch_counts():
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    return {fn.__name__: fn.launches for fn in (
        FA.flash_attention, DA.decode_attention, DA.paged_decode_attention)}


def _parity_launched(label, before, needed):
    """Fails unless each kernel in ``needed`` launched since ``before``."""
    now = _launch_counts()
    moved = {k: now[k] - before[k] for k in now}
    say(f"  {label} kernel-path launches: {moved}")
    if not all(moved[k] > 0 for k in needed):
        fail(f"phase 4d: {label} did not launch each of {needed}")


def phase_parity_families(torch):
    """Kernel path vs plain path for the MoE, VLM and audio families:
    phi3.5-moe (2 layers) through the engine, the paged cache and both
    batchers; qwen2-vl-7b (2 layers) and whisper-base (6 + 6 layers, in
    full) through the engine with seeded vision or frame embeddings."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.batching import ContinuousBatcher
    worst = 0.0

    say(f"== phase 4d: model parity, {PHI} full width, 2 layers, float32")
    cfg = dataclasses.replace(get_config(PHI), num_layers=2)
    eng = _parity_engines(torch, cfg, PARITY_MAX_LEN)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(2, 100)).astype(np.int32)
    before = _launch_counts()
    err, _, _ = _dense_and_paged_parity(torch, f"{PHI} ", eng, prompts)
    _batcher_parity(f"{PHI} dense batcher", eng,
                    lambda e: ContinuousBatcher(e, slots=2), prompts)
    _parity_launched(PHI, before, ("flash_attention", "decode_attention",
                                   "paged_decode_attention"))
    worst = max(worst, err)
    del eng
    torch.cuda.empty_cache()

    for arch, layers, max_len, key, n_in, S in (
            (QWEN, 2, 400, "vision", QVIS, 100),
            (WHISPER, None, W_MAX_LEN, "frames", WENC, 40)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        say(f"== phase 4d: model parity, {arch} full width, "
            f"{cfg.num_layers} layers, float32, {n_in} seeded {key} "
            f"embeddings")
        eng = _parity_engines(torch, cfg, max_len)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        extra = {key: _seeded_embeddings(torch, gen, (2, n_in, cfg.d_model))}
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, size=(2, S)).astype(np.int32)
        before = _launch_counts()
        err, _, _ = _engine_parity(torch, arch, eng, prompts, extra)
        _parity_launched(arch, before, ("flash_attention",
                                        "decode_attention"))
        worst = max(worst, err)
        del eng
        torch.cuda.empty_cache()
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    return worst


# --------------------------------------------------------------- phase 9
def _serve_generate(torch, card, cfg, requests, max_len, kernels, needed):
    """``cfg`` (bf16 random weights built on the card from the seed) through
    ``InferenceEngine.generate``, one request (a batch of 1) at a time:
    ``requests`` is [(batch, n)]. Checks each output; fails if a kernel in
    ``needed`` never launched. Returns the launches, counted from 0."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    _fresh_peak(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    say(f"  weights: {M.param_count(params) / 1e9:.3f}B params bf16, "
        f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_len=max_len,
                             dtype=torch.bfloat16, device="cuda")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i, (batch, n) in enumerate(requests):
        res = engine.generate(batch, n)
        toks = res.tokens[0]
        extra = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
        say(f"  req{i:3d} m={batch['tokens'].shape[1]:4d} n={n:3d} {extra} "
            f"tokens[:8]={[int(t) for t in toks[:8]]}")
        if len(toks) != n or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
            fail(f"{cfg.name} request {i}: {len(toks)} tokens for a budget of "
                 f"{n}, or a token outside the vocabulary")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in kernels}
    say(f"  launches in this run: {launches}")
    if not all(launches[k] > 0 for k in needed):
        fail(f"{cfg.name}: a kernel of the serving path never launched "
             f"(needs {needed}): {launches}")
    say(f"  {cfg.name} serve wall_s={wall:.3f} max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} card={card}")
    del params, engine
    torch.cuda.empty_cache()
    return launches


def phase_serve_families(torch, card):
    """phi3.5-moe (16 of 32 layers) behind FleetRouter as phase 5;
    qwen2-vl-7b and whisper-base in full through InferenceEngine.generate.
    Returns each kernels-line row's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, CA.paged_chunk_attention)
    names = [fn.__name__ for fn in kernels]
    out = {}
    say(f"== phase 9: serve {PHI} ({PHI_LAYERS} of 32 layers, bf16) through "
        f"FleetRouter")
    launches, _ = _serve(torch, card, PHI, kernels, names, paged=True,
                         layers=PHI_LAYERS)
    out[f"flash_attention@{PHI}"] = launches["flash_attention"]
    out[f"paged_decode_attention@{PHI}"] = launches["paged_decode_attention"]

    say(f"== phase 9: serve {QWEN} (full, bf16) through "
        f"InferenceEngine.generate")
    cfg = get_config(QWEN)
    work, prompts = _mix(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    reqs = [({"tokens": torch.from_numpy(p.astype("int32"))[None].cuda(),
              "vision": _seeded_embeddings(torch, gen, (1, QVIS, cfg.d_model))},
             n) for p, (_, n) in zip(prompts[:4], work[:4])]
    launches = _serve_generate(torch, card, cfg, reqs, QWEN_MAX_LEN, kernels,
                               ("flash_attention", "decode_attention"))
    out[f"flash_attention@{QWEN}"] = launches["flash_attention"]
    out[f"decode_attention@{QWEN}"] = launches["decode_attention"]

    say(f"== phase 9: serve {WHISPER} (full, bf16) through "
        f"InferenceEngine.generate")
    cfg = get_config(WHISPER)
    work, prompts = _mix(cfg)
    reqs = [({"tokens": torch.from_numpy(p[:W_PROMPT].astype("int32"))[None]
              .cuda(),
              "frames": _seeded_embeddings(torch, gen, (1, WENC, cfg.d_model))},
             n) for p, (_, n) in zip(prompts[:4], work[:4])]
    launches = _serve_generate(torch, card, cfg, reqs, W_MAX_LEN, kernels,
                               ("flash_attention", "decode_attention"))
    # per request: the encoder's layers and the cross prefills (a prompt
    # of one token takes the plain cross row) are the non-causal K1
    # launches, the decoder's self-attention prefills the causal ones
    non_causal = sum(cfg.encoder_layers + cfg.num_layers * (
        b["tokens"].shape[1] > 1) for b, _ in reqs)
    causal = len(reqs) * cfg.num_layers
    want = non_causal + causal
    say(f"  K1 launches {launches['flash_attention']}: {non_causal} "
        f"non-causal + {causal} causal = {want}")
    if launches["flash_attention"] != want:
        fail(f"{WHISPER}: K1 launched {launches['flash_attention']} times, "
             f"not {want}")
    out[f"flash_attention@{WHISPER}"] = launches["flash_attention"]
    out[f"decode_attention@{WHISPER}"] = launches["decode_attention"]
    return out


# --------------------------------------------------------------- phase 8
def _probe_pair():
    """The disaggregation probe pair of tests/test_disagg.py: a slow,
    near-dark eff pool and a fast, high-idle perf pool joined by a 400 Gb/s
    link. Priced with mistral-7b's config, the serve mix's requests split:
    prefill on one pool, decode on the other."""
    from repro_torch.core.systems import SystemProfile
    eff = SystemProfile(name="eff", kind="eff", chips=1, peak_flops=5e12,
                        hbm_bw=0.8e12, ici_bw=50e9, power_peak_w=120.0,
                        power_idle_w=8.0, overhead_s=0.02, sat_ctx=2048.0,
                        link_bw_gbps=400.0)
    perf = SystemProfile(name="perf", kind="perf", chips=4,
                         peak_flops=400e12, hbm_bw=1.25e12, ici_bw=100e9,
                         power_peak_w=350.0, power_idle_w=100.0,
                         overhead_s=0.0005, link_bw_gbps=400.0)
    return eff, perf


def _kv_pools(torch, gen, kind, shape):
    """A paged cache's pools of ``shape`` (layers, blocks, Hkv, bs, D) on the
    card with random contents: bf16 or float32, or int8 with float32 scale
    pools in [0.005, 0.02). The script imports no test, so this and
    ``_probe_pair`` are its own copies of tests/_torch_handoff.py's."""
    if kind != "int8":
        dt = getattr(torch, kind)
        return {k: torch.randn(shape, generator=gen, device="cuda").to(dt)
                for k in ("kp", "vp")}
    out = {k: torch.randint(-127, 128, shape, generator=gen,
                            device="cuda").to(torch.int8)
           for k in ("kp", "vp")}
    for k in ("kp_scale", "vp_scale"):
        out[k] = torch.rand(shape[:-1] + (1,), generator=gen,
                            device="cuda") * 0.015 + 0.005
    return out


def _eager_ms(torch, fn, reps=20):
    """Mean time of ``reps`` eager calls between CUDA events, host launch
    included (for work that copies host indices and cannot be captured)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_migration(torch, gen, kind):
    """Phase 8a for one pool type, on 2 layers of mistral-7b's pool geometry:
    migrate the blocks of SERVE_KV_LEN's lanes (a ragged set, in random
    order on both ends) between two pools, check the copy bit for bit and
    the payload bytes, time it, then hold K3 (K4 for int8) over the
    destination against K3 (K4) over the source, bit for bit, and against
    the plain version. Returns the worst error against the plain version."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.serving.batching import migrate_kv_blocks
    layers, bs, kv_len = 2, 16, SERVE_KV_LEN
    nblk = [-(-n // bs) for n in kv_len]
    total = sum(nblk)
    num_blocks = total + 1 + total // 2        # room for untouched blocks
    shape = (layers, num_blocks, HKV, bs, D)
    src = _kv_pools(torch, gen, kind, shape)
    dst = _kv_pools(torch, gen, kind, shape)
    src_ids = (torch.randperm(num_blocks - 1, generator=gen, device="cuda")
               + 1)[:total].tolist()
    dst_ids = (torch.randperm(num_blocks - 1, generator=gen, device="cuda")
               + 1)[:total].tolist()
    mb = max(nblk) + 1
    tables = {}
    for name, ids in (("src", src_ids), ("dst", dst_ids)):
        t = torch.zeros((len(kv_len), mb), dtype=torch.int32, device="cuda")
        used = 0
        for b, n in enumerate(nblk):
            t[b, :n] = torch.tensor(ids[used:used + n], dtype=torch.int32)
            used += n
        tables[name] = t
    src_before = {k: v.clone() for k, v in src.items()}
    dst_before = {k: v.clone() for k, v in dst.items()}
    out, moved = migrate_kv_blocks(src, src_ids, dst, dst_ids)
    torch.cuda.synchronize()
    others = torch.ones(num_blocks, dtype=torch.bool, device="cuda")
    others[dst_ids] = False
    copied = all(torch.equal(dst[k][:, dst_ids], src[k][:, src_ids])
                 for k in src)
    kept = all(torch.equal(src[k], src_before[k]) for k in src)
    untouched = all(torch.equal(dst[k][:, others], dst_before[k][:, others])
                    for k in src)
    itemsize = src["kp"].element_size()
    want = total * layers * HKV * bs * (2 * D * itemsize
                                        + (2 * 4 if kind == "int8" else 0))
    say(f"  8a {kind:8s} pools {tuple(shape)}: {total} blocks "
        f"(lanes {nblk}) copied bit for bit {copied}, source unchanged "
        f"{kept}, other blocks untouched {untouched}, payload {moved} B "
        f"(expected {want})")
    if not (out is dst and copied and kept and untouched and moved == want):
        fail(f"phase 8a: migrate_kv_blocks on {kind} pools")
    ms = _eager_ms(torch, lambda: migrate_kv_blocks(src, src_ids, dst,
                                                    dst_ids))
    say(f"  8a {kind:8s} migration: {ms:.4f} ms per call (eager, host "
        f"launch included), {moved / ms / 1e6:.1f} GB/s of payload")
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    q_types = (("float32", "bfloat16") if kind == "int8" else (kind,))
    worst = 0.0
    for layer in range(layers):
        for qt in q_types:
            q = torch.randn((len(kv_len), HQ, 1, D), generator=gen,
                            device="cuda").to(getattr(torch, qt))
            if kind == "int8":
                args = {n: (c["kp"][layer], c["vp"][layer],
                            c["kp_scale"][layer], c["vp_scale"][layer],
                            tables[n]) for n, c in (("src", src),
                                                    ("dst", dst))}
                fn, ref, label = (DA.paged_decode_attention_int8,
                                  DA.paged_decode_attention_int8_ref, "K4")
            else:
                args = {n: (c["kp"][layer], c["vp"][layer], tables[n])
                        for n, c in (("src", src), ("dst", dst))}
                fn, ref, label = (DA.paged_decode_attention,
                                  DA.paged_decode_attention_ref, "K3")
            a = fn(q, *args["dst"], kvl)
            b = fn(q, *args["src"], kvl)
            want_out = ref(q, *args["src"], kvl)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            rows = (kvl > 0)[:, None, None].expand(len(kv_len), HQ, 1)
            err, ok = _err_on_valid(torch, a, want_out, rows, TOL[qt])
            say(f"  8a {label} over migrated {kind} pool, layer {layer}, "
                f"q {qt}: equal to {label} over the source {same}, "
                f"max_abs_err vs plain {err:.3e} "
                f"{'ok' if same and ok else 'MISMATCH'}")
            if not (same and ok):
                fail(f"phase 8a: {label} over the migrated {kind} pool")
            worst = max(worst, err)
    return worst


def _disagg_run(torch, cfg, engine, work, prompts, num_blocks, label):
    """``prompts`` (budgets from ``work``) through
    FleetRouter(policy="disaggregated") over the probe pair, priced with
    mistral-7b's config, paged batchers of 4 slots and blocks of 16 on both
    pools. Fails unless every request is held after submit, handed off,
    done with its budget of tokens in the vocabulary, booked at its prefill
    pool (the query and its prompt tokens) and at its decode pool (the
    emitted tokens), and every block comes back. Each ``adopt_lane`` call
    is timed on the host clock and between CUDA events on the device (the
    span from the device reaching the call's first launch to its last).
    Returns the routed requests, the payload bytes of each handoff, the
    router, and the handoff calls' summed host and device milliseconds."""
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.core.pricing import CostModel, CostParams
    from repro_torch.serving.router import FleetRouter
    eff, perf = _probe_pair()
    router = FleetRouter(cfg, {"eff": eff, "perf": perf},
                         {"eff": engine, "perf": engine},
                         policy="disaggregated",
                         model=CostModel(get_config("mistral-7b"), None,
                                         CostParams(lam=1.0)))
    router.attach_batchers(slots=4, paged=True, num_blocks=num_blocks,
                           block_size=16)
    moved, host_s, spans = [], [], []
    for cb in router.batchers.values():
        def adopt(req, src, src_i, _adopt=cb.adopt_lane):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = _adopt(req, src, src_i)
            end.record()
            host_s.append(time.perf_counter() - t)
            spans.append((start, end))
            if out is not None:
                moved.append(out)
            return out
        cb.adopt_lane = adopt
    routed = [router.submit(p, n) for p, (_, n) in zip(prompts, work)]
    held = sum(bool(rr.request.hold) for rr in routed)
    router.drain()
    torch.cuda.synchronize()
    host_ms = 1e3 * sum(host_s)
    device_ms = sum(a.elapsed_time(b) for a, b in spans)
    handed = sum(rr.request.done and not rr.request.hold for rr in routed)
    say(f"  {label} held after submit {held}/{len(routed)}, handed off "
        f"{len(moved)} in {len(spans)} adopt_lane calls (host "
        f"{host_ms:.3f} ms, device span {device_ms:.3f} ms in all), "
        f"pending handoffs after drain {len(router._handoffs)}")
    if held != len(routed) or len(moved) != len(routed) or \
            handed != len(routed) or router._handoffs:
        fail(f"phase {label}: a request was not held and handed off")
    for rr, (m, n) in zip(routed, work):
        toks = rr.request.out_tokens
        if len(toks) != n or not all(0 <= int(t) < cfg.vocab_size
                                     for t in toks):
            fail(f"phase {label} request {rr.rid}: {len(toks)} tokens for "
                 f"a budget of {n}, or a token outside the vocabulary")
    rep = router.fleet_report()
    other = {"eff": "perf", "perf": "eff"}
    queries = Counter(rr.pool for rr in routed)
    tokens = Counter()                  # prompt tokens at the prefill pool,
    for rr, (m, _) in zip(routed, work):    # emitted ones at the decode pool
        tokens[rr.pool] += m
        tokens[other[rr.pool]] += len(rr.request.out_tokens)
    for pool, st in rep.items():
        say(f"  {label} fleet_report {pool:5s} queries={st['queries']} "
            f"tokens={st['tokens']} energy_j={st['energy_j']:.3f} "
            f"runtime_s={st['runtime_s']:.4f}")
        if st["queries"] != queries[pool] or st["tokens"] != tokens[pool]:
            fail(f"phase {label}: fleet_report does not book queries at "
                 f"their prefill pool and tokens at their decode pool")
    for pool, cb in router.batchers.items():
        back = cb.free_blocks == cb.total_blocks and not cb.queue and \
            all(r is None for r in cb.active)
        say(f"  {label} batcher {pool}: {cb.stats()} free+evictable="
            f"{cb.free_blocks} of {cb.total_blocks}")
        if not back:
            fail(f"phase {label}: blocks or lanes not returned on {pool}")
    return routed, moved, router, (host_ms, device_ms)


def _block_bytes(cfg, kv_dtype_bytes, bs=16, scales=False):
    return cfg.num_layers * cfg.num_kv_heads * bs * (
        2 * cfg.resolved_head_dim * kv_dtype_bytes + (8 if scales else 0))


def phase_disagg_migration(torch):
    say("== phase 8a: KV block migration on the card, mistral-7b pool "
        "geometry, 2 layers")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = max(_check_migration(torch, gen, kind)
                for kind in ("bfloat16", "float32", "int8"))
    say(f"  migration ok: worst K3/K4 err vs plain {worst:.3e}")


def phase_disagg_parity(torch):
    """Phase 8b: the disaggregated router against solo generation and one
    paged batcher, on the kernel and the plain path."""
    say("== phase 8b: disaggregated parity, mistral-7b full width, 2 layers, "
        "float32")
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.batching import PagedContinuousBatcher, Request
    from repro_torch.serving.engine import InferenceEngine
    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=2)
    # phase 4's weights (the same seed), with the serving context
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.float32, "cuda")
    work, prompts = _mix(cfg)
    work, prompts = work[:4], prompts[:4]
    tokens = {}
    for b in ("auto", "ref"):
        eng = InferenceEngine(cfg, params, max_len=MAX_LEN, backend=b,
                              device="cuda")
        routed, moved, _, _ = _disagg_run(torch, cfg, eng, work, prompts,
                                          256, label=f"8b {b}")
        got = [list(map(int, rr.request.out_tokens)) for rr in routed]
        solo = [list(map(int, eng.generate(
            {"tokens": torch.from_numpy(p.astype("int32"))[None].cuda()},
            n).tokens[0])) for p, (_, n) in zip(prompts, work)]
        cb = PagedContinuousBatcher(eng, slots=4, num_blocks=256,
                                    block_size=16)
        reqs = [Request(i, p, n) for i, (p, (_, n)) in
                enumerate(zip(prompts, work))]
        for r in reqs:
            cb.submit(r)
        cb.run()
        one = [list(map(int, r.out_tokens)) for r in reqs]
        want = [-(-len(p) // 16) * _block_bytes(cfg, 4) for p in prompts]
        say(f"  8b {b}: tokens {got}; equal to solo generation "
            f"{got == solo}, to one paged batcher {got == one}; payload "
            f"{sum(moved)} B (expected {sum(want)})")
        if got != solo or got != one or sorted(moved) != sorted(want):
            fail(f"phase 8b: disaggregated tokens or payload differ ({b})")
        tokens[b] = got
    if tokens["auto"] != tokens["ref"]:
        fail("phase 8b: kernel path tokens differ from the plain path")
    del params
    torch.cuda.empty_cache()


def phase_disagg_serve(torch, card):
    """Phase 8c: full mistral-7b, phase 5's 8 requests through the
    disaggregated router. Returns K3's launches in the run."""
    say("== phase 8c: serve mistral-7b (32 layers, bf16) disaggregated "
        "through FleetRouter")
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("mistral-7b")
    _fresh_peak(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    say(f"  weights: {M.param_count(params) / 1e9:.3f}B params bf16, "
        f"{cfg.num_layers} layers, built anew from the seed in "
        f"{time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda")
    work, prompts = _mix(cfg)
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, DA.paged_decode_attention_int8)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    routed, moved, router, (host_ms, device_ms) = _disagg_run(
        torch, cfg, engine, work, prompts, 1024, label="8c")
    wall = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in kernels}
    for rr, (m, n) in zip(routed, work):
        say(f"  req{rr.rid:3d} m={m:4d} n={n:3d} prefill {rr.pool} -> "
            f"decode {'eff' if rr.pool == 'perf' else 'perf'} "
            f"tokens[:8]={[int(t) for t in rr.request.out_tokens[:8]]}")
    booked = sum(router.model.migration_bytes(m, block_size=16)
                 for m, _ in work)
    want = sum(-(-m // 16) for m, _ in work) * _block_bytes(cfg, 2)
    say(f"  8c handoffs={len(moved)} migrated_bytes={sum(moved)} (counted "
        f"{want}) booked_bytes={booked:.0f} (CostModel.migration_bytes, "
        f"4 bytes per value: information only)")
    say(f"  8c handoff time in this run: host {host_ms:.3f} ms "
        f"({host_ms / 10 / wall:.4f}% of the wall), device span "
        f"{device_ms:.3f} ms ({device_ms / 10 / wall:.4f}% of the wall)")
    say(f"  8c launches in this run: {json.dumps(launches)}")
    if sum(moved) != want:
        fail("phase 8c: migrated bytes differ from the blocks' bytes")
    if launches["paged_decode_attention"] == 0:
        fail("phase 8c: K3 never launched on the decode pool")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"  mistral-7b disaggregated serve wall_s={wall:.3f} "
        f"max_memory_allocated_gb={peak:.3f} card={card}")
    del params, engine, router
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- phases 3t, 4t, 10
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 on the CUDA cores, no TF32
SMOLLM = "smollm-360m"        # 15 query heads on 5 KV heads, D 64
SHQ, SHKV, SD = 15, 5, 64
TRAIN_B, TRAIN_S = 8, 512     # phase 10's batch
ZAMBA_TRAIN_B = 2             # phase 10's zamba2-1.2b batch (of TRAIN_S)
GRAD_TOL = 1e-4               # a gradient leaf, relative to max(1, |g|inf)


def _bound_f32(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(sq, sk, causal, window):
    """(q, k) pairs a mask keeps (q_offset 0)."""
    n = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window is not None else 0
        n += max(0, hi - lo)
    return n


def check_flash_bwd(torch):
    """Phase 3t: K1 with its lse, then K1-bwd on that lse, against their
    plain versions at the training paths' shapes, both dtypes: the output
    (v4 in float32, v3 in bf16) and lse within TOL, dq, dk and dv each
    within TOL·max(1, |ref|inf); a second K1-bwd call gives the same bits.
    Returns the worst float32 K1-bwd error per kernels-line row."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    # (label, B, Hq, Hkv, Sq, Sk, D, kwargs)
    cases = [
        (SMOLLM, TRAIN_B, SHQ, SHKV, 128, 128, SD, dict(causal=True)),
        (SMOLLM, TRAIN_B, SHQ, SHKV, 512, 512, SD, dict(causal=True)),
        (f"{SMOLLM} ragged", 2, SHQ, SHKV, 300, 300, SD, dict(causal=True)),
        (ZAMBA, ZAMBA_TRAIN_B, ZHQ, ZHQ, TRAIN_S, TRAIN_S, ZD,
         dict(causal=True, window=ZWINDOW)),
        ("mistral-7b", 1, HQ, HKV, 512, 512, D, dict(causal=True, window=17)),
        ("mistral-7b", 1, HQ, HKV, 512, 512, D,
         dict(causal=True, window=4096)),
        (f"{WHISPER} encoder", 1, WHQ, WHQ, WENC, WENC, WD,
         dict(causal=False)),
        (f"{WHISPER} cross", 1, WHQ, WHQ, 24, WENC, WD, dict(causal=False)),
        (QWEN, 1, QHQ, QHKV, 768, 768, D, dict(causal=True)),
        ("grok-1 softcap", 1, 48, 8, 256, 256, D,
         dict(causal=True, softcap=30.0)),
    ]
    worst = {"flash_attention_bwd": 0.0, f"flash_attention_bwd@{ZAMBA}": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for label, B, hq, hkv, Sq, Sk, d, kw in cases:
            q = _rand(torch, gen, (B, hq, Sq, d), dt)
            k = _rand(torch, gen, (B, hkv, Sk, d), dt)
            v = _rand(torch, gen, (B, hkv, Sk, d), dt)
            do = _rand(torch, gen, (B, hq, Sq, d), dt)
            out, lse = FA._flash_attention_fwd(q, k, v, **kw)
            got = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
            again = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
            want = FA.flash_attention_bwd_ref(q, k, v, do, **kw)
            fwd_err = (out.float() - FA.flash_attention_ref(q, k, v, **kw)
                       .float()).abs().max().item()
            lse_err = (lse - FA.flash_attention_lse_ref(q, k, v, **kw)) \
                .abs().max().item()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = same and fwd_err <= TOL[name] and lse_err <= TOL[name]
            errs = []
            key = f"flash_attention_bwd@{ZAMBA}" if label == ZAMBA \
                else "flash_attention_bwd"
            for g, w in zip(got, want):
                err = (g.float() - w.float()).abs().max().item()
                lim = TOL[name] * max(1.0, w.float().abs().max().item())
                errs.append(f"{err:.2e}/{lim:.1e}")
                ok = ok and err <= lim
                if name == "float32":
                    worst[key] = max(worst[key], err)
            say(f"  3t K1+K1-bwd {name:8s} {label:18s} B={B} Hq={hq} "
                f"Hkv={hkv} Sq={Sq:4d} Sk={Sk:4d} D={d:3d} {kw}: out err "
                f"{fwd_err:.2e} lse err {lse_err:.2e}; dq/dk/dv err/limit "
                f"{' '.join(errs)} deterministic={same} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"phase 3t: K1's output or lse, or K1-bwd, disagrees "
                     f"with its plain version, or K1-bwd is not "
                     f"deterministic ({label}, {name}, {kw})")
            del q, k, v, do, out, lse, got, again, want
    torch.cuda.empty_cache()
    return worst


def _kernel_split(torch, fn, pattern, reps=5):
    """Device ms per call of each kernel whose name matches ``pattern``
    (its first group names it) that ``fn`` launches, from torch.profiler's
    CUDA trace over ``reps`` calls."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m:
            split[m.group(1)] = e.device_time_total / reps / 1e3
    return split


def _sm_clock_during(torch, fn, seconds=1.0):
    """(median SM clock MHz, max power W) that nvidia-smi samples every
    100 ms while ``fn`` runs back to back for ``seconds``: the clock the
    float32 peak is reckoned at (1980 MHz) against the one the card ran."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = []
    for line in out.splitlines()[2:]:          # skip the idle start
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((mhz, watts))
    if not samples:
        return float("nan"), float("nan")
    clocks = sorted(m for m, _ in samples)
    return clocks[len(clocks) // 2], max(w for _, w in samples)


# (B, Hq, Hkv, D, window) of K1 at the training shapes (S = TRAIN_S, causal)
FLASH_TRAIN = {SMOLLM: (TRAIN_B, SHQ, SHKV, SD, None),
               ZAMBA: (ZAMBA_TRAIN_B, ZHQ, ZHQ, ZD, ZWINDOW)}


def time_flash_train(torch):
    """Phase 3t times at smollm-360m's training shape (B 8, 15 on 5 heads,
    D 64, S 512, causal) and zamba2-1.2b's (B 2, 32 heads, no grouping, D
    64, S 512, window 8192), float32: K1-bwd (given the forward's lse)
    beside its plain version and the backward of one SDPA call on K/V
    expanded to the query heads (a yardstick the port never calls), each
    the mean of 20 eager calls between CUDA events, and by kernel (a
    torch.profiler trace); K1's float32 forward (v4) with its lse, as
    training calls it, beside its plain version and SDPA, by CUDA-graph
    replay as phase 3, and by tile; and the SM clock while each runs back
    to back. Bounds at the float32 peak without TF32 (at 1980 MHz)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    f32 = torch.float32
    S = TRAIN_S
    rows = {}
    for arch, (B, hq, hkv, d, window) in FLASH_TRAIN.items():
        kw = dict(causal=True, window=window)
        q = _rand(torch, gen, (B, hq, S, d), f32)
        k = _rand(torch, gen, (B, hkv, S, d), f32)
        v = _rand(torch, gen, (B, hkv, S, d), f32)
        do = _rand(torch, gen, (B, hq, S, d), f32)
        out, lse = FA._flash_attention_fwd(q, k, v, **kw)
        fwd_flops = 4 * B * hq * d * _pairs(S, S, True, window)
        io = (2 * hq * S * d + 2 * hkv * S * d) * 4 * B     # q, o; k, v
        shape = (f"{arch} B={B} Hq={hq} Hkv={hkv} Sq=Sk={S} D={d} float32 "
                 f"causal window={window}")
        suffix = "" if arch == SMOLLM else f"@{arch}"
        # SDPA's backward alone: one forward kept, its graph retained
        leaves = [t.clone().requires_grad_(True) for t in
                  (q, k.repeat_interleave(hq // hkv, 1),
                   v.repeat_interleave(hq // hkv, 1))]
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        # read q, k, v, o, dO and the lse; write dq, dk, dv
        b_ms, b_by = _bound_f32(
            2.5 * fwd_flops,
            io + (hq * S * d * 2 + 2 * hkv * S * d) * 4 * B + hq * S * 4 * B)
        rows[f"flash_attention_bwd{suffix}"] = dict(
            ms=_eager_ms(torch, lambda: FA.flash_attention_bwd(
                q, k, v, out, do, lse, **kw)),
            plain_ms=_eager_ms(torch, lambda: FA.flash_attention_bwd_ref(
                q, k, v, do, **kw)),
            library_ms=_eager_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, leaves, do, retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by, shape=shape,
            kernels=_kernel_split(torch, lambda: FA.flash_attention_bwd(
                q, k, v, out, do, lse, **kw), r"bwd_(\w+?)_kernel"),
            clock=_sm_clock_during(torch, lambda: FA.flash_attention_bwd(
                q, k, v, out, do, lse, **kw)))
        b_ms, b_by = _bound_f32(fwd_flops, io + hq * S * 4 * B)   # and lse
        key = f"flash_attention@{SMOLLM}" if arch == SMOLLM \
            else f"flash_attention@{arch}-train"
        err = max((out - FA.flash_attention_ref(q, k, v, **kw)).abs().max()
                  .item(), (lse - FA.flash_attention_lse_ref(q, k, v, **kw))
                  .abs().max().item())
        if err > TOL["float32"]:
            fail(f"phase 3t: K1 float32 at {arch}'s training shape: "
                 f"{err:.3e}")
        tq, tk = FA.TILES[f32]
        rows[key] = dict(
            ms=time_ms(torch, lambda: FA._flash_attention_fwd(q, k, v, **kw)),
            plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v,
                                                                   **kw)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, leaves[1].detach(), leaves[2].detach(), is_causal=True)),
            bound_ms=b_ms, bound_by=b_by, shape=shape, err=err,
            tiles={f"{bq}x{bk}": time_ms(torch, lambda: FA._flash_attention_fwd(
                q, k, v, block_q=bq, block_k=bk, **kw))
                for bq in tq for bk in tk
                if FA.smem_bytes(bq, bk, d) <= FA.SMEM_BYTES},
            clock=_sm_clock_during(torch, lambda: FA._flash_attention_fwd(
                q, k, v, **kw)))
        del q, k, v, do, out, lse, leaves, sdpa_out
    torch.cuda.empty_cache()
    for name, r in rows.items():
        say(f"  time {name:34s} {r['shape']}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
        if "tiles" in r:
            say(f"  tiles {name:33s} ms by tile: " + " ".join(
                f"{t}={ms:.4f}" for t, ms in r["tiles"].items()))
        if "kernels" in r:
            say(f"  profile {name:31s} device ms by kernel (torch.profiler): "
                + " ".join(f"{k}={ms:.4f}" for k, ms in r["kernels"].items())
                + f" sum={sum(r['kernels'].values()):.4f}")
        say(f"  clock {name:33s} under load (nvidia-smi, median of 100 ms "
            f"samples): clocks.sm={r['clock'][0]:.0f} MHz, max "
            f"power.draw={r['clock'][1]:.1f} W")
    return rows


# (label, B, H, S, P, N, chunk) of K5-bwd's checks: mamba2-130m's and
# zamba2-1.2b's training shapes (phase 10's batches), ragged, and the
# reduced configs'
SSD_TRAIN = {"mamba2-130m": (TRAIN_B, 24, TRAIN_S, 64, 128, 128),
             ZAMBA: (ZAMBA_TRAIN_B, 64, TRAIN_S, 64, 64, 128)}
SSD_BWD_CASES = [
    ("mamba2-130m", *SSD_TRAIN["mamba2-130m"]),
    ("mamba2-130m ragged", 2, 24, 300, 64, 128, 128),
    (ZAMBA, *SSD_TRAIN[ZAMBA]),
    (f"{ZAMBA} ragged", 2, 64, 300, 64, 64, 128),
    ("reduced", 2, 16, 64, 32, 32, 32),
    ("reduced ragged", 2, 16, 45, 32, 32, 32),
]


def _ssd_bwd_inputs(torch, gen, dtype, B, H, S, P, N, L, with_final):
    """K5's inputs, dy, dfinal (or None) and the workspace a K5 call on
    them filled."""
    from repro_torch.kernels import ssm_scan as SS
    inp = _ssd_inputs(torch, gen, dtype, B, H, S, P, N)
    dy = _rand(torch, gen, (B, H, S, P), dtype)
    dfinal = _rand(torch, gen, (B, H, P, N), torch.float32) \
        if with_final else None
    ws = SS.workspace(inp[0], N, L)
    SS.launch_passes(*inp, chunk=L, ws=ws)
    return inp, dy, dfinal, ws


def check_ssd_bwd(torch):
    """Phase 3t: K5-bwd against autograd of its plain version at the
    training shapes, ragged S and the reduced shape, with and without a
    final-state gradient, both dtypes, dx, ddt, dA, dB and dC each within
    SSD_TOL·max(1, |ref|inf); a second call gives the same bits. Returns
    the worst float32 error per kernels-line row."""
    from repro_torch.kernels import ssm_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    worst = {"ssd_scan_bwd": 0.0, f"ssd_scan_bwd@{ZAMBA}": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for label, B, H, S, P, N, L in SSD_BWD_CASES:
            for with_final in (False, True):
                inp, dy, dfinal, ws = _ssd_bwd_inputs(
                    torch, gen, dt, B, H, S, P, N, L, with_final)
                got = SS.ssd_scan_bwd(*inp, dy, dfinal, chunk=L, ws=ws)
                again = SS.ssd_scan_bwd(*inp, dy, dfinal, chunk=L, ws=ws)
                want = SS.ssd_scan_bwd_ref(*inp, dy, dfinal, chunk=L)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                errs, ok = [], same
                for g, w in zip(got, want):
                    err = (g.float() - w.float()).abs().max().item()
                    lim = SSD_TOL[name] * max(1.0,
                                              w.float().abs().max().item())
                    errs.append(f"{err:.2e}/{lim:.1e}")
                    ok = ok and err <= lim
                    key = f"ssd_scan_bwd@{ZAMBA}" if label.startswith(ZAMBA) \
                        else "ssd_scan_bwd"
                    if name == "float32" and not label.startswith("reduced"):
                        worst[key] = max(worst[key], err)
                say(f"  3t K5-bwd {name:8s} {label:18s} B={B} H={H} S={S:3d} "
                    f"P={P} N={N:3d} chunk={L:3d} dfinal={with_final!s:5s}: "
                    f"dx/ddt/dA/dB/dC err/limit {' '.join(errs)} "
                    f"deterministic={same} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"phase 3t: K5-bwd disagrees with its plain version "
                         f"or is not deterministic ({label}, {name}, "
                         f"dfinal={with_final})")
                del inp, dy, dfinal, ws, got, again, want
    torch.cuda.empty_cache()
    return worst


def _ssd_pairs(S, L):
    """Causal (i, j) pairs of the chunks of S steps."""
    full, tail = divmod(S, L)
    return full * L * (L + 1) // 2 + tail * (tail + 1) // 2


def time_ssd_train(torch):
    """Phase 3t times, float32, at mamba2-130m's training shape (B 8, S 512,
    H 24, P 64, N 128, chunk 128; no final-state gradient, as in training)
    and zamba2-1.2b's (B 2, H 64, N 64): K5-bwd beside its plain version,
    each the mean of 20 eager calls between CUDA events; and at both, K5's
    float32 forward beside its plain version by CUDA-graph replay, as phase
    3, and by pass; K5-bwd's six kernels' device times from a
    torch.profiler trace. No single PyTorch call computes either:
    library_ms is null.
    Bounds at the float32 peak without TF32."""
    from repro_torch.kernels import ssm_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    rows = {}
    for arch, (B, H, S, P, N, L) in SSD_TRAIN.items():
        inp, dy, _, ws = _ssd_bwd_inputs(torch, gen, torch.float32, B, H, S,
                                         P, N, L, False)
        nc = -(-S // L)
        pairs = _ssd_pairs(S, L)
        # per (lane, head): C·Bᵀ, dY·Xᵀ, dx, dB, dC over the causal pairs;
        # dY·Cᵀ, G B, Gᵀ x, S_in C and S_inᵀ dY over every step
        flops = 2 * B * H * (pairs * (3 * N + 2 * P) + 5 * S * P * N)
        nbytes = 4 * (3 * B * H * S * P + 4 * B * S * N + 2 * B * H * S
                      + 2 * H + B * H * nc * (P * N + 1))
        b_ms, b_by = _bound_f32(flops, nbytes)
        key = "ssd_scan_bwd" if arch == "mamba2-130m" else \
            f"ssd_scan_bwd@{arch}"
        shape = f"{arch} B={B} H={H} S={S} P={P} N={N} chunk={L} float32"
        rows[key] = dict(
            ms=_eager_ms(torch, lambda: SS.ssd_scan_bwd(*inp, dy, chunk=L,
                                                        ws=ws)),
            plain_ms=_eager_ms(torch, lambda: SS.ssd_scan_bwd_ref(
                *inp, dy, chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=shape,
            kernels=_kernel_split(torch, lambda: SS.ssd_scan_bwd(
                *inp, dy, chunk=L, ws=ws), r"ssd_bwd_(\w+?)_kernel"))
        # K5's float32 forward, as training calls it
        fwd_flops = 2 * B * H * (pairs * (N + P) + 2 * S * P * N)
        fwd_bytes = 4 * (2 * B * H * S * P + 2 * B * S * N + B * H * S
                         + H + B * H * P * N)
        b_ms, b_by = _bound_f32(fwd_flops, fwd_bytes)
        y, fs = SS.ssd_scan(*inp, chunk=L)
        want_y, want_fs = SS.ssd_scan_ref(*inp, chunk=L)
        err = max((y - want_y).abs().max().item(),
                  (fs - want_fs).abs().max().item())
        if err > SSD_TOL["float32"]:
            fail(f"phase 3t: K5 float32 at {arch}'s training shape: "
                 f"{err:.3e}")
        rows[f"ssd_scan@{arch}-train"] = dict(
            ms=time_ms(torch, lambda: SS.ssd_scan(*inp, chunk=L)),
            plain_ms=time_ms(torch, lambda: SS.ssd_scan_ref(*inp,
                                                            chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=shape,
            err=err, tiles=_ssd_passes(torch, SS, inp, N, L))
        del inp, dy, ws
    torch.cuda.empty_cache()
    for name, r in rows.items():
        say(f"  time {name:34s} {r['shape']}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms=null "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
        if "tiles" in r:
            say(f"  tiles {name:33s} ms by pass: " + " ".join(
                f"{t}={ms:.4f}" for t, ms in r["tiles"].items()))
        if "kernels" in r:
            say(f"  profile {name:31s} device ms by kernel (torch.profiler): "
                + " ".join(f"{k}={ms:.4f}" for k, ms in r["kernels"].items())
                + f" sum={sum(r['kernels'].values()):.4f}")
    return rows


def phase_kernels_train(torch):
    say("== phase 3t: K1 with its lse, K1-bwd and K5-bwd vs their plain "
        "versions, and the training shapes' times")
    worst = check_flash_bwd(torch)
    times = time_flash_train(torch)
    worst.update(check_ssd_bwd(torch))
    times.update(time_ssd_train(torch))
    return worst, times


def _train_kernels():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    return {"flash_attention": FA.flash_attention,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "ssd_scan": SS.ssd_scan, "ssd_scan_bwd": SS.ssd_scan_bwd}


def _train_counts():
    return {k: f.launches for k, f in _train_kernels().items()}


def _zero_train_counts():
    for f in _train_kernels().values():
        f.launches = 0


def _tree_err(torch, got, want):
    """Worst leaf error over tol·max(1, |want|inf), and whether every leaf
    of ``got`` is non-zero."""
    from repro_torch.training import optimizer as OPT
    worst, nonzero = 0.0, True
    for g, w in zip(OPT.tree_leaves(got), OPT.tree_leaves(want)):
        scale = max(1.0, w.abs().max().item())
        worst = max(worst, (g - w).abs().max().item() / scale)
        nonzero = nonzero and g.abs().sum().item() > 0
    return worst, nonzero


def _train_parity(torch, arch, cfg, batches, needed, steps=5):
    """Kernel path against plain path on the same seeded weights: the
    loss, every gradient leaf, then ``steps`` AdamW steps' losses. The
    kernel path must launch each kernel in ``needed``; the plain path no
    kernel at all."""
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as T
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.float32, "cuda",
                           max_positions=max(cfg.max_seq_len, 512))
    opt = OPT.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    res = {}
    for backend in ("auto", "ref"):
        _zero_train_counts()
        loss, _, grads = T.loss_and_grads(params, cfg, batches[0],
                                          backend=backend)
        step = T.make_train_step(cfg, opt, backend=backend)
        p, st, losses = params, OPT.init_state(params), []
        for b in batches[:steps]:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        res[backend] = (float(loss), grads, losses, _train_counts())
        del p, st
    (la, ga, sa, ca), (lr_, gr, sr, cr) = res["auto"], res["ref"]
    gerr, nonzero = _tree_err(torch, ga, gr)
    serr = max(abs(a - b) for a, b in zip(sa, sr))
    say(f"  4t {arch}: loss kernel {la:.7f} plain {lr_:.7f} "
        f"(|diff| {abs(la - lr_):.3e}, limit 1e-5); worst gradient leaf "
        f"{gerr:.3e} of max(1, |g|inf) (limit {GRAD_TOL}); every leaf "
        f"non-zero {nonzero}; {steps} AdamW steps' losses kernel "
        f"{[round(x, 6) for x in sa]} worst |diff| {serr:.3e} (limit 1e-4); "
        f"kernel-path launches {ca}, plain-path {cr}")
    if abs(la - lr_) > 1e-5 or gerr > GRAD_TOL or not nonzero or serr > 1e-4:
        fail(f"phase 4t: {arch} kernel path differs from the plain path")
    if any(ca[k] == 0 for k in needed) or any(cr.values()):
        fail(f"phase 4t: {arch} did not train through {needed} on the kernel "
             f"path alone")
    del params
    torch.cuda.empty_cache()
    return max(abs(la - lr_), serr), gerr


def phase_train_parity(torch):
    """Phase 4t: smollm-360m at full width cut to 2 layers (B 8, S 512),
    whisper-base in full (B 2, 1500 seeded frames, 64 tokens), mamba2-130m
    at full width cut to 2 layers (B 8, S 512) and zamba2-1.2b cut to 7
    (one segment with its shared attention block, then a tail; B 2, S 512),
    float32."""
    from repro_torch.configs import get_config
    from repro_torch.training import data as TD
    k1 = ("flash_attention", "flash_attention_bwd")
    k5 = ("ssd_scan", "ssd_scan_bwd")
    out = []
    for arch, layers, B, S, needed in (
            (SMOLLM, 2, TRAIN_B, TRAIN_S, k1), (WHISPER, None, 2, 64, k1),
            ("mamba2-130m", 2, TRAIN_B, TRAIN_S, k5),
            (ZAMBA, 7, ZAMBA_TRAIN_B, TRAIN_S, k1 + k5)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        say(f"== phase 4t: training parity, {arch} full width, "
            f"{cfg.num_layers} layers, float32, B {B} x {S}, kernel path vs "
            f"plain path")
        batches = list(TD.arithmetic_stream(cfg, B, S, 5, seed=SEED,
                                            device="cuda"))
        out.append(_train_parity(torch, arch, cfg, batches, needed))
    return out


def _launch_train(torch, card, arch, batch, steps, checkpoint=""):
    """Train full ``arch`` (float32, random weights from the seed) through
    ``repro_torch.launch.train``'s code path: ``batch`` x TRAIN_S tokens of
    the arithmetic stream, ``steps`` steps, lr 3e-3. Every logged loss and
    gradient norm must be finite, and each kernel must launch once per
    layer it runs in per step (K1 and K1-bwd in every attention layer or
    shared attention block, K5 and K5-bwd in every Mamba layer). Returns
    launch.train's result, the launches and the logged losses."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    cfg = get_config(arch)
    every = cfg.hybrid_attn_every
    n_attn = (cfg.num_layers // every if every else 0) \
        if cfg.family in ("ssm", "hybrid") else cfg.num_layers
    n_ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    expected = {"flash_attention": steps * n_attn,
                "flash_attention_bwd": steps * n_attn,
                "ssd_scan": steps * n_ssd, "ssd_scan_bwd": steps * n_ssd}
    say(f"== phase 10: train {arch} ({cfg.num_layers} layers, float32) "
        f"through repro_torch.launch.train: B {batch}, S {TRAIN_S}, "
        f"{steps} steps")
    _fresh_peak(torch)
    argv = ["--arch", arch, "--full-config", "--steps", str(steps),
            "--batch-size", str(batch), "--seq-len", str(TRAIN_S), "--lr",
            "3e-3", "--data", "arithmetic", "--seed", str(SEED), "--device",
            "cuda"]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    lines = []
    _zero_train_counts()
    t0 = time.perf_counter()
    res = LT.run(LT.parse_args(argv),
                 log=lambda m: (lines.append(m), say(f"  {m}")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    logged = [l for l in lines if l.startswith("step")]
    losses = [float(l.split("loss")[1].split()[0]) for l in logged]
    gnorms = [float(l.split("gnorm")[1].split()[0]) for l in logged]
    say(f"  10 {arch}: {len(logged)} logged steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, tok/s {res['tok_s']:.1f} over the steps "
        f"({res['seconds']:.3f} s), wall with build"
        f"{' and checkpoint' if checkpoint else ''} {wall:.3f} s, "
        f"max_memory_allocated_gb={peak:.3f}, launches {launches} "
        f"(expected {expected}) card={card}")
    if len(logged) != steps or not all(math.isfinite(x)
                                       for x in losses + gnorms):
        fail(f"phase 10: {arch}: a loss or gradient norm is not finite")
    if launches != expected:
        fail(f"phase 10: {arch}: launches {launches}, not {expected}")
    return res, launches, losses


def _remat_step(torch, arch, res, batch, per_layer):
    """One step's loss and gradients with --remat against without, on the
    trained weights: the losses within 1e-5, every gradient leaf non-zero,
    and with remat each forward kernel twice per layer, each backward
    kernel once (``per_layer``: the kernels' layer counts)."""
    from repro_torch.training import data as TD
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as T
    cfg, params = res["cfg"], res["params"]
    b = next(TD.arithmetic_stream(cfg, batch, TRAIN_S, 1, seed=SEED,
                                  device="cuda"))
    out = {}
    for remat in (False, True):
        _zero_train_counts()
        loss, _, grads = T.loss_and_grads(params, cfg, b, remat=remat)
        torch.cuda.synchronize()
        out[remat] = (float(loss), _train_counts())
        if not remat:
            nonzero = all(g.abs().sum().item() > 0
                          for g in OPT.tree_leaves(grads))
        del grads
    diff = abs(out[True][0] - out[False][0])
    want = {k: n * (2 if k in ("flash_attention", "ssd_scan") else 1)
            for k, n in per_layer.items()}
    say(f"  10 {arch} --remat step: loss {out[True][0]:.7f} vs "
        f"{out[False][0]:.7f} (|diff| {diff:.3e}, limit 1e-5); launches "
        f"with remat {out[True][1]}, without {out[False][1]}; every "
        f"gradient leaf non-zero {nonzero}")
    if diff > 1e-5 or not nonzero or out[True][1] != want:
        fail(f"phase 10: {arch}'s remat step differs or its launches are not "
             f"{want}")


def _profiled_step(torch, arch, res, batch):
    """One more AdamW step of ``arch`` on its trained weights under
    torch.profiler: the step's host wall beside the device time its kernels
    hold (their sum, so the rest of the wall is the device idle), and the
    kernels and host operators that take the most. What phase 10's wall
    for ``arch`` is spent on."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import data as TD
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as T
    cfg = res["cfg"]
    b = next(TD.arithmetic_stream(cfg, batch, TRAIN_S, 1, seed=SEED + 1,
                                  device="cuda"))
    step = T.make_train_step(cfg, OPT.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                  total_steps=6))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(res["params"], res["state"], b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    ops = [e for e in events if str(e.device_type).endswith("CPU")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def top(evs, ms):
        return " ".join(f"{e.key[:48]}={ms(e):.1f}" for e in sorted(
            evs, key=ms, reverse=True)[:6])
    say(f"  10 {arch} one more step under torch.profiler: wall "
        f"{wall * 1e3:.1f} ms (profiled), device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%); device ms by kernel: "
        f"{top(kernels, lambda e: e.self_device_time_total / 1e3)}; host "
        f"self ms by operator: "
        f"{top(ops, lambda e: e.self_cpu_time_total / 1e3)}")


def phase_train(torch, card):
    """Phase 10: full smollm-360m (32 layers) and full mamba2-130m (24), B 8,
    20 steps each, and full zamba2-1.2b (38), B 2, 5 steps, float32,
    through ``repro_torch.launch.train``'s code path; a --remat step on
    smollm-360m and on mamba2-130m; smollm's checkpoint round trip; one
    more zamba2-1.2b step under torch.profiler (its wall against the
    device time of its kernels)."""
    import shutil
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as OPT
    ck_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = str(ck_dir / "smollm.npz")
    res, launches, losses = _launch_train(torch, card, SMOLLM, TRAIN_B, 20,
                                          checkpoint=ck)
    if not losses[-1] < losses[0]:
        fail(f"phase 10: {SMOLLM}'s loss did not fall")
    out = {"flash_attention_bwd": launches["flash_attention_bwd"],
           f"flash_attention@{SMOLLM}": launches["flash_attention"]}
    n = res["cfg"].num_layers
    _remat_step(torch, SMOLLM, res, TRAIN_B, {
        "flash_attention": n, "flash_attention_bwd": n, "ssd_scan": 0,
        "ssd_scan_bwd": 0})

    # the checkpoint launch.train wrote, restored on the card
    params = res["params"]
    t1 = time.perf_counter()
    zeros = OPT.tree_map(torch.zeros_like, params)
    rp, rs, meta = CKPT.restore(ck, zeros, OPT.init_state(zeros))
    same = all(torch.equal(a, b) for a, b in zip(
        OPT.tree_leaves(rp) + OPT.tree_leaves(rs),
        OPT.tree_leaves(params) + OPT.tree_leaves(res["state"])))
    size = sum(f.stat().st_size for f in ck_dir.iterdir()) / 1e9
    say(f"  10 checkpoint: {size:.3f} GB written, restored on the card bit "
        f"for bit {same} (step {int(rs['step'])}, meta {meta}) in "
        f"{time.perf_counter() - t1:.2f} s")
    shutil.rmtree(ck_dir, ignore_errors=True)
    if not same or int(rs["step"]) != 20:
        fail("phase 10: the checkpoint does not restore bit for bit")
    del params, rp, rs, zeros, res
    torch.cuda.empty_cache()

    # SSM and hybrid: K5 under its autograd Function, K5-bwd
    res, launches, losses = _launch_train(torch, card, "mamba2-130m",
                                          TRAIN_B, 20)
    if not losses[-1] < losses[0]:
        fail("phase 10: mamba2-130m's loss did not fall")
    out["ssd_scan_bwd"] = launches["ssd_scan_bwd"]
    out["ssd_scan@mamba2-130m-train"] = launches["ssd_scan"]
    n = res["cfg"].num_layers
    _remat_step(torch, "mamba2-130m", res, TRAIN_B, {
        "flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": n,
        "ssd_scan_bwd": n})
    del res
    torch.cuda.empty_cache()
    say(f"  10 {ZAMBA} peak reckoned before the run: 1.2e9 parameters x 4 "
        f"bytes x (params, grads, mu, nu, new params) = 24 GB, plus "
        f"activations")
    res, launches, _ = _launch_train(torch, card, ZAMBA, ZAMBA_TRAIN_B, 5)
    out[f"ssd_scan_bwd@{ZAMBA}"] = launches["ssd_scan_bwd"]
    out[f"ssd_scan@{ZAMBA}-train"] = launches["ssd_scan"]
    out[f"flash_attention_bwd@{ZAMBA}"] = launches["flash_attention_bwd"]
    out[f"flash_attention@{ZAMBA}-train"] = launches["flash_attention"]
    _profiled_step(torch, ZAMBA, res, ZAMBA_TRAIN_B)
    del res
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 11
DRY_CASES = (("mistral-7b", "decode", 8, 4096, False),
             ("mistral-7b", "decode", 8, 4096, True),
             (ZAMBA, "train", ZAMBA_TRAIN_B, TRAIN_S, False),
             (WHISPER, "prefill", 4, 448, False))


def _flat_args(args):
    """Leaf path -> tensor over a step's argument tuple."""
    from repro_torch.sharding import specs as SH
    out = {}
    for i, tree in enumerate(args):
        SH.map_with_path(lambda p, t, i=i: out.__setitem__(f"{i}/{p}", t),
                         tree)
    return out


def _requested(torch) -> int:
    """Bytes the caching allocator was asked for and still holds, before
    its rounding."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _allocator_slack(sizes) -> int:
    """The most ``memory_allocated`` may exceed the sum of ``sizes``: the
    caching allocator rounds each block up to 512 bytes, and a block over
    1 MiB keeps the rest of its free block when that rest is 1 MiB or less
    (it splits only a larger rest)."""
    return sum(512 + (2**20 if n > 2**20 else 0) for n in sizes)


def _dry_case(torch, card, arch, kind, B, S, kv_quant):
    """Phase 11a, one case: ``input_specs`` on the meta device and on the
    card, the dry run's bytes on a 1x1 mesh, and the card's growth."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import input_specs as IS
    from repro_torch.launch.mesh import MeshSpec
    label = f"{arch} {kind} B {B} S {S}{' int8 KV' if kv_quant else ''}"
    cfg, shape = get_config(arch), InputShape(f"{kind}_{S}", S, B, kind)
    old = os.environ.pop("REPRO_KV_QUANT", None)
    if kv_quant:
        os.environ["REPRO_KV_QUANT"] = "1"
    try:
        meta = IS.input_specs(cfg, shape)
        dry = DR.argument_bytes(MeshSpec(("data", "model"), (1, 1)), cfg,
                                shape, args=meta)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(), _requested(torch)
        t0 = time.perf_counter()
        real = IS.input_specs(cfg, shape, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        grown = torch.cuda.memory_allocated() - before[0]
        requested = _requested(torch) - before[1]
    finally:
        os.environ.pop("REPRO_KV_QUANT", None)
        if old is not None:
            os.environ["REPRO_KV_QUANT"] = old
    m, r = _flat_args(meta), _flat_args(real)
    same = m.keys() == r.keys() and all(
        (m[k].shape, m[k].dtype) == (r[k].shape, r[k].dtype) and m[k].is_meta
        and r[k].is_cuda for k in m)
    sizes = [t.untyped_storage().nbytes() for t in r.values()]
    storage, slack = sum(sizes), _allocator_slack(sizes)
    want = dry["argument_size_in_bytes"]
    say(f"  11a {label}: {len(r)} leaves, shapes and dtypes equal {same}; "
        f"dry run per device (1x1) {dry}; card storage {storage} bytes "
        f"(equal {storage == want}), allocator requests {requested} (equal "
        f"{requested == storage}); memory_allocated grew {grown} "
        f"(+{grown - storage}; {sum(n > 2**20 for n in sizes)} of "
        f"{len(r)} leaves over 1 MiB, limit {slack}); built in "
        f"{build_s:.3f} s card={card}")
    if not same or storage != want or requested != storage \
            or not 0 <= grown - storage <= slack:
        fail(f"phase 11a: {label}: the card's structures are not the dry "
             f"run's")
    del real, meta, m, r
    gc.collect()
    torch.cuda.empty_cache()


def _dtensor_round_trip(torch, card):
    """Phase 11b: full smollm-360m's bf16 params as DTensors on a 1x1
    DeviceMesh of a 1-rank NCCL group, and back."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import specs as SH
    store = ROOT / "build" / "chip_smoke_pg"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        params = M.init_params(get_config(SMOLLM),
                               torch.Generator("cuda").manual_seed(SEED),
                               torch.bfloat16, "cuda")
        leaves, specs = {}, {}
        SH.map_with_path(leaves.__setitem__, params)
        SH.map_with_path(specs.__setitem__, SH.params_shardings(mesh, params))
        n, same, local_ok = 0, True, True
        for path, t in leaves.items():
            spec = specs[path]
            d = distribute_tensor(t, mesh, SH.to_placements(mesh, spec))
            local_ok = local_ok and tuple(d.to_local().shape) == \
                SH.shard_shape(mesh, tuple(t.shape), spec)
            same = same and torch.equal(d.full_tensor(), t)
            n += 1
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    say(f"  11b {SMOLLM} bf16 params: {n} leaves distributed on a "
        f"{SH.axis_sizes(mesh)} NCCL DeviceMesh, local shapes the specs' "
        f"{local_ok}, full_tensor() bit for bit {same}, "
        f"{time.perf_counter() - t0:.3f} s with the group card={card}")
    if not (same and local_ok):
        fail("phase 11b: a DTensor did not come back bit for bit")
    del params
    torch.cuda.empty_cache()


def phase_dryrun(torch, card):
    say("== phase 11: dry run — input_specs on meta and on the card, the "
        "dry run's bytes, DTensors on a 1-rank NCCL mesh")
    t0 = time.perf_counter()
    for case in DRY_CASES:
        _dry_case(torch, card, *case)
    _dtensor_round_trip(torch, card)
    say(f"  11 phase time {time.perf_counter() - t0:.3f} s card={card}")


# --------------------------------------------------------------- phase 12
MIB = 2**20


def _cost_case(torch, card, arch, kind, B, S, kv_quant, mesh):
    """Phase 12, one case: ``analyze``'s prediction for one device (on
    ``mesh``, a 1x1 mesh of DTensors, or plain meta tensors where the
    card's torch is older than the mesh path is held on) against the
    card's run of the same step. Returns the misses."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    label = f"{arch} {kind} B {B} S {S}{' int8 KV' if kv_quant else ''}"
    cfg, shape = get_config(arch), InputShape(f"{kind}_{S}", S, B, kind)
    old = os.environ.pop("REPRO_KV_QUANT", None)
    if kv_quant:
        os.environ["REPRO_KV_QUANT"] = "1"
    try:
        gc.collect()
        pred = DR.analyze(cfg, shape, mesh)
        got = DR.measure_step(cfg, shape)
    finally:
        os.environ.pop("REPRO_KV_QUANT", None)
        if old is not None:
            os.environ["REPRO_KV_QUANT"] = old
    want, temp = pred["temp_size_in_bytes"], got["temp_size_in_bytes"]
    limit = 0.02 * want + 64 * MIB
    tflops = pred["flops"] / (got["kernel_ms"] / 1e3) / 1e12
    say(f"  12 {label}: predicted on {'a 1x1 mesh' if mesh else 'plain meta'}"
        f": flops {pred['flops']} temp {want} bytes "
        f"(peak {pred['peak_bytes']}, arguments "
        f"{pred['argument_size_in_bytes']}, bytes accessed "
        f"{pred['bytes_accessed']}, traced in {pred['trace_s']:.1f} s); "
        f"card flops {got['flops']} (equal {got['flops'] == pred['flops']}), "
        f"temp {temp} bytes (gap {temp - want:+d}, limit {limit:.0f}; "
        f"{got['before']} bytes in use before); walls ref "
        f"{got['ref_ms']:.3f} ms, kernel path {got['kernel_ms']:.3f} ms; "
        f"{tflops:.2f} TFLOP/s on the kernel path, "
        f"{tflops * 1e12 / PEAK_BF16_FLOPS:.2%} of the bf16 peak "
        f"card={card}")
    misses = []
    if got["flops"] != pred["flops"]:
        misses.append(f"{label}: the card's FLOPs are not the prediction")
    if abs(temp - want) > limit:
        misses.append(f"{label}: temporary bytes {temp} against {want}")
    return misses


def phase_dryrun_cost(torch, card):
    say("== phase 12: the dry run's step analysis against the card — "
        "FLOPs and temporary bytes of phase 11a's four cases (bf16, the "
        "ref path)")
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    try:
        DR.check_mesh_torch()
        mesh = DR.ONE_DEVICE
    except RuntimeError as refused:
        say(f"  12 analyze refuses a mesh here: {refused}")
        mesh = None
    misses = []
    for case in DRY_CASES:
        misses += _cost_case(torch, card, *case, mesh)
    say(f"  12 phase time {time.perf_counter() - t0:.3f} s card={card}")
    if misses:
        fail("phase 12: " + "; ".join(misses))


# --------------------------------------------------------------- phase 13
DECODE_B, DECODE_S = 8, 4096          # phase 12's mistral-7b decode case
DECODE_POS = DECODE_S - 64            # cache rows filled before step one


def _profile_call(torch, fn):
    """One call of ``fn`` under torch.profiler: the host ms until it
    returns, the wall ms until the card is done, the device ms its device
    ops hold (their sum), how many ran, and the idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)
    return {"host_ms": host * 1e3, "wall_ms": wall * 1e3, "device_ms": busy,
            "device_ops": sum(e.count for e in ops),
            "idle": 1.0 - busy / (wall * 1e3),
            "top": [(e.key[:56], e.count, e.self_device_time_total / 1e3)
                    for e in top[:5]]}


def _fmt(p):
    top = "; ".join(f"{k} x{n} {ms:.3f} ms" for k, n, ms in p["top"])
    return (f"host {p['host_ms']:.3f} ms, wall {p['wall_ms']:.3f} ms, "
            f"device {p['device_ms']:.3f} ms over {p['device_ops']} device "
            f"ops, idle {p['idle']:.1%}; device ms by op: {top}")


def _decode_setup(torch, cfg, params, quant):
    """Two engines on one set of weights, eager and replayed, each with a
    B 8 cache of 4096 rows filled to ``DECODE_POS`` with seeded values (the
    same in both)."""
    from repro_torch.serving.engine import InferenceEngine
    eng = {g: InferenceEngine(cfg, params, max_len=DECODE_S,
                              dtype=torch.bfloat16, device="cuda",
                              kv_quant=quant, graphs=g)
           for g in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    base = eng[False].new_cache(DECODE_B)
    for k, t in base.items():
        if k == "pos":
            t.fill_(DECODE_POS)
        elif t.dtype == torch.int8:
            t.random_(-127, 128, generator=gen)
        elif k.endswith("scale"):
            t.uniform_(0.005, 0.02, generator=gen)
        else:
            t.normal_(generator=gen)
    return eng, {False: base, True: {k: t.clone() for k, t in base.items()}}


def _decode_graphs(torch, card, cfg, params, quant):
    """13a and 13b for one KV dtype: the replayed step's first call (the
    warm-up and the capture), one eager and one replayed step under
    torch.profiler, then 20 of each in turns between CUDA events; the
    logits of every step against the eager step's. Returns the medians."""
    label = "int8 KV" if quant else "bf16 KV"
    eng, cache = _decode_setup(torch, cfg, params, quant)
    tok = torch.zeros((DECODE_B, 1), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = eng[True].decode(tok, cache[True])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    want, _ = eng[False].decode(tok, cache[False])
    errs, same = [(got - want).float().abs().max().item()], [
        torch.equal(got.argmax(-1), want.argmax(-1))]
    prof, out = {}, {}
    tok = want.argmax(-1).to(torch.int32)[:, None]
    for g in (False, True):
        def step(g=g):
            out[g] = eng[g].decode(tok, cache[g])[0]
        prof[g] = _profile_call(torch, step)
    errs.append((out[True] - out[False]).float().abs().max().item())
    same.append(torch.equal(out[True].argmax(-1), out[False].argmax(-1)))
    for g in (False, True):
        say(f"  13a mistral-7b decode B {DECODE_B}, {DECODE_S}-row cache at "
            f"{DECODE_POS}, {label}, {'replayed' if g else 'eager'}: "
            f"{_fmt(prof[g])} card={card}")
    walls = {False: [], True: []}
    tok = out[False].argmax(-1).to(torch.int32)[:, None]
    for _ in range(20):
        for g in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out[g], _ = eng[g].decode(tok, cache[g])
            end.record()
            torch.cuda.synchronize()
            walls[g].append(start.elapsed_time(end))
        errs.append((out[True] - out[False]).float().abs().max().item())
        same.append(torch.equal(out[True].argmax(-1), out[False].argmax(-1)))
        tok = out[False].argmax(-1).to(torch.int32)[:, None]
    med = {g: sorted(w)[len(w) // 2] for g, w in walls.items()}
    r = eng[True].graphs
    say(f"  13b {label}: decode wall (median of 20, CUDA events) eager "
        f"{med[False]:.3f} ms, replayed {med[True]:.3f} ms "
        f"({med[False] / med[True]:.2f}x); the first replayed call (warm-up "
        f"and capture) {first * 1e3:.3f} ms; captures {r.captures}, replays "
        f"{r.replays}; logits max|d| against the eager step "
        f"{max(errs):.3e} over {len(errs)} steps, greedy tokens equal "
        f"{all(same)} card={card}")
    if not all(same) or r.captures != 1:
        fail(f"phase 13b {label}: the replayed decode step is not the "
             f"eager one")
    del eng, cache, out, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return med


def _tick_trace(torch, card, cfg, params):
    """13a, the serving tick: a paged batcher of phase 5's shape (4 slots,
    1024 blocks of 16) with 4 of the mix's prompts, their first 256
    tokens, decoding; one decode tick under torch.profiler, eager and
    replayed."""
    from repro_torch.serving.batching import PagedContinuousBatcher, Request
    from repro_torch.serving.engine import InferenceEngine
    _, prompts = _mix(cfg)
    for g in (False, True):
        eng = InferenceEngine(cfg, params, max_len=MAX_LEN,
                              dtype=torch.bfloat16, device="cuda", graphs=g)
        cb = PagedContinuousBatcher(eng, slots=4, num_blocks=1024,
                                    block_size=16)
        for i, p in enumerate(prompts[:4]):
            cb.submit(Request(i, p[:256], max_new_tokens=48))
        while len(cb._decode_lanes()) < 4:
            cb.step()
        for _ in range(3):
            cb.step()
        p = _profile_call(torch, cb.step)
        say(f"  13a phase 5's decode tick (4 lanes, paged, bf16), "
            f"{'replayed' if g else 'eager'}: {_fmt(p)} card={card}")
        del cb, eng
        gc.collect()
        torch.cuda.empty_cache()


def _turns(torch, card, label, run):
    """``run(graphs)`` eager, replayed, replayed, eager; each returns
    (wall s, tokens, bookings, ticks, runner). Fails unless every turn's
    tokens and bookings are the first's."""
    rows = []
    for g in (False, True, True, False):
        gc.collect()
        torch.cuda.empty_cache()
        wall, tokens, books, ticks, runner = run(g)
        rows.append((g, wall, tokens, books))
        what = (f"captures {runner.captures}, replays {runner.replays}"
                if runner is not None else "no runner")
        say(f"  13c {label} graphs={g}: wall {wall:.3f} s, ticks {ticks}, "
            f"{what} card={card}")
        gc.collect()
        torch.cuda.empty_cache()
    same_t = all(r[2] == rows[0][2] for r in rows)
    same_b = all(r[3] == rows[0][3] for r in rows)
    old = [r[1] for r in rows if not r[0]]
    new = [r[1] for r in rows if r[0]]
    say(f"  13c {label}: walls eager {old[0]:.3f} / {old[1]:.3f} s, "
        f"replayed {new[0]:.3f} / {new[1]:.3f} s; tokens identical {same_t}, "
        f"bookings identical {same_b} card={card}")
    if not (same_t and same_b):
        fail(f"phase 13c {label}: graphs=True served other tokens or "
             f"bookings than graphs=False")


def phase_graphs(torch, card):
    """Phase 13: the serve steps replayed as CUDA graphs against the eager
    steps: 13a traces, 13b the decode step's wall, 13c serve walls in
    turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    say("== phase 13: graphs — the serve steps replayed as CUDA graphs "
        "against the eager steps (mistral-7b 32 layers, whisper-base; bf16)")
    t0 = time.perf_counter()
    _fresh_peak(torch)
    cfg = get_config("mistral-7b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), torch.bfloat16, "cuda")
    for quant in (False, True):
        _decode_graphs(torch, card, cfg, params, quant)
    _tick_trace(torch, card, cfg, params)

    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, DA.paged_decode_attention_int8)
    for phase, quant in ((5, False), (7, True)):
        def run(g, quant=quant):
            eng = InferenceEngine(cfg, params, max_len=MAX_LEN,
                                  dtype=torch.bfloat16, device="cuda",
                                  kv_quant=quant, graphs=g)
            _, wall, tokens, info = _serve_mix(torch, cfg, eng, kernels,
                                               paged=True, verbose=False)
            return wall, tokens, info["reports"], info["ticks"], eng.graphs
        if quant:
            AT.install(_fused_cache({_paged_bucket(4, MAX_LEN, 16)}))
        try:
            _turns(torch, card, f"phase {phase} (mistral-7b, paged, "
                   f"{'int8' if quant else 'bf16'} KV)", run)
        finally:
            AT.install(None)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    wcfg = get_config(WHISPER)
    wparams = M.init_params(wcfg, torch.Generator(device="cuda").manual_seed(
        SEED), torch.bfloat16, "cuda")
    work, prompts = _mix(wcfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    reqs = [({"tokens": torch.from_numpy(p[:W_PROMPT].astype("int32"))[None]
              .cuda(),
              "frames": _seeded_embeddings(torch, gen, (1, WENC,
                                                        wcfg.d_model))}, n)
            for p, (_, n) in zip(prompts[:4], work[:4])]

    def run_whisper(g):
        eng = InferenceEngine(wcfg, wparams, max_len=W_MAX_LEN,
                              dtype=torch.bfloat16, device="cuda", graphs=g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens = [eng.generate(b, n).tokens.tolist() for b, n in reqs]
        torch.cuda.synchronize()
        return time.perf_counter() - t1, tokens, None, sum(
            n - 1 for _, n in reqs), eng.graphs
    _turns(torch, card, f"{WHISPER} generate (4 requests, full, bf16)",
           run_whisper)
    del wparams
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  13 phase time {time.perf_counter() - t0:.3f} s card={card}")


# --------------------------------------------------------------- phase 14
PRICE_DIR = ROOT / "build" / "calibration_torch"
# 14c's cells: mistral-7b's attention heads, mamba2-130m's SSD heads
PRICE_SSD = dict(heads=24, ssm_head_dim=64, state_dim=128)


def _power_at_rest(seconds=1.0):
    """(median, max) power.draw in W that nvidia-smi samples every 100 ms
    for ``seconds`` while nothing runs on the card."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(seconds)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    watts = []
    for line in out.splitlines():
        try:
            watts.append(float(line))
        except ValueError:
            continue
    if not watts:
        return float("nan"), float("nan")
    watts.sort()
    return watts[len(watts) // 2], watts[-1]


def _counted(label, needed, fn):
    """Runs ``fn`` with every kernel's count set to 0 just before and read
    just after; fails unless each kernel in ``needed`` launched."""
    from repro_torch.serving.step_graph import COUNTERS
    kernels = {k.__name__: k for k in COUNTERS}
    for k in kernels.values():
        k.launches = 0
    out = fn()
    moved = {name: k.launches for name, k in kernels.items()}
    say(f"  {label} launches: {moved}")
    missing = [k for k in needed if moved[k] <= 0]
    if missing:
        fail(f"phase {label}: {missing} not launched")
    return out


def _fit_lines(label, profile, cal, samples, card):
    """Prints a fit's constants and each sample's residual."""
    from repro_torch.core.pricing import _predict
    from repro_torch.launch.calibrate import MEASURED_REL_RMSE_BOUND
    pred = _predict(samples, profile, cal.compute_eff, cal.mem_eff,
                    cal.sat_ctx, cal.overhead_s)
    for s, p in zip(samples, pred):
        say(f"  {label} {s.kernel:18s} flops={s.flops:.4e} "
            f"bytes={s.bytes:.4e} ctx={s.ctx:6.0f} t_s={s.t_s:.4e} "
            f"noise_frac={s.noise_frac:.3f} pred_s={p:.4e} "
            f"residual={(p - s.t_s) / s.t_s:+.4f}")
    say(f"  {label} fit {profile.name}: compute_eff={cal.compute_eff!r} "
        f"mem_eff={cal.mem_eff!r} sat_ctx={cal.sat_ctx!r} "
        f"overhead_s={cal.overhead_s!r} fit_rel_rmse={cal.fit_rel_rmse!r} "
        f"(bound {MEASURED_REL_RMSE_BOUND}) n_samples={cal.n_samples} "
        f"card={card}")
    if not cal.fit_rel_rmse < MEASURED_REL_RMSE_BOUND:
        fail(f"phase {label}: fit rel-RMSE {cal.fit_rel_rmse:.4f} not below "
             f"{MEASURED_REL_RMSE_BOUND}")


def _serving_samples(torch):
    """14c's sample set: bf16 at mistral-7b's attention heads, the
    reference's lengths, int8 paged contexts and KV migrations, and the
    SSD cells at mamba2-130m's heads."""
    from repro_torch.kernels.timing import kernel_phase_samples
    kw = dict(backend="cuda", iters=10, seed=SEED, dtype=torch.bfloat16)
    return (kernel_phase_samples(ssm_lens=(), paged_ctxs=(256, 1024, 4096),
                                 migrate_blocks=(8, 64), heads=HQ,
                                 kv_heads=HKV, head_dim=D, **kw)
            + kernel_phase_samples(prefill_lens=(), decode_ctxs=(),
                                   **PRICE_SSD, **kw))


def phase_price(torch, card):
    """Phase 14: the card priced from its own kernel timings."""
    from repro_torch.core.pricing import (Calibration, CalibratedOracle,
                                          KernelSample, fit_calibration)
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import calibrate as C
    say("== phase 14: price — the card fitted from its own kernel timings "
        "(measure -> fit -> price), the paper's fleet priced with it")
    t0 = time.perf_counter()
    p = C.H100_SXM

    # 14a. power at rest and under a bf16 K1 serving call
    torch.cuda.synchronize()
    time.sleep(1.0)
    rest_med, rest_max = _power_at_rest()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = _rand(torch, gen, (1, HQ, M_CAP, D), torch.bfloat16)
    k = _rand(torch, gen, (1, HKV, M_CAP, D), torch.bfloat16)
    v = _rand(torch, gen, (1, HKV, M_CAP, D), torch.bfloat16)
    mhz, load_max = _sm_clock_during(
        torch, lambda: FA.flash_attention(q, k, v, causal=True))
    del q, k, v
    say(f"  14a power.draw at rest: median {rest_med} W, max {rest_max} W; "
        f"under K1 bf16 (B 1, {HQ}/{HKV} heads, S {M_CAP}, D {D}) back to "
        f"back: max {load_max} W at a median SM clock of {mhz} MHz; "
        f"{p.name}: power_idle_w={p.power_idle_w} "
        f"power_peak_w={p.power_peak_w} card={card}")

    # 14b. the reference's recipe, through the entry point
    f32_dir = PRICE_DIR / "f32"
    _counted("14b", ("flash_attention", "decode_attention", "ssd_scan"),
             lambda: C.run_measured(None, iters=10, out_dir=str(f32_dir),
                                    device="cuda"))
    art = json.loads((f32_dir / f"{p.name}.json").read_text())
    _fit_lines("14b", p, Calibration(**art["calibrations"][0]),
               [KernelSample(**s) for s in art["samples"]], card)

    # 14c. the serving fit, the one that prices
    samples = _counted("14c", ("flash_attention", "decode_attention",
                               "ssd_scan"),
                       lambda: _serving_samples(torch))
    cal = fit_calibration(p, samples)
    path = C._write_artifact(p, cal, samples, "measured",
                             str(PRICE_DIR / "bf16"))
    _fit_lines("14c", p, cal, samples, card)
    back = CalibratedOracle.load(path).calibrations.get(p.name)
    say(f"  14c artifact {path}: read back equal {back == cal}")
    if back != cal:
        fail("phase 14c: the calibration artifact does not read back equal")

    # 14d. the oracle refresh over phase 3c's cache
    cache = AT.AutotuneCache.load(AT.cache_path("h100", "cuda"))
    serving_key = AT.cache_key("paged_decode_quant", "cuda", AT.shape_bucket(
        "paged_decode_quant", b=4, c=MAX_LEN))
    fused = any(e.params.get("impl") == "fused"
                for e in cache.entries.values())
    needed = ("flash_attention", "decode_attention", "ssd_scan") + (
        ("paged_decode_attention_int8",) if fused else ())
    refresh = _counted("14d", needed, lambda: C.oracle_refresh(
        cache, p, model="llama2-7b", seed=SEED,
        dims={serving_key: dict(heads=HQ, kv_heads=HKV, head_dim=D)}))
    for r in refresh["remeasured"]:
        say(f"  14d {r['key']:36s} t_s={r['t_s']:.4e} "
            f"pred_s={r['pred_s']:.4e} "
            f"residual={(r['pred_s'] - r['t_s']) / r['t_s']:+.4f}")
    say(f"  14d from_autotune(llama2-7b, {p.name}): compute_eff="
        f"{refresh['compute_eff']!r} mem_eff={refresh['mem_eff']!r} "
        f"sat_ctx={refresh['sat_ctx']!r} overhead_s={refresh['overhead_s']!r}"
        f" fit_rel_rmse={refresh['fit_rel_rmse']:.4f} remeasured_rel_rmse="
        f"{refresh['remeasured_rel_rmse']:.4f} (bound {refresh['bound']}) "
        f"n_samples={refresh['n_samples']} card={card}")
    if not refresh["remeasured_rel_rmse"] < refresh["bound"]:
        fail(f"phase 14d: re-measured rel-RMSE "
             f"{refresh['remeasured_rel_rmse']:.4f} not below "
             f"{refresh['bound']}")

    # 14e. the paper's analysis with this card as the performance pool
    for fp in C.price_fleet(cal):
        origin = (f"priced from this card's calibration ({card})"
                  if fp.pricing.startswith("calibrated") else
                  "the paper's hand-tuned constants")
        for line in fp.lines():
            say(f"  14e {line} — {origin}")
    say(f"  14 phase time {time.perf_counter() - t0:.3f} s card={card}")

# --------------------------------------------------------------- phase 15
NANO = "nemotron-3-nano-30b-a3b"


def _ssd_group_bound(S, H, P, N, G, L):
    full, r = divmod(S, L)
    pairs = full * L * (L + 1) // 2 + r * (r + 1) // 2
    flops = 2 * H * (pairs * (N + P) + 2 * S * P * N)
    nbytes = (2 * H * S * P + 2 * S * G * N) * 2 + (H * S + H) * 4 \
        + H * P * N * 4
    return _bound(flops, nbytes)


def _replaced_dispatch(torch, MOE, x, idx, gate, w_up, w_down):
    """The dropless E x T dispatch K7 replaced (C = T: a slot of every
    expert for every token), on K7's weight layout."""
    E, T = w_up.shape[0], x.shape[0]
    buf, meta = MOE._dispatch(x, idx, gate, E, T)
    h = torch.relu(torch.einsum("ecd,efd->ecf", buf, w_up)).square()
    out = torch.einsum("ecf,edf->ecd", h, w_down).reshape(E * T, -1)
    return MOE._combine(out, meta, T)


def _router_flips(torch, gen, cfg):
    """How often bf16 and float32 pick other experts: Nemotron-3-Nano's
    first two blocks (M, E) at full width on one 512-token prompt, the
    port's bf16 path against the float32 reference, through the router."""
    sys.path.insert(0, str(ROOT))
    from serve_bench.reference import common as RC
    from serve_bench.reference import nemotron_h as REF
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM
    m = json.loads((ROOT / "serve_bench" / "configs" /
                    f"{NANO}.json").read_text())["model"]
    m2 = dict(m, num_layers=2, block_pattern="ME")
    cfg2 = dataclasses.replace(cfg, num_layers=2, block_pattern="ME")
    w = REF.make_weights(m2, gen, torch.bfloat16, "cuda")
    toks = torch.randint(0, m["vocab_size"], (1, 512), generator=gen,
                         device="cuda")
    with torch.no_grad():
        h = w["embed"]["emb"][toks]
        lp0, lp1 = w["layers"]
        h = h + SSM.mamba_apply(lp0["mamba"], cfg2,
                                L.rmsnorm(lp0["norm"], h))
        idx, _ = MOE.route_sigmoid(lp1["moe"], cfg2,
                                   L.rmsnorm(lp1["norm"], h)[0])
        hf = RC.f32(w["embed"]["emb"][toks[0]])
        f0, f1 = RC.to_f32(lp0), RC.to_f32(lp1)
        hf = hf + REF._mamba(f0["mamba"], m2,
                             RC.rmsnorm(hf, f0["norm"]["scale"]), None)
        want, _ = REF.route(f1["moe"], m2, RC.rmsnorm(hf, f1["norm"]["scale"]))
    a = torch.sort(idx, -1).values
    b = torch.sort(want, -1).values
    k = idx.shape[1]
    pairs = sum(len(set(x) ^ set(y)) // 2 for x, y in
                zip(a.tolist(), b.tolist()))
    tokens = int((a != b).any(-1).sum())
    return pairs, tokens, idx.shape[0], k


def phase_nemotron(torch, card):
    """Nemotron-3-Nano-30B-A3B's kernels at the cell's shapes, each against
    its plain version: K5 in 8 groups of N 128, K7 at decode (8, 32, 64
    live lanes of 64) and at a 2,048-row prefill beside the E x T dispatch
    it replaced, K1 and K2 at 32 query heads on 2 KV heads (G = 16, D 128),
    and the router's choices in bf16 against float32."""
    say("== phase 15: nemotron-3-nano-30b-a3b kernels")
    errs, times = {}, {}
    say(f"  15 card memory {torch.cuda.get_device_properties(0).total_memory}"
        f" bytes card={card}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_experts as ME
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.models import moe as MOE
    cfg = get_config(NANO)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    H, P, N, G = 64, 64, 128, 8
    for S in (512, 2048):
        x = _rand(torch, gen, (1, H, S, P), bf)
        dt = torch.rand((1, H, S), generator=gen, device="cuda") * 0.2 + 1e-3
        A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
        Bm = _rand(torch, gen, (1, S, G, N), bf)
        Cm = _rand(torch, gen, (1, S, G, N), bf)
        y, fs = SS.ssd_scan(x, dt, A, Bm, Cm)
        wy, wfs = SS.ssd_scan_ref(x, dt, A, Bm, Cm)
        err = max((y.float() - wy.float()).abs().max().item(),
                  (fs - wfs).abs().max().item())
        ms = time_ms(torch, lambda: SS.ssd_scan(x, dt, A, Bm, Cm))
        plain = time_ms(torch, lambda: SS.ssd_scan_ref(x, dt, A, Bm, Cm),
                        calls=2, replays=3)
        bound, by = _ssd_group_bound(S, H, P, N, G, 128)
        say(f"  15a K5 groups bf16 H={H} P={P} N={N} G={G} S={S}: "
            f"max_abs_err {err:.3e}, {ms:.4f} ms (bound {bound:.5f} ms by "
            f"{by}, {bound / ms * 100:.1f}%), plain {plain:.4f} ms card={card}")
        if err > 5e-2 * max(1.0, wy.float().abs().max().item()):
            fail(f"phase 15a: K5 in groups disagrees at S={S}: {err}")
        if S == 512:
            errs[f"ssd_scan@{NANO}"] = err
            times[f"ssd_scan@{NANO}"] = {"ms": ms, "plain_ms": plain,
                                         "bound_ms": bound, "bound_by": by,
                                         "library_ms": None}
    E, k, d, f = 128, 6, cfg.d_model, cfg.d_ff
    w_up = (_rand(torch, gen, (E, f, d), torch.float32) * d ** -0.5).to(bf)
    w_down = (_rand(torch, gen, (E, d, f), torch.float32) * f ** -0.5).to(bf)
    router = {"router": {"w": (_rand(torch, gen, (d, E), torch.float32)
                               * d ** -0.5).to(bf)}}
    for T, n_live in ((64, 8), (64, 32), (64, 64), (2048, 2048)):
        x = _rand(torch, gen, (T, d), bf)
        live = torch.zeros(T, dtype=torch.bool, device="cuda")
        live[:n_live] = True
        idx, gate = MOE.route_sigmoid(router, cfg, x)
        r = ME.route_table(idx, gate, E, live)
        got = ME.moe_experts(x, w_up, w_down, r)
        want = ME.moe_experts_ref(x, w_up, w_down, r)
        err = ((got - want).abs().max() / want.abs().max()).item()
        rows, touched = int(r.offsets[-1]), int(ME.experts_touched(r))
        ms = time_ms(torch, lambda: ME.moe_experts(x, w_up, w_down, r))
        up = time_ms(torch, lambda: ME.moe_experts(x, w_up, w_down, r,
                                                   passes=1))
        down = time_ms(torch, lambda: ME.moe_experts(x, w_up, w_down, r,
                                                     passes=2))
        plain = _eager_ms(torch, lambda: ME.moe_experts_ref(x, w_up, w_down,
                                                            r), reps=3)
        reps = 3 if T > 64 else 10
        old = time_ms(torch, lambda: _replaced_dispatch(
            torch, MOE, x, idx, gate, w_up, w_down), calls=reps, replays=3)
        bound, by = _bound(4.0 * rows * d * f,
                           touched * 4.0 * d * f + rows * d * 6.0)
        say(f"  15b K7 T={T} live={n_live}: rows {rows}, experts {touched}, "
            f"err/max {err:.3e}, {ms:.4f} ms (up {up:.4f}, down {down:.4f};"
            f" bound {bound:.4f} ms by {by}, {bound / ms * 100:.1f}%), plain "
            f"{plain:.3f} ms, replaced E x T dispatch {old:.3f} ms "
            f"card={card}")
        if err > 2e-2 or rows != k * n_live:
            fail(f"phase 15b: K7 at T={T} live={n_live}: err {err}, rows "
                 f"{rows}")
        if (T, n_live) == (64, 32):          # the kernels line's K7 row
            errs["moe_experts"] = (got - want).abs().max().item()
            times["moe_experts"] = {"ms": ms, "plain_ms": plain,
                                    "bound_ms": bound, "bound_by": by,
                                    "library_ms": None}
    # the whole MoE layer (route, K7, the shared expert, the combine) at
    # the cell's decode, 22 live lanes of 64, against K7 alone
    lp = {"router": {"w": router["router"]["w"],
                     "bias": torch.zeros(E, device="cuda")},
          "w_up": w_up, "w_down": w_down,
          "shared": {"up": {"w": (_rand(torch, gen, (d, 3712), torch.float32)
                                  * d ** -0.5).to(bf)},
                     "down": {"w": (_rand(torch, gen, (3712, d),
                                          torch.float32)
                                    * 3712 ** -0.5).to(bf)}}}
    x = _rand(torch, gen, (64, 1, d), bf)
    live = torch.arange(64, device="cuda") < 22
    layer = time_ms(torch, lambda: MOE.moe_apply_sigmoid(lp, cfg, x,
                                                         live=live))
    idx, gate = MOE.route_sigmoid(lp, cfg, x[:, 0])
    r = ME.route_table(idx, gate, E, live)
    k7 = time_ms(torch, lambda: ME.moe_experts(x[:, 0], w_up, w_down, r))
    say(f"  15b MoE layer at decode, 22 live lanes of 64: {layer:.4f} ms, "
        f"of it K7 {k7:.4f} ms ({k7 / layer * 100:.1f}%) card={card}")
    q = _rand(torch, gen, (1, 32, 2048, 128), bf)
    kk = _rand(torch, gen, (1, 2, 2048, 128), bf)
    vv = _rand(torch, gen, (1, 2, 2048, 128), bf)
    err = (FA.flash_attention(q, kk, vv).float()
           - FA.flash_attention_ref(q, kk, vv).float()).abs().max().item()
    ms = time_ms(torch, lambda: FA.flash_attention(q, kk, vv))
    say(f"  15c K1 bf16 32/2 heads D 128 S 2048 causal: max_abs_err "
        f"{err:.3e}, {ms:.4f} ms card={card}")
    kc = _rand(torch, gen, (64, 2, 6144, 128), bf)
    vc = _rand(torch, gen, (64, 2, 6144, 128), bf)
    q1 = _rand(torch, gen, (64, 32, 1, 128), bf)
    kvl = torch.randint(1, 400, (64,), generator=gen, device="cuda",
                        dtype=torch.int32)
    err2 = (DA.decode_attention(q1, kc, vc, kvl).float()
            - DA.decode_attention_ref(q1, kc, vc, kvl).float()
            ).abs().max().item()
    ms2 = time_ms(torch, lambda: DA.decode_attention(q1, kc, vc, kvl))
    say(f"  15c K2 bf16 B 64 32/2 heads D 128 max_len 6144 kv_len < 400: "
        f"max_abs_err {err2:.3e}, {ms2:.4f} ms card={card}")
    if err > 2e-2 or err2 > 2e-2:
        fail(f"phase 15c: K1 / K2 at G = 16 disagree: {err}, {err2}")
    del kc, vc, w_up, w_down
    gc.collect()
    torch.cuda.empty_cache()
    pairs, tokens, T, k = _router_flips(torch, gen, cfg)
    say(f"  15d router bf16 vs float32 (blocks M, E at full width, one "
        f"512-token prompt): {pairs} of {T * k} (token, expert) choices "
        f"differ, in {tokens} of {T} tokens card={card}")
    gc.collect()
    torch.cuda.empty_cache()
    return _serve_nemotron(torch, card), errs, times


def _serve_nemotron(torch, card):
    """15e: the cell's path at full size (the benchmark's bf16 draw):
    FleetRouter, its two dense batchers (each padded prefill captured when
    they are made) and the engine's captured decode reading the live mask.
    After a warm-up (every decode shape captured) K7 and K5 count from 0
    over a mix of prompts across the buckets: K7 once a MoE block of each
    prefill and decode step (23 each), K5 once a Mamba block of each
    prefill, no capture more, and each decode tick's routed rows 23 x 6 x
    its live lanes. Returns the launches under the kernels-line names."""
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from serve_bench.reference import nemotron_h as REF
    from repro_torch.configs import get_config
    from repro_torch.core.systems import paper_fleet
    from repro_torch.kernels import moe_experts as ME
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.serving import trace
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.router import FleetRouter
    m = json.loads((ROOT / "serve_bench" / "configs" /
                    f"{NANO}.json").read_text())["model"]
    cfg = get_config(NANO)
    t0 = time.perf_counter()
    w = REF.make_weights(m, torch.Generator(device="cuda").manual_seed(SEED),
                         torch.bfloat16, "cuda")
    engine = InferenceEngine(cfg, w, max_len=512, dtype=torch.bfloat16,
                             device="cuda")
    eff, perf = paper_fleet()
    router = FleetRouter(cfg, {eff.name: eff, perf.name: perf},
                         {eff.name: engine, perf.name: engine},
                         policy="threshold", t_in=32, axis="in")
    router.attach_batchers(slots=8, paged=False)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)

    def serve(lengths, n):
        for mm in lengths:
            router.submit(rng.integers(0, cfg.vocab_size, mm,
                                       dtype=np.int32), n)
        router.drain()

    serve((8, 40), 3)                            # warm-up: decode captured
    captures = engine.graphs.captures
    ME.moe_experts.launches = SS.ssd_scan.launches = 0
    trace.TICKS.clear()
    t1 = time.perf_counter()
    serve((5, 17, 30, 33, 64, 100, 250, 12, 9, 300), 6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    ticks = list(trace.TICKS)
    decodes = [t for t in ticks if t.decode_lanes]
    admitted = sum(t.admitted for t in ticks)
    n_e, n_m = cfg.blocks("E"), cfg.blocks("M")
    k7, k5 = ME.moe_experts.launches, SS.ssd_scan.launches
    bad = [t for t in decodes if t.routed_rows != n_e * 6 * t.decode_lanes]
    say(f"  15e served at full size through FleetRouter, 2 dense pools of 8 "
        f"lanes, max_len 512: built in {made:.2f} s ({engine.graphs.captures}"
        f" captures after the warm-up, {captures} before the count); "
        f"{admitted} prefills, {len(decodes)} decode steps in {wall:.3f} s;"
        f" K7 {k7} launches ({n_e} x {admitted + len(decodes)} expected), "
        f"K5 {k5} ({n_m} x {admitted}); decode ticks with routed rows != "
        f"{n_e} x 6 x lanes: {len(bad)} card={card}")
    if engine.graphs.captures != captures:
        fail("phase 15e: a step was captured after the warm-up")
    if k7 != n_e * (admitted + len(decodes)) or k5 != n_m * admitted or bad:
        fail(f"phase 15e: K7 {k7}, K5 {k5} launches for {admitted} prefills "
             f"and {len(decodes)} decode steps; {len(bad)} ticks off")
    del w, engine, router
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe_experts": k7, f"ssd_scan@{NANO}": k5}


def _nemotron_rows(launches, errs, times):
    """The kernels-line rows of phase 15: K7 (at the decode of 64 lanes, 32
    live) and K5 in groups (S 512), launches from 15e's served mix."""
    sources = {"moe_experts": (
        "src/repro_torch/csrc/moe_experts.cu",
        "none: the JAX package computes its MoE FFN as one product over an "
        "(experts, capacity) buffer (src/repro/models/moe.py)"),
        f"ssd_scan@{NANO}": ("src/repro_torch/csrc/ssm_scan.cu",
                             "src/repro/kernels/ssm_scan.py:73")}
    return [{"name": k, "route": "cuda", "source": sources[k][0],
             "replaces": sources[k][1], "launches": launches[k],
             "max_abs_err": errs[k], **times[k]} for k in sources]


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    t0 = time.perf_counter()
    name, count, card = phase_device(torch)
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import autotune as AT
    phase_build()
    if sys.argv[1:] == ["--phase", "15"]:     # phase 15 alone
        launches, errs, times = phase_nemotron(torch, card)
        say(json.dumps({"kernels": _nemotron_rows(launches, errs, times)}))
        say(json.dumps({"ok": True, "phase": 15}))
        return
    if sys.argv[1:3] == ["--phase", "k3"]:    # K3 at the serving shapes
        say("== phase 3s: K3 at the mistral7b cells' decode shapes")
        parent = None
        if sys.argv[3:4] == ["--parent"]:
            parent = parent_library(Path(sys.argv[4]).resolve())
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = k3_serving(torch, gen, parent)
        rows.update(decode_table_rows(torch, gen, parent))
        say(json.dumps({"k3_serving": rows}))
        say(json.dumps({"ok": True, "phase": "k3"}))
        return
    errs, times = phase_kernels(torch)
    bwd_worst, train_times = phase_kernels_train(torch)
    phase_autotune(torch, card)
    phase_parity(torch)
    phase_parity_ssm(torch)
    phase_parity_int8(torch)
    phase_parity_families(torch)
    phase_train_parity(torch)
    launches, bf16_tokens = phase_serve(torch, card)
    launches.update(phase_serve_ssm(torch, card))
    int8 = phase_serve_int8(torch, card, bf16_tokens)
    launches["paged_decode_attention_int8"] = \
        int8["paged_decode_attention_int8"]
    phase_disagg_migration(torch)
    phase_disagg_parity(torch)
    phase_disagg_serve(torch, card)
    launches.update(phase_serve_families(torch, card))
    nano_launches, nano_errs, nano_times = phase_nemotron(torch, card)
    launches.update(phase_train(torch, card))
    phase_dryrun(torch, card)
    phase_dryrun_cost(torch, card)
    phase_graphs(torch, card)
    phase_price(torch, card)
    for kname in ("flash_attention_bwd", f"flash_attention_bwd@{ZAMBA}",
                  "ssd_scan_bwd", f"ssd_scan_bwd@{ZAMBA}"):
        errs[kname] = bwd_worst[kname]
    for kname in (f"flash_attention@{SMOLLM}",
                  f"flash_attention@{ZAMBA}-train",
                  "ssd_scan@mamba2-130m-train", f"ssd_scan@{ZAMBA}-train"):
        errs[kname] = train_times[kname]["err"]
    times.update(train_times)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:98"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:328"),
               "paged_decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:261"),
               "paged_decode_attention_int8": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:195"),
               "ssd_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:73"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:98 (its gradient; "
                   "no Pallas counterpart)"),
               "ssd_scan_bwd": (
                   "src/repro_torch/csrc/ssm_scan_bwd.cu",
                   "src/repro/kernels/ssm_scan.py:73 (its gradient; no "
                   "Pallas counterpart)"),
               "paged_chunk_attention": (
                   "src/repro_torch/csrc/chunk_attention.cu",
                   "none: the JAX package attends a prefill chunk on its "
                   "plain path (src/repro/models/attention.py:162)")}
    rows = []
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention", "paged_decode_attention_int8",
                  "ssd_scan", f"ssd_scan@{ZAMBA}",
                  f"flash_attention@{ZAMBA}", f"decode_attention@{ZAMBA}",
                  f"flash_attention@{WHISPER}", f"flash_attention@{QWEN}",
                  f"flash_attention@{PHI}", f"decode_attention@{QWEN}",
                  f"decode_attention@{WHISPER}",
                  f"paged_decode_attention@{PHI}", "paged_chunk_attention",
                  "flash_attention_bwd",
                  f"flash_attention@{SMOLLM}", f"flash_attention_bwd@{ZAMBA}",
                  f"flash_attention@{ZAMBA}-train", "ssd_scan_bwd",
                  f"ssd_scan_bwd@{ZAMBA}", "ssd_scan@mamba2-130m-train",
                  f"ssd_scan@{ZAMBA}-train"):
        src, replaces = sources[kname.split("@")[0]]
        t = times[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    rows += _nemotron_rows(nano_launches, nano_errs, nano_times)
    if AT.installed() is not None:
        fail("an autotune cache is still installed at the end")
    say(f"total_s={time.perf_counter() - t0:.2f} card={card}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
