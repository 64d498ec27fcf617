#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (one process per source, all started together), then:

1. Holds the SpMM kernels against the plain COO product and their plain
   PyTorch versions at the kernel tests' small shapes (balanced, naive,
   blocked with evil rows, row-reordered).
1b. Holds the flash-attention kernel against its plain version over the JAX
   kernel tests' sweep (GQA, Sq < Sk, ragged tiles, causal on and off,
   windows 8 and 24, bf16), at D 64, 128 and 256 with S 1000, and at lengths
   that cut its query tiles and its cp.async ring at every edge (1, 15, 17,
   63, 65, 129, 1000; Sq < Sk with windows; every D; GQA groups 1, 2, 7 and
   10), and with Sq > Sk (cross-attention), where only the rows that see a
   key are compared: causal rows before the first key are defined by no
   version. bf16 at D 256 runs the wgmma kernel
   (``flash_attention_wgmma.cu``), everything else the mma.sync kernel;
   each D 256 case is also called twice and must give the same bits, and in
   bf16 each of its output rows is held to ``ATTN_BF16_ROW_TOL`` of the
   row's RMS, as phase 5 holds the prefill shape.
2. Serves 3 batches of 4 requests on the full-width ``reddit`` graph
   (232,965 nodes, 602 features, hidden 128, 41 classes) through the port's
   GCN path — ``registry.get_executor`` → ``ScheduleExecutor.forward_batch``
   — with the SpMM launch counts reset just before and read just after, and
   holds every request's logits against the plain COO forward. Then serves
   the same batches in turn for ``STEADY_S`` seconds: steady throughput is
   all of that window's requests over its whole time.
3. Holds each SpMM kernel against its plain version at the GCN path's
   shapes (and ``spmm_balanced`` against itself: two calls, bit-equal) and
   times kernel, plain version, ``spmm_balanced`` end to end and
   ``torch.sparse.mm`` on the CSR adjacency (a yardstick the port never
   calls) with CUDA events, in turns; times the window kernel under a few
   other lane mappings beside the one it picks. Records the schedule's
   geometry as the window kernel meets it (windows, evil chunks, padding,
   row runs).
4. Serves qwen2-0.5b at full width (24 layers, d_model 896, vocab 151,936;
   seeded random weights, f32) through ``ServeEngine.generate``: 4 prompts of
   2048, 1536, 1024 and 512 seeded random tokens (left-padded to 2048),
   ``max_seq`` 2080, 32 new tokens; a warm-up run, then a timed run with the
   attention launch count reset just before and read just after (one launch
   per layer's prefill). Holds the prefill and every decode step's logits
   (teacher-forced on the same tokens) against the same engine with the
   plain attention, and the tokens wherever the plain path's top two logits
   are further apart than the tolerance.
5. Times the flash kernel, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the prefill's shape: B 4, S 2048, H 14, Hkv 2, D 64, causal, f32; then
   the kernel and ``scaled_dot_product_attention`` in bf16 at that shape.
   In bf16 it also holds every output row to ``ATTN_BF16_ROW_TOL``: the
   row's RMS error over its RMS. Its bounds: the tensor-core bound of the
   arithmetic the path issues (3xTF32 in f32, bf16), the CUDA-core f32
   bound, the softmax's exponentials at 16 ex2 per SM per clock, and HBM.
6. Serves reddit through ``GCNServingEngine`` on a fresh tuning store under
   ``build/``: a cold ``add_graph`` runs the default measured sweep on the
   card (launch counts reset just before and read after the whole phase),
   12 requests built as in phase 2 are submitted with deadlines and held
   against the plain COO forward, then the engine serves for ``STEADY_S``
   seconds. A second engine on the same store, after the in-process caches
   are cleared, must warm-start with zero sweeps and zero schedule builds
   and serve bit-equal logits; with a budget of reddit's footprint, adding
   ``pubmed`` evicts reddit, and serving reddit again re-admits it with no
   rebuild and equal logits.
6b. Holds the SpMM kernels' bf16-accumulate variant, which phase 6 ran in
   the sweep's error report, against its plain version bit for bit (the
   same rounding sequence in the same order), on the sweep winner's
   schedule through the report's twin executor: at the tuning probe's
   width on the report's own operand, and at kdim 512. Both lie within the
   JAX package's loose 0.1 of the f32 product, the result differs from
   the f32 kernel's (at the probe by the report's ``bf16_max_err``
   exactly), two calls are bit-equal, and an f32 B and the same values in
   bf16 give the same bits. First the card's exhaustive check that the
   kernels' packed ``mul.rn.bf16x2``/``add.rn.bf16x2`` round as the plain
   versions' f32 sequence over all 2^32 pairs of bf16 patterns (0
   mismatches for each). Times the window (its cast of B to bf16 included)
   beside the f32 kernel (f32, bf16-acc, bf16-acc, f32), the cast alone,
   the window on the bf16 operand under ``BF16ACC_LANE_SWEEP``'s lane
   mappings beside the one it picks, its plain version and
   ``torch.sparse.mm`` on bf16 operands (a yardstick that accumulates
   differently); the epilogue beside the f32 one, its plain version and
   ``index_add_`` of the kept bf16 partials into a bf16 output.
7. Streams edge updates into reddit through ``GCNServingEngine.update_graph``
   (launch counts reset just before and read after the whole phase), on an
   engine that warm-starts from phase 6's store (zero sweeps, zero builds).
   The traffic is the JAX package's streaming suite's: deltas of 16 edges
   from numpy seed 4321, value-only (existing edges re-weighted) or
   structural (random inserts). 4 warm-up and 16 timed value updates, each
   after the previous revision's persist has drained, must all take the
   value lane with a scoped upload; then 8 updates alternating value and
   structural deltas while a background thread serves a request throughout
   (no failure allowed), and the old executor's arrays must be unchanged by
   the swaps; then one structural delta of 4,096 edges, replayed through
   ``repaired_executor`` alone and beside a cold ``ScheduleExecutor`` on the
   same repaired schedule (their uploads ``torch.equal``). 4 requests' logits
   after the chain must equal a one-candidate engine's cold admission of the
   final graph bit for bit and lie within tolerance of the plain COO forward
   on it; the engine's allocation must match its accounting as in phase 6.
   After ``drain_persists`` a restarted engine admits the mutated graph warm
   (zero sweeps, zero builds) with bit-equal logits. On pubmed, an engine
   with ``repair_drift_threshold=1e-9`` re-tunes on its first update, within
   tolerance of the plain forward.
8. Trains the GCN on reddit through ``spmm_cuda.make_spmm_fn`` (the kernels
   on A's schedule forward and on Aᵀ's backward; both built and uploaded, and
   timed, first), from phase 2's weights on the dataset's teacher labels.
   The loss's gradients through the kernels are held against the same
   function with the kernels' plain versions and against autograd through
   the plain COO product. Then ``TRAIN_STEPS`` AdamW steps
   (``TRAIN_ADAMW``, f32 working weights) through the kernels, with launch
   counts reset just before and read after: every step launches each kernel
   twice forward and twice backward, plans and uploads no schedule after
   step 1, and the loss falls; the same steps through the COO product stay
   within the f32 tolerance of it, step by step. The state at step
   ``TRAIN_SAVE_AT`` is saved by the async ``CheckpointManager`` under
   ``build/``, restored onto the card into a fresh template, and the resumed
   steps must reproduce the uninterrupted run's losses and state bit for
   bit; a second restore must give back the saved arrays. Times the steps
   (forward, backward, optimizer), the COO steps, and the two kernels on
   Aᵀ at the backward's widths (128, 41) beside their plain versions and
   ``torch.sparse.mm`` on Aᵀ in CSR (a yardstick the port never calls).
9a. Runs ``ShardedScheduleExecutor`` on phase 2's reddit schedule over
   ``MESH_SIZES`` (2 and 4) mesh positions, round robin over the visible
   cards: on one card every position names it (``["cuda:0"] * D``; the card
   runs the positions one after another, so this measures the sharded
   path's cost, not scaling). Per mesh: the shards'
   step counts (max − min ≤ 1), non-zeros and live slots; its allocation
   against ``device_bytes``; ``forward_batch`` on phase 2's first 4 requests
   (kdim 512, then 164) with launch counts reset just before and read just
   after — 2·D window and 2·D epilogue launches — held against phase 2's
   single-device logits and the COO forward, two calls bit-equal; the batch
   and the SpMM at both widths timed beside the single-device executor,
   with one partial add timed and the partials' bytes at HBM rate.
9b. Serves through ``GCNServingEngine`` on 4 such positions
   (``devices=["cuda:0"] * 4`` on one card) with a
   one-candidate sweep and a per-position budget of a quarter of reddit's
   estimate, so reddit takes the sharded route (launch counts reset just
   before and read after the phase): a cold admission, 4 requests against
   the single-device executor, a warm restart with bit-equal logits;
   pubmed and cora at their published sizes on single positions, pubmed
   made hot until it holds 3 replicas whose logits equal a ``max_replicas=1``
   engine's bit for bit; an injected ``replica_chunk`` fault retried on a
   sibling (0 request failures); a 16-edge value and a 16-edge structural
   delta into sharded reddit and a value delta into replicated pubmed, each
   graph then bit-equal to a cold admission of its final graph.
10. Serves two MoE models (``attn_moe``: capacity dispatch, AWB placement)
   through ``ServeEngine.generate`` with phase 4's prompt lengths,
   ``max_seq`` and new tokens, seeded random f32 weights:
   granite-moe-3b-a800m at full width and depth (32 layers, d_model 1536,
   40 experts top-8), then qwen3-moe-30b-a3b at its published widths with
   the depth cut to ``MOE_CUT_LAYERS`` of 48 (48 f32 layers do not fit the
   card). Per model: a warm-up, a timed run with the flash launch count
   reset just before and read just after (one launch per layer, all in the
   prefill), and ``torch.profiler`` device splits of the prefill and a
   decode step by part (the MoE's ranges: router, dispatch, experts,
   combine; the flash kernel; other matrix products; the rest). The check
   against the plain attention is layer by layer, teacher-forced on the
   kernel path's hidden states: attention at the attention tolerance; an
   expert set may differ only where the k-th and (k+1)-th router
   probabilities lie within ``MOE_TIE``, a keep only in an expert whose
   arrivals such a choice changed; the MoE outputs of the agreeing tokens
   at the f32 tolerance. End to end, the logits of a teacher-forced run of
   each engine (every routing decision recorded) must agree within the LM
   tolerance when no decision differed. On granite, the AWB placement of
   the worst layer's own router histogram (``MOE_DEVICES`` devices,
   ``MOE_SLOTS_PER_DEVICE`` slots each) must give the identity placement's
   output dropless; static and AWB imbalances for every layer. Times the
   flash kernel beside its plain version and
   ``scaled_dot_product_attention`` at both models' prefill shapes.
11. Serves whisper-tiny (``enc`` and ``xattn`` layers) at full width and
   depth (4 encoder and 4 decoder layers, d_model 384, 6 heads, D 64, vocab
   51,865; seeded random f32 weights) through ``ServeEngine.run`` with
   ``source_embed``: 4 seeded ``[1500, 384]`` frame embeddings, prompts of 4
   seeded tokens, ``max_seq`` 448 (the decoder's published context), 64 new
   tokens. A warm-up, then a timed run with the flash launch count reset
   just before and read just after: 4 encoder, 4 self- and 4
   cross-attention launches in the prefill, then 4 cross-attention launches
   a decode step. ``torch.profiler`` device splits of the prefill and a
   decode step (flash, dense, ``rglru.scan``/``rglru.conv``, the rest, and
   the host's idle share); the logits of a teacher-forced run against the
   plain-attention engine at the LM tolerance. Times the flash kernel, its
   plain version and ``scaled_dot_product_attention`` at the encoder's shape
   (B 4, S 1500, H 6, D 64, non-causal) and at a decode step's
   cross-attention (Sq 1, Sk 1500).
12. The same for recurrentgemma-2b (``rglru`` and ``local`` layers,
   ``(rglru, rglru, local) × 8 + (rglru, rglru)``) at full width and depth
   (26 layers, d_model 2560, 10 heads on 1 KV head, D 256, window 2048,
   vocab 256,000; 14.2 GB of f32 weights) with phase 4's prompts,
   ``max_seq`` 2080 and 32 new tokens: 8 flash launches, all in the
   prefill; decode at positions 2048–2078 wraps the local layers' ring of
   2048 slots. Then one prefill of the same prompts in bf16
   (``transformer.prefill``, ``compute_dtype`` bf16) with the wgmma kernel's
   launch count reset just before and read just after: its 8 local layers
   run the wgmma kernel (the f32 prefill's logits beside it, reported).
   Times the flash kernel at D 256 (B 4, S 2048, H 10, Hkv 1, causal,
   window 2048) in f32 (mma.sync, 3xTF32) and the wgmma kernel in bf16,
   each beside its plain version, its bound and
   ``scaled_dot_product_attention``.
13. The same for rwkv6-3b (``rwkv`` layers: TimeMix with the chunked wkv
   scan, ChannelMix) at full width and depth (32 layers, d_model 2560, 40
   heads of 64, d_ff 8,960, vocab 65,536; 12.4 GB of f32 weights) with
   phase 4's prompts, ``max_seq`` 2080 and 32 new tokens: no attention, so
   no flash launch; device splits by the ``rwkv.wkv`` and ``rwkv.ddlerp``
   ranges. The checks: every wkv call of a prefill on the kernel path, on
   the inputs its layer gives it, held against the sequential scan (its
   plain version) at the f32 tolerance, outputs and states; end to end,
   the teacher-forced logits of the served engine and of the plain engine
   (the sequential wkv) against a float64 run of the plain engine, prompt
   by prompt. A prompt on which the plain engine lies within the LM
   tolerance of the float64 run holds the served engine to the plain one
   and to the float64 run at the LM tolerance. The f32 model is
   ill-conditioned on long runs of pad tokens (the prompts are left-padded
   with token 0, as in the JAX package; ``tests/test_torch_rwkv6.py``
   shows the JAX package's own f32 forward drifting from its x64 run
   there): a prompt on which the plain engine lies farther than the LM
   tolerance from the float64 run holds the served engine to the float64
   run within twice the plain engine's distance, capped at
   ``RWKV_F64_CAP`` times the LM tolerance. Times the wkv alone at the
   prefill's shape for each of ``WKV_CHUNKS`` beside the sequential scan,
   each held to it.
14. Trains qwen2-0.5b at full width and depth through
   ``launch/steps.make_train_step``: bf16 working weights, f32 master,
   remat on, ``TokenPipeline`` batches of 4 × 2048 (seed 0), AdamW at lr
   1e-3 with 10 warm-up steps. Step 1 through the flash kernel
   (``_FlashAttention``: the kernel's forward, the VJP in torch ops) is held
   against the same step with the plain attention under autograd (loss,
   global grad norm, every grad leaf, each within 4× the plain path's own
   bf16 error against f32 plus 2^-9 of its scale); one ``train_step`` call
   is split by device time under ``torch.profiler`` (``lm_step_split``).
   Then 20 steps, with the flash launch count reset
   before and read after each (2 a layer: the forward and remat's
   recompute), the loss falling; the state at step 10 is checkpointed under
   ``build/``, restored onto the card and resumed, and steps 11–20 must
   reproduce the uninterrupted run's losses and state bit for bit. Times
   the flash kernel at the step's shape in bf16 and its backward
   (``attention_vjp``) in bf16 and f32 beside
   ``scaled_dot_product_attention``'s forward and backward.
15. Runs the step factories on a 2 × 2 ``("data", "model")`` mesh
   (``MESH_STEP_SHAPE``; ``launch.mesh.Mesh`` over ``mesh_of``'s positions,
   all on one card when there is one: the positions run one after another,
   so this measures the sharded steps' cost, not scaling), after phase 14's
   state is freed. (a) ``launch.steps.make_gcn_step`` on phase 2's reddit
   (its published widths; the schedule with one column block, since the
   nine-array form reads ``lcol`` as the global column) against phase 2's
   single-device forward at the f32 tolerance, with the SpMM launch counts
   reset just before and read after: each data position's step range runs
   the window and the epilogue kernel once a layer (2 × 2 × 2); the kernels
   held and timed on data position 0's range beside their plain versions
   and ``torch.sparse.mm`` on that range's entries. (b)
   ``make_train_step`` on qwen2-0.5b at full width and depth with phase
   14's batches for ``MESH_TRAIN_STEPS`` steps (parameters and optimizer
   state stored by ``partition``'s specs: each position's bytes must equal
   its specs' local shards, and the card's allocation the shards' within
   5 %): step 1's loss and global grad norm against phase 14's
   single-device step within phase 14's bf16 tolerance, the loss falling,
   the flash kernel launched once per model position on its head slice (7
   heads on 1 KV head), twice a layer with remat: 192 launches a step. (c)
   The mesh prefill and decode (``spmd.prefill``, ``spmd.decode_step``) on
   phase 4's prompts (f32) and ``MESH_DECODE`` teacher-forced tokens, with
   and without ``seq_shard_kv``, against the single-device engine at the LM
   tolerance; 24 × 4 flash launches in each prefill; then
   ``make_prefill_step`` and ``make_decode_step``, which run them in bf16,
   for a prefill and a decode step (finite logits, 96 flash launches, their
   logs of collectives; the error against the f32 engine is reported). (d)
   The dry-run's
   ``qwen2-0.5b train_4k`` and ``gcn-reddit`` cells on the 16 × 16
   production mesh (meta device), printed. (e) granite-moe-3b-a800m at full
   width and depth through ``spmd.prefill`` on phase 4's prompts (f32),
   routing every MoE layer over the whole batch, against the single
   device's ``transformer.prefill``: the logits at the LM tolerance, and
   kept/routed on both sides; 32 × 4 flash launches. Then layer by layer,
   teacher-forced (two f32 paths part at near ties, and a flipped choice
   changes later layers' inputs): the data positions' routings joined in
   order against ``moe.route`` on one device over the same joined tokens:
   expert sets may differ only at a near tie of the k-th and (k+1)-th
   probabilities (1e-5), a keep only in an expert whose arrivals those
   changed (phase 10's rule); where no set differs, every (token, expert)
   choice is kept on both sides or on neither (a near tie inside a token's
   top k may order its choices differently, which moves no arrival rank).
16. Runs the port's four examples on the card, in process, through each
   one's ``main(argv)`` with no arguments (``EXAMPLES``; their output goes
   to standard error): ``quickstart_torch`` (cora at scale 2: profile,
   autotuner, schedules, ``spmm_cuda.spmm_balanced`` against the COO
   product, the executor, a tuning-store warm restart),
   ``serve_gcn_torch`` (two GCNs trained through ``make_spmm_fn``, cold
   and warm admission, batched and deadline serving, a hot graph
   replicated over two positions of the card), ``train_lm_torch``
   (reduced qwen2-0.5b, 60 steps, the loss must drop by 0.1) and
   ``moe_rebalance_torch``. Each example asserts its own results; any
   failure fails the run. The SpMM and flash launch counts are reset just
   before and read just after each example: quickstart and serve_gcn must
   launch the SpMM kernels, train_lm the flash kernel.

Float32 matmuls and cuDNN run without TF32 (both flags are set False), so
every float32 product is full float32. Tolerances, each scaled by
max(1, |gold|max): SpMM 1e-4 (f32) and 3e-2 (bf16), attention 2e-5 (f32)
and 5e-2 (bf16, unscaled) — the JAX package's kernel test tolerances — and
LM logits 2e-3, its decode-vs-forward tolerance.

Prints the SpMM kernels' registers and spills (``-Xptxas -v``; for the
bf16-accumulate kernels their SASS count of packed bf16 multiplies and adds;
it fails if one spills or a bf16-accumulate kernel issues none) and the
window kernel's lane mapping per kdim, the flash kernel's registers, spills,
shared bytes and SASS ``HMMA`` (mma.sync) or ``HGMMA`` (wgmma) count per
instantiation (``flash_registers``; it fails if one spills or issues
neither), a ``{"kernels": [...]}``
line, a ``{"serving": ...}`` line, a ``{"lm_serving": ...}`` line, the
window kernel's all-gathers-miss bound per kdim, the flash kernel's bounds
(``flash_bounds``), an ``{"engine_serving": ...}`` line, an
``{"engine_streaming": ...}`` line, a ``{"gcn_training": ...}`` line (the
kernels line names phase 8's Aᵀ entries ``...@AT``; its f32 SpMM entries
carry their launches per sharded ``forward_batch``), a
``{"mesh_executor": ...}`` and an ``{"engine_mesh": ...}`` line, a
``{"moe_serving": ...}`` line (the kernels line names phase 10's flash
entries ``flash_attention@<arch>``), ``{"whisper_serving": ...}`` and
``{"recurrentgemma_serving": ...}`` lines (phases 11 and 12; their flash
entries ``flash_attention@whisper-tiny``,
``flash_attention@recurrentgemma-2b`` and
``flash_attention_wgmma@recurrentgemma-2b``), ``{"rwkv_serving": ...}`` and
``{"lm_training": ...}`` lines (phases 13 and 14; the latter's flash entry
``flash_attention@lm-training``), a ``{"mesh_steps": ...}`` line (phase 15;
its kernels entries ``spmm_balanced@mesh``, ``spmm_epilogue@mesh`` and
``flash_attention@mesh-train``), an ``{"examples": ...}`` line (phase 16:
each example's wall seconds and launch counts), the card's name and power
limit, and
as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate, non-tensor-core float32 rate, dense
# tensor-core TF32 and bf16 rates, and the SFU's ex2 per SM per clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
EX2_PER_SM_CLOCK = 16
REPLACES = {
    "spmm_balanced": "src/repro/kernels/spmm_pallas.py:54",
    "spmm_epilogue": "src/repro/core/schedule.py:898",
    # the executor's bf16_accumulate option (not in the Pallas kernel): its
    # gather routing's bf16 multiply and its bf16 scatter-add
    "spmm_balanced_bf16acc": "src/repro/core/executor.py:666",
    "spmm_epilogue_bf16acc": "src/repro/core/executor.py:679",
}
#: the f32 SpMM kernels phase 2 drives; the bf16-accumulate variant runs in
#: phase 6 (the sweep's error report)
F32_SPMM = ("spmm_balanced", "spmm_epilogue")
#: the bf16-accumulate variant's wide check beside the tuning probe's width,
#: and the window's lane mappings timed beside the one it picks: (vec,
#: lanes a step, vectors a lane) on reddit's bf16 B (1-line panels, one
#: pass, 4-line panels)
BF16ACC_WIDE = 512
BF16ACC_LANE_SWEEP = {128: [(8, 8, 1), (8, 16, 1)],
                      512: [(8, 8, 1), (8, 16, 2), (8, 8, 4)]}
#: phase 6: the engine's batch bound, the requests' deadline, and the graph
#: the eviction round trip adds beside reddit
ENGINE_MAX_BATCH, ENGINE_DEADLINE_S, EVICT_GRAPH = 4, 0.25, "pubmed"
BATCHES, BATCH_SIZE, KEEP, STEADY_S = 3, 4, 0.9, 2.0
#: phase 7: edges a delta, the deltas' numpy seed (the JAX package's
#: streaming suite's), warm-up and timed value updates, the alternating
#: chain under concurrent serving, the wide delta's edges, the drift graph
STREAM_EDGES, STREAM_SEED, STREAM_WARMUP, STREAM_TIMED = 16, 4321, 4, 16
STREAM_CHAIN, STREAM_WIDE, DRIFT_GRAPH = 8, 4096, "pubmed"
#: phase 9: the sharded executor's mesh sizes (positions on the one card),
#: the mesh engine's positions, its graphs beside reddit (the first one hot)
#: and the hot graph's requests per poll
MESH_SIZES, MESH_ENGINE_POSITIONS = (2, 4), 4
MESH_SMALL, MESH_HOT_REQUESTS = ("pubmed", "cora"), 12
#: phase 8: AdamW steps through the kernels (and through the COO product),
#: the step whose state is checkpointed and resumed from, and the optimizer's
#: settings (the JAX package's GCN training test's)
TRAIN_STEPS, TRAIN_SAVE_AT = 20, 10
TRAIN_ADAMW = dict(lr=0.05, warmup_steps=5, total_steps=60, weight_decay=0.0)
# the window kernel's lane mappings timed beside the one it picks, per kdim:
# (vec, lanes a step, vectors a lane); reddit's B of f32 rows
LANE_SWEEP = {512: [(4, 16, 1), (4, 32, 1), (4, 32, 4)],
              164: [(4, 8, 3), (4, 32, 2), (4, 16, 1)],
              128: [(4, 16, 1), (4, 32, 1)], 41: [(1, 32, 2), (1, 8, 3)]}
# LM serving: qwen2-0.5b prompts, cache length, new tokens, logits tolerance
LM_ARCH, LM_PROMPTS, LM_MAX_SEQ, LM_NEW, LM_TOL = (
    "qwen2-0.5b", (2048, 1536, 1024, 512), 2080, 32, 2e-3)
# MoE serving (phase 10): granite-moe at full width and depth, qwen3-moe at
# its published widths with the depth cut; 10c's devices and slots a device
# for the AWB placement (48 slots over 40 experts: 8 spare for replicas);
# router probabilities closer than MOE_TIE at the k-th choice are a near
# tie; the parts of the MoE device split
MOE_ARCH, MOE_CUT_ARCH, MOE_CUT_LAYERS = "granite-moe-3b-a800m", "qwen3-moe-30b-a3b", 8
MOE_DEVICES, MOE_SLOTS_PER_DEVICE, MOE_TIE = 4, 12, 1e-5
MOE_PARTS = ("router", "dispatch", "experts", "combine", "flash_attention", "dense",
             "other")
# phase 11: whisper-tiny's prompts (4 tokens each), the decoder's published
# context as the cache length, and new tokens; phase 12: recurrentgemma-2b
# with phase 4's prompts, cache length and new tokens; their device split's parts
WHISPER_ARCH, WHISPER_PROMPTS, WHISPER_MAX_SEQ, WHISPER_NEW = (
    "whisper-tiny", (4, 4, 4, 4), 448, 64)
RG_ARCH = "recurrentgemma-2b"
LM_PARTS = ("flash_attention", "dense", "rglru.scan", "rglru.conv", "rwkv.wkv",
            "rwkv.ddlerp", "other")
# phase 13: rwkv6-3b with phase 4's traffic, and the wkv's chunk sizes timed
# at its prefill shape; phase 14: qwen2-0.5b training (LM_ARCH) on batches
# of TRAIN_LM_BATCH × TRAIN_LM_SEQ tokens (TokenPipeline, seed 0), AdamW at
# TRAIN_LM_ADAMW for TRAIN_LM_STEPS steps, checkpointed at TRAIN_LM_SAVE_AT
# and resumed from it; its step time is the median over the steps from
# TRAIN_LM_TIMED_FROM on. RWKV_F64_CAP: on a prompt where f32 is
# ill-conditioned, the served engine's distance from the float64 run may
# reach twice the plain engine's, but never this many LM tolerances
RWKV_ARCH, WKV_CHUNKS, RWKV_F64_CAP = "rwkv6-3b", (4, 8, 16), 5.0
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_STEPS, TRAIN_LM_SAVE_AT = 4, 2048, 20, 10
TRAIN_LM_ADAMW = dict(lr=1e-3, warmup_steps=10, total_steps=20)
TRAIN_LM_TIMED_FROM = 3
# the training step's profiler ranges (launch/steps, _FlashAttention) and
# the parts of its device split
TRAIN_SPANS = {"train.forward": "forward", "train.cross_entropy": "cross_entropy",
               "train.backward": "backward", "attention.vjp": "flash_backward",
               "train.optimizer": "optimizer"}
TRAIN_PARTS = ("forward", "flash_forward", "cross_entropy", "backward", "flash_backward",
               "optimizer", "other")
# phase 15: the step factories on a (data, model) mesh over mesh_of's
# positions: phase 14's training for MESH_TRAIN_STEPS steps, phase 4's
# prompts with MESH_DECODE teacher-forced decode steps, and the dry-run's
# MESH_DRYRUN cells on the 16 × 16 production mesh
MESH_STEP_SHAPE, MESH_TRAIN_STEPS, MESH_DECODE = (2, 2), 5, 8
MESH_DRYRUN = (("qwen2-0.5b", "train_4k"), ("gcn-reddit", "train_4k"))
#: phase 16: the port's examples (``examples/<name>.py``), and the kernel
#: family each must launch
EXAMPLES = {"quickstart_torch": "spmm", "serve_gcn_torch": "spmm",
            "train_lm_torch": "flash", "moe_rebalance_torch": None}
# the flash kernel's checks: (b, sq, sk, h, hkv, d), the JAX kernel tests'
# shapes then the configs' head widths at a length no tile divides
ATTN_SHAPES = [(2, 32, 32, 4, 4, 16), (1, 48, 48, 8, 2, 32), (2, 16, 64, 4, 1, 16),
               (1, 40, 40, 2, 2, 16), (2, 1000, 1000, 4, 2, 64),
               (2, 1000, 1000, 4, 1, 128),
               # lengths that cut the query tiles and the kv ring at every
               # edge, every head width, GQA groups 1, 2 and 7 (qwen2-0.5b's)
               (1, 1, 1, 2, 2, 64), (2, 15, 15, 7, 1, 32), (1, 17, 17, 14, 2, 64),
               (1, 63, 63, 4, 2, 128), (1, 65, 65, 2, 1, 16), (2, 129, 129, 2, 2, 32),
               (1, 129, 129, 14, 2, 64), (1, 15, 63, 2, 2, 16), (1, 1, 129, 4, 2, 64),
               (1, 65, 1000, 4, 2, 32), (1, 17, 1000, 7, 1, 128),
               (1, 129, 1000, 14, 2, 16),
               # head width 256 (recurrentgemma-2b's local layers): MQA with
               # group 10, ragged 16-key f32 and 64-query tiles, Sq < Sk
               (1, 130, 130, 10, 1, 256), (2, 65, 65, 4, 2, 256), (1, 1, 1, 2, 1, 256),
               (1, 17, 300, 10, 1, 256), (1, 1, 129, 10, 1, 256),
               (1, 1000, 1000, 10, 1, 256)]
# Sq > Sk (cross-attention over fewer keys than queries): the causal rows
# before the first key see none and are defined by no version, so only the
# rows that see a key are compared
ATTN_SQ_OVER_SK = [(1, 200, 70, 6, 6, 64), (2, 100, 33, 4, 2, 16),
                   (1, 300, 70, 4, 2, 256), (1, 130, 17, 10, 1, 256)]
ATTN_MASKS = [(True, None), (False, None), (True, 8), (True, 24), (False, 24)]
# the bf16 flash check at the prefill shape beside the JAX tolerance: each
# output row's RMS error over the row's RMS in the plain version. bf16 keeps
# 8 significant bits, and rounding P and O each costs at most 2^-9 of a value
ATTN_BF16_ROW_TOL = 2 ** -7


def tol(gold, dtype) -> float:
    import torch

    scale = max(1.0, float(gold.abs().max()))
    return (1e-4 if dtype == torch.float32 else 3e-2) * scale


def check(name, got, gold, dtype) -> float:
    err = float((got.float() - gold.float()).abs().max()) if gold.numel() else 0.0
    if not err <= tol(gold, dtype):
        raise AssertionError(f"{name}: max |err| {err} > {tol(gold, dtype)}")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_small(dev) -> int:
    """Kernel vs the plain COO product and vs its plain version at the JAX
    package's kernel-test shapes. Returns the number of cases checked."""
    import numpy as np
    import torch

    from repro_torch.core import schedule, spmm
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.tuning import registry

    def operand(n, k, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)

    cases = 0
    for n, density, alpha in [(64, 0.05, 0.8), (200, 0.02, 1.1), (123, 0.08, 0.6)]:
        a = synth.power_law_adjacency(n, density, alpha, seed=n)
        s = schedule.build_balanced_schedule(a, 32, 16)
        for kdim in (5, 16, 24):
            b = operand(n, kdim, n)
            gold = spmm.spmm_coo(a, b)
            for dtype in (torch.float32, torch.bfloat16):
                got = spmm_cuda.spmm_balanced(s, b.to(dtype), ktile=8)
                plain = spmm_cuda.spmm_balanced_plain(s, b.to(dtype))
                check(f"balanced n={n} k={kdim} {dtype}", got, gold, dtype)
                check(f"plain n={n} k={kdim} {dtype}", got, plain, dtype)
                cases += 1
    a = synth.power_law_adjacency(150, 0.04, 1.0, seed=9)
    b = operand(150, 12, 9)
    for builder in (schedule.build_balanced_schedule, schedule.build_naive_schedule):
        got = spmm_cuda.spmm_balanced(builder(a, 16, 8), b, ktile=8)
        check(f"{builder.__name__}", got, spmm.spmm_coo(a, b), torch.float32)
        cases += 1
    a = synth.power_law_adjacency(96, 0.1, 1.2, seed=4)
    b = operand(96, 9, 4)
    s = schedule.build_balanced_schedule(a, 16, 8, cols_per_block=32, evil_threshold=8)
    if s.n_evil_chunks == 0:
        raise AssertionError("blocked case has no evil chunks")
    check("blocked+evil", spmm_cuda.spmm_balanced(s, b, ktile=8),
          spmm.spmm_coo(a, b), torch.float32)
    a = synth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    b = operand(300, 12, 7)
    for routing in ("gather", "onehot"):
        ex = registry.get_executor(a, nnz_per_step=32, rows_per_window=16,
                                   reorder="degree", routing=routing, device=dev)
        check(f"reordered executor ({routing})", ex.spmm(b), spmm.spmm_coo(a, b),
              torch.float32)
        cases += 1
    torch.cuda.synchronize()
    return cases + 1


def glorot(dims, seed: int) -> dict:
    """Glorot-uniform weights from a numpy seed, as ``gcn.init_params``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (din + dout))
        params[f"w{i}"] = rng.uniform(-lim, lim, (din, dout)).astype(np.float32)
    return params


def phase_serve(dev):
    """The main path at full width; returns what phase 3 needs."""
    import torch

    from repro_torch.core import gcn
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.tuning import registry

    t0 = time.perf_counter()
    ds = synth.make_dataset("reddit", scale=1, device=dev)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = registry.get_executor(ds.adj, device=dev)
    torch.cuda.synchronize()
    t_exec = time.perf_counter() - t0
    sched = ex.sched
    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
    x = torch.from_numpy(ds.features).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [
        torch.stack([
            x * (torch.rand(x.shape, generator=gen, device=dev) < KEEP)
            for _ in range(BATCH_SIZE)
        ])
        for _ in range(BATCHES)
    ]
    torch.cuda.synchronize()

    spmm_cuda.reset_launches()
    outs, batch_ms = [], []
    t_all = time.perf_counter()
    for xb in batches:
        t0 = time.perf_counter()
        outs.append(ex.forward_batch(params, xb))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    serve_s = time.perf_counter() - t_all
    launches = dict(spmm_cuda.LAUNCHES)
    for name in F32_SPMM:
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")

    adj = ds.adj._replace(row=ds.adj.row.to(dev), col=ds.adj.col.to(dev),
                          val=ds.adj.val.to(dev))
    max_err = 0.0
    for xb, out in zip(batches, outs):
        if out.shape != (BATCH_SIZE, ds.num_nodes, ds.num_classes):
            raise AssertionError(f"logits have shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite logits")
        for i in range(BATCH_SIZE):
            gold = gcn.forward(params, adj, xb[i])
            max_err = max(max_err, check("request logits", out[i], gold,
                                         torch.float32))
    # steady throughput: the batches again, in turn, until the window is full
    n_steady, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < STEADY_S:
        ex.forward_batch(params, batches[n_steady % BATCHES])
        torch.cuda.synchronize()
        n_steady += 1
    steady_s = time.perf_counter() - t0
    # the dense X·W products of one batch (both layers, ReLU between), timed
    # apart so the batch time splits into dense products and SpMM kernels
    xb = batches[0]
    xw_ms = timed_ms(lambda: torch.relu(xb @ params["w0"]) @ params["w1"], 5)
    n_req = BATCHES * BATCH_SIZE
    serving = {
        "graph": "reddit", "nodes": ds.num_nodes, "features": ds.num_features,
        "hidden": ds.hidden, "classes": ds.num_classes, "nnz": int(ds.adj.nnz),
        "n_steps": sched.n_steps, "n_windows": sched.n_windows,
        "utilization": sched.utilization, "n_evil_chunks": sched.n_evil_chunks,
        "requests": n_req, "batches": BATCHES, "batch_size": BATCH_SIZE,
        "requests_per_s": n_req / serve_s,
        "steady_requests_per_s": n_steady * BATCH_SIZE / steady_s,
        "steady_batches": n_steady, "steady_s": steady_s,
        "steady_batch_ms": steady_s * 1e3 / n_steady, "batch_ms": batch_ms,
        "xw_ms_per_batch": xw_ms, "max_abs_err": max_err,
        "dataset_s": t_data, "executor_build_s": t_exec,
    }
    del batches, outs
    return ds, ex, launches, serving


def bytes_window(steps, n, kdim, elt, all_miss=False, part_elt=4) -> int:
    """Bytes the window kernel must move: each live slot's 8-byte record,
    the per-step pointers, B once (or once per live slot when no gather
    hits in L2), and the partials written once (f32, or bf16 with
    ``part_elt=2``)."""
    n_slots = steps.slots.shape[0]
    meta = n_slots * 8 + (steps.slot_ptr.numel() + steps.part_ptr.numel()) * 4
    b_bytes = (n_slots if all_miss else n) * kdim * elt
    return meta + b_bytes + steps.n_parts * kdim * part_elt


def schedule_geometry(sched, steps) -> dict:
    """The converged schedule as the window kernel meets it: windows and
    their steps, evil chunks, padding and row runs (counts, not times)."""
    import numpy as np

    n_steps, r = sched.n_steps, sched.rows_per_window
    per_window = np.bincount(sched.win_id, minlength=sched.n_windows)
    evil = np.zeros(sched.n_windows, bool)
    evil[sched.win_id[n_steps - sched.n_evil_chunks:]] = True
    regular = ~evil & (per_window > 0)
    live_rows = (sched.row_map.reshape(-1, r) >= 0).sum(axis=1)
    n_live = int(steps.slot_ptr[-1])
    return {
        "regular_windows": int(regular.sum()),
        "regular_windows_of_one_step": int((per_window[regular] == 1).sum()),
        "rows_per_regular_window": float(live_rows[regular].mean()),
        "evil_windows": int(evil.sum()),
        "steps_per_evil_window": float(per_window[evil].mean()) if evil.any() else 0.0,
        "evil_steps": int(sched.n_evil_chunks),
        "issued_slots": int(sched.issued_slots), "live_slots": n_live,
        "padding_share": 1.0 - n_live / sched.issued_slots,
        "partials": int(steps.n_parts), "runs_per_step": steps.n_parts / n_steps,
    }


def spmm_instantiation(mangled: str):
    """A readable name for a compiled SpMM kernel of ``spmm_balanced.cu``
    (``spmm_step_kernel<f32,4,1>``, ``epilogue_kernel_bf16acc<bf16,8>``...),
    or None for another symbol."""
    import re

    t = re.search(r"(spmm_step_kernel|epilogue_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d+)E(?:Li(\d+)E)?E", mangled)
    if t:
        dims = ",".join(g for g in t.groups()[2:] if g)
        return f"{t.group(1)}<{'f32' if t.group(2) == 'f' else 'bf16'},{dims}>"
    t = re.search(r"spmm_step_kernel_bf16accILi(\d+)ELi(\d+)EE", mangled)
    if t:
        return f"spmm_step_kernel_bf16acc<{t.group(1)},{t.group(2)}>"
    t = re.search(r"epilogue_kernel_bf16accI(f|t)Li(\d+)EE", mangled)
    if t:
        return (f"epilogue_kernel_bf16acc<{'f32' if t.group(1) == 'f' else 'bf16'},"
                f"{t.group(2)}>")
    return "bf16_rounding_check_kernel" if "bf16_rounding_check_kernel" in mangled \
        else None


def kernel_registers() -> dict:
    """Registers and spill bytes of each compiled SpMM kernel, from ptxas;
    for the bf16-accumulate kernels also their SASS counts of packed bf16
    arithmetic (``HMUL2``/``HADD2``/``HFMA2``, ``.BF16_V2``: ptxas issues a
    rounded multiply or add also as an ``HFMA2`` with a -0 addend or a 1
    factor) and of conversions (``F2F``, ``F2FP``), from ``cuobjdump -sass``. Raises if a
    kernel spills or a bf16-accumulate kernel issues no packed bf16 op."""
    import re
    import shutil

    from repro_torch.kernels import _build

    regs, name = {}, None
    for line in _build.BUILD_LOGS.get("spmm_balanced", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = spmm_instantiation(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            regs.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.library_path("spmm_balanced"))],
                          check=True, capture_output=True, text=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = spmm_instantiation(m.group(1))
            if name and "bf16acc" in name:
                regs.setdefault(name, {}).update(packed_bf16_ops=0, conversions=0)
            continue
        if name not in regs or "packed_bf16_ops" not in regs[name]:
            continue
        if re.search(r"\bH(MUL2|ADD2|FMA2)(\.MMA)?\.BF16", line):
            regs[name]["packed_bf16_ops"] += 1
        if re.search(r"\bF2FP?\b|\bF2FP?\.", line):
            regs[name]["conversions"] += 1
    for name, r in regs.items():
        if r.get("spill_store_bytes", 0) or (
                "bf16acc" in name and not r.get("packed_bf16_ops")):
            raise AssertionError(f"SpMM kernel <{name}> spills or issues no packed "
                                 f"bf16 arithmetic: {r}")
    return regs


def spmm_rows(steps, a_csr, b, ktile, what=""):
    """The window and epilogue kernels on ``steps`` at operand ``b``: each
    held against its plain version, the kernels' product against the
    library's, ``spmm_balanced`` against itself (two calls, bit-equal);
    then timed beside their plain versions, ``spmm_balanced`` and the
    library calls (``torch.sparse.mm`` on ``a_csr``; ``index_add_`` of the
    kept partials for the epilogue), with CUDA events, in turns. Returns the
    window's and the epilogue's rows (ms per call) and the window's lane
    mapping."""
    import numpy as np
    import torch

    from repro_torch.kernels import spmm_cuda

    dev = b.device
    m, n = steps.shape
    kdim = b.shape[1]
    # multiplies this run's data needs: padding slots (val 0) are skipped
    n_nnz = int((steps.slots[:, 1] != 0).sum())
    n_kept = int(steps.epi_part.numel())
    part_row = torch.full((steps.n_parts,), -1, dtype=torch.long, device=dev)
    part_row[steps.epi_part.long()] = torch.repeat_interleave(
        torch.arange(m, device=dev), steps.epi_ptr.diff().long())
    kept = part_row >= 0
    part_k = spmm_cuda.spmm_window(steps, b, ktile=ktile)
    part_p = spmm_cuda.spmm_window_plain(steps, b)
    err_w = check(f"{what}spmm_window k={kdim}", part_k, part_p, torch.float32)
    epi_k = spmm_cuda.spmm_epilogue(steps, part_p, torch.float32)
    epi_p = spmm_cuda.spmm_epilogue_plain(steps, part_p, torch.float32)
    err_e = check(f"{what}spmm_epilogue k={kdim}", epi_k, epi_p, torch.float32)
    lib = torch.sparse.mm(a_csr, b)
    check(f"{what}sparse.mm vs kernels k={kdim}", epi_k, lib, torch.float32)
    first = spmm_cuda.spmm_balanced(steps, b, ktile=ktile)
    if not torch.equal(first, spmm_cuda.spmm_balanced(steps, b, ktile=ktile)):
        raise AssertionError(f"{what}spmm_balanced k={kdim}: two calls differ")
    del part_k, epi_k, lib, first
    # library and kernels in turns: sparse.mm, spmm_balanced, the two
    # kernels apart, then spmm_balanced and sparse.mm again
    lib_ms = [timed_ms(lambda: torch.sparse.mm(a_csr, b), 10)]
    bal_ms = [timed_ms(lambda: spmm_cuda.spmm_balanced(steps, b, ktile=ktile), 10)]
    w_ms = timed_ms(lambda: spmm_cuda.spmm_window(steps, b, ktile=ktile), 10)
    e_ms = timed_ms(lambda: spmm_cuda.spmm_epilogue(steps, part_p, torch.float32), 10)
    bal_ms.append(timed_ms(lambda: spmm_cuda.spmm_balanced(steps, b, ktile=ktile), 10))
    lib_ms.append(timed_ms(lambda: torch.sparse.mm(a_csr, b), 10))
    wp_ms = timed_ms(lambda: spmm_cuda.spmm_window_plain(steps, b), 2)
    ep_ms = timed_ms(
        lambda: spmm_cuda.spmm_epilogue_plain(steps, part_p, torch.float32), 3)
    tgt, src = part_row[kept], part_p[kept]
    e_lib = timed_ms(
        lambda: torch.zeros((m, kdim), device=dev).index_add_(0, tgt, src), 10)
    del part_p, src
    w_bytes = bytes_window(steps, n, kdim, 4)
    w_ops_ms = 2 * n_nnz * kdim / PEAK_F32_FLOPS * 1e3
    e_bytes = n_kept * kdim * 4 + (m + 1 + n_kept) * 4 + m * kdim * 4
    window = {
        "kdim": kdim, "max_abs_err": err_w,
        "ms": w_ms, "plain_ms": wp_ms, "library_ms": float(np.mean(lib_ms)),
        "balanced_ms": float(np.mean(bal_ms)), "balanced_runs_ms": bal_ms,
        "library_runs_ms": lib_ms,
        "bound_ms": max(w_bytes / PEAK_BYTES_PER_S * 1e3, w_ops_ms),
        "bound_by": "bytes" if w_bytes / PEAK_BYTES_PER_S * 1e3 >= w_ops_ms
        else "operations",
    }
    epilogue = {
        "kdim": kdim, "max_abs_err": err_e,
        "ms": e_ms, "plain_ms": ep_ms, "library_ms": e_lib,
        "bound_ms": e_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    return window, epilogue, spmm_cuda.lane_mapping(kdim, b.dtype, rows=n)


def kernel_entries(rows, launches, per, suffix=""):
    """``{"kernels": [...]}`` entries of the window and epilogue kernels from
    their rows: each time summed over the rows on the main path."""
    import numpy as np

    from repro_torch.kernels import spmm_cuda

    kernels = []
    for name, shapes in rows.items():
        main = [s for s in shapes if s["main_path"]]
        entry = {
            "name": name + suffix, "route": "cuda", "source": spmm_cuda.SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in main)
            else "operations",
            "per": per,
        }
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        for key in keys + (("balanced_ms",) if name == "spmm_balanced" else ()):
            entry[key] = float(np.sum([s[key] for s in main]))
        entry["shapes"] = shapes
        kernels.append(entry)
    return kernels


def phase_kernels(ds, ex, launches):
    """Each kernel vs its plain version and the library call at the main
    path's shapes (batched: 4 requests × 128 and × 41 columns) and at one
    request's (128 and 41); times in ms per call."""
    import torch

    from repro_torch.kernels import spmm_cuda

    dev = ex.device
    steps = ex._steps
    m, n = ds.adj.shape
    geometry = schedule_geometry(ex.sched, steps)
    csr = ds.adj_csr
    a_csr = torch.sparse_csr_tensor(
        csr.indptr.long(), csr.indices.long(), csr.data, size=(m, n)
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"spmm_balanced": [], "spmm_epilogue": []}
    all_miss, lanes = {}, {}
    main_widths = (BATCH_SIZE * ds.hidden, BATCH_SIZE * ds.num_classes)
    for kdim in main_widths + (ds.hidden, ds.num_classes):
        b = torch.randn((n, kdim), generator=gen, device=dev)
        window, epilogue, chosen = spmm_rows(steps, a_csr, b, ex.ktile)
        lane_ms = {str(chosen): window["ms"]}
        for vec, gw, nc in LANE_SWEEP[kdim]:
            mapping = (vec, gw, nc, -(-kdim // (vec * gw * nc)))
            lane_ms[str(mapping)] = timed_ms(
                lambda: spmm_cuda._window(steps, b, mapping), 10)
        w_miss = bytes_window(steps, n, kdim, 4, all_miss=True)
        all_miss[str(kdim)] = w_miss / PEAK_BYTES_PER_S * 1e3
        vec, gw, nc, panels = chosen
        lanes[str(kdim)] = {"vec": vec, "group": gw, "vectors": nc, "panels": panels,
                            "idle_share": 1 - kdim // vec / (panels * gw * nc)}
        rows["spmm_balanced"].append({**window, "main_path": kdim in main_widths,
                                      "lane_sweep_ms": lane_ms})
        rows["spmm_epilogue"].append({**epilogue, "main_path": kdim in main_widths})
        del b
        torch.cuda.empty_cache()
    # per forward_batch call: one launch of each kernel per layer
    kernels = kernel_entries(rows, launches,
                             "one forward_batch of 4 requests (both layers)")
    return kernels, all_miss, lanes, geometry


def same(name, got, plain) -> float:
    """Hold a kernel to its plain version bit for bit (the bf16-accumulate
    variant takes the plain version's rounding sequence in its order).
    Returns the max |difference|, which is then 0.0."""
    import torch

    if got.shape != plain.shape or not torch.equal(got, plain):
        err = float((got.float() - plain.float()).abs().max())
        raise AssertionError(f"{name}: differs from its plain version (max |err| {err})")
    return 0.0


def phase_bf16acc(ds, winner):
    """The bf16-accumulate variant of the SpMM kernels where the main path
    runs it: on the schedule of phase 6's sweep winner, through the twin
    executor the error report builds, on the report's probe operand (the
    tuning width, ``runner.autotune``'s seeded B); and at kdim 512 with a
    random B. First the exhaustive rounding check (0 mismatches). Kernel vs
    plain version bit for bit (``torch.equal``); both vs the f32 product
    (0.1); the result differs from the f32 kernel's on the same inputs, and
    at the probe the difference is the report's ``bf16_max_err`` exactly;
    two calls bit-equal; an f32 B and its bf16 values give the same bits.
    Times in turns beside the f32 kernel, under other lane mappings, the
    plain version, ``torch.sparse.mm`` on bf16 operands and ``index_add_``.
    Returns the two ``kernels`` entries (launches filled in from phase 6)."""
    import numpy as np
    import torch

    from repro_torch.core.executor import ScheduleExecutor
    from repro_torch.kernels import spmm_cuda

    cfg, sched, inv, probe_kdim, dev = winner
    t0 = time.perf_counter()
    mul_bad, add_bad = spmm_cuda.bf16_rounding_check(dev)
    torch.cuda.synchronize()
    rounding = {"pairs": 2 ** 32, "mul_mismatches": mul_bad, "add_mismatches": add_bad,
                "seconds": time.perf_counter() - t0}
    if mul_bad or add_bad:
        raise AssertionError(f"packed bf16 rounding differs from the f32 sequence: "
                             f"{rounding}")
    twins = {acc: ScheduleExecutor(sched, ktile=cfg.ktile, routing=cfg.routing,
                                   bf16_accumulate=acc, device=dev, row_unperm=inv)
             for acc in (False, True)}
    ex = twins[True]
    steps, unperm = ex._steps, ex._unperm
    m, n = ds.adj.shape
    bf16 = torch.bfloat16
    n_nnz = int((steps.slots[:, 1] != 0).sum())
    n_kept = int(steps.epi_part.numel())
    part_row = torch.full((steps.n_parts,), -1, dtype=torch.long, device=dev)
    part_row[steps.epi_part.long()] = torch.repeat_interleave(
        torch.arange(m, device=dev), steps.epi_ptr.diff().long())
    kept = part_row >= 0
    csr = ds.adj_csr
    a_csr = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(), csr.data,
                                    size=(m, n)).to(dev)
    a_bf16 = torch.sparse_csr_tensor(a_csr.crow_indices(), a_csr.col_indices(),
                                     a_csr.values().to(bf16), size=(m, n))
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {"spmm_balanced_bf16acc": [], "spmm_epilogue_bf16acc": []}
    for kdim in (probe_kdim, BF16ACC_WIDE):
        if kdim == probe_kdim:  # the report's operand (runner.autotune, seed 0)
            b = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (n, kdim)).astype(np.float32)).to(dev)
        else:
            b = torch.randn((n, kdim), generator=gen, device=dev)
        b16 = spmm_cuda.window_operand(b, bf16)
        gold = torch.sparse.mm(a_csr, b)
        part_k = spmm_cuda.spmm_window(steps, b, acc_dtype=bf16)
        part_p = spmm_cuda.spmm_window_plain(steps, b, acc_dtype=bf16)
        err_w = same(f"bf16acc window k={kdim}", part_k, part_p)
        same(f"bf16acc window k={kdim} on bf16 B",
             spmm_cuda.spmm_window(steps, b16, acc_dtype=bf16), part_p)
        epi_k = spmm_cuda.spmm_epilogue(steps, part_p, torch.float32, unperm,
                                        acc_dtype=bf16)
        epi_p = spmm_cuda.spmm_epilogue_plain(steps, part_p, torch.float32, unperm,
                                              acc_dtype=bf16)
        err_e = same(f"bf16acc epilogue k={kdim}", epi_k, epi_p)
        got = ex.spmm(b)
        plain = spmm_cuda.spmm_balanced_plain(steps, b, row_unperm=unperm,
                                                acc_dtype=bf16)
        err = same(f"bf16acc spmm k={kdim}", got, plain)
        err_gold = float((got - gold).abs().max())
        if not err_gold <= 0.1:
            raise AssertionError(f"bf16acc k={kdim} vs the f32 product: {err_gold} > 0.1")
        if not torch.equal(got, ex.spmm(b)):
            raise AssertionError(f"bf16acc spmm k={kdim}: two calls differ")
        err_f32 = float((got - twins[False].spmm(b)).abs().max())
        if not err_f32 > 0:
            raise AssertionError(f"bf16acc spmm k={kdim} equals the f32 kernel's result")
        if kdim == probe_kdim and err_f32 != cfg.bf16_max_err:
            raise AssertionError(f"the report's bf16_max_err {cfg.bf16_max_err} is not "
                                 f"the twins' difference {err_f32} on its operand")
        del part_k, epi_k, epi_p, got, plain
        # f32 and bf16-accumulate windows in turns: f32, bf16, bf16, f32; the
        # bf16-accumulate window's time holds its cast of B
        f32_ms = [timed_ms(lambda: spmm_cuda.spmm_window(steps, b), 10)]
        w_ms = [timed_ms(lambda: spmm_cuda.spmm_window(steps, b, acc_dtype=bf16), 10)
                for _ in range(2)]
        f32_ms.append(timed_ms(lambda: spmm_cuda.spmm_window(steps, b), 10))
        cast_ms = timed_ms(lambda: spmm_cuda.window_operand(b, bf16), 10)
        chosen = spmm_cuda.lane_mapping(kdim, bf16, b16.data_ptr() % 16 == 0, n, bf16)
        lane_ms = {str(chosen): timed_ms(
            lambda: spmm_cuda._window(steps, b16, chosen, bf16), 10)}
        for vec, gw, nc in BF16ACC_LANE_SWEEP.get(kdim, ()):
            mapping = (vec, gw, nc, -(-kdim // (vec * gw * nc)))
            lane_ms[str(mapping)] = timed_ms(
                lambda: spmm_cuda._window(steps, b16, mapping, bf16), 10)
        e_ms = timed_ms(lambda: spmm_cuda.spmm_epilogue(
            steps, part_p, torch.float32, unperm, acc_dtype=bf16), 10)
        part32 = spmm_cuda.spmm_window(steps, b)
        e32_ms = timed_ms(lambda: spmm_cuda.spmm_epilogue(
            steps, part32, torch.float32, unperm), 10)
        del part32
        tgt, src = part_row[kept], part_p[kept]
        e_lib = timed_ms(
            lambda: torch.zeros((m, kdim), dtype=bf16, device=dev).index_add_(0, tgt, src),
            10)
        del src
        wp_ms = timed_ms(lambda: spmm_cuda.spmm_window_plain(steps, b, acc_dtype=bf16), 1)
        ep_ms = timed_ms(lambda: spmm_cuda.spmm_epilogue_plain(
            steps, part_p, torch.float32, unperm, acc_dtype=bf16), 1)
        # the yardstick only: a build without a bf16 sparse product records
        # none (the port never calls it)
        lib_ms, lib_diff, lib_error = None, None, None
        try:
            lib_diff = float((torch.sparse.mm(a_bf16, b16).float() - gold).abs().max())
        except (NotImplementedError, RuntimeError) as e:
            lib_error = f"{type(e).__name__}: {e}"
        else:
            lib_ms = timed_ms(lambda: torch.sparse.mm(a_bf16, b16), 10)
        del part_p, b16
        # compulsory bytes: the window reads each record and B once (f32, as
        # the main path hands it over; bf16 where the caller holds it in
        # bf16) and writes the bf16 partials; its operations, a bf16 multiply
        # and add per non-zero and column, at the bf16 peak
        w_bytes = bytes_window(steps, n, kdim, 4, part_elt=2) / PEAK_BYTES_PER_S * 1e3
        w_bytes_b16 = bytes_window(steps, n, kdim, 2, part_elt=2) / PEAK_BYTES_PER_S * 1e3
        w_ops = 2 * n_nnz * kdim / PEAK_BF16_FLOPS * 1e3
        e_bytes = (n_kept * kdim * 2 + (m + 1 + n_kept + m) * 4 + m * kdim * 4
                   ) / PEAK_BYTES_PER_S * 1e3
        rows["spmm_balanced_bf16acc"].append({
            "kdim": kdim, "max_abs_err": max(err_w, err), "ms": float(np.mean(w_ms)),
            "ms_runs": w_ms, "f32_ms": float(np.mean(f32_ms)), "f32_runs_ms": f32_ms,
            "cast_ms": cast_ms, "lane_mapping": list(chosen), "lane_sweep_ms": lane_ms,
            "plain_ms": wp_ms, "library_ms": lib_ms, "library_max_abs_diff_f32": lib_diff,
            "library_error": lib_error, "max_abs_err_vs_f32_product": err_gold,
            "max_abs_diff_f32_kernel": err_f32, "bound_ms": max(w_bytes, w_ops),
            "bound_by": "bytes" if w_bytes >= w_ops else "operations",
            "bound_bytes_ms_bf16_b": w_bytes_b16, "bound_operations_ms": w_ops})
        rows["spmm_epilogue_bf16acc"].append({
            "kdim": kdim, "max_abs_err": err_e, "ms": e_ms, "f32_ms": e32_ms,
            "plain_ms": ep_ms, "library_ms": e_lib, "bound_ms": e_bytes,
            "bound_by": "bytes"})
        del b, gold, tgt
        torch.cuda.empty_cache()
    del twins, ex, steps
    torch.cuda.empty_cache()
    geometry = {k: getattr(cfg, k) for k in ("nnz_per_step", "rows_per_window",
                                             "ktile", "reorder")}
    entries = []
    for name, shapes in rows.items():
        entry = {"name": name, "route": "cuda", "source": spmm_cuda.SOURCE,
                 "replaces": REPLACES[name], "launches": None,
                 "max_abs_err": max(s["max_abs_err"] for s in shapes),
                 "bound_by": shapes[0]["bound_by"],
                 "per": f"one call at kdim {probe_kdim} on the sweep winner's schedule "
                        f"{geometry} (the error report's shape; shapes has kdim "
                        f"{BF16ACC_WIDE} too); launches over phase 6",
                 "shapes": shapes}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[key] = shapes[0][key]
        entries.append(entry)
    entries[0]["rounding_check"] = rounding
    return entries


def phase_engine(dev, ds, base_rps):
    """Reddit through ``GCNServingEngine``: a cold admission through the
    measured sweep, 12 checked requests, steady serving, a warm restart and
    an eviction round trip. ``base_rps`` is phase 2's steady throughput.
    Returns the ``engine_serving`` record, the phase's launch counts and the
    sweep winner (config, host schedule, row un-permutation, probe width,
    device) for phase 6b."""
    import torch

    from repro_torch.core import gcn
    from repro_torch.core import schedule as tsched
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.serving.gcn_engine import GCNServingEngine
    from repro_torch.tuning import registry, runner, space
    from repro_torch.tuning.store import TuningStore

    eligible = [c for c in space.default_sweep(ds.adj)
                if c["routing"] != "onehot" and not c.get("bf16_accumulate")]
    # the sweep's timings and schedule builds, counted (both are called
    # through their modules: runner.measure_candidate,
    # registry -> schedule.build_balanced_schedule)
    wrapped = {"measure_candidate": runner, "build_balanced_schedule": tsched}
    originals = {name: getattr(mod, name) for name, mod in wrapped.items()}
    calls = dict.fromkeys(wrapped, 0)

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    (ROOT / "build").mkdir(exist_ok=True)
    store = TuningStore(tempfile.mkdtemp(prefix="chip_smoke_store_", dir=ROOT / "build"))
    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
    x = torch.from_numpy(ds.features).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)  # phase 2's requests
    reqs = [x * (torch.rand(x.shape, generator=gen, device=dev) < KEEP)
            for _ in range(BATCHES * BATCH_SIZE)]
    adj = ds.adj._replace(row=ds.adj.row.to(dev), col=ds.adj.col.to(dev),
                          val=ds.adj.val.to(dev))
    golds = [gcn.forward(params, adj, r) for r in reqs]
    registry.clear_caches()
    for name, mod in wrapped.items():
        setattr(mod, name, counted(name))
    try:
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated(dev)
        spmm_cuda.reset_launches()
        # -- cold start: the default sweep, timed on the card ---------------
        eng = GCNServingEngine(store=store, max_batch=ENGINE_MAX_BATCH,
                               device_budget_bytes=1 << 40)
        t0 = time.perf_counter()
        cold = eng.add_graph("reddit", ds.adj, params)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_calls = dict(calls)
        resident = torch.cuda.memory_allocated(dev) - base_bytes
        if cold.warm_start or cold_calls["measure_candidate"] == 0:
            raise AssertionError(f"reddit's admission was not a cold sweep: {cold}")
        if abs(resident - eng.device_bytes_in_use) > 0.05 * eng.device_bytes_in_use + (
                64 << 20):
            raise AssertionError(
                f"after admission {resident} bytes are allocated for the engine's "
                f"{eng.device_bytes_in_use}: the sweep's candidates were not freed")
        # what the error report ran the bf16-accumulate kernels on (phase 6b)
        rec = eng._graphs["reddit"]
        winner = (cold.config, rec.sched, rec.inv, rec.kdim, dev)
        # -- 12 checked requests, with deadlines ---------------------------
        outs = serve_requests(eng, reqs)
        max_err = 0.0
        for out, gold in zip(outs, golds):
            if out.shape != gold.shape or not torch.isfinite(out).all():
                raise AssertionError(f"engine logits {tuple(out.shape)} malformed")
            max_err = max(max_err, check("engine logits", out, gold, torch.float32))
        checked = eng.stats()
        # -- steady serving -------------------------------------------------
        eng.reset_stats()
        served, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < STEADY_S:
            for r in reqs[:ENGINE_MAX_BATCH]:
                eng.submit("reddit", r, deadline_s=ENGINE_DEADLINE_S)
            served += sum(o.shape[0] for o in eng.poll().values())
        served += sum(o.shape[0] for o in eng.flush().values())
        steady_s = time.perf_counter() - t0
        steady = eng.stats()
        launches = dict(spmm_cuda.LAUNCHES)
        eng.remove_graph("reddit")
        del eng
        torch.cuda.empty_cache()
        # -- restart: a second engine on the same store ---------------------
        registry.clear_caches()
        before = dict(calls)
        eng2 = GCNServingEngine(store=store, max_batch=ENGINE_MAX_BATCH,
                                device_budget_bytes=cold.device_bytes)
        t0 = time.perf_counter()
        warm = eng2.add_graph("reddit", ds.adj, params)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_calls = {k: calls[k] - before[k] for k in calls}
        if not warm.warm_start or warm.tune_seconds != 0.0 or (
                warm_calls["measure_candidate"] or warm_calls["build_balanced_schedule"]):
            raise AssertionError(f"restart was not warm: {warm}, calls {warm_calls}")
        outs2 = serve_requests(eng2, reqs)
        if not all(torch.equal(a, b) for a, b in zip(outs, outs2)):
            raise AssertionError("the warm engine's logits differ from the cold one's")
        # -- eviction round trip: pubmed beside reddit over a reddit budget -
        pub = synth.make_dataset(EVICT_GRAPH, scale=1, device=dev)
        pcfg = gcn.GCNConfig(pub.num_features, pub.hidden, pub.num_classes)
        pparams = gcn.params_from_jax(glorot(pcfg.dims, seed=0), dev)
        px = torch.from_numpy(pub.features).to(dev)
        t0 = time.perf_counter()
        padmit = eng2.add_graph(EVICT_GRAPH, pub.adj, pparams)
        pout = eng2.infer(EVICT_GRAPH, px)
        before = dict(calls)
        t1 = time.perf_counter()
        back = eng2.serve_batch("reddit", reqs[:BATCH_SIZE])
        torch.cuda.synchronize()
        readmit_s = time.perf_counter() - t1
        round_trip_s = time.perf_counter() - t0
        st2 = eng2.stats()
        pgold = gcn.forward(pparams, pub.adj._replace(
            row=pub.adj.row.to(dev), col=pub.adj.col.to(dev), val=pub.adj.val.to(dev)), px)
        check("pubmed logits", pout, pgold, torch.float32)
        if calls["build_balanced_schedule"] != before["build_balanced_schedule"]:
            raise AssertionError("re-admitting reddit rebuilt its schedule")
        if st2["evictions"] < 2 or st2["readmissions"] < 1:
            raise AssertionError(f"no eviction round trip: {st2}")
        if not torch.equal(back, torch.stack(outs2[:BATCH_SIZE])):
            raise AssertionError("reddit's logits after re-admission differ")
        del eng2, back, outs, outs2
    finally:
        for name, mod in wrapped.items():
            setattr(mod, name, originals[name])
    torch.cuda.empty_cache()
    rps = served / steady_s
    config = dict(vars(cold.config))
    record = {
        "graph": "reddit", "store": "fresh, under build/", "max_batch": ENGINE_MAX_BATCH,
        "deadline_s": ENGINE_DEADLINE_S, "sweep": "default_sweep",
        "candidates_eligible": len(eligible),
        "cold_add_graph_s": cold_s, "tune_seconds": cold.tune_seconds,
        "measure_calls": cold_calls["measure_candidate"],
        "candidates_timed": cold_calls["measure_candidate"] // runner.AUTOTUNE_ROUNDS,
        "candidates_pruned": len(eligible)
        - cold_calls["measure_candidate"] // runner.AUTOTUNE_ROUNDS,
        "schedules_built": cold_calls["build_balanced_schedule"],
        "config": config, "bf16_max_err": cold.config.bf16_max_err,
        "device_bytes": cold.device_bytes, "resident_allocated_bytes": resident,
        "requests_checked": len(reqs), "max_abs_err": max_err,
        "checked_deadline_met": checked["deadline_met"],
        "checked_deadline_misses": checked["deadline_misses"],
        "steady_requests": served, "steady_s": steady_s, "steady_requests_per_s": rps,
        "phase2_steady_requests_per_s": base_rps,
        "engine_overhead_share": 1.0 - rps / base_rps,
        "latency_us_p50": steady["latency_us_p50"], "latency_us_p99": steady["latency_us_p99"],
        "deadline_met": steady["deadline_met"], "deadline_misses": steady["deadline_misses"],
        "batches": steady["batches"],
        "warm_add_graph_s": warm_s, "warm_calls": warm_calls, "warm_logits_equal": True,
        "evict_graph": EVICT_GRAPH, "evict_graph_tune_seconds": padmit.tune_seconds,
        "evict_budget_bytes": cold.device_bytes, "evictions": st2["evictions"],
        "readmissions": st2["readmissions"], "readmit_serve_s": readmit_s,
        "eviction_round_trip_s": round_trip_s,
    }
    for name in ("spmm_balanced", "spmm_epilogue", "spmm_balanced_bf16acc",
                 "spmm_epilogue_bf16acc"):
        if launches[name] == 0:
            raise AssertionError(f"phase 6 never launched {name}")
    return record, launches, winner, store


def value_delta(coo, k, rng):
    """``k`` existing edges re-weighted (the streaming suite's value delta)."""
    import numpy as np

    from repro_torch.core import csc as fmt

    row, col = fmt.to_numpy(coo.row), fmt.to_numpy(coo.col)
    idx = rng.choice(row.shape[0], size=min(k, row.shape[0]), replace=False)
    vals = (rng.random(idx.shape[0]) + 0.5).astype(np.float32)
    return fmt.EdgeDelta(row[idx], col[idx], vals)


def structural_delta(n, k, rng):
    """``k`` random edges inserted or re-weighted (its structural delta)."""
    import numpy as np

    from repro_torch.core import csc as fmt

    return fmt.EdgeDelta(rng.integers(0, n, k), rng.integers(0, n, k),
                         (rng.random(k) + 0.1).astype(np.float32))


def coo_on(coo, dev):
    """A host COO (numpy or tensors) with its arrays on ``dev``."""
    import torch

    from repro_torch.core import csc as fmt

    return coo._replace(**{f: torch.from_numpy(fmt.to_numpy(getattr(coo, f))).to(dev)
                           for f in ("row", "col", "val")})


def replay_repair(state, delta):
    """``update_graph``'s repair lane on a captured graph state (COO,
    permuted COO, per-row counts, schedule, permutation, inverse, config),
    timed and not published: ``(schedule, stats, apply_s, repair_s)``."""
    from repro_torch.core import csc as fmt
    from repro_torch.core import schedule as tsched
    from repro_torch.serving.gcn_engine import _geometry_kwargs

    coo, pcoo, per_row_old, sched, perm, inv, config = state
    t0 = time.perf_counter()
    new_coo, rep = fmt.apply_edge_delta(coo, delta, with_report=True)
    per_row_new = per_row_old.copy()
    per_row_new[rep.touched_rows] += rep.row_nnz_delta
    base, touched = new_coo, rep.touched_rows
    if perm is not None:
        pdelta = fmt.EdgeDelta(inv[delta.row], delta.col, delta.val)
        base, prep = fmt.apply_edge_delta(pcoo, pdelta, with_report=True)
        touched = prep.touched_rows
        per_row_old, per_row_new = per_row_old[perm], per_row_new[perm]
    apply_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_sched, stats = tsched.repair_schedule(
        sched, None, base, touched, per_row_old=per_row_old,
        per_row_new=per_row_new, **_geometry_kwargs(config))
    return new_sched, stats, apply_s, time.perf_counter() - t0


def state_of(rec):
    """The graph state ``replay_repair`` starts from."""
    return (rec.coo, rec.pcoo, rec.per_row, rec.sched, rec.perm, rec.inv, rec.config)


def prune_store(store, keep):
    """Delete the store entries of superseded revisions (each about 342 MB
    on reddit): every entry not in ``keep`` except the newest."""
    extra = sorted((p for p in store.dir.glob("*.npz") if p not in keep),
                   key=lambda p: p.stat().st_mtime)
    for p in extra[:-1]:
        p.unlink()


def phase_streaming(dev, ds, store):
    """Edge updates streamed into reddit through ``update_graph``; see the
    module docstring's phase 7. Returns the ``engine_streaming`` record."""
    import dataclasses
    import gc
    import threading

    import numpy as np
    import torch

    from repro_torch.core import csc as fmt
    from repro_torch.core import gcn
    from repro_torch.core import schedule as tsched
    from repro_torch.core.executor import (ScheduleExecutor, release_device_steps,
                                           repaired_executor, value_patched_executor)
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.serving.gcn_engine import GCNServingEngine, _dedup_value_delta
    from repro_torch.tuning import registry, runner
    from repro_torch.tuning.store import TuningStore

    wrapped = {"measure_candidate": runner, "build_balanced_schedule": tsched}
    originals = {name: getattr(mod, name) for name, mod in wrapped.items()}
    calls = dict.fromkeys(wrapped, 0)

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    def cand(cfg):
        """A one-candidate sweep pinning ``cfg`` (the streaming suite's)."""
        return dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
            nnz_per_step=cfg.nnz_per_step, rows_per_window=cfg.rows_per_window,
            cols_per_block=cfg.cols_per_block, window_nnz=cfg.window_nnz,
            routing=cfg.routing, ktile=cfg.ktile, reorder=cfg.reorder)])

    n = ds.num_nodes
    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
    x = torch.from_numpy(ds.features).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)  # phase 2's requests
    reqs = [x * (torch.rand(x.shape, generator=gen, device=dev) < KEEP)
            for _ in range(BATCH_SIZE)]
    del x
    keep = set(store.dir.glob("*.npz"))
    rng = np.random.default_rng(STREAM_SEED)
    registry.clear_caches()
    for name, mod in wrapped.items():
        setattr(mod, name, counted(name))
    try:
        torch.cuda.synchronize()
        gc.collect()
        base_bytes = torch.cuda.memory_allocated(dev)
        spmm_cuda.reset_launches()
        # -- warm admission from phase 6's store ----------------------------
        eng = GCNServingEngine(store=store, max_batch=ENGINE_MAX_BATCH,
                               device_budget_bytes=1 << 40)
        t0 = time.perf_counter()
        adm = eng.add_graph("reddit", ds.adj, params)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if not adm.warm_start or any(calls.values()):
            raise AssertionError(f"phase 7's admission was not warm: {adm}, {calls}")
        eng.infer("reddit", reqs[0])
        # -- the value lane: warm-up, then timed updates ----------------------
        for _ in range(STREAM_WARMUP):
            eng.update_graph("reddit", value_delta(eng._graphs["reddit"].coo,
                                                   STREAM_EDGES, rng))
        value_s, persist_s = [], []
        for _ in range(STREAM_TIMED):
            delta = value_delta(eng._graphs["reddit"].coo, STREAM_EDGES, rng)
            # the previous revision's O(nnz) fingerprint and store write
            # finish first, so their host time stays out of the update's
            t0 = time.perf_counter()
            eng.drain_persists()
            persist_s.append(time.perf_counter() - t0)
            prune_store(store, keep)
            rep = eng.update_graph("reddit", delta)
            if not (rep.repaired and rep.scoped_upload and not rep.fell_back):
                raise AssertionError(f"a value update left the value lane: {rep}")
            value_s.append(rep.update_seconds)
        eng.drain_persists()
        prune_store(store, keep)
        # -- alternating chain under concurrent serving ----------------------
        old_ex = eng._graphs["reddit"].executor
        old_arrays = [t.clone() for t in old_ex._steps[:5]]
        stop, served, failures = threading.Event(), [0], []

        def background():
            while not stop.is_set():
                try:
                    y = eng.infer("reddit", reqs[1])
                    if y.shape != (n, ds.num_classes) or not torch.isfinite(y).all():
                        raise AssertionError(f"malformed logits {tuple(y.shape)}")
                    served[0] += 1
                except Exception as e:  # the failure this phase counts
                    failures.append(repr(e))
                    return

        th = threading.Thread(target=background, daemon=True)
        th.start()
        chain = []
        try:
            for i in range(STREAM_CHAIN):
                coo = eng._graphs["reddit"].coo
                delta = (value_delta(coo, STREAM_EDGES, rng) if i % 2 == 0
                         else structural_delta(n, STREAM_EDGES, rng))
                rep = eng.update_graph("reddit", delta)
                if not rep.repaired or rep.fell_back:
                    raise AssertionError(f"chain update {i} not repaired: {rep}")
                chain.append({
                    "kind": "value" if i % 2 == 0 else "structural",
                    "update_seconds": rep.update_seconds,
                    "steps_reused": rep.steps_reused,
                    "n_steps": eng._graphs["reddit"].sched.n_steps,
                    "windows_reused": rep.windows_reused,
                    "windows_total": rep.windows_total,
                    "scoped_upload": rep.scoped_upload})
        finally:
            stop.set()
            th.join(timeout=120.0)
        if th.is_alive() or failures or served[0] == 0:
            raise AssertionError(f"serving during the chain: {served[0]} served, "
                                 f"failures {failures}")
        if not all(torch.equal(t, c) for t, c in zip(old_ex._steps[:5], old_arrays)):
            raise AssertionError("a swap wrote into the old executor's arrays")
        del old_ex, old_arrays
        eng.drain_persists()
        prune_store(store, keep)
        # -- where an update's time goes: both lanes' stages, replayed on
        # the served state without publishing ------------------------------
        rec = eng._graphs["reddit"]
        split = {}
        delta = value_delta(rec.coo, STREAM_EDGES, rng)
        t0 = time.perf_counter()
        fmt.apply_edge_delta(rec.coo, delta, with_report=True)
        split["value_apply_edge_delta_s"] = time.perf_counter() - t0
        rows, cols, vals = _dedup_value_delta(delta, n)
        if rec.perm is not None:
            rows = rec.inv[rows]
        # what the first value update after a structural one pays: the
        # structural swap drops the slot index
        t0 = time.perf_counter()
        index = tsched.slot_entry_keys(rec.sched)
        split["slot_entry_keys_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vsched, slots = tsched.value_patch_schedule(rec.sched, index, rows, cols, vals)
        split["value_patch_schedule_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vex = value_patched_executor(rec.executor, vsched, slots, vsched.val[slots])
        torch.cuda.synchronize()
        split["value_patched_executor_s"] = time.perf_counter() - t0
        del vex, index
        release_device_steps(vsched)
        ssched, sstats, split["structural_apply_edge_delta_s"], \
            split["structural_repair_schedule_s"] = replay_repair(
                state_of(rec), structural_delta(n, STREAM_EDGES, rng))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sex = repaired_executor(rec.executor, ssched, sstats)
        torch.cuda.synchronize()
        split["structural_repaired_executor_s"] = time.perf_counter() - t0
        split["structural_scoped_upload"] = sex.scoped_upload
        split["structural_steps_reused"] = sstats.steps_reused
        del sex
        release_device_steps(ssched)
        # -- one wide structural update, then its repair replayed ------------
        state = state_of(rec)
        old_ex = rec.executor
        delta = structural_delta(n, STREAM_WIDE, rng)
        wide = eng.update_graph("reddit", delta)
        if not wide.repaired or wide.fell_back:
            raise AssertionError(f"the wide update was not repaired: {wide}")
        replay, stats, wide_apply_s, wide_repair_s = replay_repair(state, delta)
        rec = eng._graphs["reddit"]
        for f in tsched._ARRAY_FIELDS:
            if not np.array_equal(getattr(replay, f), getattr(rec.sched, f)):
                raise AssertionError(f"the replayed repair differs in {f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rex = repaired_executor(old_ex, replay, stats)
        torch.cuda.synchronize()
        rex_s = time.perf_counter() - t0
        twin = dataclasses.replace(replay)  # a new identity: no upload to reuse
        t0 = time.perf_counter()
        cold = ScheduleExecutor(twin, ktile=rec.config.ktile,
                                routing=rec.config.routing, device=dev,
                                row_unperm=rec.inv)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(rex._steps[:5], cold._steps[:5])):
            raise AssertionError("the spliced upload differs from a cold one")
        wide_scoped_replay = rex.scoped_upload
        del rex, cold, old_ex
        release_device_steps(replay)
        release_device_steps(twin)
        # -- memory: the engine's accounting ---------------------------------
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev) - base_bytes
        engine_bytes = eng.device_bytes_in_use
        if abs(held - engine_bytes) > 0.05 * engine_bytes + (64 << 20):
            raise AssertionError(f"after the chain {held} bytes are allocated for the "
                                 f"engine's {eng.device_bytes_in_use}")
        # -- correctness after the chain -------------------------------------
        rec = eng._graphs["reddit"]
        outs = eng.serve_batch("reddit", reqs)
        adj = coo_on(rec.coo, dev)
        max_err = 0.0
        for out, r in zip(outs, reqs):
            max_err = max(max_err, check("streamed logits", out,
                                         gcn.forward(params, adj, r), torch.float32))
        del adj
        pinned = GCNServingEngine(store=TuningStore(tempfile.mkdtemp(
            prefix="chip_smoke_pinned_", dir=ROOT / "build")),
            autotune_kwargs=cand(rec.config), device_budget_bytes=1 << 40)
        t0 = time.perf_counter()
        pinned.add_graph("reddit", rec.coo, params)
        pinned_s = time.perf_counter() - t0
        if not torch.equal(pinned.serve_batch("reddit", reqs), outs):
            raise AssertionError("streamed logits differ from a cold admission's")
        pinned.remove_graph("reddit")
        del pinned
        # -- persist, then a restart ----------------------------------------
        t0 = time.perf_counter()
        eng.drain_persists()
        drain_s = time.perf_counter() - t0
        fp = registry.graph_fingerprint(rec.coo)
        if rec.fingerprint != fp:
            raise AssertionError("the persist worker did not back-fill the fingerprint")
        final_coo = rec.coo
        launches = dict(spmm_cuda.LAUNCHES)
        stats_ = eng.stats()
        eng.remove_graph("reddit")
        del eng, rec
        torch.cuda.empty_cache()
        registry.clear_caches()
        before = dict(calls)
        eng2 = GCNServingEngine(store=store, max_batch=ENGINE_MAX_BATCH,
                                device_budget_bytes=1 << 40)
        t0 = time.perf_counter()
        again = eng2.add_graph("reddit", final_coo, params)
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        restart_calls = {k: calls[k] - before[k] for k in calls}
        if not again.warm_start or any(restart_calls.values()):
            raise AssertionError(f"restart was not warm: {again}, {restart_calls}")
        if not torch.equal(eng2.serve_batch("reddit", reqs), outs):
            raise AssertionError("the restarted engine's logits differ")
        eng2.remove_graph("reddit")
        del eng2, outs
        # -- drift re-tune on pubmed ----------------------------------------
        pub = synth.make_dataset(DRIFT_GRAPH, scale=1, device=dev)
        pcfg = gcn.GCNConfig(pub.num_features, pub.hidden, pub.num_classes)
        pparams = gcn.params_from_jax(glorot(pcfg.dims, seed=0), dev)
        px = torch.from_numpy(pub.features).to(dev)
        peng = GCNServingEngine(
            store=TuningStore(tempfile.mkdtemp(prefix="chip_smoke_drift_",
                                               dir=ROOT / "build")),
            repair_drift_threshold=1e-9, device_budget_bytes=1 << 40,
            autotune_kwargs=dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
                nnz_per_step=256, rows_per_window=64, cols_per_block=None,
                window_nnz=None, routing="gather")]))
        peng.add_graph(DRIFT_GRAPH, pub.adj, pparams)
        peng.infer(DRIFT_GRAPH, px)
        drift = peng.update_graph(DRIFT_GRAPH, value_delta(
            peng._graphs[DRIFT_GRAPH].coo, STREAM_EDGES, rng))
        if drift.repaired or peng.counters["update_retunes"] != 1:
            raise AssertionError(f"the drift update did not re-tune: {drift}")
        drift_err = check("re-tuned pubmed logits", peng.infer(DRIFT_GRAPH, px),
                          gcn.forward(pparams, coo_on(peng._graphs[DRIFT_GRAPH].coo,
                                                      dev), px), torch.float32)
        peng.remove_graph(DRIFT_GRAPH)
        del peng, pub, px
    finally:
        for name, mod in wrapped.items():
            setattr(mod, name, originals[name])
    torch.cuda.empty_cache()
    for name in F32_SPMM:
        if launches[name] == 0:
            raise AssertionError(f"phase 7 never launched {name}")
    structural = [c for c in chain if c["kind"] == "structural"]
    return {
        "graph": "reddit", "store": "phase 6's", "delta_edges": STREAM_EDGES,
        "seed": STREAM_SEED, "warm_add_graph_s": warm_s,
        "value_updates_timed": len(value_s), "value_update_s": value_s,
        "value_update_median_s": float(np.median(value_s)),
        "value_updates_scoped": len(value_s), "persist_s": persist_s,
        "persist_median_s": float(np.median(persist_s)), "split": split,
        "chain": chain, "chain_served": served[0], "chain_failures": len(failures),
        "structural_median_s": float(np.median([c["update_seconds"]
                                                for c in structural])),
        "wide_edges": STREAM_WIDE, "wide_update_s": wide.update_seconds,
        "wide_steps_reused": wide.steps_reused,
        "wide_windows_reused": wide.windows_reused,
        "wide_windows_total": wide.windows_total,
        "wide_scoped_upload": wide.scoped_upload,
        "wide_replay_scoped_upload": wide_scoped_replay,
        "wide_apply_edge_delta_s": wide_apply_s,
        "wide_repair_schedule_s": wide_repair_s,
        "wide_repaired_executor_s": rex_s, "wide_cold_executor_s": cold_s,
        "wide_upload_equal_cold": True,
        "final_nnz": int(final_coo.row.shape[0]), "max_abs_err": max_err,
        "logits_equal_cold_admission": True, "pinned_add_graph_s": pinned_s,
        "drain_persists_s": drain_s, "restart_add_graph_s": restart_s,
        "restart_calls": restart_calls, "restart_logits_equal": True,
        "held_bytes": held, "device_bytes_in_use": engine_bytes,
        "graph_updates": stats_["graph_updates"],
        "drift_graph": DRIFT_GRAPH, "drift_repaired": drift.repaired,
        "drift_update_s": drift.update_seconds, "drift_max_abs_err": drift_err,
        "launches": launches,
    }


def phase_training(dev, ds):
    """GCN training on reddit through ``spmm_cuda.make_spmm_fn``: forward on
    A's schedule, backward on Aᵀ's; see the module docstring's phase 8.
    Returns the ``gcn_training`` record and the Aᵀ kernels' entries of the
    kernels line."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import csc as fmt
    from repro_torch.core import executor, gcn
    from repro_torch.kernels import spmm_cuda
    from repro_torch.training import optimizer as opt
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import flatten_with_paths
    from repro_torch.tuning import registry

    registry.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    # every schedule planned or uploaded in this phase, in order
    planned = []
    real_plan, real_upload = spmm_cuda.kernel_plan, executor._upload_plan

    def counted_plan(sched):
        planned.append(("plan", sched.shape))
        return real_plan(sched)

    def counted_upload(plan, shape, device):
        planned.append(("upload", shape))
        return real_upload(plan, shape, device)

    spmm_cuda.kernel_plan, executor._upload_plan = counted_plan, counted_upload
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    mgr = CheckpointManager(ckpt_dir, keep=2, async_write=True)
    try:
        # -- the schedules: A's (as phase 2 built it), then Aᵀ's ------------
        t0 = time.perf_counter()
        registry.get_schedule(ds.adj)
        build_a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f = spmm_cuda.make_spmm_fn(ds.adj)
        build_at_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        steps_a = f.device_steps(False, dev)
        torch.cuda.synchronize()
        upload_a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        steps_t = f.device_steps(True, dev)
        torch.cuda.synchronize()
        upload_at_s = time.perf_counter() - t0
        geometry = {"A": schedule_geometry(f.sched, steps_a),
                    "AT": schedule_geometry(f.sched_t, steps_t)}
        cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
        params0 = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
        x = torch.from_numpy(ds.features).to(dev)
        labels = torch.from_numpy(ds.labels).to(dev)
        adj = coo_on(ds.adj, dev)
        ocfg = opt.AdamWConfig(**TRAIN_ADAMW)

        def loss_grads(params, spmm_fn, events=None):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss = gcn.loss_fn(p, adj, x, labels, spmm_fn=spmm_fn)
            fwd = dict(spmm_cuda.LAUNCHES)
            if events:
                events[1].record()
            grads = torch.autograd.grad(loss, list(p.values()))
            return loss.detach(), dict(zip(p, grads)), fwd

        # -- gradients: kernels vs plain versions vs the COO product ---------
        plain = spmm_cuda.make_spmm_fn(ds.adj, schedules=(f.sched, f.sched_t),
                                       backend="torch")
        loss_k, g_k, _ = loss_grads(params0, f)
        loss_p, g_p, _ = loss_grads(params0, plain)
        loss_c, g_c, _ = loss_grads(params0, None)
        grad_err = {"plain": 0.0, "coo": 0.0}
        for k in g_k:
            for route, gold in (("plain", g_p[k]), ("coo", g_c[k])):
                grad_err[route] = max(grad_err[route], check(
                    f"d{k} vs {route}", g_k[k], gold, torch.float32))
        loss_err = max(check("loss vs plain", loss_k, loss_p, torch.float32),
                       check("loss vs COO", loss_k, loss_c, torch.float32))
        del g_p, g_c, plain

        # -- 20 AdamW steps through the kernels, checkpointed at step 10 ------
        def run(params, state, spmm_fn, first, last, save=False):
            losses, split, host_ms, launches = [], [], [], []
            for i in range(first, last + 1):
                before, n_planned = dict(spmm_cuda.LAUNCHES), len(planned)
                events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                events[0].record()
                loss, grads, fwd = loss_grads(params, spmm_fn, events)
                events[2].record()
                params, state, _ = opt.adamw_update(ocfg, grads, state,
                                                    param_dtype=torch.float32)
                events[3].record()
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                split.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])
                losses.append(float(loss))
                after = spmm_cuda.LAUNCHES
                launches.append({n: (fwd[n] - before[n], after[n] - fwd[n])
                                 for n in F32_SPMM})
                if i > 1 and len(planned) != n_planned:
                    raise AssertionError(f"step {i} planned or uploaded a schedule: "
                                         f"{planned[n_planned:]}")
                if save and i == TRAIN_SAVE_AT:
                    t0 = time.perf_counter()
                    mgr.save(i, (params, state), block=False)
                    save_s = time.perf_counter() - t0
                    saved = {k: v.cpu().numpy() for k, v in
                             flatten_with_paths((params, state)).items()}
            out = {"params": params, "state": state, "losses": losses,
                   "split": split, "host_ms": host_ms, "launches": launches}
            if save:
                out.update(saved=saved, save_s=save_s)
            return out

        spmm_cuda.reset_launches()
        main = run(params0, opt.adamw_init(params0), f, 1, TRAIN_STEPS, save=True)
        launches = dict(spmm_cuda.LAUNCHES)
        for name in F32_SPMM:
            if launches[name] == 0:
                raise AssertionError(f"phase 8 never launched {name}")
            for i, step in enumerate(main["launches"], 1):
                if step[name] != (2, 2):
                    raise AssertionError(f"step {i} launched {name} {step[name]} "
                                         "times (forward, backward); want (2, 2)")
        losses = main["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        coo = run(params0, opt.adamw_init(params0), None, 1, TRAIN_STEPS)
        loss_diff = []
        for i, (lk, lc) in enumerate(zip(losses, coo["losses"]), 1):
            loss_diff.append(check(f"step {i} loss vs COO", torch.tensor(lk),
                                   torch.tensor(lc), torch.float32))

        # -- resume from the step-10 checkpoint -------------------------------
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        template = {k: torch.zeros_like(v) for k, v in params0.items()}
        template = (template, opt.adamw_init(template))
        t0 = time.perf_counter()
        (rparams, rstate), meta = mgr.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if meta["step"] != TRAIN_SAVE_AT or int(rstate["count"]) != TRAIN_SAVE_AT:
            raise AssertionError(
                f"restored step {meta['step']}, count {int(rstate['count'])}")
        resumed = run(rparams, rstate, f, TRAIN_SAVE_AT + 1, TRAIN_STEPS)
        if resumed["losses"] != losses[TRAIN_SAVE_AT:]:
            raise AssertionError(f"resumed losses {resumed['losses']} differ from "
                                 f"{losses[TRAIN_SAVE_AT:]}")
        for k, v in flatten_with_paths((main["params"], main["state"])).items():
            got = flatten_with_paths((resumed["params"], resumed["state"]))[k]
            if not torch.equal(got, v):
                raise AssertionError(
                    f"resumed {k} differs from the uninterrupted run's")
        again, _ = mgr.restore(template)
        for k, v in flatten_with_paths(again).items():
            if not np.array_equal(v.cpu().numpy(), main["saved"][k]):
                raise AssertionError(
                    f"checkpoint array {k} differs from what was saved")

        # -- the Aᵀ kernels at the backward's widths --------------------------
        m, n = ds.adj.shape
        csr_t = fmt.csr_from_coo(fmt.transpose_coo(ds.adj))
        at_csr = torch.sparse_csr_tensor(
            csr_t.indptr.long(), csr_t.indices.long(), csr_t.data, size=(n, m)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(8)
        rows = {"spmm_balanced": [], "spmm_epilogue": []}
        for kdim in (ds.hidden, ds.num_classes):
            b = torch.randn((m, kdim), generator=gen, device=dev)
            window, epilogue, _ = spmm_rows(steps_t, at_csr, b, f.ktile, what="Aᵀ ")
            rows["spmm_balanced"].append({**window, "main_path": True})
            rows["spmm_epilogue"].append({**epilogue, "main_path": True})
            del b
        bwd_launches = {name: sum(s[name][1] for s in main["launches"])
                        for name in F32_SPMM}
        kernels = kernel_entries(rows, bwd_launches,
                                 "one training step's backward (both layers)", "@AT")
        del at_csr, steps_a, steps_t, f, x, adj
    finally:
        spmm_cuda.kernel_plan, executor._upload_plan = real_plan, real_upload
        mgr.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    registry.clear_caches()
    torch.cuda.empty_cache()

    def mean_split(run_):
        steady = np.array(run_["split"][1:])
        return {"forward_ms": float(steady[:, 0].mean()),
                "backward_ms": float(steady[:, 1].mean()),
                "optimizer_ms": float(steady[:, 2].mean()),
                "device_ms": float(steady.sum(axis=1).mean()),
                "host_ms": float(np.mean(run_["host_ms"][1:])),
                "first_step_host_ms": run_["host_ms"][0]}

    record = {
        "graph": ds.name, "nodes": ds.num_nodes, "features": ds.num_features,
        "hidden": ds.hidden, "classes": ds.num_classes, "steps": TRAIN_STEPS,
        "adamw": TRAIN_ADAMW, "param_dtype": "float32", "schedule": geometry,
        "build_a_s": build_a_s, "build_at_s": build_at_s,
        "upload_a_s": upload_a_s, "upload_at_s": upload_at_s,
        "grad_max_abs_err": grad_err, "loss_max_abs_err": loss_err,
        "losses": losses, "coo_losses": coo["losses"],
        "loss_vs_coo_max_abs_diff": max(loss_diff),
        "step": mean_split(main), "coo_step": mean_split(coo),
        "launches": launches, "launches_per_step": main["launches"][0],
        "planned_or_uploaded_after_step_1": 0,
        "planned_before_the_steps": [list(p) for p in planned],
        "checkpoint": {"step": TRAIN_SAVE_AT, "save_s": main["save_s"],
                       "wait_s": wait_s, "restore_s": restore_s,
                       "resumed_losses_equal": True, "resumed_state_equal": True,
                       "arrays_equal": True},
    }
    return record, kernels


def mesh_of(dev, d):
    """``d`` mesh positions round robin over the visible cards: on one card
    every position names ``dev``."""
    import torch

    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return [dev if n == 1 else torch.device("cuda", i % n) for i in range(d)]


def allocated(mesh) -> int:
    """Bytes allocated on the mesh's distinct devices."""
    import torch

    return sum(torch.cuda.memory_allocated(x) for x in {str(x): x for x in mesh}.values())


def phase9_requests(ds, dev):
    """Phase 2's weights and its first batch of 4 requests."""
    import torch

    from repro_torch.core import gcn

    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
    x = torch.from_numpy(ds.features).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)  # phase 2's requests
    xb = torch.stack([x * (torch.rand(x.shape, generator=gen, device=dev) < KEEP)
                      for _ in range(BATCH_SIZE)])
    return params, xb


def phase_mesh_executor(dev, ds):
    """``ShardedScheduleExecutor`` on phase 2's reddit schedule over
    ``MESH_SIZES`` positions (round robin over the visible cards); see the
    module docstring's phase 9a. Returns the ``mesh_executor`` record and the launches per
    sharded ``forward_batch``."""
    import torch

    from repro_torch.core import executor as texe
    from repro_torch.core import gcn
    from repro_torch.kernels import spmm_cuda
    from repro_torch.sharding import schedule_shard
    from repro_torch.tuning import registry

    m, n = ds.adj.shape
    params, xb = phase9_requests(ds, dev)
    adj = coo_on(ds.adj, dev)
    golds = [gcn.forward(params, adj, xb[i]) for i in range(BATCH_SIZE)]
    del adj
    single = registry.get_executor(ds.adj, device=dev)  # phase 2's executor
    sched = single.sched
    gold_single = single.forward_batch(params, xb)
    widths = (BATCH_SIZE * ds.hidden, BATCH_SIZE * ds.num_classes)
    gen = torch.Generator(device=dev).manual_seed(9)
    ops = {k: torch.randn((n, k), generator=gen, device=dev) for k in widths}
    single_ms = timed_ms(lambda: single.forward_batch(params, xb), 5)
    single_spmm = {str(k): timed_ms(lambda b=b: single.spmm(b), 10)
                   for k, b in ops.items()}
    # one add of two [m, kdim] f32 partials: the ordered sum's unit of work
    add_ms = {}
    for k in widths:
        p0, p1 = torch.randn((m, k), device=dev), torch.randn((m, k), device=dev)
        add_ms[str(k)] = timed_ms(lambda p0=p0, p1=p1: p0.add_(p1), 10)
        del p0, p1
    # the batch's X·W products: one per request (forward_batch's, so a
    # request's logits do not depend on its batch) against one GEMM over
    # the stacked requests
    h1 = torch.relu(xb @ params["w0"])
    dense_ms = {
        "per_request": timed_ms(lambda: [torch.matmul(xb[j], params["w0"]) for j in
                                         range(BATCH_SIZE)] + [torch.matmul(
                                             h1[j], params["w1"]) for j in
                                             range(BATCH_SIZE)], 5),
        "batched": timed_ms(lambda: (xb @ params["w0"], h1 @ params["w1"]), 5),
    }
    del h1
    live_single = int(single._steps.slots.shape[0])
    del single
    torch.cuda.empty_cache()
    records, launches_per = [], {}
    for d in MESH_SIZES:
        mesh = mesh_of(dev, d)
        torch.cuda.synchronize()
        base = allocated(mesh)
        t0 = time.perf_counter()
        ex = texe.ShardedScheduleExecutor(sched, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = allocated(mesh) - base
        if not ex.device_bytes <= held <= ex.device_bytes + (1 << 20):
            raise AssertionError(f"{d} positions hold {held} bytes for their "
                                 f"device_bytes {ex.device_bytes}")
        steps = schedule_shard.shard_step_counts(sched.n_steps, d)
        nnz = schedule_shard.shard_nnz(sched, d)
        live = [int(s.slots.shape[0]) for s in ex._steps]
        if steps.max() - steps.min() > 1 or int(nnz.sum()) != sched.nnz or (
                sum(live) != live_single):
            raise AssertionError(f"shards of {d}: steps {steps}, nnz {nnz}, live {live}")
        spmm_cuda.reset_launches()
        out = ex.forward_batch(params, xb)
        torch.cuda.synchronize()
        launches = dict(spmm_cuda.LAUNCHES)
        for name in F32_SPMM:
            if launches[name] != 2 * d:
                raise AssertionError(f"{d} positions: {launches[name]} launches of "
                                     f"{name} in one forward_batch (want {2 * d})")
        launches_per[str(d)] = {name: launches[name] for name in F32_SPMM}
        if not torch.equal(out, ex.forward_batch(params, xb)):
            raise AssertionError(f"{d} positions: two calls differ")
        err_single = check(f"mesh {d} vs single-device", out, gold_single, torch.float32)
        err_coo = max(check(f"mesh {d} request {i}", out[i], golds[i], torch.float32)
                      for i in range(BATCH_SIZE))
        batch_ms = timed_ms(lambda: ex.forward_batch(params, xb), 5)
        spmm_ms = {str(k): timed_ms(lambda b=b: ex.spmm(b), 10) for k, b in ops.items()}
        records.append({
            "positions": d, "mesh": [str(x) for x in mesh], "build_s": build_s, "device_bytes": ex.device_bytes,
            "allocated_bytes": held, "steps_per_shard": steps.tolist(),
            "nnz_per_shard": nnz.tolist(), "live_slots_per_shard": live,
            "max_abs_err_vs_single": err_single, "max_abs_err_vs_coo": err_coo,
            "bit_equal_calls": True, "batch_ms": batch_ms,
            "batch_ms_single": single_ms, "spmm_ms": spmm_ms,
            "spmm_ms_single": single_spmm,
            # the partials' bytes: D [m, kdim] f32 rows written by the
            # epilogues and read by the sum, at HBM rate
            "partial_bytes": {str(k): d * m * k * 4 for k in widths},
            "partial_bytes_ms": {str(k): d * m * k * 4 / PEAK_BYTES_PER_S * 1e3
                                 for k in widths},
        })
        del ex, out
        texe.release_device_steps(sched)
        torch.cuda.empty_cache()
    return {"graph": "reddit", "nodes": m, "nnz": int(sched.nnz),
            "n_steps": sched.n_steps, "widths": list(widths), "add_ms": add_ms,
            "dense_xw_ms": dense_ms,
            "cards": len({str(x) for x in mesh_of(dev, max(MESH_SIZES))}),
            "note": "positions that name one card run one after another: there "
                    "this measures the sharded path's cost, not scaling",
            "meshes": records}, launches_per


def phase_mesh_engine(dev, ds):
    """``GCNServingEngine`` on ``MESH_ENGINE_POSITIONS`` positions (round
    robin over the visible cards); see the module docstring's phase 9b. Returns the ``engine_mesh``
    record."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import gcn
    from repro_torch.core.executor import FAULTS, ShardedScheduleExecutor
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.serving.gcn_engine import GCNServingEngine
    from repro_torch.serving.placement import REPLICATED, SHARDED, SINGLE
    from repro_torch.tuning import registry
    from repro_torch.tuning.store import TuningStore

    d = MESH_ENGINE_POSITIONS
    mesh = mesh_of(dev, d)
    one = dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
        nnz_per_step=256, rows_per_window=64, cols_per_block=None, window_nnz=None,
        routing="gather")])
    params, xb = phase9_requests(ds, dev)
    reqs = list(xb)
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=ROOT / "build")
            for _ in range(4)]
    rng = np.random.default_rng(STREAM_SEED)
    small = {}
    for name in MESH_SMALL:
        sd = synth.make_dataset(name, scale=1, device=dev)
        scfg = gcn.GCNConfig(sd.num_features, sd.hidden, sd.num_classes)
        sx = torch.from_numpy(sd.features).to(dev)
        small[name] = (sd.adj, gcn.params_from_jax(glorot(scfg.dims, seed=0), dev),
                       [sx * (1.0 - 0.02 * i) for i in range(MESH_HOT_REQUESTS)])
    est = ds.adj.nnz * 16
    budget = est // 4  # reddit over one position's budget: the sharded route
    registry.clear_caches()
    FAULTS.clear()
    try:
        spmm_cuda.reset_launches()
        eng = GCNServingEngine(store=TuningStore(dirs[0]), devices=mesh,
                               device_budget_bytes=budget, max_replicas=3,
                               replicate_after_s=1e-6, replica_shrink_after=10**6,
                               max_batch=64, autotune_kwargs=one)
        t0 = time.perf_counter()
        cold = eng.add_graph("reddit", ds.adj, params)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        rec = eng._graphs["reddit"]
        if (cold.warm_start or cold.placement.kind != SHARDED
                or cold.config.n_devices != d
                or not isinstance(rec.executor, ShardedScheduleExecutor)):
            raise AssertionError(f"reddit did not take the sharded route: {cold}")
        for r in reqs:
            eng.submit("reddit", r, deadline_s=ENGINE_DEADLINE_S)
        out = eng.flush()["reddit"]
        single = registry.get_executor(ds.adj, device=dev)
        gold = single.forward_batch(params, xb)
        registry.clear_caches()
        err = check("sharded engine vs single-device", out, gold, torch.float32)
        del single, gold
        # -- a warm restart of the sharded route -----------------------------
        warm_eng = GCNServingEngine(store=TuningStore(dirs[0]), devices=mesh,
                                    device_budget_bytes=budget, autotune_kwargs=one)
        t0 = time.perf_counter()
        warm = warm_eng.add_graph("reddit", ds.adj, params)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if not warm.warm_start or warm.placement.kind != SHARDED:
            raise AssertionError(f"the restart was not warm: {warm}")
        if not torch.equal(warm_eng.serve_batch("reddit", reqs), out):
            raise AssertionError("the warm restart's logits differ")
        warm_eng.remove_graph("reddit")
        del warm_eng
        torch.cuda.empty_cache()
        # -- small graphs on single positions; the hot one replicates -------
        placements = {}
        for name, (adj, sp, sreqs) in small.items():
            rep = eng.add_graph(name, adj, sp)
            if rep.placement.kind != SINGLE:
                raise AssertionError(f"{name} did not take one position: {rep}")
            placements[name] = rep.placement.device_index
            eng.infer(name, sreqs[0])
        hot = MESH_SMALL[0]
        adj, sp, sreqs = small[hot]
        base_eng = GCNServingEngine(store=TuningStore(dirs[1]), devices=mesh,
                                    max_replicas=1, autotune_kwargs=one)
        base_eng.add_graph(hot, adj, sp)
        ref = base_eng.serve_batch(hot, sreqs)
        eng.serve_batch(hot, sreqs[:2])  # prime the service EWMA
        t0 = time.perf_counter()
        for _ in range(3):
            for r in sreqs:
                eng.submit(hot, r, deadline_s=0.0)
            if not torch.equal(eng.poll()[hot], ref):
                raise AssertionError("replicated logits differ from one replica's")
        grow_s = time.perf_counter() - t0
        pl = eng.placer.placement_of(hot)
        if pl.kind != REPLICATED or len(pl.device_indices) != 3:
            raise AssertionError(f"{hot} did not replicate: {pl}")
        replicas = eng.stats()["replicas"]
        # -- a failed replica chunk retries on a sibling ---------------------
        victim = sorted(eng._graphs[hot].replicas)[0]
        FAULTS.arm("replica_chunk", graph=hot, device=victim, times=1)
        if not torch.equal(eng.serve_batch(hot, sreqs), ref):
            raise AssertionError("the sibling retry changed the logits")
        if FAULTS.fired != [("replica_chunk", hot, victim)]:
            raise AssertionError(f"the fault did not fire: {FAULTS.fired}")
        fired = [list(f) for f in FAULTS.fired]
        FAULTS.clear()
        # -- updates: sharded reddit, replicated hot ------------------------
        updates = []
        for kind in ("value", "structural"):
            delta = (value_delta(eng._graphs["reddit"].coo, STREAM_EDGES, rng)
                     if kind == "value" else structural_delta(ds.num_nodes,
                                                              STREAM_EDGES, rng))
            t0 = time.perf_counter()
            urep = eng.update_graph("reddit", delta)
            torch.cuda.synchronize()
            updates.append({"kind": kind, "update_seconds": time.perf_counter() - t0,
                            "repaired": urep.repaired, "fell_back": urep.fell_back,
                            "scoped_upload": urep.scoped_upload,
                            "dirty_positions": getattr(eng._graphs["reddit"].executor,
                                                       "dirty_devices", None)})
            if not urep.repaired or urep.fell_back:
                raise AssertionError(f"the {kind} update did not repair: {urep}")
        urep = eng.update_graph(hot, value_delta(eng._graphs[hot].coo, STREAM_EDGES, rng))
        if not urep.repaired or not urep.scoped_upload:
            raise AssertionError(f"the update of replicated {hot}: {urep}")
        outs = [u.executor.forward_batch(u.params, torch.stack(sreqs[:1])).to(dev)
                for u in eng._units(eng._graphs[hot])]
        if len(outs) != 3 or not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError("the replicas of the updated graph differ")
        streamed = eng.serve_batch("reddit", reqs)
        eng.drain_persists()
        # -- cold admissions of the final graphs ------------------------------
        cold_eng = GCNServingEngine(store=TuningStore(dirs[2]), devices=mesh,
                                    device_budget_bytes=budget, autotune_kwargs=one)
        cold_eng.add_graph("reddit", eng._graphs["reddit"].coo, params)
        if not torch.equal(cold_eng.serve_batch("reddit", reqs), streamed):
            raise AssertionError("streamed reddit differs from a cold admission's")
        cold_eng.remove_graph("reddit")
        del cold_eng
        hot_eng = GCNServingEngine(store=TuningStore(dirs[3]), device=dev,
                                   autotune_kwargs=one)
        hot_eng.add_graph(hot, eng._graphs[hot].coo, sp)
        if not torch.equal(hot_eng.infer(hot, sreqs[0]), outs[0][0]):
            raise AssertionError(f"updated {hot} differs from a cold admission's")
        del hot_eng
        launches = dict(spmm_cuda.LAUNCHES)
        st = eng.stats()
        if st["request_failures"] != 0 or st["chunk_retries"] < 1:
            raise AssertionError(f"failures {st['request_failures']}, "
                                 f"retries {st['chunk_retries']}")
        record = {
            "positions": d, "mesh": [str(x) for x in mesh], "budget_bytes": budget,
            "reddit_estimate_bytes": est,
            "cold_add_graph_s": cold_s, "warm_add_graph_s": warm_s,
            "reddit_device_bytes": cold.device_bytes, "max_abs_err": err,
            "placements": placements, "replicas": replicas,
            "replica_growth_s": grow_s, "updates": updates,
            "logits_equal_cold_admission": True, "replicas_bit_equal": True,
            "fault_fired": fired,
            "counters": {k: st[k] for k in (
                "request_failures", "chunk_retries", "replicas_added", "batches",
                "requests", "graph_updates", "evictions", "rebalances")},
            "per_device_bytes": [p["used_bytes"] for p in st["per_device"]],
            "launches": launches,
        }
        for name in small:
            eng.remove_graph(name)
        eng.remove_graph("reddit")
        del eng, base_eng
    finally:
        FAULTS.clear()
        for p in dirs:
            shutil.rmtree(p, ignore_errors=True)
    torch.cuda.empty_cache()
    for name in F32_SPMM:
        if launches[name] == 0:
            raise AssertionError(f"phase 9b never launched {name}")
    return record


def serve_requests(eng, reqs):
    """Submit ``reqs`` to reddit with deadlines, collect every batch (the
    ``max_batch`` threshold flushes them) and return the logits in order."""
    for r in reqs:
        t = eng.submit("reddit", r, deadline_s=ENGINE_DEADLINE_S)
        if not t.accepted:
            raise AssertionError(f"request refused: {t}")
    logits = eng.flush()["reddit"]
    if logits.shape[0] != len(reqs):
        raise AssertionError(f"served {logits.shape[0]} of {len(reqs)} requests")
    return list(logits)


def attn_tol(gold, dtype) -> float:
    import torch

    if dtype == torch.float32:
        return 2e-5 * max(1.0, float(gold.abs().max()))
    return 5e-2


def attn_row_err(got, gold) -> float:
    """The largest RMS error of an output row (over D) relative to that
    row's RMS in ``gold``."""
    err = (got.float() - gold).pow(2).mean(-1).sqrt()
    return float((err / gold.pow(2).mean(-1).sqrt().clamp_min(1e-30)).max())


def phase_attention_small(dev):
    """The flash kernel vs its plain version (on f32 copies of the same
    inputs) over the sweep. Returns (cases, max |err| in f32)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa

    cases, max_err = 0, 0.0
    for shape in ATTN_SHAPES + ATTN_SQ_OVER_SK:
        rng = np.random.default_rng(sum(shape))
        b, sq, sk, h, hkv, d = shape
        base = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
        qpos = torch.arange(sq, device=dev) + sk - sq
        for causal, window in ATTN_MASKS:
            # the rows that see at least one key
            hi = torch.clamp(qpos + 1, max=sk) if causal else torch.full_like(qpos, sk)
            lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
            rows = hi > lo
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in base)
                got = tfa.flash_attention(q, k, v, causal=causal, window=window)
                gold = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                                 causal=causal, window=window)
                if got.dtype != dtype:
                    raise AssertionError(f"flash_attention {shape}: {got.dtype} out")
                if d == 256 and not torch.equal(
                        got, tfa.flash_attention(q, k, v, causal=causal, window=window)):
                    raise AssertionError(f"flash_attention {shape} causal={causal} "
                                         f"window={window} {dtype}: two calls differ")
                got, gold = got[:, rows], gold[:, rows]
                err = float((got.float() - gold).abs().max())
                if not err <= attn_tol(gold, dtype):
                    raise AssertionError(
                        f"flash_attention {shape} causal={causal} window={window} "
                        f"{dtype}: max |err| {err} > {attn_tol(gold, dtype)}")
                if d == 256 and dtype == torch.bfloat16 and not (
                        attn_row_err(got, gold) <= ATTN_BF16_ROW_TOL):
                    raise AssertionError(
                        f"flash_attention {shape} causal={causal} window={window} bf16: "
                        f"a row's RMS error is {attn_row_err(got, gold)} of its RMS > "
                        f"{ATTN_BF16_ROW_TOL}")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                cases += 1
    torch.cuda.synchronize()
    return cases, max_err


def phase_lm(dev):
    """qwen2-0.5b at full width through ``serve_checked``; see the module
    docstring's phase 4. Returns the ``lm_serving`` record and the main
    path's flash launch count (one per layer, all in the prefill)."""
    import numpy as np

    from repro_torch import configs

    cfg = configs.get_config(LM_ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
    return serve_checked(dev, cfg, prompts, LM_MAX_SEQ, LM_NEW, cfg.n_layers,
                         cfg.n_layers)


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible: what the kernel must do."""
    import numpy as np

    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def phase_attention_time(dev, launches, small_err):
    """The flash kernel vs its plain version and the library call at the
    prefill's shape, in f32 and then in bf16 (where each row is also held to
    ``ATTN_BF16_ROW_TOL``). Returns its ``kernels`` entry, whose error also
    covers phase 1b's f32 cases (``small_err``), and its bounds at that
    shape. Kernel and library are timed in turns: kernel, library, library,
    kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda as tfa

    cfg_b, (s, h, hkv, d) = len(LM_PROMPTS), (max(LM_PROMPTS), 14, 2, 64)
    gen = torch.Generator(device=dev).manual_seed(3)
    base = [torch.randn((cfg_b, s, n, d), generator=gen, device=dev)
            for n in (h, hkv, hkv)]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)

    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in base)
        got = tfa.flash_attention(q, k, v, causal=True)
        gold = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
        err = float((got.float() - gold).abs().max())
        if not err <= attn_tol(gold, dtype):
            raise AssertionError(f"flash_attention at the prefill shape, {dtype}: "
                                 f"max |err| {err} > {attn_tol(gold, dtype)}")
        row_err = attn_row_err(got, gold)
        if dtype == torch.bfloat16 and not row_err <= ATTN_BF16_ROW_TOL:
            raise AssertionError(
                f"flash_attention at the prefill shape, bf16: a row's RMS error is "
                f"{row_err} of its RMS > {ATTN_BF16_ROW_TOL}")
        lib_diff = float((sdpa(q, k, v).float() - gold).abs().max())
        del got, gold
        ms = [timed_ms(lambda: tfa.flash_attention(q, k, v, causal=True), 20)]
        lib_ms = [timed_ms(lambda: sdpa(q, k, v), 20) for _ in range(2)]
        ms.append(timed_ms(lambda: tfa.flash_attention(q, k, v, causal=True), 20))
        runs[dtype] = (err, row_err, lib_diff, ms, lib_ms)
    plain_ms = timed_ms(lambda: tfa.flash_attention_plain(*base, causal=True), 3)

    pairs = visible_pairs(s, s, True, None) * cfg_b * h
    flops = 4 * d * pairs
    n_elems = 2 * base[0].numel() + base[1].numel() + base[2].numel()
    bytes_ms = {dt: n_elems * dt.itemsize / PEAK_BYTES_PER_S * 1e3 for dt in runs}
    tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3  # 3xTF32: three passes
    bf16_ms = flops / PEAK_BF16_FLOPS * 1e3
    clock = sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    err32, row32, diff32, ms32, lib32 = runs[torch.float32]
    err16, row16, diff16, ms16, lib16 = runs[torch.bfloat16]
    entry = {
        "name": "flash_attention", "route": "cuda", "source": tfa.SOURCE,
        "replaces": tfa.REPLACES, "launches": launches,
        "max_abs_err": max(err32, small_err),
        "ms": float(np.mean(ms32)), "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms[torch.float32], tf32_ms),
        "bound_by": "bytes" if bytes_ms[torch.float32] >= tf32_ms else "operations",
        "library_ms": float(np.mean(lib32)), "library_max_abs_diff": diff32,
        "ms_runs": ms32, "library_runs_ms": lib32, "max_row_rel_err": row32,
        "bf16_ms": float(np.mean(ms16)), "bf16_ms_runs": ms16,
        "bf16_library_ms": float(np.mean(lib16)), "bf16_library_runs_ms": lib16,
        "bf16_max_abs_err": err16, "bf16_max_row_rel_err": row16,
        "bf16_library_max_abs_diff": diff16,
        "per": f"one call at B {cfg_b}, S {s}, H {h}, Hkv {hkv}, D {d}, causal, "
               "f32 (bf16_* in bf16); launches counted over one generate (one per "
               "layer); bound_ms is the tensor-core bound of the f32 path (3xTF32)",
    }
    # computed, not measured: the bounds of the same call, and what they use
    bounds = {
        "tensor_core_f32_ms": tf32_ms, "tensor_core_bf16_ms": bf16_ms,
        "cuda_core_f32_ms": flops / PEAK_F32_FLOPS * 1e3,
        "ex2_ms": pairs / (EX2_PER_SM_CLOCK * n_sm * clock) * 1e3,
        "hbm_f32_ms": bytes_ms[torch.float32], "hbm_bf16_ms": bytes_ms[torch.bfloat16],
        "bf16_bound_ms": max(bytes_ms[torch.bfloat16], bf16_ms),
        "flops": flops, "visible_pairs": pairs, "bytes_f32": n_elems * 4,
        "sm_clock_mhz": clock / 1e6, "sms": n_sm,
    }
    return entry, bounds


def flash_timing(dev, shape, causal=True, window=None, dtype=None):
    """The flash kernel vs its plain version and ``scaled_dot_product_attention``
    at ``shape = (b, sq, sk, h, hkv, d)``, in f32 (or ``dtype``), timed in
    turns (kernel, library, library, kernel); holds the kernel to the plain
    version at the attention tolerance. Returns the timings, errors and
    the call's bound (the larger of HBM and the tensor-core bound of the
    arithmetic the path issues: 3xTF32 in f32, bf16 in bf16)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda as tfa

    dtype = dtype or torch.float32
    b, sq, sk, h, hkv, d = shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((b, n, m, d), generator=gen, device=dev).to(dtype)
               for n, m in ((sq, h), (sk, hkv), (sk, hkv)))
    mask = None
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=dev)[None, :]
    if window is not None and bool((kpos <= qpos - window).any()):
        mask = kpos > qpos - window  # the window cuts keys: SDPA needs it spelt out
        if causal:
            mask &= kpos <= qpos

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=causal and mask is None and sq == sk,
            enable_gqa=True).transpose(1, 2)

    if causal and mask is None and sq != sk:
        raise ValueError("SDPA's is_causal aligns queries at 0, the kernel at Sk − Sq")

    def kernel():
        return tfa.flash_attention(q, k, v, causal=causal, window=window)

    gold = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                     window=window)
    out = kernel()
    err = float((out.float() - gold).abs().max())
    if not err <= attn_tol(gold, dtype):
        raise AssertionError(f"flash_attention {shape} causal={causal} window={window} "
                             f"{dtype}: max |err| {err} > {attn_tol(gold, dtype)}")
    row_err = attn_row_err(out, gold)
    if dtype == torch.bfloat16 and not row_err <= ATTN_BF16_ROW_TOL:
        raise AssertionError(f"flash_attention {shape} bf16: a row's RMS error is "
                             f"{row_err} of its RMS > {ATTN_BF16_ROW_TOL}")
    del out
    lib_diff = float((sdpa().float() - gold).abs().max())
    del gold
    ms = [timed_ms(kernel, 20)]
    lib_ms = [timed_ms(sdpa, 20) for _ in range(2)]
    ms.append(timed_ms(kernel, 20))
    plain_ms = timed_ms(lambda: tfa.flash_attention_plain(q, k, v, causal=causal,
                                                          window=window), 3)
    flops = 4 * d * visible_pairs(sq, sk, causal, window) * b * h
    bytes_ms = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
                / PEAK_BYTES_PER_S * 1e3)
    ops_ms = (3 * flops / PEAK_TF32_FLOPS if dtype == torch.float32  # three passes
              else flops / PEAK_BF16_FLOPS) * 1e3
    return {"max_abs_err": err, "max_row_rel_err": row_err, "ms": float(np.mean(ms)),
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": float(np.mean(lib_ms)), "library_max_abs_diff": lib_diff,
            "ms_runs": ms, "library_runs_ms": lib_ms, "flops": flops}


def flash_entry(dev, tag, shape, launches, causal=True, window=None, per=""):
    """The kernels line's ``flash_attention@<tag>`` entry at one model's
    shape ``(b, sq, sk, h, hkv, d)`` in f32 (``flash_timing``), with
    ``launches`` from that model's main run."""
    from repro_torch.kernels import flash_attention_cuda as tfa

    b, sq, sk, h, hkv, d = shape
    entry = {"name": f"flash_attention@{tag}", "route": "cuda", "source": tfa.SOURCE,
             "replaces": tfa.REPLACES, "launches": launches}
    entry.update(flash_timing(dev, shape, causal, window))
    mask = ("causal" if causal else "non-causal") + (f", window {window}" if window else "")
    entry["per"] = (f"one call at B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d} "
                    f"(GQA group {h // hkv}), {mask}, f32; launches counted over one "
                    f"generate of {tag}{per}; bound_ms is the larger of the f32 path's "
                    "tensor-core bound (3xTF32) and HBM")
    return entry


def timeline_split(fn, part_of_span, parts):
    """Device ms of ``fn`` by part under ``torch.profiler``: a kernel that
    starts inside a profiler range on the device timeline whose part
    ``part_of_span(name)`` gives (None for other ranges) counts there; the
    others count as ``flash_attention``, ``dense`` (the other matrix
    products: projections, MLP and the LM head) or ``other``. Returns the
    split over ``parts`` and the number of device operations."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    spans, work = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if part_of_span(e.name) else work).append(e)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    split = dict.fromkeys(parts, 0.0)
    for e in work:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        name = e.name.lower()
        part = ("flash_attention" if "flash_attention_kernel" in name
                else part_of_span(spans[i].name)
                if i >= 0 and e.time_range.start < spans[i].time_range.end
                else "dense" if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass"))
                else "other")
        split[part] += e.time_range.elapsed_us() / 1e3
    return split, len(work)


def moe_split(fn):
    """Device ms of ``fn`` by part (``timeline_split``): the MoE's ranges
    ``moe.router``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``,
    then ``flash_attention``, ``dense`` and ``other``."""
    split, ops = timeline_split(
        fn, lambda name: name[4:] if name.startswith("moe.") else None, MOE_PARTS)
    if not (split["experts"] > 0.0 and split["router"] > 0.0):
        raise AssertionError(f"the MoE ranges hold no device time: {split}; the "
                             "ranges' names no longer match moe_split's")
    return split, ops


class RouteLog:
    """Records ``moe.route``'s expert ids and keep masks, call by call, while
    active (``moe_forward`` looks ``route`` up in its module); with
    ``inputs``, also each call's router weight and tokens."""

    def __init__(self, inputs=False):
        self.calls, self.routings, self.inputs, self._keep_inputs = [], [], [], inputs

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route

        def route(*args, **kw):
            r = self._route(*args, **kw)
            self.calls.append((r.expert_ids, r.keep))
            self.routings.append(r)
            if self._keep_inputs:
                self.inputs.append((args[0]["router"], args[2]))
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def chosen_and_kept(ids, keep, n_experts):
    """Per token [G, Tg, E]: whether it chose each expert, and whether that
    choice was kept."""
    import torch

    g, tg, k = ids.shape
    chosen = torch.zeros((g, tg, n_experts), dtype=torch.bool, device=ids.device)
    chosen.scatter_(-1, ids, True)
    kept = torch.zeros_like(chosen).scatter_(-1, ids, keep.reshape(g, tg, k))
    return chosen, kept


def compare_routes(a, b, n_experts):
    """Two routings' (expert ids, keep): the tokens whose expert sets
    differ, the experts whose arrivals those changed, and the (token,
    expert) choices made on both sides whose keep differs."""
    ca, ka = chosen_and_kept(*a, n_experts)
    cb, kb = chosen_and_kept(*b, n_experts)
    set_diff = (ca != cb).any(-1)                           # [G, Tg]
    affected = (ca != cb).any(dim=1).any(dim=0)             # [E]
    keep_diff = ca & cb & (ka != kb)                        # [G, Tg, E]
    return set_diff, affected, keep_diff


def layer_check(cfg, params, tokens, keep_row):
    """Teacher-forced on the kernel path, layer by layer: from the hidden
    state entering each layer, the attention with the flash kernel and with
    its plain version (at the attention tolerance), ``route`` on both
    paths' MoE inputs (an expert set may differ only at a near tie of the
    k-th and (k+1)-th probabilities, a keep only in an expert whose
    arrivals a differing set changed), and the MoE outputs of the tokens
    whose decisions agree (at the f32 tolerance). Returns the kernel path's
    final hidden state, per-layer records, and each layer's router
    histogram and the MoE input of batch row ``keep_row``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tr

    b, s = tokens.shape
    dims, mdims = cfg.attn_dims(None), cfg.moe_dims
    e, k = mdims.n_experts, mdims.top_k
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = tr._embed(params, tokens, torch.float32)
    layers, hists, rows = [], [], []
    for li, p in enumerate(params["layers"]):
        q, kk, v = attention._project_qkv(p["attn"], dims, tr._norm(cfg, p["norm1"], x),
                                          positions)
        o = {be: ops.attention(q, kk, v, causal=True, backend=be) for be in ("cuda", "torch")}
        attn_err = float((o["cuda"] - o["torch"]).abs().max())
        if not attn_err <= attn_tol(o["torch"], torch.float32):
            raise AssertionError(f"layer {li}: flash vs plain attention max |err| "
                                 f"{attn_err} > {attn_tol(o['torch'], torch.float32)}")
        h = {be: x + o[be].reshape(b, s, -1) @ p["attn"]["wo"] for be in o}
        m = {be: tr._norm(cfg, p["norm2"], h[be]) for be in o}
        r = {be: moe.route(p["moe"], mdims, m[be]) for be in o}
        set_diff, affected, keep_diff = compare_routes(
            (r["cuda"].expert_ids, r["cuda"].keep),
            (r["torch"].expert_ids, r["torch"].keep), e)
        top = [r[be].probs.topk(k + 1, dim=-1).values for be in o]
        gap = torch.minimum(*(t[..., k - 1] - t[..., k] for t in top))
        wide = set_diff & (gap >= MOE_TIE)
        if bool(wide.any()):
            raise AssertionError(
                f"layer {li}: {int(wide.sum())} tokens chose other experts on the two "
                f"paths though their k-th and (k+1)-th probabilities are {MOE_TIE} or "
                "more apart")
        stray = keep_diff & ~affected
        if bool(stray.any()):
            raise AssertionError(f"layer {li}: {int(stray.sum())} choices kept on one "
                                 "path and dropped on the other in experts whose "
                                 "arrivals no differing choice changed")
        agree = (~set_diff & ~keep_diff.any(-1)).reshape(b, s)
        out = {be: moe.moe_forward(p["moe"], mdims, m[be])[0] for be in o}
        moe_err = float((out["cuda"][agree] - out["torch"][agree]).abs().max())
        if not moe_err <= tol(out["torch"][agree], torch.float32):
            raise AssertionError(
                f"layer {li}: MoE outputs of agreeing tokens differ by {moe_err} > "
                f"{tol(out['torch'][agree], torch.float32)}")
        keep = r["cuda"].keep
        layers.append({"attn_max_abs_err": attn_err, "moe_max_abs_err": moe_err,
                       "tokens_choice_differs": int(set_diff.sum()),
                       "choices_keep_differs": int(keep_diff.sum()),
                       "min_gap_where_choice_differs": (
                           float(gap[set_diff].min()) if bool(set_diff.any()) else None),
                       "kept": int(keep.sum()), "routed": keep.numel(),
                       "capacity": r["cuda"].capacity})
        hists.append(torch.bincount(r["cuda"].expert_ids.reshape(-1),
                                    minlength=e).cpu().numpy())
        rows.append(m["cuda"][keep_row:keep_row + 1].clone())
        x = h["cuda"] + out["cuda"]
        del o, h, m, r, out
    return x, layers, hists, rows


def timed_serve(dev, cfg, prompts, max_seq, new, launches, prefill_launches, split,
                source=None):
    """One model through ``ServeEngine.run`` on seeded random f32 weights: a
    warm-up, then a timed run with the flash launch count reset just before
    and read just after (it must be ``launches``, and finite logits of the
    right shape); then the device split (``split``) of one prefill, which
    must launch the kernel ``prefill_launches`` times and show its time, and
    of 2 decode steps, through the calls the engine makes. Returns the
    parameters, the engine, the run's tokens and logits, and the record."""
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine

    t0 = time.perf_counter()
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_seq=max_seq, device=dev)
    t0 = time.perf_counter()
    eng.run(prompts, new, source_embed=source)  # warm-up
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    tfa.reset_launches()
    t0 = time.perf_counter()
    toks, logits = eng.run(prompts, new, source_embed=source)
    total_s = time.perf_counter() - t0
    got = tfa.LAUNCHES["flash_attention"]
    timing = dict(eng.last_timing)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if got != launches:
        raise AssertionError(f"{cfg.name}: generate launched the flash kernel {got} "
                             f"times; expected {launches}")
    if logits.shape != (len(prompts), new, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)} are malformed "
                             "or non-finite")

    plen = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), plen), dtype=torch.long)
    for i, p in enumerate(prompts):  # right-aligned, as ServeEngine.run
        tokens[i, plen - len(p):] = torch.tensor(p)
    batch = {"tokens": tokens.to(dev)}
    if source is not None:
        batch["source_embed"] = source
    tfa.reset_launches()
    pre, pre_ops = split(lambda: tr.prefill(cfg, params, batch, max_seq,
                                            compute_dtype=torch.float32))
    got = tfa.LAUNCHES["flash_attention"]
    if got != prefill_launches or (got > 0) != (pre["flash_attention"] > 0.0):
        raise AssertionError(f"{cfg.name}: the prefill launched the flash kernel {got} "
                             f"times, with {pre['flash_attention']} device ms under "
                             "its name")
    _, cache = tr.prefill(cfg, params, batch, max_seq, compute_dtype=torch.float32)

    def decode_two():
        for step in range(2):
            tr.decode_step(cfg, params, cache, batch["tokens"][:, -1], plen + step,
                           compute_dtype=torch.float32)

    dec, dec_ops = split(decode_two)
    dec = {part: ms / 2 for part, ms in dec.items()}
    del cache

    steps = timing["decode_steps"]
    record = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "d_head": cfg.head_dim,
        "vocab": cfg.vocab, "params": tr.count_params(cfg), "dtype": "float32",
        "prompt_lens": [len(p) for p in prompts], "max_seq": max_seq, "new_tokens": new,
        "prefill_ms": timing["prefill_s"] * 1e3,
        "decode_ms_per_token": timing["decode_s"] * 1e3 / steps,
        "generate_ms": total_s * 1e3,
        "tokens_per_s": len(prompts) * new / total_s,
        "decode_tokens_per_s": len(prompts) * steps / timing["decode_s"],
        "attention_launches": launches, "attention_launches_prefill": prefill_launches,
        "prefill_device_ms": pre, "prefill_device_ops": pre_ops,
        "decode_device_ms_per_step": dec, "decode_device_ops_per_step": dec_ops / 2,
        "peak_gb": peak_gb, "init_s": init_s, "warmup_generate_s": warm_s,
    }
    for key, host_ms, dev_ms in (("prefill", record["prefill_ms"], pre),
                                 ("decode", record["decode_ms_per_token"], dec)):
        record[f"{key}_device_idle_ms"] = host_ms - sum(dev_ms.values())
        record[f"{key}_device_idle_share"] = 1.0 - sum(dev_ms.values()) / host_ms
    return params, eng, toks, logits, record


def serve_moe(dev, cfg, prompts):
    """One MoE model through ``ServeEngine.generate``: a warm-up, a timed
    run with the flash launch count reset just before and read just after,
    prefill and decode device splits, then the checks against the plain
    attention (``layer_check``, then the logits end to end). Returns the
    record, the launch count, the parameters, and the router histograms and
    MoE inputs ``placement_check`` takes."""
    import torch

    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine

    # one flash launch per layer, all in the prefill
    params, eng, toks, logits, record = timed_serve(
        dev, cfg, prompts, LM_MAX_SEQ, LM_NEW, cfg.n_layers, cfg.n_layers, moe_split)
    plen = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), plen), dtype=torch.long)
    for i, p in enumerate(prompts):  # right-aligned, as ServeEngine.run
        tokens[i, plen - len(p):] = torch.tensor(p)
    tokens = tokens.to(dev)

    # teacher-forced on the kernel run's tokens, with the same engine on the
    # plain attention, every routing decision recorded
    new = torch.tensor([t[-LM_NEW:] for t in toks], device=dev)
    with RouteLog() as got_log:
        _, got = eng.run(prompts, LM_NEW, forced=new)
    plain = ServeEngine(cfg, params, max_seq=LM_MAX_SEQ, device=dev, backend="torch")
    with RouteLog() as gold_log:
        _, gold = plain.run(prompts, LM_NEW, forced=new)
    if len(got_log.calls) != len(gold_log.calls):
        raise AssertionError(f"{cfg.name}: {len(got_log.calls)} routings on the kernel "
                             f"path, {len(gold_log.calls)} on the plain one")
    differs = {"tokens_choice_differs": 0, "choices_keep_differs": 0, "calls_differ": 0}
    for a, b in zip(got_log.calls, gold_log.calls):
        set_diff, _, keep_diff = compare_routes(a, b, cfg.moe.n_experts)
        n_set, n_keep = int(set_diff.sum()), int(keep_diff.sum())
        differs["tokens_choice_differs"] += n_set
        differs["choices_keep_differs"] += n_keep
        differs["calls_differ"] += int(n_set + n_keep > 0)
    tol_lm = LM_TOL * max(1.0, float(gold.abs().max()))
    err = (got - gold).abs().amax(dim=(0, 2))  # per step
    if not differs["calls_differ"] and not float(err.max()) <= tol_lm:
        raise AssertionError(f"{cfg.name}: no routing decision differed, yet the logits "
                             f"differ by {float(err.max())} > {tol_lm}")

    record.update({
        "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
        "d_expert": cfg.moe.d_expert, "capacity_factor": cfg.moe.capacity_factor,
        "active_params": tr.active_params(cfg),
        "teacher_forced_rerun_bit_equal": bool(torch.equal(got, logits)),
        "routing_calls": len(got_log.calls), "routing_differs": differs,
        "max_abs_err_prefill": float(err[0]), "max_abs_err_decode": float(err[1:].max()),
        "tolerance": tol_lm, "logits_within_tolerance": bool(float(err.max()) <= tol_lm),
    })
    del got_log, gold_log, plain, got, gold

    x, layers, hists, rows = layer_check(cfg, params, tokens, 0)
    loop_err = float((tr._logits(cfg, params, x[:, -1:])[:, 0] - logits[:, 0]).abs().max())
    if not loop_err <= tol_lm:
        raise AssertionError(f"{cfg.name}: the layer check's last logits are {loop_err} "
                             "from the engine's prefill")
    record["layer_check"] = {
        "per_layer": layers, "loop_vs_engine_prefill_max_abs_err": loop_err,
        "attn_tolerance": "2e-5 * max(1, |plain|max)",
        "moe_tolerance": "1e-4 * max(1, |plain|max), agreeing tokens",
        "near_tie": MOE_TIE,
        "tokens_choice_differs": sum(r["tokens_choice_differs"] for r in layers),
        "choices_keep_differs": sum(r["choices_keep_differs"] for r in layers),
        "attn_max_abs_err": max(r["attn_max_abs_err"] for r in layers),
        "moe_max_abs_err": max(r["moe_max_abs_err"] for r in layers)}
    record["kept_over_routed"] = [r["kept"] / r["routed"] for r in layers]
    del eng, logits, x
    return record, cfg.n_layers, params, hists, rows


def placement_check(cfg, params, hists, rows):
    """AWB placement at full width on the MoE layer whose router histogram
    loads ``MOE_DEVICES`` devices worst under the static layout:
    ``balance_placement`` of that histogram over ``MOE_SLOTS_PER_DEVICE``
    slots a device (spare slots for replicas), through
    ``tables_from_placement`` into ``moe_forward`` on that layer's input
    (batch row 0), dropless, against the identity placement at the same
    slot count (within 1e-5 of max|out|); the kept share at the default
    capacity under both; every layer's static and AWB imbalance."""
    import numpy as np

    from repro_torch.core import moe_balance
    from repro_torch.models import moe

    e = cfg.moe.n_experts
    static = moe_balance.static_placement(e, MOE_DEVICES)
    per_layer = []
    for h in hists:
        load = h.astype(np.float64)
        awb = moe_balance.balance_placement(load, MOE_DEVICES,
                                            slots_per_device=MOE_SLOTS_PER_DEVICE)
        per_layer.append((moe_balance.imbalance(moe_balance.device_loads(static, load)),
                          moe_balance.imbalance(moe_balance.device_loads(awb, load))))
    li = int(np.argmax([s for s, _ in per_layer]))
    load = hists[li].astype(np.float64)
    placement = moe_balance.balance_placement(load, MOE_DEVICES,
                                              slots_per_device=MOE_SLOTS_PER_DEVICE)
    x, p = rows[li], params["layers"][li]["moe"]
    dims = cfg.moe_dims._replace(n_slots=MOE_DEVICES * MOE_SLOTS_PER_DEVICE)
    tables = moe.tables_from_placement(placement, device=x.device)
    dropless = x.shape[0] * x.shape[1] * dims.top_k
    base, _ = moe.moe_forward(p, dims, x, capacity_override=dropless)
    got, _ = moe.moe_forward(p, dims, x, placement=tables, capacity_override=dropless)
    err = float((got - base).abs().max())
    limit = 1e-5 * max(1.0, float(base.abs().max()))
    if not err <= limit:
        raise AssertionError(f"layer {li}: the AWB placement's dropless output differs "
                             f"from the identity placement's by {err} > {limit}")
    kept_static = moe.route(p, cfg.moe_dims, x).keep
    kept_awb = moe.route(p, dims, x, placement=tables).keep
    return {
        "layer": li, "devices": MOE_DEVICES, "slots_per_device": MOE_SLOTS_PER_DEVICE,
        "n_slots": dims.n_slots, "tokens": x.shape[1], "histogram": load.tolist(),
        "replica_count": placement.replica_count.tolist(),
        "static_imbalance": per_layer[li][0], "awb_imbalance": per_layer[li][1],
        "dropless_max_abs_err": err, "bit_equal": err == 0.0, "tolerance": limit,
        "kept_share_default_capacity_static": float(kept_static.float().mean()),
        "kept_share_default_capacity_awb": float(kept_awb.float().mean()),
        "imbalance_per_layer": [{"static": s, "awb": a} for s, a in per_layer],
    }


def phase_moe(dev):
    """MoE serving on the card; see the module docstring's phase 10. Returns
    the ``moe_serving`` record and the flash kernel's entries at the two
    MoE models' prefill shapes."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as tr

    full = configs.get_config(MOE_CUT_ARCH)
    cut = dataclasses.replace(full, n_layers=MOE_CUT_LAYERS,
                              segments=((("attn_moe",), MOE_CUT_LAYERS),))
    rng = np.random.default_rng(0)
    record, entries = {}, []
    for cfg in (configs.get_config(MOE_ARCH), cut):
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
        t0 = time.perf_counter()
        rec, launches, params, hists, rows = serve_moe(dev, cfg, prompts)
        if cfg.name == MOE_ARCH:
            rec["placement"] = placement_check(cfg, params, hists, rows)
        else:
            rec["reduced"] = {"layers": f"{MOE_CUT_LAYERS} of {full.n_layers}",
                              "why": f"{full.n_layers} layers in f32 hold "
                                     f"{4 * tr.count_params(full) / 1e9:.1f} GB, over the "
                                     "card's 80 GB"}
        rec["phase_s"] = time.perf_counter() - t0
        record[cfg.name] = rec
        del params, rows
        torch.cuda.empty_cache()
        s = max(LM_PROMPTS)
        entries.append(flash_entry(dev, cfg.name, (len(LM_PROMPTS), s, s, cfg.n_heads,
                                                   cfg.n_kv_heads, cfg.head_dim),
                                   launches, per=" (one per layer's prefill)"))
    return record, entries



def lm_split(fn):
    """Device ms of ``fn`` by part (``timeline_split``): the RG-LRU's
    ranges ``rglru.scan`` and ``rglru.conv``, RWKV-6's ``rwkv.wkv`` and
    ``rwkv.ddlerp``, then ``flash_attention``, ``dense`` and ``other``."""
    return timeline_split(
        fn, lambda name: name if name.startswith(("rglru.", "rwkv.")) else None, LM_PARTS)


def serve_checked(dev, cfg, prompts, max_seq, new, launches, prefill_launches,
                  source=None):
    """One model through ``timed_serve`` (split by ``lm_split``), then the
    logits of a teacher-forced run against the same engine on the plain
    attention at ``LM_TOL``; where the plain path's top two logits are
    further apart than that, the generated tokens must agree. Returns the
    record and the run's flash launch count."""
    import torch

    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine

    params, eng, toks, logits, record = timed_serve(
        dev, cfg, prompts, max_seq, new, launches, prefill_launches, lm_split, source)
    forced = torch.tensor([t[-new:] for t in toks], device=dev)
    plain = ServeEngine(cfg, params, max_seq=max_seq, device=dev, backend="torch")
    _, gold = plain.run(prompts, new, forced=forced, source_embed=source)
    tol_lm = LM_TOL * max(1.0, float(gold.abs().max()))
    err = (logits - gold).abs().amax(dim=(0, 2))  # per step
    if not float(err.max()) <= tol_lm:
        raise AssertionError(f"{cfg.name}: logits max |err| {float(err.max())} > {tol_lm}")
    top2 = gold.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol_lm
    mismatch = decided & (gold.argmax(-1) != forced)
    if bool(mismatch.any()):
        raise AssertionError(f"{cfg.name}: {int(mismatch.sum())} generated tokens differ "
                             "from the plain path where its top two logits are apart")
    record.update({
        "kinds": sorted(set(tr.layer_kinds(cfg))),
        "max_abs_err_prefill": float(err[0]), "max_abs_err_decode": float(err[1:].max()),
        "tolerance": tol_lm, "tokens_decided": int(decided.sum()),
        "tokens_total": len(prompts) * new})
    del params, eng, plain, logits, gold
    torch.cuda.empty_cache()
    return record, launches


def phase_whisper(dev):
    """whisper-tiny at full width and depth; see the module docstring's
    phase 11. Returns the ``whisper_serving`` record and the flash kernel's
    ``flash_attention@whisper-tiny`` entry."""
    import numpy as np
    import torch

    from repro_torch import configs

    cfg = configs.get_config(WHISPER_ARCH)
    b, frames = len(WHISPER_PROMPTS), cfg.encoder.max_source
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in WHISPER_PROMPTS]
    source = torch.randn((b, frames, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(11), device=dev)
    n_dec, n_enc = cfg.n_layers, cfg.encoder.n_layers
    # the encoder, the decoder's self- and cross-attention in the prefill,
    # then the cross-attention in every decode step
    prefill = n_enc + 2 * n_dec
    record, launches = serve_checked(dev, cfg, prompts, WHISPER_MAX_SEQ, WHISPER_NEW,
                                     prefill + n_dec * (WHISPER_NEW - 1), prefill, source)
    record.update(encoder_layers=n_enc, source_frames=frames)
    h, d = cfg.n_heads, cfg.head_dim
    entry = flash_entry(dev, cfg.name, (b, frames, frames, h, h, d), launches,
                        causal=False, per=f" ({n_enc} encoder, {n_dec} self- and {n_dec} "
                        f"cross-attention in the prefill, {n_dec} cross-attention a "
                        "decode step); the timed call is the encoder's")
    entry["decode_cross_attention"] = flash_timing(dev, (b, 1, frames, h, h, d),
                                                   causal=False)
    entry["decode_cross_attention"]["per"] = (
        f"one call at B {b}, Sq 1, Sk {frames}, H {h}, D {d}, non-causal, f32 (a decode "
        "step's cross-attention over the encoder's frames)")
    return record, entry


def phase_recurrentgemma(dev):
    """recurrentgemma-2b at full width and depth; see the module docstring's
    phase 12. Returns the ``recurrentgemma_serving`` record and the kernels
    line's ``flash_attention@recurrentgemma-2b`` (f32, D 256) and
    ``flash_attention_wgmma@recurrentgemma-2b`` (bf16) entries."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as tr

    cfg = configs.get_config(RG_ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
    n_local = tr.layer_kinds(cfg).count("local")
    record, launches = serve_checked(dev, cfg, prompts, LM_MAX_SEQ, LM_NEW, n_local,
                                     n_local)
    record.update(window=cfg.window, d_rnn=cfg.rnn_width,
                  ring_slots=min(LM_MAX_SEQ, cfg.window),
                  decode_positions=[max(LM_PROMPTS), max(LM_PROMPTS) + LM_NEW - 2])
    record["bf16_prefill"], wgmma_launches = rg_bf16_prefill(dev, cfg, prompts, n_local)
    s, h, hkv, d = max(LM_PROMPTS), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shape = (len(LM_PROMPTS), s, s, h, hkv, d)
    entry = flash_entry(dev, cfg.name, shape, launches, window=cfg.window,
                        per=" (one per local layer's prefill, none in decode)")
    from repro_torch.kernels import flash_attention_cuda as tfa

    wgmma = {"name": f"flash_attention_wgmma@{cfg.name}", "route": "cuda",
             "source": tfa.WGMMA_SOURCE, "replaces": tfa.REPLACES,
             "launches": wgmma_launches}
    wgmma.update(flash_timing(dev, shape, True, cfg.window, torch.bfloat16))
    wgmma["per"] = (f"one call at B {shape[0]}, Sq {s}, Sk {s}, H {h}, Hkv {hkv}, D {d}, "
                    f"causal, window {cfg.window}, bf16; launches counted over one bf16 "
                    "prefill of phase 4's prompts (one per local layer); bound_ms is the "
                    "bf16 tensor-core bound")
    return record, [entry, wgmma]


def rg_bf16_prefill(dev, cfg, prompts, n_local):
    """One prefill of ``prompts`` in bf16 on seeded f32 weights, with the
    wgmma kernel's launch count reset just before and read just after (it
    must be one per local layer, and the mma.sync kernel's none); its last
    logits finite, and their distance from the f32 prefill's reported.
    Returns the record and the launch count."""
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.models import transformer as tr

    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plen = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), plen), dtype=torch.long)
    for i, p in enumerate(prompts):  # right-aligned, as ServeEngine.run
        tokens[i, plen - len(p):] = torch.tensor(p)
    batch = {"tokens": tokens.to(dev)}
    with torch.no_grad():
        tfa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = tr.prefill(cfg, params, batch, LM_MAX_SEQ, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(tfa.LAUNCHES)
        gold, _ = tr.prefill(cfg, params, batch, LM_MAX_SEQ, compute_dtype=torch.float32)
    if launches != {"flash_attention": 0, "flash_attention_wgmma": n_local}:
        raise AssertionError(f"the bf16 prefill launched {launches}; expected "
                             f"{n_local} wgmma launches and no other")
    if got.shape != gold.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"the bf16 prefill's logits {tuple(got.shape)} are not "
                             "finite logits of the f32 prefill's shape")
    diff = (got.float() - gold).abs()
    record = {"prefill_ms_host_clock": ms, "wgmma_launches": n_local,
              "max_abs_diff_vs_f32": float(diff.max()),
              "f32_logit_scale": float(gold.abs().max()),
              "argmax_agreement": float((got.float().argmax(-1) == gold.argmax(-1))
                                        .float().mean())}
    del params, got, gold
    torch.cuda.empty_cache()
    return record, launches["flash_attention_wgmma"]


def wkv_timing(dev, cfg):
    """The wkv recurrence at rwkv6-3b's prefill shape (B 4, S 2048, H 40, dh
    64, f32; seeded r, k, v, u and state, decays at the seeded model's w0 of
    −5 with a spread of 0.5): ``wkv_chunked`` at each of ``WKV_CHUNKS``,
    held to ``wkv_sequential`` (its plain version, the reference's step
    loop) at 1e-5·max(1, |gold|max) on outputs and state, and timed beside
    it. The bound is the larger of the bytes (r, k, v, log w, u and the
    state read once, the output and state written once) at HBM rate and the
    recurrence's 7·dh² f32 operations per token and head at the CUDA-core
    rate."""
    import torch

    from repro_torch.models import rwkv6

    b, s, h, dh = len(LM_PROMPTS), max(LM_PROMPTS), cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = randn(b, s, h, dh), randn(b, s, h, dh), randn(b, s, h, dh)
    log_w = -torch.exp(-5.0 + 0.5 * randn(b, s, h, dh))
    u, state = randn(h, dh), randn(b, h, dh, dh)
    args = (r, k, v, log_w, u, state)
    gold_out, gold_state = rwkv6.wkv_sequential(*args)
    scale = max(1.0, float(gold_out.abs().max()), float(gold_state.abs().max()))
    plain_ms = timed_ms(lambda: rwkv6.wkv_sequential(*args), 1)
    chunks = {}
    for c in WKV_CHUNKS:
        out, st = rwkv6.wkv_chunked(*args, chunk=c)
        err = max(float((out - gold_out).abs().max()), float((st - gold_state).abs().max()))
        if not err <= 1e-5 * scale:
            raise AssertionError(f"wkv_chunked at chunk {c}: max |err| {err} against the "
                                 f"sequential scan > {1e-5 * scale}")
        del out, st
        chunks[str(c)] = {"ms": timed_ms(lambda c=c: rwkv6.wkv_chunked(*args, chunk=c), 5),
                          "max_abs_err": err}
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * state.numel())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 7 * dh * dh * b * s * h / PEAK_F32_FLOPS * 1e3
    return {"shape": [b, s, h, dh], "chunks": chunks, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "tolerance": 1e-5 * scale}


def wkv_layer_check(cfg, params, tokens) -> dict:
    """Every wkv call of one prefill on the kernel path (the chunked scan,
    on the inputs each layer gives it) held against the sequential scan,
    its plain version, on the same inputs: outputs and states at the f32
    tolerance (``check``). Returns the calls and the largest errors."""
    import torch

    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as tr

    errs = {"calls": 0, "out_max_abs_err": 0.0, "state_max_abs_err": 0.0}
    chunked = rwkv6.wkv_chunked

    def held(*args, **kwargs):
        out, state = chunked(*args, **kwargs)
        gold, gold_state = rwkv6.wkv_sequential(*args)
        i = errs["calls"]
        errs["out_max_abs_err"] = max(errs["out_max_abs_err"], check(
            f"wkv call {i} output", out, gold, torch.float32))
        errs["state_max_abs_err"] = max(errs["state_max_abs_err"], check(
            f"wkv call {i} state", state, gold_state, torch.float32))
        errs["calls"] += 1
        return out, state

    rwkv6.wkv_chunked = held  # rwkv_time_mix looks it up in its module
    try:
        tr.prefill(cfg, params, {"tokens": tokens}, LM_MAX_SEQ,
                   compute_dtype=torch.float32)
    finally:
        rwkv6.wkv_chunked = chunked
    if errs["calls"] != cfg.n_layers:
        raise AssertionError(f"the prefill made {errs['calls']} wkv calls; expected "
                             f"{cfg.n_layers}")
    return errs


def phase_rwkv(dev):
    """rwkv6-3b at full width and depth through ``timed_serve`` (no
    attention, so no flash launch); see the module docstring's phase 13.
    Returns the ``rwkv_serving`` record."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine
    from repro_torch.training.tree import tree_map

    cfg = configs.get_config(RWKV_ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
    new = LM_NEW
    params, eng, toks, logits, record = timed_serve(dev, cfg, prompts, LM_MAX_SEQ, new, 0,
                                                    0, lm_split)
    for part in ("rwkv.wkv", "rwkv.ddlerp"):
        if not record["prefill_device_ms"][part] > 0.0:
            raise AssertionError(f"the prefill's {part} range holds no device time: "
                                 f"{record['prefill_device_ms']}")
    forced = torch.tensor([t[-new:] for t in toks], device=dev)
    _, plain = ServeEngine(cfg, params, max_seq=LM_MAX_SEQ, device=dev,
                           backend="torch").run(prompts, new, forced=forced)
    exact = ServeEngine(cfg, tree_map(lambda t: t.double(), params), max_seq=LM_MAX_SEQ,
                        device=dev, compute_dtype=torch.float64, backend="torch")
    _, gold = exact.run(prompts, new, forced=forced)
    del exact
    tol_lm = LM_TOL * max(1.0, float(gold.abs().max()))
    err_k = (logits.double() - gold).abs()
    err_p = (plain.double() - gold).abs()
    err_kp = (logits - plain).abs()
    rows_k, rows_p, rows_kp = (e.amax(dim=(1, 2)).tolist() for e in (err_k, err_p, err_kp))
    limits = [max(tol_lm, min(2 * p, RWKV_F64_CAP * tol_lm)) for p in rows_p]
    for i, (k, p, kp, lim) in enumerate(zip(rows_k, rows_p, rows_kp, limits)):
        if p <= tol_lm and not kp <= tol_lm:
            raise AssertionError(f"{cfg.name} prompt {i}: the kernel path's logits lie {kp} "
                                 f"from the plain path's, beyond the LM tolerance {tol_lm}")
        if not k <= lim:
            raise AssertionError(f"{cfg.name} prompt {i}: the kernel path's logits lie {k} "
                                 f"from a float64 run, beyond {lim} (the LM tolerance, or "
                                 f"twice the plain path's distance {p}, at most "
                                 f"{RWKV_F64_CAP}× the LM tolerance)")
    top2 = gold.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1])
               > torch.tensor(limits, dtype=gold.dtype, device=dev)[:, None])
    mismatch = decided & (gold.argmax(-1) != forced)
    if bool(mismatch.any()):
        raise AssertionError(f"{cfg.name}: {int(mismatch.sum())} generated tokens differ "
                             "from the float64 run where its top two logits are apart")
    batch = torch.zeros((len(prompts), max(LM_PROMPTS)), dtype=torch.long)
    for i, p in enumerate(prompts):
        batch[i, -len(p):] = torch.tensor(p)
    wkv_calls = wkv_layer_check(cfg, params, batch.to(dev))
    record.update({
        "kinds": sorted(set(tr.layer_kinds(cfg))), "flash_launches": 0,
        "wkv_chunk": rwkv6.WKV_CHUNK, "tolerance": tol_lm,
        "max_abs_err_prefill": float(err_kp[:, 0].max()),
        "max_abs_err_decode": float(err_kp[:, 1:].max()),
        "kernel_vs_plain_per_row": rows_kp, "kernel_vs_float64_per_row": rows_k,
        "plain_vs_float64_per_row": rows_p, "float64_limit_per_row": limits,
        "rows_held_to_plain": [p <= tol_lm for p in rows_p],
        "wkv_calls_held": wkv_calls,
        "tokens_decided": int(decided.sum()), "tokens_total": len(prompts) * new})
    del params, eng, logits, plain, gold
    torch.cuda.empty_cache()
    record["wkv"] = wkv_timing(dev, cfg)
    return record


def flash_backward_timing(dev, shape, dtype):
    """``attention_vjp`` (the flash kernel's backward, torch ops) at
    ``shape = (b, s, s, h, hkv, d)``, causal, on the kernel's output, held to
    autograd through the plain version of the f32 inputs (1e-4·max(1,
    |gold|max) in f32; 2^-5 of the largest gradient in bf16, whose inputs
    round to 8 bits), and timed beside ``scaled_dot_product_attention``'s
    forward and backward. Bound: the larger of the bytes (q, k, v, o and dO
    read once, dq, dk and dv written once) at HBM rate and the backward's 10·D
    operations per visible pair (S recomputed, dV, dP, dQ, dK) at the peak
    of the inputs' type (f32 without tensor cores, bf16 with them)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda as tfa

    b, sq, sk, h, hkv, d = shape
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn((b, n, m, d), generator=gen, device=dev)
               for n, m in ((sq, h), (sk, hkv), (sk, hkv)))
    dout = torch.randn((b, sq, h, d), generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.backward(tfa.flash_attention_plain(*leaves), dout)
    gold = [t.grad for t in leaves]
    del leaves
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    out = tfa.flash_attention(q, k, v)
    got = tfa.attention_vjp(q, k, v, out, dout)
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, gold)]
    limit = (1e-4 * max(1.0, max(float(w.abs().max()) for w in gold))
             if dtype == torch.float32 else 2 ** -5 * max(float(w.abs().max()) for w in gold))
    if not max(errs) <= limit:
        raise AssertionError(f"attention_vjp {shape} {dtype}: max |err| {max(errs)} > "
                             f"{limit}")
    del got, gold
    ms = timed_ms(lambda: tfa.attention_vjp(q, k, v, out, dout), 5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa_both():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dt)

    lib_ms = [timed_ms(sdpa_both, 5) for _ in range(2)]
    pairs = visible_pairs(sq, sk, True, None) * b * h
    nbytes = 2 * (q.numel() + dout.numel() + k.numel() + v.numel()) * q.element_size()
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 10 * d * pairs / (PEAK_F32_FLOPS if dtype == torch.float32
                               else PEAK_BF16_FLOPS) * 1e3
    return {"ms": ms, "max_abs_err": max(errs), "tolerance": limit,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_forward_backward_ms": sum(lib_ms) / 2, "library_runs_ms": lib_ms}


def lm_grad_check(cfg, params, batch):
    """Step 1 through the flash kernel against the same step with the plain
    attention under autograd (``backend="torch"``; both with bf16 weights
    and compute): the loss, the global grad norm and every grad leaf, each
    within 4× the plain path's own bf16 error (its distance from the plain
    step in f32 on the same bf16 weights) plus half a bf16 ulp of the
    value's scale (2^-9). Returns the record; raises on a miss."""
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.tree import flatten_with_paths, tree_map

    runs = {}
    for name, backend, dtype in (("kernel", None, torch.bfloat16),
                                 ("plain", "torch", torch.bfloat16),
                                 ("plain_f32", "torch", torch.float32)):
        weights = params if dtype == torch.bfloat16 else tree_map(lambda t: t.float(), params)
        tfa.reset_launches()
        loss, grads = steps.value_and_grad(cfg, weights, batch, backend=backend,
                                           compute_dtype=dtype)
        runs[name] = (float(loss), float(global_norm(grads)),
                      {k: g.float() for k, g in flatten_with_paths(grads).items()},
                      tfa.LAUNCHES["flash_attention"])
        del weights, grads
    (lk, nk, gk, launches), (lp, npl, gp, plain_launches), (lf, nf, gf, _) = runs.values()
    if launches != 2 * cfg.n_layers or plain_launches != 0:
        raise AssertionError(f"step 1 launched the flash kernel {launches} times on the "
                             f"kernel path and {plain_launches} on the plain one")

    def limit(own, scale):
        return 4 * own + 2 ** -9 * scale

    checks = {"loss": (abs(lk - lp), limit(abs(lp - lf), abs(lf))),
              "grad_norm": (abs(nk - npl), limit(abs(npl - nf), nf))}
    worst_ratio, worst_rel, worst_leaf = 0.0, 0.0, None
    for key in gf:
        err = float((gk[key] - gp[key]).abs().max())
        scale = float(gf[key].abs().max())
        lim = limit(float((gp[key] - gf[key]).abs().max()), scale)
        if err / lim > worst_ratio:
            worst_ratio, worst_leaf = err / lim, key
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
    for name, (err, lim) in checks.items():
        if not err <= lim:
            raise AssertionError(f"step 1 {name}: kernel path differs from the plain "
                                 f"attention by {err} > {lim}")
    if not worst_ratio <= 1.0:
        raise AssertionError(f"step 1 grad leaf {worst_leaf}: the kernel path's error "
                             f"is {worst_ratio}× its limit")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_plain_f32": lf,
            "grad_norm_kernel": nk, "grad_norm_plain": npl, "grad_norm_plain_f32": nf,
            "loss_abs_err": checks["loss"][0], "loss_limit": checks["loss"][1],
            "grad_norm_abs_err": checks["grad_norm"][0],
            "grad_norm_limit": checks["grad_norm"][1],
            "max_leaf_err_over_limit": worst_ratio, "worst_leaf": worst_leaf,
            "max_leaf_rel_err": worst_rel, "leaves": len(gf),
            "flash_launches": launches}


def lm_step_split(step, params, opt_state, batch):
    """Device ms of one ``train_step`` call by part under ``torch.profiler``,
    its result dropped. The step's profiler ranges name the parts
    (``TRAIN_SPANS``): a kernel counts in the innermost range whose device
    span holds its start, and the flash kernel as ``flash_forward`` wherever
    it runs (the forward and remat's recompute). The autograd engine
    launches the backward from a thread of its own, outside the calling
    thread's ``train.backward``, so a kernel in no range that starts after
    the cross-entropy's span and before the optimizer's counts as
    ``backward``; any other as ``other``. Returns the split (each part's ms
    and ``ops``); raises if a part of the step holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    spans, work = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if e.name in TRAIN_SPANS else work).append(e)

    def edge(name, end):
        found = [e.time_range.end if end else e.time_range.start
                 for e in spans if e.name == name]
        if not found:
            raise AssertionError(f"the step's device timeline holds no {name} range")
        return max(found) if end else min(found)

    ce_end, opt_start = edge("train.cross_entropy", True), edge("train.optimizer", False)
    split = dict.fromkeys(TRAIN_PARTS, 0.0)
    for e in work:
        t = e.time_range.start
        inner = [sp for sp in spans if sp.time_range.start <= t < sp.time_range.end]
        part = ("flash_forward" if "flash_attention_kernel" in e.name.lower()
                else TRAIN_SPANS[max(inner, key=lambda sp: sp.time_range.start).name]
                if inner else "backward" if ce_end <= t < opt_start else "other")
        split[part] += e.time_range.elapsed_us() / 1e3
    empty = [k for k in TRAIN_PARTS if k != "other" and not split[k] > 0.0]
    if empty:
        raise AssertionError(f"the step's split holds no device time in {empty}: {split}")
    split["ops"] = len(work)
    return split


def lm_train_steps(cfg, step, state, pipe, first, last, mgr=None):
    """Steps ``first`` + 1 to ``last`` of ``step`` on ``pipe``'s batches,
    each synchronised and timed, with the flash launch count reset just
    before and read just after each; ``mgr`` saves the state at
    ``TRAIN_LM_SAVE_AT``. Returns the state, losses, step seconds, launches
    per step and the save's seconds."""
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.launch.train import to_jax_layout

    params, opt_state = state
    losses, secs, launches, save_s = [], [], [], None
    for i in range(first, last):
        batch = pipe.next_batch()
        torch.cuda.synchronize()
        tfa.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(tfa.LAUNCHES["flash_attention"])
        if mgr is not None and i + 1 == TRAIN_LM_SAVE_AT:
            t0 = time.perf_counter()
            mgr.save(i + 1, to_jax_layout(cfg, params, opt_state),
                     extra={"pipeline": pipe.checkpoint_state()})
            save_s = time.perf_counter() - t0
    return (params, opt_state), losses, secs, launches, save_s


def phase_lm_training(dev):
    """qwen2-0.5b trained at full width and depth through
    ``launch/steps.make_train_step``; see the module docstring's phase 14.
    Returns the ``lm_training`` record and the kernels line's
    ``flash_attention@lm-training`` entry."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.launch import steps
    from repro_torch.launch.train import from_jax_layout, to_jax_layout
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import flatten_with_paths, tree_map

    cfg = configs.get_config(LM_ARCH)
    b, s = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    opt_cfg = opt_mod.AdamWConfig(**TRAIN_LM_ADAMW)
    specs = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step, _ = steps.make_train_step(cfg, dev, specs, opt_cfg=opt_cfg)
    master = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = tree_map(lambda t: t.to(torch.bfloat16), master)
    opt_state = opt_mod.adamw_init(master)
    del master

    first = {k: torch.as_tensor(v, device=dev)
             for k, v in TokenPipeline(cfg.vocab, b, s, seed=0).next_batch().items()}
    t0 = time.perf_counter()
    grad_check = lm_grad_check(cfg, params, first)
    grad_check["seconds"] = time.perf_counter() - t0
    split = lm_step_split(step, params, opt_state, first)
    del first
    torch.cuda.empty_cache()

    ckpt_dir = ROOT / "build" / "lm_training_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    pipe = TokenPipeline(cfg.vocab, b, s, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    state, losses, secs, launches, save_s = lm_train_steps(
        cfg, step, (params, opt_state), pipe, 0, TRAIN_LM_STEPS, mgr)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if set(launches) != {2 * cfg.n_layers}:
        raise AssertionError(f"flash launches per step {launches}; expected "
                             f"{2 * cfg.n_layers} (forward and remat's recompute)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")

    t0 = time.perf_counter()
    saved, meta = mgr.restore(to_jax_layout(cfg, *state), device=dev)
    resumed = from_jax_layout(cfg, saved, state, dev)
    restore_s = time.perf_counter() - t0
    del saved
    pipe2 = TokenPipeline(cfg.vocab, b, s, seed=0)
    pipe2.restore_state(meta["extra"]["pipeline"])
    resumed, losses2, _, _, _ = lm_train_steps(cfg, step, resumed, pipe2, meta["step"],
                                               TRAIN_LM_STEPS)
    if losses2 != losses[meta["step"]:]:
        raise AssertionError(f"the resumed losses {losses2} differ from the "
                             f"uninterrupted run's {losses[meta['step']:]}")
    for tree_a, tree_b in zip(state, resumed):
        for key, a in flatten_with_paths(tree_a).items():
            if not torch.equal(a, flatten_with_paths(tree_b)[key]):
                raise AssertionError(f"the resumed state's {key} differs from the "
                                     "uninterrupted run's")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    del state, resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    step_ms = float(np.median(secs[TRAIN_LM_TIMED_FROM - 1:])) * 1e3
    shape = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    entry = {"name": "flash_attention@lm-training", "route": "cuda", "source": tfa.SOURCE,
             "replaces": tfa.REPLACES, "launches": launches[0]}
    entry.update(flash_timing(dev, shape, dtype=torch.bfloat16))
    entry["backward"] = {"bfloat16": flash_backward_timing(dev, shape, torch.bfloat16),
                         "float32": flash_backward_timing(dev, shape, torch.float32)}
    entry["per"] = (f"one call at B {b}, S {s}, H {cfg.n_heads}, Hkv {cfg.n_kv_heads}, D "
                    f"{cfg.head_dim}, causal, bf16 (the training step's type); launches "
                    "per training step (the forward and remat's recompute of each layer); "
                    "backward: attention_vjp (torch ops) beside "
                    "scaled_dot_product_attention's forward and backward")
    n = cfg.n_layers
    busy = sum(ms for part, ms in split.items() if part in TRAIN_PARTS)
    record = {
        "arch": cfg.name, "layers": n, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_head": cfg.head_dim, "vocab": cfg.vocab,
        "params": tr.count_params(cfg), "tied_embeddings": cfg.tie_embeddings,
        "remat": cfg.remat, "param_dtype": "bfloat16", "master_dtype": "float32",
        "batch": b, "seq": s, "tokens_per_step": b * s, "steps": TRAIN_LM_STEPS,
        "adamw": TRAIN_LM_ADAMW, "step_ms_median": step_ms,
        "step_ms_median_from_step": TRAIN_LM_TIMED_FROM,
        "step_ms": [x * 1e3 for x in secs], "tokens_per_s": b * s / step_ms * 1e3,
        "device_ms": split, "device_idle_ms": step_ms - busy,
        "device_idle_share": 1.0 - busy / step_ms, "peak_gb": peak_gb,
        "loss_step1": losses[0], "loss_last": losses[-1], "losses": losses,
        "flash_launches_per_step": launches[0], "grad_check": grad_check,
        "resume": {"from_step": meta["step"], "bit_equal": True, "save_s": save_s,
                   "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
                   "depth": "full"}}
    return record, entry


def step_mesh(dev):
    """Phase 15's ``MESH_STEP_SHAPE`` (data × model) mesh over ``mesh_of``'s
    positions: on one card every position names it."""
    from repro_torch.launch.mesh import Mesh

    d, m = MESH_STEP_SHAPE
    return Mesh(mesh_of(dev, d * m), (d, m), ("data", "model"))


def mesh_gcn(dev, ds, mesh):
    """15a: ``make_gcn_step`` on reddit against phase 2's single-device
    forward; the SpMM kernels held and timed on data position 0's step
    range. Returns the record and the kernels line's ``@mesh`` entries."""
    import numpy as np
    import torch

    from repro_torch.core import schedule as tsched
    from repro_torch.kernels import spmm_cuda
    from repro_torch.launch import steps
    from repro_torch.sharding import spmd
    from repro_torch.tuning import registry

    m, n = ds.adj.shape
    params, xb = phase9_requests(ds, dev)
    single = registry.get_executor(ds.adj, device=dev)  # phase 2's executor
    gold = single.forward_batch(params, xb[:1])[0]
    sched = single.sched
    one_block = sched.cols_per_block >= n
    build_s = 0.0
    if not one_block:  # the nine-array form reads lcol as the global column
        t0 = time.perf_counter()
        sched = tsched.build_balanced_schedule(ds.adj, sched.nnz_per_step,
                                               sched.rows_per_window)
        build_s = time.perf_counter() - t0
    k, r = sched.nnz_per_step, sched.rows_per_window
    fn, specs = steps.make_gcn_step(mesh, m, ds.num_features, ds.hidden, ds.num_classes,
                                    sched.n_steps, k, r)

    def padded(a, spec, fill=0):
        out = np.full(tuple(spec.shape), fill, a.dtype)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return torch.from_numpy(out).to(dev)

    arrays = [padded(sched.val.reshape(-1, k), specs[3]),
              padded(sched.local_row.reshape(-1, k), specs[4]),
              padded(sched.local_col.reshape(-1, k), specs[5]),
              padded(sched.win_id, specs[6]), padded(sched.col_block, specs[7]),
              padded(sched.row_map, specs[8], -1)]
    x = torch.zeros(tuple(specs[0].shape), device=dev)
    x[:, :ds.num_features] = xb[0]
    w1 = torch.zeros(tuple(specs[1].shape), device=dev)
    w1[:ds.num_features, :ds.hidden] = params["w0"]
    w2 = torch.zeros(tuple(specs[2].shape), device=dev)
    w2[:ds.hidden] = params["w1"]
    args = [x, w1, w2] + arrays
    torch.cuda.synchronize()
    spmm_cuda.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(spmm_cuda.LAUNCHES)
    n_data = spmd.data_size(mesh)
    for name in F32_SPMM:
        if launches[name] != 2 * n_data:
            raise AssertionError(f"make_gcn_step launched {name} {launches[name]} times; "
                                 f"expected {2 * n_data} (one a data position and layer)")
    if out.shape != (m, ds.num_classes) or not torch.isfinite(out).all():
        raise AssertionError(f"make_gcn_step logits {tuple(out.shape)} malformed")
    err = check("make_gcn_step vs the single-device forward", out, gold, torch.float32)
    if not torch.equal(out, fn(*args)):
        raise AssertionError("make_gcn_step: two calls differ")
    step_ms = timed_ms(lambda: fn(*args), 3)
    single_ms = timed_ms(lambda: single.forward_batch(params, xb[:1]), 3)
    del out, gold

    # the kernels on data position 0's step range, at the layers' widths
    steps0 = next(v for key, v in fn.plans.items() if key[0] == 0)
    per = specs[3].shape[0] // n_data
    val, lrow, lcol, win, _, rmap = (a.cpu().numpy() for a in arrays)
    live = val[:per] != 0
    rows_a = rmap[win[:per, None].astype(np.int64) * r + lrow[:per]][live]
    a0 = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows_a, lcol[:per][live]]).astype(np.int64)),
        torch.from_numpy(val[:per][live]), (m, n)).coalesce().to_sparse_csr().to(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    rows = {"spmm_balanced": [], "spmm_epilogue": []}
    for kdim in (ds.hidden, ds.num_classes):
        b = torch.randn((n, kdim), generator=gen, device=dev)
        window, epilogue, _ = spmm_rows(steps0, a0, b, 128, what="mesh ")
        rows["spmm_balanced"].append({**window, "main_path": True})
        rows["spmm_epilogue"].append({**epilogue, "main_path": True})
        del b
    entries = kernel_entries(rows, launches, "data position 0's step range, both layers "
                             "(kdim 128 and 41); launches per make_gcn_step call", "@mesh")
    record = {"graph": "reddit", "nodes": m, "nnz": int(sched.nnz),
              "schedule_one_column_block": True, "schedule_rebuilt": not one_block,
              "schedule_build_s": build_s, "n_steps": sched.n_steps,
              "n_steps_padded": int(specs[3].shape[0]), "steps_per_data_position": per,
              "launches": {name: launches[name] for name in F32_SPMM},
              "max_abs_err_vs_single": err, "first_call_s": first_s,
              "step_ms": step_ms, "single_device_forward_ms": single_ms}
    del a0, arrays, args, fn
    torch.cuda.empty_cache()
    return record, entries


def mesh_train(dev, mesh, grad_check):
    """15b: qwen2-0.5b trained on the mesh at full width and depth with
    phase 14's batches; step 1 against phase 14's single-device step.
    Returns the record and the ``flash_attention@mesh-train`` entry."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import partition, spmd
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.tree import flatten_with_paths, tree_map

    cfg = configs.get_config(LM_ARCH)
    b, s = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    specs = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step, (param_specs, _) = steps.make_train_step(
        cfg, mesh, specs, opt_cfg=opt_mod.AdamWConfig(**TRAIN_LM_ADAMW))
    pspecs = partition.param_pspecs(cfg, param_specs, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    master = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = spmd.shard_tree(tree_map(lambda t: t.to(torch.bfloat16), master), pspecs, mesh)
    opt_state = spmd.shard_tree(opt_mod.adamw_init(master),
                                partition.opt_state_pspecs(pspecs), mesh)
    del master
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) - base
    leaves = list(flatten_with_paths((params, opt_state)).values())
    stored = sum(t.nbytes for sh in leaves for t in sh.copies.values())
    per_position = {}
    for pos in mesh.positions():
        got = sum(sh.nbytes_at(pos) for sh in leaves)
        want = sum(partition.local_nbytes(sh.shape, sh.dtype, sh.spec, mesh) for sh in leaves)
        if got != want:
            raise AssertionError(f"position {pos} holds {got} bytes; its specs' local "
                                 f"shards are {want}")
        per_position[str(pos)] = got
    if not abs(held - stored) <= 0.05 * stored:
        raise AssertionError(f"the card holds {held} bytes for {stored} bytes of shards")
    pipe = TokenPipeline(cfg.vocab, b, s, seed=0)  # phase 14's batches
    torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms, secs, launches = [], [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.next_batch().items()}
        tfa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        launches.append(tfa.LAUNCHES["flash_attention"])
    peak = torch.cuda.max_memory_allocated(dev) - base
    want_launches = 2 * cfg.n_layers * mesh.size
    if set(launches) != {want_launches}:
        raise AssertionError(f"flash launches per mesh step {launches}; expected "
                             f"{want_launches} (forward and recompute, a model position "
                             "each, per data position)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the mesh step's loss did not fall: {losses}")

    def limit(own, scale):  # phase 14's: 4× the plain path's bf16 error + 2^-9
        return 4 * own + 2 ** -9 * scale

    g = grad_check
    checks = {"loss": (abs(losses[0] - g["loss_kernel"]),
                       limit(abs(g["loss_plain"] - g["loss_plain_f32"]),
                             abs(g["loss_plain_f32"]))),
              "grad_norm": (abs(gnorms[0] - g["grad_norm_kernel"]),
                            limit(abs(g["grad_norm_plain"] - g["grad_norm_plain_f32"]),
                                  g["grad_norm_plain_f32"]))}
    for name, (err, lim) in checks.items():
        if not err <= lim:
            raise AssertionError(f"mesh step 1 {name} lies {err} from the single-device "
                                 f"step's (limit {lim})")
    del params, opt_state
    torch.cuda.empty_cache()
    tp = mesh.shape["model"]
    shape = (b // spmd.data_size(mesh), s, s, cfg.n_heads // tp, cfg.n_kv_heads // tp,
             cfg.head_dim)
    entry = {"name": "flash_attention@mesh-train", "route": "cuda", "source": tfa.SOURCE,
             "replaces": tfa.REPLACES, "launches": launches[0]}
    entry.update(flash_timing(dev, shape, dtype=torch.bfloat16))
    entry["per"] = (f"one call on a model position's head slice: B {shape[0]}, S {s}, H "
                    f"{shape[3]}, Hkv {shape[4]}, D {shape[5]}, causal, bf16; launches per "
                    f"mesh train step ({mesh.shape['data']} data × {tp} model positions, "
                    "forward and remat's recompute)")
    record = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "seq": s,
              "steps": MESH_TRAIN_STEPS, "losses": losses, "grad_norms": gnorms,
              "step_ms": [x * 1e3 for x in secs],
              "step_ms_median_from_step_2": float(np.median(secs[1:])) * 1e3,
              "flash_launches_per_step": launches[0],
              "step1_vs_single_device": {k: {"abs_err": e, "limit": lim}
                                         for k, (e, lim) in checks.items()},
              "state_bytes_per_position": per_position, "state_bytes_stored": stored,
              "state_bytes_allocated": held, "peak_gb": peak / 1e9,
              "activations_gb": (peak - held) / 1e9}
    return record, entry


def mesh_serve(dev, mesh):
    """15c: qwen2-0.5b's prefill and ``MESH_DECODE`` teacher-forced decode
    steps on the mesh (``spmd.prefill``, ``spmd.decode_step``), with and
    without the sequence-sharded cache, against the single-device engine at
    the LM tolerance (phase 4's prompts, f32); then the bf16 step factories
    over them, a prefill and a decode step."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer_serve import ServeEngine
    from repro_torch.sharding import spmd
    from repro_torch.training.tree import tree_map

    cfg = configs.get_config(LM_ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, max_seq=LM_MAX_SEQ, device=dev)
    toks, gold = eng.run(prompts, MESH_DECODE)
    forced = torch.tensor([t[-MESH_DECODE:] for t in toks], device=dev)
    plen = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), plen), dtype=torch.long)
    for i, p in enumerate(prompts):  # right-aligned, as ServeEngine.run
        tokens[i, plen - len(p):] = torch.tensor(p)
    batch = {"tokens": tokens.to(dev)}
    tol_lm = LM_TOL * max(1.0, float(gold.abs().max()))
    runs = {}
    f32 = torch.float32
    for seq_shard in (False, True):
        tfa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = spmd.prefill(cfg, mesh, params, batch, LM_MAX_SEQ, compute_dtype=f32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = tfa.LAUNCHES["flash_attention"]
        if seq_shard:  # the prefill's cache, resharded by sequence
            cache = spmd.unshard_tree(cache, dev)
        outs = [logits[:, -1]]
        t0 = time.perf_counter()
        for i in range(MESH_DECODE - 1):
            log = []
            logits, cache = spmd.decode_step(cfg, mesh, params, cache, forced[:, i], plen + i,
                                             seq_shard, compute_dtype=f32, log=log)
            outs.append(logits[:, -1])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (MESH_DECODE - 1)
        got = torch.stack(outs, dim=1)
        err = (got - gold).abs().amax(dim=(0, 2))
        if not float(err.max()) <= tol_lm:
            raise AssertionError(f"mesh serving (seq_shard_kv={seq_shard}): logits max "
                                 f"|err| {float(err.max())} > {tol_lm}")
        want = cfg.n_layers * mesh.size
        if prefill_launches != want:
            raise AssertionError(f"the mesh prefill launched the flash kernel "
                                 f"{prefill_launches} times; expected {want}")
        runs["seq_shard_kv" if seq_shard else "heads"] = {
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "prefill_flash_launches": prefill_launches,
            "max_abs_err_prefill": float(err[0]), "max_abs_err_decode": float(err[1:].max()),
            "collectives_per_decode": len(log)}
        del cache, logits, got
    # the step factories as a user calls them (bf16 weights and compute):
    # spmd's prefill and one decode step
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    prefill, _ = steps.make_prefill_step(cfg, mesh, None, LM_MAX_SEQ)
    decode, _ = steps.make_decode_step(cfg, mesh, len(prompts), LM_MAX_SEQ)
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = prefill(params16, batch)
    second, cache = decode(params16, cache, forced[:, 0], plen)
    torch.cuda.synchronize()
    factory_ms = (time.perf_counter() - t0) * 1e3
    got = torch.cat([first, second], dim=1).float()
    if (got.shape != gold[:, :2].shape or not torch.isfinite(got).all()
            or tfa.LAUNCHES["flash_attention"] != cfg.n_layers * mesh.size
            or not (prefill.log and decode.log)):
        raise AssertionError(f"the bf16 mesh step factories: logits {tuple(got.shape)}, "
                             f"{tfa.LAUNCHES['flash_attention']} flash launches, "
                             f"{len(prefill.log)} + {len(decode.log)} collectives")
    runs["factories_bf16"] = {"prefill_and_one_decode_ms": factory_ms,
                              "max_abs_err_vs_f32_engine": float((got - gold[:, :2]).abs().max()),
                              "collectives": len(prefill.log) + len(decode.log)}
    del params16, cache, first, second, got
    record = {"arch": cfg.name, "prompt_lens": list(LM_PROMPTS), "max_seq": LM_MAX_SEQ,
              "decode_steps": MESH_DECODE, "dtype": "float32", "tolerance": tol_lm,
              "single_device_prefill_ms": eng.last_timing["prefill_s"] * 1e3, "runs": runs}
    del params, eng, gold
    torch.cuda.empty_cache()
    return record


def mesh_moe(dev, mesh):
    """15e: granite-moe-3b-a800m's prefill on the mesh, each MoE layer
    routing the whole batch, against the single device's; see the module
    docstring's phase 15."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import spmd

    cfg = configs.get_config(MOE_ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in LM_PROMPTS]
    plen = max(len(p) for p in prompts)
    tokens = torch.zeros((len(prompts), plen), dtype=torch.long)
    for i, p in enumerate(prompts):  # right-aligned, as ServeEngine.run
        tokens[i, plen - len(p):] = torch.tensor(p)
    batch = {"tokens": tokens.to(dev)}
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    f32, ms = torch.float32, {}
    runs = {}
    for side in ("one_device", "mesh"):
        tfa.reset_launches()
        with torch.no_grad(), RouteLog(inputs=side == "mesh") as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "mesh":
                logits, cache = spmd.prefill(cfg, mesh, params, batch, LM_MAX_SEQ,
                                             compute_dtype=f32)
            else:
                logits, cache = tr.prefill(cfg, params, batch, LM_MAX_SEQ, compute_dtype=f32)
            torch.cuda.synchronize()
            ms[side] = (time.perf_counter() - t0) * 1e3
        runs[side] = (logits, log, tfa.LAUNCHES["flash_attention"])
        del cache
    gold, one, one_launches = runs["one_device"]
    got, parts, mesh_launches = runs["mesh"]
    tol_lm = LM_TOL * max(1.0, float(gold.abs().max()))
    err = float((got - gold).abs().max())
    if not err <= tol_lm:
        raise AssertionError(f"{cfg.name} mesh prefill: logits max |err| {err} > {tol_lm}")
    if one_launches != cfg.n_layers or mesh_launches != cfg.n_layers * mesh.size:
        raise AssertionError(f"{cfg.name}: {one_launches} and {mesh_launches} flash "
                             "launches in the single-device and mesh prefills")
    n_layers = len(one.routings)
    n_data = len(parts.routings) // n_layers
    dims, k, near = cfg.moe_dims, cfg.moe.top_k, 1e-5
    kept = {"one_device": sum(int(r.keep.sum()) for r in one.routings),
            "mesh": sum(int(r.keep.sum()) for r in parts.routings)}
    same_layers, exact_layers, tied_tokens, keep_moved = 0, 0, 0, 0
    with torch.no_grad():
        for i in range(n_layers):
            mine = [parts.routings[d * n_layers + i] for d in range(n_data)]
            ids = torch.cat([r.expert_ids for r in mine], dim=1)
            keep = torch.cat([r.keep for r in mine], dim=1)
            router = parts.inputs[i][0]
            x = torch.cat([parts.inputs[d * n_layers + i][1] for d in range(n_data)])
            want = moe.route({"router": router}, dims, x)  # one device, the same tokens
            set_diff, affected, keep_diff = compare_routes(
                (ids, keep), (want.expert_ids, want.keep), cfg.moe.n_experts)
            if not bool(set_diff.any()):
                # the same expert sets; their order within a token may differ at a
                # near tie, which moves no arrival rank: compare (token, expert) keeps
                if bool(keep_diff.any()):
                    raise AssertionError(f"{cfg.name} layer {i}: the mesh keeps other "
                                         "choices than one device from the same experts")
                same_layers += 1
                exact_layers += int(torch.equal(ids, want.expert_ids)
                                    and torch.equal(keep, want.keep))
                continue
            top = want.probs.topk(k + 1, dim=-1).values
            gap = (top[..., k - 1] - top[..., k])[set_diff]
            if not bool((gap <= near).all()):
                raise AssertionError(f"{cfg.name} layer {i}: expert sets differ beyond a "
                                     f"near tie (gap {float(gap.max())})")
            if bool((keep_diff & ~affected).any()):
                raise AssertionError(f"{cfg.name} layer {i}: a keep differs in an expert "
                                     "whose arrivals no differing choice changed")
            tied_tokens += int(set_diff.sum())
            keep_moved += int(keep_diff.sum())
    routed = n_layers * tokens.numel() * k
    record = {"arch": cfg.name, "prompt_lens": list(LM_PROMPTS), "dtype": "float32",
              "prefill_ms": ms["mesh"], "single_device_prefill_ms": ms["one_device"],
              "max_abs_err": err, "tolerance": tol_lm, "moe_layers": n_layers,
              "data_positions": n_data, "kept_over_routed": kept["mesh"] / routed,
              "single_device_kept_over_routed": kept["one_device"] / routed,
              "layers_with_equal_routing": same_layers,
              "layers_with_bit_equal_ids_and_keep": exact_layers,
              "tokens_with_near_tie_choices": tied_tokens,
              "keeps_moved_by_near_ties": keep_moved, "flash_launches": mesh_launches}
    del params, runs, gold, got, one, parts
    torch.cuda.empty_cache()
    return record


def mesh_dryrun() -> dict:
    """15d: the dry-run's ``MESH_DRYRUN`` cells on the 16 × 16 production
    mesh (meta device; written under ``build/``), printed."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape in MESH_DRYRUN:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "single", force=True,
                              out_dir=ROOT / "build" / "dryrun_torch")
        print(f"[phase 15d] {dryrun.summary_line(rec, time.perf_counter() - t0)}",
              file=sys.stderr)
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run {arch} {shape}: {rec.get('error')}")
        out[f"{arch}/{shape}"] = {
            key: rec[key] for key in ("chips", "flops", "bytes", "hbm_bytes_model",
                                      "argument_bytes", "temp_bytes", "peak_bytes_est",
                                      "collectives", "roofline")}
    return out


def phase_mesh_steps(dev, ds, grad_check):
    """The step factories on a data × model mesh; see the module
    docstring's phase 15. Returns the ``mesh_steps`` record and the kernels
    line's entries."""
    mesh = step_mesh(dev)
    parts = {}
    t0 = time.perf_counter()
    gcn, entries = mesh_gcn(dev, ds, mesh)
    parts["gcn_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, flash = mesh_train(dev, mesh, grad_check)
    parts["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = mesh_serve(dev, mesh)
    parts["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = mesh_dryrun()
    parts["dryrun_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe = mesh_moe(dev, mesh)
    parts["moe_s"] = time.perf_counter() - t0
    record = {"mesh": dict(mesh.shape), "positions": [str(d) for d in mesh_of(dev, mesh.size)],
              "cards": len({str(d) for d in mesh_of(dev, mesh.size)}),
              "note": "positions that name one card run one after another: this "
                      "measures the sharded steps' cost, not scaling",
              "gcn": gcn, "train": train, "serve": serve, "dryrun": dry, "moe": moe,
              "seconds": parts}
    return record, entries + [flash]


def flash_registers() -> dict:
    """Registers and spill bytes (ptxas), dynamic shared bytes and SASS
    tensor-core instructions of each instantiation of the flash kernels:
    ``HMMA`` (mma.sync) in ``flash_attention.cu``, ``HGMMA`` (wgmma) in
    ``flash_attention_wgmma.cu``; raises if one spills or issues none."""
    import re
    import shutil

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_cuda as tfa

    def instantiation(text):
        if "flash_attention_wgmma_kernel" in text:
            return "bf16,256"
        m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E", text)
        return f"{'f32' if m.group(1) == 'f' else 'bf16'},{m.group(2)}" if m else None

    regs = {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, op in (("flash_attention", "HMMA"), ("flash_attention_wgmma", "HGMMA")):
        name = None
        for line in _build.BUILD_LOGS.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                name = instantiation(line)
                if name:
                    regs[name] = {"library": lib, "tensor_core_op": op, "count": 0}
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                regs[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name]["registers"] = int(m.group(1))
        sass = subprocess.run([tool, "--dump-sass", str(_build.library_path(lib))],
                              check=True, capture_output=True, text=True).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = instantiation(m.group(1))
            elif name in regs and re.search(rf"\b{op}\.", line):
                regs[name]["count"] += 1
    want = 2 * len(tfa.HEAD_DIMS)  # f32 and bf16 at every head width
    if len(regs) != want:
        raise AssertionError(
            f"expected {want} flash kernel instantiations, found {sorted(regs)}")
    for name, r in regs.items():
        kind, d = name.split(",")
        r["shared_bytes"] = tfa.shared_bytes(
            int(d), torch.float32 if kind == "f32" else torch.bfloat16)
        if r.get("spill_store_bytes", 0) or not r["count"]:
            raise AssertionError(f"flash kernel <{name}> spills or issues no "
                                 f"{r['tensor_core_op']}: {r}")
    return regs


def phase_examples(card: str) -> dict:
    """The port's examples on the card; see the module docstring's phase 16.
    Returns the ``examples`` record."""
    import contextlib
    import importlib.util

    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.kernels import spmm_cuda

    out = {}
    for name, must in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        spmm_cuda.reset_launches()
        tfa.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            mod.main([])
        seconds = time.perf_counter() - t0
        rec = {"seconds": seconds,
               "spmm_launches": sum(spmm_cuda.LAUNCHES.values()),
               "flash_launches": sum(tfa.LAUNCHES.values())}
        if must is not None and rec[f"{must}_launches"] == 0:
            raise AssertionError(f"phase 16: {name} never launched the {must} kernels")
        out[name] = rec
        print(f"[phase 16] {name} in {seconds:.1f} s", file=sys.stderr)
    out["card"] = card
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    start = time.perf_counter()
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()

    t0 = time.perf_counter()
    _build.build(["spmm_balanced", "flash_attention", "flash_attention_wgmma"])
    build_s = time.perf_counter() - t0
    for name, log in _build.BUILD_LOGS.items():
        print(f"[build] {name}.cu in {build_s:.1f} s\n{log.strip()}", file=sys.stderr)
    flash_regs = flash_registers()
    spmm_regs = kernel_registers()

    t0 = time.perf_counter()
    n_cases = phase_small(dev)
    print(f"[phase 1] {n_cases} small kernel checks passed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    n_attn, attn_small_err = phase_attention_small(dev)
    print(f"[phase 1b] {n_attn} flash-attention checks passed in "
          f"{time.perf_counter() - t0:.1f} s (f32 max |err| {attn_small_err:.3g})",
          file=sys.stderr)
    ds, ex, launches, serving = phase_serve(dev)
    print(f"[phase 2] served {serving['requests']} requests", file=sys.stderr)
    kernels, all_miss, lanes, geometry = phase_kernels(ds, ex, launches)
    serving["schedule"] = geometry
    print("[phase 3] SpMM kernels timed", file=sys.stderr)
    del ex
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm, attn_launches = phase_lm(dev)
    print(f"[phase 4] served {LM_ARCH} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    attn_entry, attn_bounds = phase_attention_time(dev, attn_launches, attn_small_err)
    kernels.append(attn_entry)
    print("[phase 5] flash kernel timed", file=sys.stderr)
    t0 = time.perf_counter()
    engine, engine_launches, winner, store = phase_engine(
        dev, ds, serving["steady_requests_per_s"])
    print(f"[phase 6] engine served reddit (cold, warm, eviction) in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    bf16acc = phase_bf16acc(ds, winner)
    print("[phase 6b] bf16-accumulate SpMM kernels checked and timed on the sweep "
          "winner's schedule", file=sys.stderr)
    del winner
    t0 = time.perf_counter()
    streaming = phase_streaming(dev, ds, store)
    print(f"[phase 7] streamed updates into reddit in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    training, at_kernels = phase_training(dev, ds)
    print(f"[phase 8] trained on reddit ({TRAIN_STEPS} steps, resumed from step "
          f"{TRAIN_SAVE_AT}) in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    mesh_exec, mesh_launches = phase_mesh_executor(dev, ds)
    print(f"[phase 9a] sharded reddit on {MESH_SIZES} positions in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    mesh_engine = phase_mesh_engine(dev, ds)
    print(f"[phase 9b] mesh engine (sharded reddit, replicas, updates, a fault) in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_serving, moe_entries = phase_moe(dev)
    print(f"[phase 10] served {MOE_ARCH} and {MOE_CUT_ARCH} ({MOE_CUT_LAYERS} layers) "
          f"in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    kernels.extend(moe_entries)
    moe_serving["card"] = card
    t0 = time.perf_counter()
    whisper, whisper_entry = phase_whisper(dev)
    print(f"[phase 11] served {WHISPER_ARCH} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    rgemma, rgemma_entries = phase_recurrentgemma(dev)
    print(f"[phase 12] served {RG_ARCH} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    kernels.extend([whisper_entry, *rgemma_entries])
    whisper["card"] = card
    rgemma["card"] = card
    t0 = time.perf_counter()
    rwkv = phase_rwkv(dev)
    rwkv["card"] = card
    print(f"[phase 13] served {RWKV_ARCH} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    lm_training, training_entry = phase_lm_training(dev)
    lm_training["card"] = card
    kernels.append(training_entry)
    print(f"[phase 14] trained {LM_ARCH} ({TRAIN_LM_STEPS} steps, resumed from step "
          f"{TRAIN_LM_SAVE_AT}) in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_steps, mesh_entries = phase_mesh_steps(dev, ds, lm_training["grad_check"])
    mesh_steps["seconds"]["phase"] = time.perf_counter() - t0
    mesh_steps["card"] = card
    mesh_steps["train"]["single_device_step_ms_median_phase14"] = lm_training[
        "step_ms_median"]
    kernels.extend(mesh_entries)
    del ds
    torch.cuda.empty_cache()
    print(f"[phase 15] mesh steps (gcn, train, prefill/decode, dry-run, MoE prefill) in "
          f"{mesh_steps['seconds']['phase']:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    examples = phase_examples(card)
    print(f"[phase 16] the port's four examples in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    for entry in kernels:
        if entry["name"] in F32_SPMM:
            entry["launches_sharded_forward_batch"] = {
                pos: per[entry["name"]] for pos, per in mesh_launches.items()}
    mesh_exec["card"] = card
    mesh_engine["card"] = card
    training["card"] = card
    kernels.extend(at_kernels)
    streaming["card"] = card
    for entry in bf16acc:
        entry["launches"] = engine_launches[entry["name"]]
    kernels.extend(bf16acc)
    engine["launches"] = engine_launches
    engine["card"] = card
    serving["build_s"] = build_s
    serving["card"] = card
    lm["card"] = card

    # the SpMM kernels' registers and spills, and the window kernel's lanes
    print(json.dumps({"spmm_registers": spmm_regs, "spmm_lanes": lanes}))
    print(json.dumps({"flash_registers": flash_regs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"lm_serving": lm}))
    print(json.dumps({"engine_serving": engine}))
    print(json.dumps({"engine_streaming": streaming}))
    print(json.dumps({"gcn_training": training}))
    print(json.dumps({"mesh_executor": mesh_exec}))
    print(json.dumps({"engine_mesh": mesh_engine}))
    print(json.dumps({"moe_serving": moe_serving}))
    print(json.dumps({"whisper_serving": whisper}))
    print(json.dumps({"recurrentgemma_serving": rgemma}))
    print(json.dumps({"rwkv_serving": rwkv}))
    print(json.dumps({"lm_training": lm_training}))
    print(json.dumps({"mesh_steps": mesh_steps}))
    print(json.dumps({"examples": examples}))
    # the window kernel's bound if every gathered B row came from HBM, per kdim
    print(json.dumps({"spmm_balanced_bound_all_miss_ms": all_miss}))
    # the flash kernel's bounds at the prefill shape: tensor cores (3xTF32 in
    # f32, bf16), CUDA cores (f32), the softmax's ex2 and HBM
    print(json.dumps({"flash_bounds": attn_bounds}))
    print(card)
    print(f"[chip_smoke] all phases in {time.perf_counter() - start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
